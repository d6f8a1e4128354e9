"""Synthetic interaction graphs for tests and benchmarks.

Port of ``gnn_recsys_tpu/utils/synthetic.py``: ``make_synthetic_data``
(``:41``), a clustered bipartite user-item graph with clicks and an optional
sport node type, and ``make_hard_synthetic_data`` (``:146``), interactions
from a latent-factor model with Zipf popularity.  The numpy draws come in the
same order, so the same seed gives the same arrays as the JAX package.
``make_drift_logs`` is ``benchmarks/e2e_drift_cli.py:make_drift_csvs``
without pandas: raw interaction logs in the reference's CSV layout, whose
items live for a finite window, so that the ETL's date windows drop rows.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional, Tuple

import numpy as np

from gnn_recsys_tpu_torch.config import ColumnConfig
from gnn_recsys_tpu_torch.data.io import write_csv
from gnn_recsys_tpu_torch.data.table import Table
from gnn_recsys_tpu_torch.graph.hetero import HeteroGraph, build_hetero_graph


@dataclasses.dataclass
class SyntheticData:
    graph: HeteroGraph  # full graph (train + valid edges)
    train_graph: HeteroGraph  # the same graph: test edges were never added
    # canonical etype -> (user ids, item ids) of training positive edges
    train_pairs: Dict[Tuple[str, str, str], Tuple[np.ndarray, np.ndarray]]
    test_ground_truth: Tuple[np.ndarray, np.ndarray]  # (users, items)
    num_users: int
    num_items: int
    num_groups: int
    user_group: Optional[np.ndarray] = None
    item_group: Optional[np.ndarray] = None
    # make_hard_synthetic_data: the latent factors that generated the
    # interactions, for oracle-ceiling baselines.
    user_latent: Optional[np.ndarray] = None
    item_latent: Optional[np.ndarray] = None
    item_logpop: Optional[np.ndarray] = None


def make_synthetic_data(
    num_users: int = 200,
    num_items: int = 100,
    num_groups: int = 5,
    interactions_per_user: int = 12,
    test_per_user: int = 3,
    feat_dim: int = 8,
    in_group_prob: float = 0.9,
    with_clicks: bool = True,
    with_sports: bool = False,
    num_sports: int = 10,
    seed: int = 0,
    max_fanout: Optional[int] = None,
) -> SyntheticData:
    rng = np.random.default_rng(seed)
    user_group = rng.integers(0, num_groups, size=num_users)
    item_group = rng.integers(0, num_groups, size=num_items)
    # Per-group item pools, concatenated for vectorized gather.
    pool_concat = np.argsort(item_group, kind="stable").astype(np.int64)
    group_sizes = np.bincount(item_group, minlength=num_groups)
    group_offsets = np.concatenate([[0], np.cumsum(group_sizes)[:-1]])
    empty = group_sizes == 0  # fall back to uniform for empty groups

    def sample_items_for(users: np.ndarray) -> np.ndarray:
        """One clustered item draw per entry of ``users``."""
        g = user_group[users]
        in_group = (rng.random(users.shape[0]) < in_group_prob) & ~empty[g]
        within = (rng.random(users.shape[0]) * np.maximum(group_sizes[g], 1)
                  ).astype(np.int64)
        clustered = pool_concat[group_offsets[g] + within]
        uniform = rng.integers(0, num_items, size=users.shape[0])
        return np.where(in_group, clustered, uniform).astype(np.int32)

    buys_u = np.repeat(np.arange(num_users, dtype=np.int32), interactions_per_user)
    buys_i = sample_items_for(buys_u)
    test_u = np.repeat(np.arange(num_users, dtype=np.int32), test_per_user)
    test_i = sample_items_for(test_u)

    schema = {
        ("user", "buys", "item"): (buys_u, buys_i),
        ("item", "bought-by", "user"): (buys_i, buys_u),
    }
    train_pairs = {("user", "buys", "item"): (buys_u, buys_i)}
    if with_clicks:
        n_clicks = num_users * interactions_per_user
        clicks_u = rng.integers(0, num_users, size=n_clicks).astype(np.int32)
        clicks_i = sample_items_for(clicks_u)
        schema[("user", "clicks", "item")] = (clicks_u, clicks_i)
        schema[("item", "clicked-by", "user")] = (clicks_i, clicks_u)
        train_pairs[("user", "clicks", "item")] = (clicks_u, clicks_i)

    num_nodes = {"user": num_users, "item": num_items}
    if with_sports:
        num_nodes["sport"] = num_sports
        item_sport = rng.integers(0, num_sports, size=num_items).astype(np.int32)
        iid = np.arange(num_items, dtype=np.int32)
        schema[("item", "utilized-by", "sport")] = (iid, item_sport)
        schema[("sport", "utilizes", "item")] = (item_sport, iid)

    def noisy_onehot(groups: np.ndarray, dim: int) -> np.ndarray:
        base = np.zeros((len(groups), dim), dtype=np.float32)
        base[np.arange(len(groups)), groups % dim] = 1.0
        return base + rng.normal(0, 0.1, size=base.shape).astype(np.float32)

    ndata = {
        "user": {"features": noisy_onehot(user_group, feat_dim)},
        "item": {"features": noisy_onehot(item_group, feat_dim)},
    }
    if with_sports:
        sport_groups = np.arange(num_sports) % num_groups
        ndata["sport"] = {"features": noisy_onehot(sport_groups, feat_dim)}

    # Per-edge features: occurrence (counts) and recency (days).
    edata = {}
    for etype, (s, _) in schema.items():
        if etype[0] in ("user", "item") and etype[2] in ("user", "item"):
            edata[etype] = {
                "occurrence": rng.integers(1, 4, size=len(s)).astype(np.float32),
                "recency": rng.integers(1, 30, size=len(s)).astype(np.float32),
            }

    graph = build_hetero_graph(
        schema, num_nodes, edata=edata, ndata=ndata, max_fanout=max_fanout
    )
    return SyntheticData(
        graph=graph,
        train_graph=graph,
        train_pairs=train_pairs,
        test_ground_truth=(np.asarray(test_u, dtype=np.int32),
                           np.asarray(test_i, dtype=np.int32)),
        num_users=num_users,
        num_items=num_items,
        num_groups=num_groups,
        user_group=user_group,
        item_group=item_group,
    )


def make_hard_synthetic_data(
    num_users: int = 50_000,
    num_items: int = 15_000,
    latent_dim: int = 16,
    feat_dim: int = 8,
    interactions_per_user: int = 12,
    test_per_user: int = 2,
    beta: float = 6.0,
    pop_exponent: float = 0.9,
    pop_weight: float = 0.5,
    feat_noise: float = 1.5,
    with_clicks: bool = True,
    click_beta: float = 2.0,
    seed: int = 0,
    max_fanout: Optional[int] = None,
    user_chunk: int = 2048,
) -> SyntheticData:
    """Interactions drawn from ``P(i | u) ~ exp(beta <z_u, z_i> + pop_weight *
    logpop_i)`` without replacement (Gumbel top-k): unit Gaussian latents, a
    Zipf(``pop_exponent``) item popularity, so hub items and a popularity
    baseline that a model can beat; node features are a low-rank noisy
    projection of the latents, so a model must use the graph.  Clicks are the
    same process at the weaker ``click_beta``.  The latent scorer's recall is
    the ceiling, popularity's the floor."""
    rng = np.random.default_rng(seed)
    zu = rng.standard_normal((num_users, latent_dim)).astype(np.float32)
    zi = rng.standard_normal((num_items, latent_dim)).astype(np.float32)
    zu /= np.linalg.norm(zu, axis=1, keepdims=True)
    zi /= np.linalg.norm(zi, axis=1, keepdims=True)
    # Zipf popularity over a random item permutation.
    ranks = rng.permutation(num_items) + 1
    logpop = (-pop_exponent * np.log(ranks)).astype(np.float32)
    logpop -= logpop.max()

    def draw_for(users_lo, users_hi, n_draw, b):
        """Gumbel top-n_draw item ids [C, n_draw] (unordered) per user."""
        z = zu[users_lo:users_hi]
        logits = b * (z @ zi.T) + pop_weight * logpop[None, :]
        g = rng.gumbel(size=logits.shape).astype(np.float32)
        part = np.argpartition(-(logits + g), n_draw, axis=1)[:, :n_draw]
        return part.astype(np.int32)

    n_draw = interactions_per_user + test_per_user
    buys = np.empty((num_users, n_draw), dtype=np.int32)
    for lo in range(0, num_users, user_chunk):
        hi = min(lo + user_chunk, num_users)
        buys[lo:hi] = draw_for(lo, hi, n_draw, beta)
    # Shuffle each row, then split train / test: the held-out items are an
    # exchangeable sample of the user's draws.
    perm = rng.permuted(np.broadcast_to(np.arange(n_draw), (num_users, n_draw)), axis=1)
    buys = np.take_along_axis(buys, perm, axis=1)
    train_items = buys[:, :interactions_per_user]
    test_items = buys[:, interactions_per_user:]

    buys_u = np.repeat(np.arange(num_users, dtype=np.int32), interactions_per_user)
    buys_i = train_items.reshape(-1)
    test_u = np.repeat(np.arange(num_users, dtype=np.int32), test_per_user)
    test_i = test_items.reshape(-1)

    schema = {
        ("user", "buys", "item"): (buys_u, buys_i),
        ("item", "bought-by", "user"): (buys_i, buys_u),
    }
    train_pairs = {("user", "buys", "item"): (buys_u, buys_i)}
    if with_clicks:
        clicks = np.empty((num_users, interactions_per_user), dtype=np.int32)
        for lo in range(0, num_users, user_chunk):
            hi = min(lo + user_chunk, num_users)
            clicks[lo:hi] = draw_for(lo, hi, interactions_per_user, click_beta)
        clicks_u = np.repeat(np.arange(num_users, dtype=np.int32), interactions_per_user)
        clicks_i = clicks.reshape(-1)
        schema[("user", "clicks", "item")] = (clicks_u, clicks_i)
        schema[("item", "clicked-by", "user")] = (clicks_i, clicks_u)
        train_pairs[("user", "clicks", "item")] = (clicks_u, clicks_i)

    proj_u = rng.standard_normal((latent_dim, feat_dim)).astype(np.float32)
    proj_i = rng.standard_normal((latent_dim, feat_dim)).astype(np.float32)
    ndata = {
        "user": {"features": zu @ proj_u + feat_noise * rng.standard_normal(
            (num_users, feat_dim)).astype(np.float32)},
        "item": {"features": zi @ proj_i + feat_noise * rng.standard_normal(
            (num_items, feat_dim)).astype(np.float32)},
    }
    edata = {
        etype: {"occurrence": np.ones(len(s), dtype=np.float32),
                "recency": rng.integers(1, 30, size=len(s)).astype(np.float32)}
        for etype, (s, _) in schema.items()
    }
    graph = build_hetero_graph(schema, {"user": num_users, "item": num_items},
                               edata=edata, ndata=ndata, max_fanout=max_fanout)
    return SyntheticData(
        graph=graph,
        train_graph=graph,  # test edges were never added
        train_pairs=train_pairs,
        test_ground_truth=(test_u, test_i),
        num_users=num_users,
        num_items=num_items,
        num_groups=0,
        user_latent=zu,
        item_latent=zi,
        item_logpop=logpop,
    )


def make_drift_logs(outdir: str, num_users: int = 3000, num_items: int = 900,
                    per_user: int = 30, total_days: int = 540, latent_dim: int = 8,
                    beta: float = 5.0, pop_weight: float = 0.5,
                    seed: int = 0) -> Tuple[Dict[str, str], Table]:
    """Write ``interactions.csv``, ``item_feat.csv`` and ``user_feat.csv``
    to ``outdir``, byte for byte what ``make_drift_csvs`` writes for the same
    arguments (the same draws from ``np.random.default_rng(seed)``); returns
    (the files' paths by name, the interactions).

    Users prefer items of high ``<z_u, z_i>`` and popular items; each item
    is active over ``[birth, death)`` days (birth uniform over the history,
    120-300 day lives); a user interacts only with items active that day,
    half the days in the last 120; 60% of interactions are purchases."""
    c = ColumnConfig()
    rng = np.random.default_rng(seed)
    zu = rng.normal(size=(num_users, latent_dim))
    zi = rng.normal(size=(num_items, latent_dim))
    logpop = -0.9 * np.log(rng.permutation(num_items) + 1.0)
    birth = rng.integers(0, total_days - 60, num_items)
    death = np.minimum(birth + rng.integers(120, 300, num_items), total_days)
    base = np.datetime64("2020-01-01", "D")
    rows = []
    for u in range(num_users):
        days = np.concatenate([
            rng.integers(0, total_days, per_user // 2),
            rng.integers(total_days - 120, total_days, per_user // 2),
        ])
        for d in days:
            active = np.flatnonzero((birth <= d) & (d < death))
            if len(active) == 0:
                continue
            logits = beta * (zi[active] @ zu[u]) / np.sqrt(latent_dim) \
                + pop_weight * logpop[active]
            logits -= logits.max()
            pvec = np.exp(logits)
            it = int(rng.choice(active, p=pvec / pvec.sum()))
            buy = int(rng.random() < 0.6)
            rows.append((f"u{u}", f"it{it}", buy, str(base + np.timedelta64(int(d), "D")),
                         int(d) * 100000 + len(rows)))
    cols = list(zip(*rows)) or [()] * 5
    df = Table({name: np.array(col, dtype=object if i in (0, 1, 3) else np.int64)
                for i, (name, col) in enumerate(zip(
                    (c.ctm_id, c.specific_item_id, c.buy, c.hit_date, c.hit_timestamp), cols))})
    ar_items, ar_users = np.arange(num_items), np.arange(num_users)
    itf = Table({
        c.specific_item_id: np.array([f"it{i}" for i in ar_items], dtype=object),
        c.general_item_id: np.array([f"g{i // 3}" for i in ar_items], dtype=object),
        "is_junior": ar_items % 2, "is_male": (ar_items + 1) % 2,
        "is_female": np.zeros(num_items, np.int64), "eco_design": np.ones(num_items, np.int64),
    })
    uf = Table({c.ctm_id: np.array([f"u{i}" for i in ar_users], dtype=object),
                "is_male": ar_users % 2, "is_female": (ar_users + 1) % 2})
    os.makedirs(outdir, exist_ok=True)
    paths = {}
    for name, table in (("interactions", df), ("item_feat", itf), ("user_feat", uf)):
        paths[name] = os.path.join(outdir, f"{name}.csv")
        write_csv(table, paths[name])
    return paths, df
