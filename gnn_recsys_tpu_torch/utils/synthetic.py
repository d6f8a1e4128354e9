"""Synthetic interaction graphs for tests and benchmarks.

Port of ``make_synthetic_data`` (``gnn_recsys_tpu/utils/synthetic.py:41``):
a clustered bipartite user-item graph with clicks and an optional sport node
type.  The numpy draws come in the same order, so the same seed gives the
same arrays as the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np

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
