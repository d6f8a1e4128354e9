"""Inputs made from the seed: the click/purchase graph and the weights.

The graph generator copies the arithmetic of the clustered synthetic data
the repository's benchmark model has always used (users and items in
groups; each user buys ``interactions_per_user`` items, in its group with
probability ``in_group_prob``, and as many clicks go to random users'
picks; noisy one-hot features of the group).  It returns COO lists, which
both the program and the reference build their own structures from.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

MASK64 = (1 << 64) - 1


def sub_seed(seed: int, *tags: int) -> int:
    """A 63-bit seed for one use of the run's ``--seed`` (any integer)."""
    state = np.random.SeedSequence([seed & MASK64, *tags]).generate_state(1, dtype=np.uint64)
    return int(state[0]) & ((1 << 63) - 1)


def make_graph(g: dict, seed: int) -> dict:
    """``schema`` (etype -> (src, dst) int32), ``num_nodes``, ``ndata``,
    ``edata`` and ``train_etypes`` of the clustered click/purchase graph."""
    rng = np.random.default_rng(seed)
    num_users, num_items, groups = g["num_users"], g["num_items"], g["num_groups"]
    per_user, feat_dim = g["interactions_per_user"], g["feat_dim"]
    user_group = rng.integers(0, groups, size=num_users)
    item_group = rng.integers(0, groups, size=num_items)
    pool = np.argsort(item_group, kind="stable").astype(np.int64)
    sizes = np.bincount(item_group, minlength=groups)
    offsets = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    empty = sizes == 0

    def items_for(users: np.ndarray) -> np.ndarray:
        grp = user_group[users]
        in_group = (rng.random(users.shape[0]) < g["in_group_prob"]) & ~empty[grp]
        within = (rng.random(users.shape[0]) * np.maximum(sizes[grp], 1)).astype(np.int64)
        clustered = pool[offsets[grp] + within]
        uniform = rng.integers(0, num_items, size=users.shape[0])
        return np.where(in_group, clustered, uniform).astype(np.int32)

    buys_u = np.repeat(np.arange(num_users, dtype=np.int32), per_user)
    buys_i = items_for(buys_u)
    items_for(np.repeat(np.arange(num_users, dtype=np.int32), g["test_per_user"]))
    clicks_u = rng.integers(0, num_users, size=num_users * per_user).astype(np.int32)
    clicks_i = items_for(clicks_u)
    schema = {("user", "buys", "item"): (buys_u, buys_i),
              ("item", "bought-by", "user"): (buys_i, buys_u),
              ("user", "clicks", "item"): (clicks_u, clicks_i),
              ("item", "clicked-by", "user"): (clicks_i, clicks_u)}

    def noisy_onehot(grp: np.ndarray) -> np.ndarray:
        base = np.zeros((len(grp), feat_dim), dtype=np.float32)
        base[np.arange(len(grp)), grp % feat_dim] = 1.0
        return base + rng.normal(0, 0.1, size=base.shape).astype(np.float32)

    ndata = {"user": {"features": noisy_onehot(user_group)},
             "item": {"features": noisy_onehot(item_group)}}
    edata = {et: {"occurrence": rng.integers(1, 4, size=len(s)).astype(np.float32),
                  "recency": rng.integers(1, 30, size=len(s)).astype(np.float32)}
             for et, (s, _) in schema.items()}
    return {"schema": schema, "num_nodes": {"user": num_users, "item": num_items},
            "ndata": ndata, "edata": edata,
            "train_etypes": (("user", "buys", "item"), ("user", "clicks", "item"))}


def make_weights(spec: Dict[str, tuple], seed: int, device) -> Dict[str, torch.Tensor]:
    """Float32 parameters from one uniform draw on ``device``: each matrix
    Xavier-uniform with ReLU gain, each bias uniform in [-0.1, 0.1)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    sizes = [int(np.prod(s)) for s in spec.values()]
    flat = torch.rand(sum(sizes), generator=gen, device=device) * 2 - 1
    out, lo = {}, 0
    for (name, shape), n in zip(spec.items(), sizes):
        if len(shape) == 2:
            scale = (2.0 ** 0.5) * (6.0 / (shape[0] + shape[1])) ** 0.5
        else:
            scale = 0.1
        out[name] = (flat[lo:lo + n] * scale).reshape(shape)
        lo += n
    return out
