"""Padded-row pair-set membership.

Port of ``gnn_recsys_tpu/ops/membership.py``: per source, the padded row of
its destination ids; ``contains(u, v)`` is one row gather and a broadcast
compare.  Used for the already-bought filter in retrieval and for the
ground-truth test in the metrics.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from gnn_recsys_tpu_torch.graph.hetero import coo_to_padded_csc
from gnn_recsys_tpu_torch.ops.cuda import pool_mask
from gnn_recsys_tpu_torch.utils.profiling import to_device


@dataclasses.dataclass
class PaddedPairSet:
    """Per-source padded destination rows; empty slots are -1."""

    rows: torch.Tensor  # [num_src, K] int32
    num_src: int

    @property
    def max_row(self) -> int:
        return self.rows.shape[1]

    def to(self, device) -> "PaddedPairSet":
        return PaddedPairSet(rows=to_device(self.rows, device), num_src=self.num_src)


def build_padded_pair_set(src, dst, num_src: int,
                          cap: Optional[int] = None) -> PaddedPairSet:
    """Host-side build from COO pairs (numpy in, CPU tensor out).  With a
    ``cap``, each source keeps its ``cap`` most recent pairs."""
    # The CSC packer with roles swapped: rows keyed by SOURCE.
    nbr, _, nbr_mask, _ = coo_to_padded_csc(
        np.asarray(dst, dtype=np.int32), np.asarray(src, dtype=np.int32),
        num_dst=num_src, max_fanout=cap,
    )
    rows = np.where(nbr_mask, nbr, -1).astype(np.int32)
    return PaddedPairSet(rows=torch.from_numpy(rows), num_src=num_src)


def _rows_of(ps: PaddedPairSet, u: torch.Tensor) -> torch.Tensor:
    # Out-of-range ids clamp to the nearest row (the JAX take's mode="clip").
    return ps.rows[u.long().clamp(0, ps.rows.shape[0] - 1)]


def pair_set_contains(ps: PaddedPairSet, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Is (u[i], v[i]) in the set?  u: [*s]; v: [*s] or [*s, S].  Returns
    bool of v's shape.  Negative probes (the -1 "no recommendation" slot)
    never match, although padding is -1 too."""
    rows = _rows_of(ps, u)  # [*s, K]
    if v.dim() == u.dim():
        return (rows == v[..., None]).any(dim=-1) & (v >= 0)
    return (rows[..., None, :] == v[..., None]).any(dim=-1) & (v >= 0)


def pair_set_contains_pool(ps: PaddedPairSet, u: torch.Tensor, pool: torch.Tensor,
                           use_kernel: bool = False) -> torch.Tensor:
    """Membership of every (u[b], pool[p]) pair: the dense-pool
    false-negative mask, where every positive probes the same pool.
    Returns [B, P] f32.  ``use_kernel`` routes rows of at most 128 slots
    through :func:`~gnn_recsys_tpu_torch.ops.cuda.pool_mask.pool_membership_mask`
    (its plain version for CPU tensors), as the JAX routing does."""
    rows = _rows_of(ps, u)  # [B, K]
    if use_kernel and rows.shape[1] <= pool_mask.MAX_ROW:
        return pool_mask.pool_membership_mask(rows, pool)
    return pool_mask.pool_membership_mask_reference(rows, pool)


def scatter_row_mask(ps: PaddedPairSet, u: torch.Tensor, num_dst: int,
                     lo: int = 0) -> torch.Tensor:
    """Dense [len(u), num_dst] membership mask for the given sources over
    destinations ``lo .. lo + num_dst - 1`` (a catalog shard's columns):
    each source's row scattered into a boolean row; padding and destinations
    outside the range land in a dropped overflow column."""
    rows = _rows_of(ps, u).long() - lo  # [C, K]
    cols = torch.where((rows >= 0) & (rows < num_dst), rows, torch.full_like(rows, num_dst))
    out = torch.zeros((rows.shape[0], num_dst + 1), dtype=torch.bool, device=rows.device)
    out.scatter_(1, cols, torch.ones_like(cols, dtype=torch.bool))
    return out[:, :num_dst]
