"""Negative edge sampling for the full-batch trainer.

Port of ``gnn_recsys_tpu/ops/negative.py`` (the reference's DGL
``negative_sampler.Uniform``, ``src/sampling.py:163-165``): for each
positive edge (u, i), ``neg_sample_size`` destinations drawn uniformly over
the catalog, with the same source.  The ints come from a draw source
(:class:`~gnn_recsys_tpu_torch.ops.sampling.Draws`), so a test can replay the
JAX package's draws.
"""

from __future__ import annotations

from typing import Tuple

import torch


def uniform_negative_dst(
    draws,
    pos_src: torch.Tensor,
    num_dst: int,
    neg_sample_size: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Uniformly corrupted destinations.  pos_src: [B] source ids; returns
    (neg_src [B, S], the sources broadcast; neg_dst [B, S] int32 in
    [0, num_dst)), on the device of the draws."""
    b = pos_src.shape[0]
    neg_dst = draws.randint((b, neg_sample_size), num_dst)
    neg_src = pos_src.to(neg_dst.device)[:, None].expand(b, neg_sample_size)
    return neg_src, neg_dst
