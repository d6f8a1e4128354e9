"""Message-passing aggregation primitives.

Port of ``gnn_recsys_tpu/ops/message.py`` (the XLA segment reductions that
stand in for DGL's ``update_all(copy_src|u_mul_e, mean|max)``).  Two
layouts, same semantics:

* ``coo_segment_*`` — scatter-reduce over the COO edge list
  (``index_add_`` / ``scatter_reduce_``), for full-graph passes.
* ``csc_gather_mean`` — gather + masked mean over the padded neighbour table
  (without edge weights: the gather-mean kernel, ``ops/cuda/gather_mean.py``);
  ``csc_gather_max`` — the masked max over the same table.

DGL semantics: ``mean`` divides by the number of incoming messages and a
zero-degree destination gets zeros; ``max`` over no messages gives zeros;
edge-weighted variants scale each message by a scalar edge value first.

bf16 tables give bf16 results.  The means sum in f32 and round once: the
JAX package's ``coo_segment_mean`` sums its messages and its count with a
bf16 ``segment_sum``, whose count stops at 256 (256 + 1 rounds back to 256
in bf16), so a node with more than 256 in-edges gets a wrong mean there
(ROADMAP.md, queue 3).
"""

from __future__ import annotations

from typing import Optional

import torch

from gnn_recsys_tpu_torch.ops.cuda.gather_mean import gather_mean


def _messages(h_src, src, edge_weight):
    msgs = h_src.index_select(0, src.long())
    if edge_weight is not None:
        msgs = msgs * edge_weight[:, None].to(msgs.dtype)
    return msgs


def coo_segment_mean(
    h_src: torch.Tensor,
    src: torch.Tensor,
    dst: torch.Tensor,
    num_dst: int,
    edge_weight: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Mean of incoming messages per destination, COO layout.

    h_src: [N_src, D]; src/dst: [E]; edge_weight: [E] or None -> [num_dst, D].
    """
    msgs = _messages(h_src, src, edge_weight)
    dst = dst.long()
    acc = torch.promote_types(h_src.dtype, torch.float32)  # f32 sums for bf16
    total = torch.zeros((num_dst, h_src.shape[1]), dtype=acc, device=h_src.device)
    total.index_add_(0, dst, msgs.to(acc))
    count = torch.zeros(num_dst, dtype=acc, device=h_src.device).index_add_(
        0, dst, torch.ones(dst.shape[0], dtype=acc, device=h_src.device)
    )
    return (total / count.clamp(min=1.0)[:, None]).to(h_src.dtype)


def coo_segment_max(
    h_src: torch.Tensor,
    src: torch.Tensor,
    dst: torch.Tensor,
    num_dst: int,
    edge_weight: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Max of incoming messages per destination, COO layout (zeros where a
    destination has no messages)."""
    msgs = _messages(h_src, src, edge_weight)
    index = dst.long()[:, None].expand(-1, h_src.shape[1])
    out = h_src.new_full((num_dst, h_src.shape[1]), float("-inf"))
    out.scatter_reduce_(0, index, msgs, reduce="amax", include_self=True)
    return torch.where(torch.isfinite(out), out, torch.zeros_like(out))


def _gather_msgs(h_src, nbr, nbr_eid, edge_weight):
    # Padding slots hold -1: clip into range before gathering (``jnp.take``'s
    # ``mode='clip'``); the mask drops them.
    msgs = h_src[nbr.long().clamp(0, h_src.shape[0] - 1)]  # [N_dst, K, D]
    if edge_weight is not None:
        if nbr_eid is None:
            raise ValueError("edge weighting requires nbr_eid")
        w = edge_weight[nbr_eid.long().clamp(0, edge_weight.shape[0] - 1)]
        msgs = msgs * w[..., None].to(msgs.dtype)
    return msgs


def csc_gather_mean(
    h_src: torch.Tensor,
    nbr: torch.Tensor,
    nbr_mask: torch.Tensor,
    nbr_eid: Optional[torch.Tensor] = None,
    edge_weight: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Masked mean over the padded neighbour axis; the denominator is the
    true number of valid slots.  h_src: [N_src, D]; nbr/nbr_mask: [N_dst, K].

    Without edge weights this is the contract of the gather-mean kernel
    (:func:`~gnn_recsys_tpu_torch.ops.cuda.gather_mean.gather_mean`), which
    it calls: for CUDA tensors it launches the kernels."""
    if edge_weight is None:
        return gather_mean(h_src, nbr, nbr_mask)
    msgs = _gather_msgs(h_src, nbr, nbr_eid, edge_weight)
    mask = nbr_mask.to(h_src.dtype)
    total = (msgs * mask[..., None]).sum(dim=1)
    return total / mask.sum(dim=1).clamp(min=1.0)[:, None]


def csc_gather_max(
    h_src: torch.Tensor,
    nbr: torch.Tensor,
    nbr_mask: torch.Tensor,
    nbr_eid: Optional[torch.Tensor] = None,
    edge_weight: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Masked max over the padded neighbour axis (``message.py:108-120``);
    a row with no valid slot gives zeros.  h_src: [N_src, D]; nbr/nbr_mask:
    [N_dst, K]; padding ids (-1) and ids >= N_src are clipped into range."""
    msgs = _gather_msgs(h_src, nbr, nbr_eid, edge_weight)
    out = msgs.masked_fill(~nbr_mask.bool()[..., None], float("-inf")).amax(dim=1)
    return torch.where(torch.isfinite(out), out, torch.zeros_like(out))


def edge_dot(h_u: torch.Tensor, h_v: torch.Tensor, src: torch.Tensor,
             dst: torch.Tensor) -> torch.Tensor:
    """Per-edge dot product of endpoint representations (DGL ``u_dot_v``).
    Returns [E].  The rows are taken with ``index_select``, whose backward
    is an ``index_add_``: advanced indexing's backward sorts the indices
    first (PERF.md)."""
    return (h_u.index_select(0, src.long()) * h_v.index_select(0, dst.long())).sum(dim=-1)
