"""Message-passing aggregation primitives.

Port of ``gnn_recsys_tpu/ops/message.py`` (the XLA segment reductions that
stand in for DGL's ``update_all(copy_src|u_mul_e, mean|max)``).  Two
layouts, same semantics:

* ``coo_segment_*`` — scatter-reduce over the COO edge list
  (``index_add_`` / ``scatter_reduce_``), for full-graph passes.
* ``csc_gather_mean`` — gather + masked mean over the padded neighbour table
  (without edge weights: the gather-mean kernel, ``ops/cuda/gather_mean.py``).

DGL semantics: ``mean`` divides by the number of incoming messages and a
zero-degree destination gets zeros; ``max`` over no messages gives zeros;
edge-weighted variants scale each message by a scalar edge value first.
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
    total = h_src.new_zeros((num_dst, h_src.shape[1])).index_add_(0, dst, msgs)
    count = h_src.new_zeros(num_dst).index_add_(
        0, dst, h_src.new_ones(dst.shape[0])
    )
    return total / count.clamp(min=1.0)[:, None]


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


def edge_dot(h_u: torch.Tensor, h_v: torch.Tensor, src: torch.Tensor,
             dst: torch.Tensor) -> torch.Tensor:
    """Per-edge dot product of endpoint representations (DGL ``u_dot_v``).
    Returns [E]."""
    return (h_u[src.long()] * h_v[dst.long()]).sum(dim=-1)
