"""The MLP head's operations and bytes (``pred='nn'``: concat(u, i) -> Dense
128 -> ReLU -> Dense 32 -> ReLU -> Dense 1 -> sigmoid), counted as the least
work its mathematics needs, whatever computes it, so that no implementation
of the head, factorised or fused, reads over its roofline.

Layer 1 factorises: ``W1 [h_u ; h_i] = W1_u h_u + W1_i h_i``, so each
distinct input row goes once through its ``out x 128`` half of ``W1``; the
pair's sum, bias and ReLU are elementwise.  Layers 2 and 3 run on every
pair.  The backward is counted at twice the forward.  Bytes: the head's
input rows and its f32 scores out; in the backward, the scores' gradients in
and the rows' gradients out.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

from portbench.counts import kernels as kc
from portbench.counts import model

Etype = Tuple[str, str, str]

HIDDEN_1, HIDDEN_2 = 128, 32


def step_rows(widths: Dict[Etype, int], pool: int) -> int:
    """The head's distinct input rows a step with the dense pool: each
    positive's user row and item row, and the pool's rows."""
    return 2 * sum(widths.values()) + pool


def step_pairs(widths: Dict[Etype, int], pool: int) -> int:
    """The pairs a step scores with the dense pool: each positive, and each
    positive against every pool item."""
    return sum(n + n * pool for n in widths.values())


def forward_flops(rows: float, pairs: float, out: int) -> float:
    return 2.0 * rows * out * HIDDEN_1 + 2.0 * pairs * (HIDDEN_1 * HIDDEN_2 + HIDDEN_2)


def step_cost(rows: float, pairs: float, out: int, elem: int) -> Tuple[float, float]:
    """(FLOPs, bytes) of the head's forward and backward over ``rows``
    distinct input rows of ``out`` elements of ``elem`` bytes and ``pairs``
    scored pairs."""
    return 3.0 * forward_flops(rows, pairs, out), 2.0 * (elem * rows * out + 4.0 * pairs)


def step_bound_s(rows: float, pairs: float, out: int, elem: int, peak_flops: float) -> float:
    """The least seconds of the head's forward and backward on the H100."""
    return kc.bound_s(*step_cost(rows, pairs, out, elem), peak_flops)


def train_step(etypes: Sequence[Etype], widths: Dict[Etype, int], pool: int,
               fanouts: Sequence[int], feat_dim: int, hidden: int, out: int,
               num_nodes: Dict[str, int]) -> dict:
    """A step on the sampled tree with the MLP head, each positive scored
    against the whole pool: :func:`.model.train_step`'s model FLOPs with the
    cosine scores' products replaced by the head's least work, and the
    tree's leaf kernel calls (K, P)."""
    cost = model.train_step(etypes, widths, pool, fanouts, feat_dim, hidden, out, num_nodes)
    cosine = sum(2.0 * n * out + 2.0 * n * pool * out for n in widths.values())
    head = forward_flops(step_rows(widths, pool), step_pairs(widths, pool), out)
    return {"flops": cost["flops"] + 3.0 * (head - cosine), "leaves": cost["leaves"]}
