"""An on-demand request's least work where the run ranks with the MLP head
(``pred='nn'``): the full-graph embeddings of :func:`.model.request`, with
the cosine scores' products replaced by the head's, counted as
:func:`.pred_nn.forward_flops` counts them (layer 1 factorised, so each
listed user's row and each item's row goes once through its half of W1;
layers 2 and 3 on every pair), whatever computes it.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

from portbench.counts import kernels as kc
from portbench.counts import model
from portbench.counts import pred_nn

Etype = Tuple[str, str, str]


def head_cost(users: int, items: int, pairs: float, out: int) -> Tuple[float, float]:
    """(FLOPs, bytes) of the head ranking ``users`` against ``items``: its
    ``users + items`` distinct f32 input rows of ``out`` read once, and
    ``pairs`` f32 scores written."""
    rows = users + items
    return pred_nn.forward_flops(rows, pairs, out), 4.0 * (rows * out + pairs)


def head_bound_s(users: int, items: int, pairs: float, out: int) -> float:
    """The least seconds of the head's ranking on the H100, in f32."""
    return kc.bound_s(*head_cost(users, items, pairs, out), kc.PEAK_F32_FLOPS)


def boost_passes(users: int, items: int, d: int, fetch: int) -> List[Tuple[float, float]]:
    """(FLOPs, bytes) of ``mips_topk_boosted``'s two passes over ``users``
    against ``items`` of ``d`` f32: ``mips_lse`` reads both tables and writes
    each user's max and sum-exp; ``mips_boost`` reads them again with the
    popularity and those two floats, and writes ``fetch`` (f32 score, int64
    index) pairs a user.  Each pass multiplies every pair once."""
    products, rows = kc.mips_topk(users, items, d, 0)
    lse = (products, rows + 8.0 * users)
    boost = kc.mips_topk(users, items, d, fetch)
    return [lse, (boost[0], boost[1] + 4.0 * items + 8.0 * users)]


def request(etypes: Sequence[Etype], num_nodes: Dict[str, int], n_conv: int, feat_dim: int,
            hidden: int, out: int, users: int, pred: str) -> float:
    """A request's FLOPs: :func:`.model.request` for ``pred='cos'``; for
    ``'nn'`` the same embeddings and the head's least work on every (user,
    item) pair in place of the cosine products."""
    flops = model.request(etypes, num_nodes, n_conv, feat_dim, hidden, out, users)
    if pred == "cos":
        return flops
    items = num_nodes["item"]
    return (flops - 2.0 * users * items * out
            + head_cost(users, items, float(users) * items, out)[0])
