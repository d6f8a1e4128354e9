"""The LSTM model's operations: a training step's matrix-product FLOPs on the
sampled tree, counted as :func:`.model.train_step` counts them, with the
LSTM's two products a row-slot in place of the pre-MLP's one a row."""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

from portbench.counts import model

Etype = Tuple[str, str, str]


def tree_row_slots(etypes: Sequence[Etype], seeds: Dict[str, int],
                   fanouts: Sequence[int]) -> int:
    """The LSTM's rows times slots over the sampled trees of ``seeds``
    (node type -> ids): one row a node and incoming edge type at every
    level above the leaves, ``fanouts[l-1]`` slots at level ``l``."""
    total = 0

    def walk(nt: str, n: int, level: int) -> None:
        nonlocal total
        if level == 0:
            return
        walk(nt, n, level - 1)
        for et in etypes:
            if et[2] == nt:
                m = n * fanouts[level - 1]
                total += m
                walk(et[0], m, level - 1)

    for nt, n in seeds.items():
        walk(nt, n, len(fanouts))
    return total


def slot_flops(d_in: int, hidden: int) -> float:
    """One cell update of one row: the input and recurrent products of the
    four packed gates, ``2 * 4H * (in + H)``."""
    return 2.0 * 4 * hidden * (d_in + hidden)


def train_step(etypes: Sequence[Etype], widths: Dict[Etype, int], pool: int,
               fanouts: Sequence[int], feat_dim: int, hidden: int, out: int,
               num_nodes: Dict[str, int]) -> float:
    """The model FLOPs of a step of the LSTM model on the sampled tree, each
    positive scored against the whole pool (the forward three times
    over)."""
    b = sum(widths.values())
    rs = tree_row_slots(etypes, {"user": b, "item": b + pool}, fanouts)
    mean_nn = model.train_step(etypes, widths, pool, fanouts, feat_dim, hidden, out, num_nodes)
    # Every row-slot of the tree ran mean_nn's pre-MLP ``2 H H``; the LSTM
    # runs its cell there instead.
    return mean_nn["flops"] + 3.0 * rs * (slot_flops(hidden, hidden) - 2.0 * hidden * hidden)
