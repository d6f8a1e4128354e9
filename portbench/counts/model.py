"""The model's operations: a training step's and an on-demand request's
matrix-product FLOPs, counted from the model's definition whatever route
or kernel computes them, and the shapes of the kernel calls a step makes."""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

Etype = Tuple[str, str, str]


def tree_forward(etypes: Sequence[Etype], seeds: Dict[str, int], fanouts: Sequence[int],
                 feat_dim: int, hidden: int, out: int) -> Tuple[float, List[Tuple[int, int]]]:
    """(forward FLOPs of the sampled trees of ``seeds`` (node type -> ids),
    the leaf aggregations as (K, P) pairs in walk order).  Each node of the
    tree is computed once per occurrence: the embedding at level 0, and per
    incoming edge type the pre-MLP on every sampled neighbour and the two
    towers on every node."""
    levels = len(fanouts)
    flops = 0.0
    leaves: List[Tuple[int, int]] = []

    def walk(nt: str, n: int, level: int) -> None:
        nonlocal flops
        if level == 0:
            flops += 2.0 * n * feat_dim * hidden
            return
        walk(nt, n, level - 1)
        d_out = out if level == levels else hidden
        for et in etypes:
            if et[2] != nt:
                continue
            m = n * fanouts[level - 1]
            if level == 1:
                leaves.append((fanouts[0], n))
            walk(et[0], m, level - 1)
            flops += 2.0 * m * hidden * hidden + 2.0 * 2.0 * n * hidden * d_out

    for nt, n in seeds.items():
        walk(nt, n, levels)
    return flops, leaves


def dedup_forward(etypes: Sequence[Etype], seeds: Dict[str, int], fanouts: Sequence[int],
                  num_nodes: Dict[str, int], feat_dim: int, hidden: int, out: int,
                  full_width: int = 0) -> float:
    """Forward FLOPs of the dedup'd block forward of ``seeds``: each
    level's table holds ``max(8, min(n, N))`` rounded up to 8 rows, n its
    frontier (its own rows above, then each incoming edge type's samples,
    ``full_width`` slots a row at fanout -1); every row of a table is
    computed once, padding rows included."""
    def cap(nt: str, n: int) -> int:
        return max(8, -(-min(n, num_nodes[nt]) // 8) * 8)

    levels = len(fanouts)
    tables = [None] * (levels + 1)
    tables[levels] = {nt: cap(nt, n) for nt, n in seeds.items()}
    for lvl in range(levels, 0, -1):
        frontier: Dict[str, int] = {}
        for nt, rows in tables[lvl].items():
            frontier[nt] = frontier.get(nt, 0) + rows
            for s, _, d in etypes:
                if d == nt:
                    k = fanouts[lvl - 1] if fanouts[lvl - 1] > 0 else full_width
                    frontier[s] = frontier.get(s, 0) + rows * k
        tables[lvl - 1] = {nt: cap(nt, n) for nt, n in frontier.items()}
    flops = sum(2.0 * rows * feat_dim * hidden for rows in tables[0].values())
    for lvl in range(1, levels + 1):
        d_out = out if lvl == levels else hidden
        for nt, rows in tables[lvl].items():
            for s, _, d in etypes:
                if d == nt:
                    flops += 2.0 * tables[lvl - 1][s] * hidden * hidden
                    flops += 4.0 * rows * hidden * d_out
    return flops


def train_step(etypes: Sequence[Etype], widths: Dict[Etype, int], pool: int,
               fanouts: Sequence[int], feat_dim: int, hidden: int, out: int,
               num_nodes: Dict[str, int], dedup: bool = False, full_width: int = 0) -> dict:
    """A step on the sampled tree (``dedup``: on the dedup'd block
    forward), each positive scored against the whole pool: its model FLOPs (forward three times over, for the
    backward's two products a forward product) and the tree's leaf kernel
    calls (K, P)."""
    b = sum(widths.values())
    seeds = {"user": b, "item": b + pool}
    if dedup:
        fwd = dedup_forward(etypes, seeds, fanouts, num_nodes, feat_dim, hidden, out, full_width)
        leaves = []
    else:
        fwd, leaves = tree_forward(etypes, seeds, fanouts, feat_dim, hidden, out)
    fwd += sum(2.0 * n * out + 2.0 * n * pool * out for n in widths.values())
    return {"flops": 3.0 * fwd, "leaves": leaves}


def full_graph(etypes: Sequence[Etype], num_nodes: Dict[str, int], n_conv: int,
               feat_dim: int, hidden: int, out: int) -> float:
    """FLOPs of every node's embedding: the embedding, then per conv layer
    and edge type the pre-MLP on every source node and the towers on every
    destination node."""
    flops = sum(2.0 * n * feat_dim * hidden for n in num_nodes.values())
    for layer in range(n_conv):
        d_out = out if layer == n_conv - 1 else hidden
        for s, _, d in etypes:
            flops += 2.0 * num_nodes[s] * hidden * hidden + 4.0 * num_nodes[d] * hidden * d_out
    return flops


def request(etypes: Sequence[Etype], num_nodes: Dict[str, int], n_conv: int, feat_dim: int,
            hidden: int, out: int, users: int) -> float:
    """An on-demand request: the full-graph embeddings, then every listed
    user scored against the whole catalog."""
    return (full_graph(etypes, num_nodes, n_conv, feat_dim, hidden, out)
            + 2.0 * users * num_nodes["item"] * out)
