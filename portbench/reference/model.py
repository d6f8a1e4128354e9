"""A plain PyTorch reference of the recommender: its graph, sampler, model,
loss and Adam, written from the model's definition.

It imports nothing of the measured package.  It computes in float32 with
TF32 off, and takes a rounding function ``q`` that the control uses to
compute the same in a lower precision: ``q`` rounds every matrix
product's inputs and output.

The model is GraphSAGE-style hetero message passing (hieucnm/GNN-RecSys
``src/model.py``): a per-node-type embedding ``x W^T + b``, then conv layers
in which, for each edge type into a node type,

    msgs = relu(drop(h_src) W_pre^T)                   (the pre-MLP)
    agg  = mean (mean_nn) or max (pool_nn) of msgs over the valid sampled
           slots, 0 without one
    z    = relu(drop(h_self) W_self^T + agg W_neigh^T),  z / |z|  (0 rows stay 0)

and the edge types' outputs are summed.  ``drop`` is inverted dropout in
training: each element kept with probability ``1 - p`` (a Bernoulli draw
of a boolean tensor of its shape from the default generator of its
device) and scaled by ``1 / (1 - p)``; the source table's mask is drawn
before the self rows' mask of the same edge type.  Pairs score by cosine.  The
max-margin loss is ``relu(neg + delta - pos - false_negative)`` averaged
over every (positive, negative) pair.

The sampled tree (one independent sample per occurrence): level ``l``
samples ``fanouts[l-1]`` incoming neighbours of each node with replacement,
uniform over the node's neighbour list (the last ``max_fanout`` edges into
it, in edge-id order, ``max_fanout`` rounded up to a multiple of 8); slot = min(floor(u * deg), deg - 1) in float32 from a
uniform ``u``.  A sampled edge that belongs to the batch, or whose reverse
does, is an invalid slot.  Random numbers are taken in walk order: a node
type's own lower level first, then per incoming edge type (in the graph's
edge-type order) the draw of that edge type's samples, then the subtree of
the sampled neighbours.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

Etype = Tuple[str, str, str]

REVERSE = {"buys": "bought-by", "bought-by": "buys", "clicks": "clicked-by",
           "clicked-by": "clicks"}


def identity(x: torch.Tensor) -> torch.Tensor:
    return x


def _round_scaled(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` through ``dtype`` with one scale for the tensor, its largest
    magnitude at the type's largest finite value (fp8 as it is used)."""
    top = torch.finfo(dtype).max
    amax = x.detach().abs().amax().float()
    scale = torch.where(amax > 0, amax / top, torch.ones_like(amax))
    return ((x.float() / scale).to(dtype).float() * scale).to(x.dtype)


class _RoundST(torch.autograd.Function):
    """Each value rounded through fp8: e4m3 forward, and e5m2 for the
    gradient, each with its tensor's scale."""

    @staticmethod
    def forward(ctx, x, dtype):
        return _round_scaled(x, dtype)

    @staticmethod
    def backward(ctx, grad):
        return _round_scaled(grad, torch.float8_e5m2), None


def rounding(dtype: Optional[torch.dtype]) -> Callable[[torch.Tensor], torch.Tensor]:
    """``q`` for the reference: the identity, or fp8 rounding (``dtype`` the
    forward's type)."""
    if dtype is None:
        return identity
    return lambda x: _RoundST.apply(x, dtype)


def ntypes_of(etypes: Sequence[Etype]) -> Tuple[str, ...]:
    seen = []
    for s, _, d in etypes:
        for t in (s, d):
            if t not in seen:
                seen.append(t)
    return tuple(seen)


def etype_key(et: Etype) -> str:
    return "__".join(et)


def reverse(et: Etype) -> Etype:
    return (et[2], REVERSE.get(et[1], et[1]), et[0])


def param_spec(etypes: Sequence[Etype], feat_dims: Dict[str, int], hidden: int, out: int,
               n_layers: int, aggregator: str) -> Dict[str, Tuple[int, ...]]:
    """Name -> shape of every parameter of the model with an embedding layer
    (``n_layers - 1`` conv layers: hidden to hidden, the last hidden to
    out).  Weights are ``[out, in]``."""
    if aggregator not in ("mean_nn", "pool_nn"):
        raise ValueError(f"the reference implements mean_nn and pool_nn, not {aggregator!r}")
    spec = {}
    for nt in ntypes_of(etypes):
        spec[f"{nt}_embed.proj_feats.weight"] = (hidden, feat_dims[nt])
        spec[f"{nt}_embed.proj_feats.bias"] = (hidden,)
    n_conv = n_layers - 1
    for layer in range(n_conv):
        d_out = out if layer == n_conv - 1 else hidden
        for et in etypes:
            key = f"layer{layer}_{etype_key(et)}"
            spec[f"{key}.fc_self.weight"] = (d_out, hidden)
            spec[f"{key}.fc_neigh.weight"] = (d_out, hidden)
            spec[f"{key}.fc_preagg.weight"] = (hidden, hidden)
    return spec


def linear(x, w, b=None, q=identity):
    y = q(q(x) @ q(w).T)
    return y if b is None else q(y + q(b))


def row_normalize(z: torch.Tensor) -> torch.Tensor:
    """``z / |z|`` per row; a zero row stays zero."""
    n = torch.linalg.vector_norm(z, dim=-1, keepdim=True)
    return z / torch.where(n == 0, torch.ones_like(n), n)


def cosine_normalize(x: torch.Tensor) -> torch.Tensor:
    """``x / max(|x|, 1e-12)`` per row (``F.normalize``)."""
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp(min=1e-12)


class Graph:
    """The reference's view of a graph given as COO edge lists: per edge
    type the full lists (for full-graph means) and each destination's
    neighbour list, the last ``max_fanout`` edges into it in edge-id order
    (the cap rounded up to a multiple of 8), as a [N_dst, K] table padded
    with -1 (ids and edge ids), K a multiple of 8."""

    def __init__(self, schema: Dict[Etype, Tuple[np.ndarray, np.ndarray]],
                 num_nodes: Dict[str, int], max_fanout: Optional[int], device):
        self.etypes = tuple(schema)
        self.num_nodes = dict(num_nodes)
        self.src, self.dst, self.nbr, self.eid = {}, {}, {}, {}
        for et, (src, dst) in schema.items():
            src = np.asarray(src, dtype=np.int64)
            dst = np.asarray(dst, dtype=np.int64)
            n_dst = num_nodes[et[2]]
            counts = np.bincount(dst, minlength=n_dst)
            width = max(1, int(counts.max()) if len(dst) else 1)
            if max_fanout is not None:
                width = min(width, max_fanout)
            width = -(-width // 8) * 8  # rows padded to a multiple of 8 slots
            order = np.argsort(dst, kind="stable")  # edge-id order within a row
            start = np.concatenate([[0], np.cumsum(counts)[:-1]])
            d_sorted = dst[order]
            pos = np.arange(len(dst)) - start[d_sorted]
            kept = pos >= counts[d_sorted] - width  # the last `width` edges
            slot = pos - np.maximum(counts[d_sorted] - width, 0)
            nbr = np.full((n_dst, width), -1, dtype=np.int64)
            eid = np.full((n_dst, width), -1, dtype=np.int64)
            nbr[d_sorted[kept], slot[kept]] = src[order[kept]]
            eid[d_sorted[kept], slot[kept]] = order[kept]
            self.nbr[et] = torch.from_numpy(nbr).to(device)
            self.eid[et] = torch.from_numpy(eid).to(device)
            self.src[et] = torch.from_numpy(src).to(device)
            self.dst[et] = torch.from_numpy(dst).to(device)

    def in_etypes(self, nt: str):
        return [et for et in self.etypes if et[2] == nt]


def sample(graph: Graph, et: Etype, ids: torch.Tensor, u: torch.Tensor,
           excluded: Optional[torch.Tensor]):
    """Sampled neighbours ``[n, fanout]`` of ``ids`` under ``et`` and their
    validity; invalid slots carry node 0.  ``u`` None takes every slot of
    the neighbour lists (the full sampler)."""
    rows = graph.nbr[et][ids]
    if u is None:
        mask = rows != -1
        if excluded is not None:
            mask = mask & ~excluded[graph.eid[et][ids].clamp(min=0)]
        return torch.where(mask, rows, torch.zeros_like(rows)), mask
    deg = (rows != -1).sum(dim=-1, dtype=torch.int32)
    slot = torch.minimum((u * deg.clamp(min=1)[:, None]).to(torch.int32),
                         (deg - 1).clamp(min=0)[:, None]).long()
    nbr = rows.gather(1, slot)
    mask = (deg > 0)[:, None].expand(nbr.shape)
    if excluded is not None:
        eid = graph.eid[et][ids].gather(1, slot)
        mask = mask & ~excluded[eid.clamp(min=0)]
    return torch.where(mask, nbr, torch.zeros_like(nbr)), mask


class Model:
    """The model's forward over parameters ``P`` (name -> tensor)."""

    def __init__(self, P: Dict[str, torch.Tensor], graph: Graph,
                 feats: Dict[str, torch.Tensor], q=identity, aggregator: str = "mean_nn",
                 dropout: float = 0.0):
        self.P, self.graph, self.feats, self.q = P, graph, feats, q
        self.aggregator, self.p = aggregator, dropout

    def drop(self, x: torch.Tensor) -> torch.Tensor:
        if self.p == 0.0:
            return x
        keep = torch.empty_like(x, dtype=torch.bool).bernoulli_(1.0 - self.p)
        return x * keep.to(x.dtype) * (1.0 / (1.0 - self.p))

    def reduce(self, msgs: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """Mean or max of ``msgs`` [n, K, D] over the valid slots; 0 rows
        where none is valid."""
        if self.aggregator == "pool_nn":
            agg = torch.where(mask[..., None], msgs, torch.full_like(msgs, float("-inf")))
            agg = agg.amax(dim=1)
            return torch.where(torch.isfinite(agg), agg, torch.zeros_like(agg))
        m = mask.to(msgs.dtype)
        return (msgs * m[..., None]).sum(dim=1) / m.sum(dim=1).clamp(min=1.0)[:, None]

    def embed(self, nt: str, x: torch.Tensor) -> torch.Tensor:
        return linear(x, self.P[f"{nt}_embed.proj_feats.weight"],
                      self.P[f"{nt}_embed.proj_feats.bias"], self.q)

    def combine(self, key: str, h_self: torch.Tensor, agg: torch.Tensor) -> torch.Tensor:
        z = torch.relu(linear(self.drop(h_self), self.P[f"{key}.fc_self.weight"], q=self.q)
                       + linear(agg, self.P[f"{key}.fc_neigh.weight"], q=self.q))
        return self.q(row_normalize(z))

    def premlp(self, key: str, h: torch.Tensor) -> torch.Tensor:
        return torch.relu(linear(self.drop(h), self.P[f"{key}.fc_preagg.weight"], q=self.q))

    def tree(self, nt: str, ids: torch.Tensor, level: int, fanouts: Sequence[int], draws,
             excluded: Dict[Etype, torch.Tensor]) -> torch.Tensor:
        """The sampled tree's output for the 1-D ``ids`` at ``level`` (no
        dropout: its masks' order is not this reference's)."""
        if self.p:
            raise ValueError("the reference's sampled tree runs without dropout")
        if level == 0:
            return self.embed(nt, self.feats[nt][ids])
        h_self = self.tree(nt, ids, level - 1, fanouts, draws, excluded)
        fanout = fanouts[level - 1]
        out = None
        for et in self.graph.in_etypes(nt):
            u = draws.uniform((ids.shape[0], fanout))
            nbr, mask = sample(self.graph, et, ids, u, excluded.get(et))
            h_nbr = self.tree(et[0], nbr.reshape(-1), level - 1, fanouts, draws, excluded)
            key = f"layer{level - 1}_{etype_key(et)}"
            msgs = self.premlp(key, h_nbr).reshape(ids.shape[0], fanout, -1)
            z = self.combine(key, h_self, self.reduce(msgs, mask))
            out = z if out is None else out + z
        return out

    def dedup(self, seeds: Dict[str, torch.Tensor], fanouts: Sequence[int], draws,
              excluded: Dict[Etype, torch.Tensor], gathers: Optional[list] = None):
        """The dedup'd block forward (DGL's blocks): each level's distinct
        nodes computed once.  Top-down, each level's frontier (per node type
        its own ids, then each incoming edge type's sampled neighbours, in
        the order they were pushed) becomes a table of its sorted distinct
        ids, padded with node 0 to ``max(8, min(n, N)`` rounded up to 8)
        entries; every entry, padding included, samples its neighbours once,
        one draw of ``[entries, fanout]`` per (node type of the level's
        tables, incoming edge type), none at fanout -1 (every slot).  Bottom-up, each table's rows are
        computed from the rows of the table below.  ``gathers`` collects
        (rows, fanout, source rows, valid slots, distinct sources) of each
        neighbour mean (mean_nn)."""
        g = self.graph

        def table(flat: torch.Tensor, nt: str):
            cap = max(8, -(-min(flat.numel(), g.num_nodes[nt]) // 8) * 8)
            uniq, inv = torch.unique(flat, sorted=True, return_inverse=True)
            return torch.cat([uniq, uniq.new_zeros(cap - uniq.numel())]), inv

        levels = len(fanouts)
        tables = {levels: {nt: table(ids, nt) for nt, ids in seeds.items()}}
        plans = {}
        for lvl in range(levels, 0, -1):
            frontier: Dict[str, list] = {}

            def push(nt: str, ids: torch.Tensor):
                segs = frontier.setdefault(nt, [])
                off = sum(x.numel() for x in segs)
                segs.append(ids.reshape(-1))
                return nt, off, ids.numel()

            plan = {}
            for nt, (uids, _) in tables[lvl].items():
                entry = {"self": push(nt, uids), "etypes": []}
                for et in g.in_etypes(nt):
                    fanout = fanouts[lvl - 1]
                    u = None if fanout == -1 else draws.uniform((uids.shape[0], fanout))
                    nbr, mask = sample(g, et, uids, u, excluded.get(et))
                    entry["etypes"].append((et, push(et[0], nbr), mask))
                plan[nt] = entry
            tables[lvl - 1] = {nt: table(torch.cat(segs), nt) for nt, segs in frontier.items()}
            plans[lvl] = plan

        h = {nt: self.embed(nt, self.feats[nt][uids]) for nt, (uids, _) in tables[0].items()}
        for lvl in range(1, levels + 1):
            below, nxt = tables[lvl - 1], {}
            for nt, entry in plans[lvl].items():
                snt, off, n = entry["self"]
                h_self = h[snt][below[snt][1][off:off + n]]
                for et, (src, off, n), mask in entry["etypes"]:
                    key = f"layer{lvl - 1}_{etype_key(et)}"
                    pos = below[src][1][off:off + n].reshape(mask.shape)
                    agg = self.reduce(self.premlp(key, h[src])[pos], mask)
                    if gathers is not None and self.aggregator == "mean_nn":
                        gathers.append((mask.shape[0], mask.shape[1], h[src].shape[0],
                                        int(mask.sum()), int(torch.unique(pos[mask]).numel())))
                    z = self.combine(key, h_self, agg)
                    nxt[nt] = z if nt not in nxt else nxt[nt] + z
            h = nxt
        return {nt: h[nt][tables[levels][nt][1]] for nt in seeds}

    def full_graph(self, n_conv: int) -> Dict[str, torch.Tensor]:
        """Every node's embedding, each layer's mean over every incoming
        edge of the full COO lists."""
        g = self.graph
        h = {nt: self.embed(nt, self.feats[nt]) for nt in self.feats}
        for layer in range(n_conv):
            nxt = {}
            for et in g.etypes:
                key = f"layer{layer}_{etype_key(et)}"
                msgs = self.premlp(key, h[et[0]])[g.src[et]]
                n_dst = g.num_nodes[et[2]]
                total = torch.zeros((n_dst, msgs.shape[1]), dtype=msgs.dtype,
                                    device=msgs.device).index_add_(0, g.dst[et], msgs)
                count = torch.bincount(g.dst[et], minlength=n_dst).to(msgs.dtype)
                z = self.combine(key, h[et[2]], total / count.clamp(min=1.0)[:, None])
                nxt[et[2]] = z if et[2] not in nxt else nxt[et[2]] + z
            h = nxt
        return h


def pair_keys(src: torch.Tensor, dst: torch.Tensor, num_dst: int) -> torch.Tensor:
    """Sorted unique ``src * num_dst + dst`` keys of an edge set."""
    return torch.unique(src.long() * num_dst + dst.long())


def contains(keys: torch.Tensor, u: torch.Tensor, v: torch.Tensor, num_dst: int) -> torch.Tensor:
    """Whether each (u, v) pair (broadcast) is in the edge set ``keys``."""
    probe = u.long() * num_dst + v.long()
    pos = torch.searchsorted(keys, probe.reshape(-1)).clamp(max=keys.numel() - 1)
    return (keys[pos] == probe.reshape(-1)).reshape(probe.shape)


def max_margin(pos: Dict[Etype, torch.Tensor], neg: Dict[Etype, torch.Tensor],
               false_neg: Dict[Etype, torch.Tensor], delta: float,
               rows: Optional[Dict[Etype, torch.Tensor]] = None) -> torch.Tensor:
    """Mean of ``relu(neg + delta - pos - false_negative)`` over every pair
    of every edge type; ``rows`` keeps only the positives it marks (a
    fault of the control)."""
    total = count = 0.0
    for et in neg:
        s = torch.relu(neg[et] + delta - pos[et][:, None] - false_neg[et].to(neg[et].dtype))
        if rows is not None:
            s = s[rows[et]]
        total = total + s.sum()
        count += s.numel()
    return total / max(count, 1)


class Adam:
    """Adam (b1 0.9, b2 0.999, eps 1e-8 outside the root) over ``params``."""

    def __init__(self, params: Dict[str, torch.Tensor], lr: float):
        self.lr, self.t = lr, 0
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}

    def step(self, params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor]) -> None:
        self.t += 1
        c1, c2 = 1 - 0.9 ** self.t, 1 - 0.999 ** self.t
        with torch.no_grad():
            for k, g in grads.items():
                self.m[k].mul_(0.9).add_(g, alpha=0.1)
                self.v[k].mul_(0.999).addcmul_(g, g, value=0.001)
                denom = (self.v[k].sqrt() / c2 ** 0.5).add_(1e-8)
                params[k].addcdiv_(self.m[k], denom, value=-self.lr / c1)
