"""Multi-device training: data-parallel and tensor-parallel steps, row-sharded
tables and sharded-CSR sampling.

Port of ``gnn_recsys_tpu/parallel/sharded.py``.  One process drives every
device of a :class:`~gnn_recsys_tpu_torch.parallel.mesh.Mesh`, as JAX's
``shard_map`` does (the decision of ``retrieval/sharded.py``): each shard's
work is launched on its own device, and JAX's collectives are explicit
copies between the entries' devices, summed in a fixed shard order.  A
value laid out over an axis is a list of blocks, one a shard of that axis;
functions that JAX runs per device inside ``shard_map`` take the list.
Processes compose through ``parallel/distributed.py``: a data axis that
spans processes reduces onto each process's first device, then
``all_reduce`` across processes.

* :func:`make_shardmap_dp_step`: each data shard runs the single-device
  loss on its slice of the batch with its own draw source (JAX's
  ``fold_in(rng, axis_index)``), in eval mode as JAX's ``with_update=False``
  step runs it; losses and gradients are averaged over the axis, then one
  Adam update.  Parameters live on the model's device; each other device
  of the mesh gets a copy of the model, refreshed before every step.  On
  CUDA devices each shard's loss and backward is one CUDA graph, so the host
  issues one replay a shard and the shards of several cards overlap.
* :func:`make_shardmap_tp_dp_step`: the ('data', 'model') step.  Per data
  shard the tree is computed once, on the shard's entry at model index 0;
  every read of a row-sharded table goes through the owners
  (:func:`row_sharded_lookup_a2a`), the frontier split over the model axis
  and reassembled; adjacency rows of ``graph_shard_etypes`` come from their
  owners too (:func:`sample_neighbors_sharded`).
* :func:`make_gspmd_minibatch_step`: the single-device step's program and
  draws, its per-edge work split over the data axis.  One draw stream in
  the single-device order; each data shard takes its rows of every per-edge
  draw.  The negative pool's trees (and, with ``dedup``, the whole block
  forward, whose plan is not split by edge) are computed on every data
  shard.  Row-sharded feature tables (:func:`shard_inputs`) are read
  through :func:`row_sharded_lookup`.
"""

from __future__ import annotations

import copy
import math
import weakref
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from gnn_recsys_tpu_torch.graph.hetero import CanonicalEtype, HeteroGraph, Relation
from gnn_recsys_tpu_torch.models.conv_model import ConvModel
from gnn_recsys_tpu_torch.models.layers import dropout_keep_mask
from gnn_recsys_tpu_torch.ops.sampling import Draws, sample_neighbors
from gnn_recsys_tpu_torch.parallel import distributed
from gnn_recsys_tpu_torch.parallel.mesh import Mesh, _tree_map, shard_batch
from gnn_recsys_tpu_torch.train.minibatch import (
    MinibatchConfig,
    batch_exclusion,
    draw_negatives,
    make_minibatch_loss,
    scored_loss,
)

Blocks = List[torch.Tensor]


# ----------------------------------------------------------------------
# Placement
# ----------------------------------------------------------------------
class Sharding(NamedTuple):
    """Where a value goes on a mesh: replicated (``axis`` None), or its
    leading dimension split over ``axis`` (JAX's ``NamedSharding``)."""

    mesh: Mesh
    axis: Optional[str] = None


def replicated(mesh: Mesh) -> Sharding:
    return Sharding(mesh, None)


def batch_sharded(mesh: Mesh, axis: str = "data") -> Sharding:
    return Sharding(mesh, axis)


def row_sharded(mesh: Mesh, axis: str = "model") -> Sharding:
    return Sharding(mesh, axis)


def _to(value, dev: torch.device):
    """``value`` (a tensor, a dict / list / tuple of them, or anything with
    ``.to``, such as a graph or a pair set) on ``dev``."""
    if value is None:
        return None
    if isinstance(value, dict):
        return type(value)((k, _to(v, dev)) for k, v in value.items())
    if isinstance(value, (list, tuple)):
        return type(value)(_to(v, dev) for v in value)
    return value.to(dev)


class Replicated:
    """A value with one copy a distinct device of a mesh."""

    def __init__(self, mesh: Mesh, value):
        self.value = value
        self.copies = {d: _to(value, d) for d in dict.fromkeys(mesh.devices.flat)}

    def at(self, dev: torch.device):
        return self.copies[dev]


class RowBlocks:
    """A table split by rows over a mesh axis: zero-padded to a multiple of
    the axis, then one contiguous block of ``rows_per`` rows a shard, block
    ``k`` on every entry at index ``k`` of the axis."""

    def __init__(self, mesh: Mesh, table: torch.Tensor, axis: str = "model"):
        m = mesh.shape[axis]
        pad = (-table.shape[0]) % m
        if pad:
            table = F.pad(table, (0, 0) * (table.dim() - 1) + (0, pad))
        self.num_rows, self.rows_per = table.shape[0] - pad, table.shape[0] // m
        pos = mesh.axis_names.index(axis)
        self.blocks: Dict[Tuple[int, torch.device], torch.Tensor] = {}
        for coord in np.ndindex(*mesh.devices.shape):
            k, dev = coord[pos], mesh.devices[coord]
            if (k, dev) not in self.blocks:
                self.blocks[(k, dev)] = table[k * self.rows_per:(k + 1) * self.rows_per].to(dev)

    def owners(self, devices: Sequence[torch.device]) -> Blocks:
        """Block ``k`` on ``devices[k]``, for every shard ``k``."""
        return [self.blocks[(k, d)] for k, d in enumerate(devices)]


def place(sharding: Sharding, value):
    """``value`` on ``sharding``'s mesh: :class:`Replicated`, or
    :class:`RowBlocks` over its axis."""
    if sharding.axis is None:
        return Replicated(sharding.mesh, value)
    return RowBlocks(sharding.mesh, value, sharding.axis)


def shard_inputs(mesh: Mesh, state, graph, features: Dict[str, torch.Tensor], edge_tables,
                 row_shard_ntypes: Tuple[str, ...] = ("item",)):
    """Training inputs on the mesh (``sharded.py:56-81``): the graph, the
    pair tables and the other feature tables replicated, the tables of
    ``row_shard_ntypes`` split by rows over ``model`` where the mesh has that
    axis.  The state stays where it is: the steps keep copies of the model
    on the other devices."""
    rows = row_shard_ntypes if "model" in mesh.shape else ()
    feats = {nt: place(row_sharded(mesh) if nt in rows else replicated(mesh), x)
             for nt, x in features.items()}
    return state, Replicated(mesh, graph), feats, Replicated(mesh, edge_tables)


def shard_batch_dict(mesh: Mesh, batch: Dict, axis: str = "data") -> List:
    """Every per-edge array of a minibatch split over ``axis``: one batch a
    mesh entry, in the grid's flat order (per-etype sizes must divide the
    axis)."""
    return shard_batch(mesh, batch, axis)


class _Placer:
    """Placements of the plain values a step is given, made at their first
    use and kept while the caller passes the same object."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        self.kept: Dict = {}

    def _keep(self, key, obj, make):
        got = self.kept.get((key, id(obj)))
        if got is None or got[0] is not obj:
            got = (obj, make())
            self.kept[(key, id(obj))] = got
        return got[1]

    def at(self, value, dev: torch.device):
        """``value`` on ``dev``: a :class:`Replicated`'s copy, or a copy kept."""
        if isinstance(value, Replicated):
            return value.at(dev)
        if isinstance(value, dict) and any(isinstance(v, (Replicated, RowBlocks))
                                           for v in value.values()):
            return {k: self.at(v, dev) for k, v in value.items() if not isinstance(v, RowBlocks)}
        return self._keep(("at", dev), value, lambda: _to(value, dev))

    def rows(self, features: Dict, ntypes, axis: str) -> Dict[str, RowBlocks]:
        """The tables of ``ntypes`` split by rows over ``axis``."""
        out = {}
        for nt in ntypes:
            x = features[nt]
            if isinstance(x, Replicated):
                x = x.value
            out[nt] = x if isinstance(x, RowBlocks) else self._keep(
                ("rows", axis), x, lambda x=x: RowBlocks(self.mesh, x, axis))
        return out


def _batch_blocks(mesh: Mesh, batch, axis: str, devices: Sequence[torch.device],
                  first: int = 0, extent: Optional[int] = None) -> List[Dict]:
    """Shard ``first + i``'s block of a batch for each local shard ``i`` of
    ``axis``, on ``devices[i]``: from the entries of :func:`shard_batch_dict`
    (a list), or split from the whole batch into ``extent`` blocks."""
    if isinstance(batch, list):
        return [batch[int(np.ravel_multi_index(c, mesh.devices.shape))]
                for c in _shard_coords(mesh, axis)]
    extent = extent or len(devices)

    def block(x, i):
        if x.shape[0] % extent:
            raise ValueError(f"a batch of {x.shape[0]} edges does not split over {extent} shards")
        n = x.shape[0] // extent
        return x[(first + i) * n:(first + i + 1) * n].to(devices[i])

    return [{et: {k: block(v, i) for k, v in d.items()} for et, d in batch.items()}
            for i in range(len(devices))]


# ----------------------------------------------------------------------
# Copies of the model and the gradient reduction
# ----------------------------------------------------------------------
class _Replicas:
    """The model on its own device and a copy on each other device a step
    uses; :meth:`sync` writes the model's parameters into the copies."""

    def __init__(self, model: ConvModel):
        self.model = model
        self.home = next(model.parameters()).device
        self.copies: Dict[torch.device, ConvModel] = {self.home: model}

    def on(self, dev: torch.device) -> ConvModel:
        if dev not in self.copies:
            self.copies[dev] = copy.deepcopy(self.model).to(dev)
        return self.copies[dev]

    def sync(self) -> None:
        params = list(self.model.parameters())
        with torch.no_grad():
            for dev, m in self.copies.items():
                if m is not self.model:
                    torch._foreach_copy_(list(m.parameters()), [p.to(dev) for p in params])


def _grads(loss: torch.Tensor, models: Sequence[ConvModel]) -> List[torch.Tensor]:
    """The gradient of ``loss`` by parameter of the model, summed over the
    copies ``models`` (all on their own devices) onto the first's device."""
    per = [list(m.parameters()) for m in models]
    flat = [p for ps in per for p in ps]
    got = torch.autograd.grad(loss, flat, allow_unused=True)
    got = [torch.zeros_like(p) if g is None else g for p, g in zip(flat, got)]
    n = len(per[0])
    acc = got[:n]
    home = per[0][0].device
    for j in range(1, len(per)):
        torch._foreach_add_(acc, [g.to(home) for g in got[j * n:(j + 1) * n]])
    return acc


def _sum_onto(parts: Sequence[Sequence[torch.Tensor]], home: torch.device) -> List[torch.Tensor]:
    """Element-wise sums of the lists in ``parts``, in their order, on
    ``home``: new tensors (the parts may be a CUDA graph's outputs, which its
    next replay overwrites)."""
    acc = [t.to(home, copy=True) for t in parts[0]]
    for p in parts[1:]:
        torch._foreach_add_(acc, [t.to(home, non_blocking=True) for t in p])
    return acc


def _apply(state, model: ConvModel, grads: Sequence[torch.Tensor]) -> None:
    for p, g in zip(model.parameters(), grads):
        p.grad = g
    state.apply_gradients()


# ----------------------------------------------------------------------
# Row-sharded lookups
# ----------------------------------------------------------------------
def row_sharded_lookup(table_shards: Blocks, ids: torch.Tensor,
                       row_transform=None, device=None) -> torch.Tensor:
    """Rows ``ids`` of a table split by rows into ``table_shards`` (block
    ``k`` on owner ``k``'s device), summed onto ``device`` (by default the
    ids'): each owner gathers the rows it owns and transforms them
    (``row_transform``: one callable, or one an owner), zeros the slots it
    does not own, and the owners' answers are added in shard order
    (``sharded.py:823-847``, JAX's ``psum``).  Each id has one owner, so the
    sum is the gather."""
    device = torch.device(device) if device is not None else ids.device
    per = table_shards[0].shape[0]
    transforms = _per_owner(row_transform, len(table_shards))
    out = None
    for k, (table, transform) in enumerate(zip(table_shards, transforms)):
        local = ids.to(table.device).long() - k * per
        owned = (local >= 0) & (local < per)
        rows = table[local.clamp(0, per - 1)]
        if transform is not None:
            rows = transform(rows)
        rows = torch.where(owned[:, None], rows, torch.zeros_like(rows)).to(device)
        out = rows if out is None else out + rows
    return out


def _per_owner(row_transform, m: int) -> list:
    if isinstance(row_transform, (list, tuple)):
        return list(row_transform)
    return [row_transform] * m


def statistical_a2a_capacity(chunk: int, m: int, factor: float) -> int:
    """Per-peer bucket capacity for near-uniform id frontiers
    (``sharded.py:180-191``): ``factor`` times the mean load ``chunk / m``,
    rounded up to a multiple of 8 and at most ``chunk``."""
    return min(chunk, max(8, 8 * math.ceil(factor * chunk / (m * 8))))


def row_sharded_lookup_a2a(
    table_shards: Blocks,
    ids_shards: Blocks,
    capacity: Optional[int] = None,
    overflow_capacity: Optional[int] = None,
    return_dropped: bool = False,
    row_transform=None,
    stats: Optional[Dict[str, int]] = None,
):
    """All-to-all row exchange, sharded ids against a table sharded by rows
    (``sharded.py:491-618``).  Requester ``j`` holds ``ids_shards[j]`` [b]
    on its device, owner ``k`` the rows ``[k * per, (k + 1) * per)`` in
    ``table_shards[k]``; the ``j``-th entry of the result is ``[b, D']`` on
    requester ``j``'s device.

    Each requester buckets its ids by owner (a stable sort; ``capacity``
    slots a peer, the worst case ``b`` by default); the ``[m, c]`` buckets
    go to their owners (copies between the entries' devices, every copy
    sent before anything waits on the host); each owner gathers its rows,
    applies ``row_transform`` (one callable, or one an owner) and then zeros
    the empty slots (the map need not send 0 to 0); the answers come back the
    same way and are un-bucketed.  With a capacity below ``b``, ids beyond
    their bucket go through a bounded overflow lane of ``overflow_capacity``
    (default ``capacity``) ids a requester, answered by
    :func:`row_sharded_lookup`; ids beyond both come back as zero rows, and
    ``return_dropped`` returns their count, summed over the requesters, on
    requester 0's device.  ``stats``: bytes of the requests, responses and
    overflow lane are added to its ``request_bytes``, ``response_bytes`` and
    ``overflow_bytes``, from the buckets' shapes."""
    m = len(table_shards)
    per = table_shards[0].shape[0]
    transforms = _per_owner(row_transform, m)
    b = ids_shards[0].shape[0]
    c = b if capacity is None else min(int(capacity), b)
    oc = c if overflow_capacity is None else min(int(overflow_capacity), b)

    plans = []
    for ids in ids_shards:
        owner = (ids.long() // per).clamp(0, m - 1)
        order = torch.sort(owner, stable=True)[1]
        sorted_ids, sorted_owner = ids[order], owner[order]
        pos = (torch.arange(b, device=ids.device)
               - torch.searchsorted(sorted_owner, sorted_owner, side="left"))
        fits = pos < c
        # Overflow entries land in a sink column past the buckets.
        send = torch.full((m, c + 1), -1, dtype=ids.dtype, device=ids.device)
        send[sorted_owner, torch.where(fits, pos, torch.full_like(pos, c))] = sorted_ids
        plans.append((order, sorted_ids, sorted_owner, pos, fits, send[:, :c]))

    # The request buckets to their owners: recv[k][j] = what j sent to k.
    answers = []
    for k, (table, transform) in enumerate(zip(table_shards, transforms)):
        recv = torch.stack([p[5][k].to(table.device, non_blocking=True) for p in plans])
        local = recv.long() - k * per
        valid = (recv >= 0) & (local >= 0) & (local < per)
        rows = table[local.clamp(0, per - 1)]
        if transform is not None:
            rows = transform(rows.reshape(m * c, -1)).reshape(m, c, -1)
        answers.append(torch.where(valid[..., None], rows, torch.zeros_like(rows)))
    d = answers[0].shape[-1]

    outs, dropped = [], None
    for j, (ids, (order, sorted_ids, sorted_owner, pos, fits, _)) in enumerate(
            zip(ids_shards, plans)):
        resp = torch.stack([a[j].to(ids.device, non_blocking=True) for a in answers])
        got = resp[sorted_owner, pos.clamp(max=c - 1)]  # [b, D']
        if c < b:
            ovf = ~fits
            rank = torch.cumsum(ovf, 0) - 1
            in_budget = ovf & (rank < oc)
            buf = torch.zeros(oc + 1, dtype=ids.dtype, device=ids.device)
            buf[torch.where(in_budget, rank, torch.full_like(rank, oc))] = torch.where(
                in_budget, sorted_ids, torch.zeros_like(sorted_ids))
            lane = row_sharded_lookup(table_shards, buf[:oc], transforms, device=ids.device)
            got = torch.where(ovf[:, None], lane[rank.clamp(0, oc - 1)], got)
            lost = ovf & (rank >= oc)
            got = torch.where(lost[:, None], torch.zeros_like(got), got)
            n = lost.sum().to(torch.int32).to(ids_shards[0].device)
            dropped = n if dropped is None else dropped + n
        inverse = torch.empty_like(order).scatter_(0, order, torch.arange(b, device=ids.device))
        outs.append(got[inverse])
    if stats is not None:
        id_bytes = ids_shards[0].element_size()
        row_bytes = d * answers[0].element_size()
        stats["request_bytes"] = stats.get("request_bytes", 0) + m * m * c * id_bytes
        stats["response_bytes"] = stats.get("response_bytes", 0) + m * m * c * row_bytes
        if c < b:
            stats["overflow_bytes"] = stats.get("overflow_bytes", 0) + m * oc * (
                m * id_bytes + m * row_bytes)
    if return_dropped:
        if dropped is None:
            dropped = torch.zeros((), dtype=torch.int32, device=ids_shards[0].device)
        return outs, dropped
    return outs


_MIX_A = 0x9E3779B1  # odd 32-bit golden-ratio multipliers
_MIX_B = 0x85EBCA77


def hash_mix_ids(ids: torch.Tensor, n2_log: int) -> torch.Tensor:
    """Bijective murmur-style mix of ids within ``[0, 2**n2_log)``
    (``sharded.py:436-456``): xorshift and odd-multiply rounds, a
    permutation of the padded id domain, so the owner of a mixed id is
    pseudorandom whatever the ids' distribution.  JAX multiplies in uint32
    with wrap-around; here in int64, masked to ``n2_log`` bits after each
    step (the low bits of a product do not depend on the bits above them),
    so the result equals JAX's bit for bit."""
    mask = (1 << n2_log) - 1
    s1 = max(1, n2_log // 2)
    v = ids.long() & mask
    v = (v ^ (v >> s1)) & mask
    v = (v * _MIX_A) & mask
    v = (v ^ (v >> s1)) & mask
    v = (v * _MIX_B) & mask
    v = (v ^ (v >> s1)) & mask
    return v.to(ids.dtype)


def hash_shard_table(table: torch.Tensor, m: int) -> Tuple[torch.Tensor, int]:
    """A table laid out for hash-sharded rows (``sharded.py:459-488``):
    zero-padded to the next power of two (at least ``m``), logical row ``i``
    at slot ``hash_mix_ids(i)``.  Returns (the table, ``n2_log``)."""
    n = int(table.shape[0])
    n2_log = max(int(np.ceil(np.log2(max(n, m, 2)))), 1)
    slots = hash_mix_ids(torch.arange(n, dtype=torch.int64), n2_log)
    out = torch.zeros((1 << n2_log,) + tuple(table.shape[1:]), dtype=table.dtype)
    out[slots] = table.cpu()
    return out.to(table.device), n2_log


# ----------------------------------------------------------------------
# Sharded adjacency (sharded CSR)
# ----------------------------------------------------------------------
def pad_adjacency_tables(rel: Relation, m: int):
    """A relation's per-destination tables padded to a multiple of ``m`` rows
    (``sharded.py:662-677``): ``nbr`` -1, ``mask`` False, ``eid`` and ``deg``
    0.  Returns ``(nbr, nbr_eid, nbr_mask, deg, n_rows)``."""
    n = int(rel.nbr.shape[0])
    pad = (-n) % m
    nbr = F.pad(rel.nbr, (0, 0, 0, pad), value=-1)
    eid = F.pad(rel.nbr_eid, (0, 0, 0, pad))
    mask = F.pad(rel.nbr_mask, (0, 0, 0, pad))
    deg = F.pad(rel.deg, (0, pad))
    return nbr, eid, mask, deg, n


def shard_adjacency(graph: HeteroGraph, etypes, m: int) -> Dict:
    """``{etype: {"nbr", "eid", "mask", "deg"}}``, each relation's tables
    padded for ``m`` row blocks (``sharded.py:621-634``); a step built with
    ``graph_shard_etypes`` splits them over its model axis."""
    out = {}
    for et in etypes:
        nbr, eid, mask, deg, _ = pad_adjacency_tables(graph.rels[et], m)
        out[et] = {"nbr": nbr, "eid": eid, "mask": mask, "deg": deg}
    return out


def strip_adjacency(graph: HeteroGraph, etypes) -> HeteroGraph:
    """The graph with the per-destination tables of ``etypes`` cut to
    one-element placeholders (``sharded.py:637-659``); COO arrays, edge data
    and ``eid_pos`` stay."""
    rels = dict(graph.rels)
    for et in etypes:
        r = rels[et]
        dev = r.nbr.device
        rels[et] = Relation(
            src=r.src, dst=r.dst,
            nbr=torch.full((1, 1), -1, dtype=torch.int32, device=dev),
            nbr_eid=torch.zeros((1, 1), dtype=torch.int32, device=dev),
            nbr_mask=torch.zeros((1, 1), dtype=torch.bool, device=dev),
            deg=torch.zeros((1,), dtype=torch.int32, device=dev),
            edata=r.edata, eid_pos=r.eid_pos, nbr_feat=None)
    return HeteroGraph(rels=rels, ndata=graph.ndata, num_nodes_tuple=graph.num_nodes_tuple)


def exclusion_table_sharded(nbr_shard: torch.Tensor, eid_pos: torch.Tensor,
                            eids: torch.Tensor, index: int) -> torch.Tensor:
    """Shard ``index``'s rows of :func:`~gnn_recsys_tpu_torch.ops.sampling.
    exclusion_table` (``sharded.py:680-709``; JAX reads the index from the
    mesh axis): the slots of ``eids`` that this shard owns are sign-marked,
    the others' marks go to a sink slot and are cut off.  The shards'
    tables, concatenated, are the replicated one."""
    per, k = nbr_shard.shape
    base = index * per * k
    pos = eid_pos[eids.reshape(-1).long()].long() - base
    in_shard = (pos >= 0) & (pos < per * k)
    flat = torch.cat([nbr_shard.reshape(-1), nbr_shard.new_zeros(1)])  # the sink last
    slot = torch.where(in_shard, pos, torch.full_like(pos, per * k))
    flat[slot] = flat[slot] | -(2**31)
    return flat[:per * k].reshape(per, k)


def sharded_neighbor_rows(nbr_shards: Blocks, eid_shards: Blocks, mask_shards: Blocks,
                          deg_shards: Blocks, ids: torch.Tensor,
                          capacity: Optional[int] = None,
                          nbr_table_shards: Optional[Blocks] = None,
                          requesters: Optional[Sequence[torch.device]] = None,
                          return_dropped: bool = False, stats: Optional[Dict] = None):
    """A frontier's adjacency rows from tables split by rows
    (``sharded.py:712-774``): the four tables packed into one int32 row of
    width 3K + 1 a node, one exchange (:func:`row_sharded_lookup_a2a`), the
    frontier ``ids`` (1-D) split over the shards and reassembled on its
    device.  ``requesters``: the device of each shard's slice of the
    frontier (by default the owners'); ``nbr_table_shards``: the blocks of
    :func:`exclusion_table_sharded`, fetched in place of ``nbr``.  Returns
    ``(nbr, eid, mask, deg)``, the rows a replicated relation would give,
    and with ``return_dropped`` the count of rows lost beyond ``capacity``
    and its overflow lane (they read as empty rows; the JAX package does not
    count them)."""
    m = len(nbr_shards)
    k = nbr_shards[0].shape[1]
    tables = nbr_shards if nbr_table_shards is None else nbr_table_shards
    packed = [torch.cat([t.int(), e.int(), ms.int(), dg.int()[:, None]], dim=1)
              for t, e, ms, dg in zip(tables, eid_shards, mask_shards, deg_shards)]
    requesters = list(requesters) if requesters is not None else [p.device for p in packed]
    f = ids.shape[0]
    pad = (-f) % m
    ids_p = torch.cat([ids.int(), ids.new_zeros(pad, dtype=torch.int32)])
    chunk = ids_p.shape[0] // m
    mine = [ids_p[j * chunk:(j + 1) * chunk].to(d) for j, d in enumerate(requesters)]
    rows, dropped = row_sharded_lookup_a2a(packed, mine, capacity=capacity,
                                           return_dropped=True, stats=stats)
    full = torch.cat([r.to(ids.device) for r in rows])[:f]
    nbr, eid = full[:, :k], full[:, k:2 * k]
    mask, deg = full[:, 2 * k:3 * k].bool(), full[:, 3 * k]
    if nbr_table_shards is None:
        # Zero-filled rows must read as empty, not as "neighbour 0".
        nbr = torch.where(mask, nbr, torch.full_like(nbr, -1))
    else:
        # Marked tables carry the exclusion bit: -1 only where the slot is
        # invalid and unmarked.
        nbr = torch.where(mask | (nbr < 0), nbr, torch.full_like(nbr, -1))
    if return_dropped:
        return nbr, eid, mask, deg, dropped.to(ids.device)
    return nbr, eid, mask, deg


def sample_neighbors_sharded(nbr_shards: Blocks, eid_shards: Blocks, mask_shards: Blocks,
                             deg_shards: Blocks, ids: torch.Tensor, fanout: int,
                             u: Optional[torch.Tensor] = None, mode: str = "uniform",
                             capacity: Optional[int] = None, with_eids: bool = True,
                             nbr_table_shards: Optional[Blocks] = None,
                             requesters: Optional[Sequence[torch.device]] = None,
                             return_dropped: bool = False, stats: Optional[Dict] = None):
    """:func:`~gnn_recsys_tpu_torch.ops.sampling.sample_neighbors` against
    tables split by rows (``sharded.py:777-820``): the frontier's rows
    fetched once (:func:`sharded_neighbor_rows`), then the unchanged local
    sampler on that view with the same draws ``u``, so the sample equals the
    replicated sampler's, exclusion included (``nbr_table_shards``).
    Returns ``(nbr, eid, mask)`` (and the dropped count with
    ``return_dropped``)."""
    flat = ids.reshape(-1)
    nbr, eid, mask, deg, dropped = sharded_neighbor_rows(
        nbr_shards, eid_shards, mask_shards, deg_shards, flat, capacity=capacity,
        nbr_table_shards=nbr_table_shards, requesters=requesters, return_dropped=True,
        stats=stats)
    zero = torch.zeros(1, dtype=torch.int32, device=flat.device)
    view = Relation(src=zero, dst=zero, nbr=nbr, nbr_eid=eid, nbr_mask=mask, deg=deg, edata={})
    pos = torch.arange(flat.shape[0], device=flat.device).reshape(ids.shape)
    out = sample_neighbors(view, pos, fanout, u=u, mode=mode, with_eids=with_eids,
                           nbr_table=nbr if nbr_table_shards is not None else None)
    return (*out, dropped) if return_dropped else out


# ----------------------------------------------------------------------
# The data-parallel step
# ----------------------------------------------------------------------
def _check_draws(draws, n: int) -> list:
    draws = list(draws) if isinstance(draws, (list, tuple)) else None
    if draws is None or len(draws) != n:
        raise ValueError(f"the step takes one draw source a data shard ({n})")
    return draws


def _on_graph(capture: Optional[bool], draws) -> bool:
    if capture is not None:
        return capture
    return all(isinstance(d, Draws) and d.device.type == "cuda" for d in draws)


def make_shardmap_dp_step(model: ConvModel, cfg: MinibatchConfig, train_etypes, mesh: Mesh,
                          axis: str = "data", has_reverse: Optional[Dict] = None,
                          capture: Optional[bool] = None) -> Callable:
    """The data-parallel step (``sharded.py:118-177``):
    ``step(state, graph, features, batch, edge_tables, draws) -> (state,
    loss)`` with ``draws`` one draw source a local data shard (JAX folds the
    shard index into the key).  Graph, features and pair tables are
    replicated (plain values are copied to each device once and kept while
    the same objects come back; :func:`shard_inputs` places them ahead); the
    batch is split over ``axis`` (whole, or :func:`shard_batch_dict`'s).
    Each shard runs the single-device loss (``make_minibatch_step(...,
    with_update=False)``: no dropout) and its backward; the losses and
    gradients are averaged over the axis, across processes too on a
    :class:`~gnn_recsys_tpu_torch.parallel.distributed.GlobalMesh`, and Adam
    applies the mean on the model's device.  The kernels of the model and
    ``cfg`` run per shard.

    ``capture`` (by default: whether every draw source is a CUDA
    :class:`Draws`): each shard's loss and backward is a CUDA graph,
    captured at the first call (:class:`~gnn_recsys_tpu_torch.train.
    graph_step.CapturedStep`); later calls must pass the same graph,
    features and tables and the same generators, and the batch is copied
    into the graph's buffers.  ``step.captured`` lists the shards' graphs."""
    if has_reverse is None:
        has_reverse = {et: True for et in train_etypes}
    etypes = tuple(train_etypes)
    devices = mesh.shard_devices(axis)
    n = len(devices)
    replicas, placer = _Replicas(model), _Placer(mesh)
    losses_of = {}
    static: Dict = {}  # the shards' captured steps and their outputs

    def local(i, graph, features, batch, edge_tables, draws):
        dev = devices[i]
        rep = replicas.on(dev)
        if dev not in losses_of:
            losses_of[dev] = make_minibatch_loss(rep, cfg, etypes, cfg.exclude_batch_edges,
                                                 has_reverse)
        rep.train(False)
        loss = losses_of[dev](placer.at(graph, dev), placer.at(features, dev), batch,
                              placer.at(edge_tables, dev), draws)
        return loss.detach(), _grads(loss, [rep])

    def capture_shards(graph, features, blocks, edge_tables, draws):
        from gnn_recsys_tpu_torch.train.graph_step import CapturedStep

        static.update(out={}, steps=[])
        fed = [_tree_map(torch.clone, b) for b in blocks]
        for i, d in enumerate(draws):
            def body(update, step_draws, i=i):
                static["out"][i] = local(i, graph, features, fed[i], edge_tables, step_draws)
            static["steps"].append(CapturedStep(body, d, held=(graph, features, edge_tables),
                                                fed=fed[i]))
        step_ref().captured = static["steps"]

    def step(state, graph, features, batch, edge_tables, draws):
        draws = _check_draws(draws, n)
        replicas.sync()
        first = distributed.first_shard(mesh, axis)
        blocks = _batch_blocks(mesh, batch, axis, devices, first,
                               distributed.extent(mesh, axis))
        if _on_graph(capture, draws):
            if not static:
                capture_shards(graph, features, blocks, edge_tables, draws)
            for s, b, d in zip(static["steps"], blocks, draws):
                s.check((graph, features, edge_tables), d.generator, b)
            for s in static["steps"]:
                with torch.cuda.device(s.generator.device):  # a replay runs on its card
                    s.replay()
            outs = [static["out"][i] for i in range(n)]
        else:
            outs = [local(i, graph, features, b, edge_tables, d)
                    for i, (b, d) in enumerate(zip(blocks, draws))]
        home = replicas.home
        total = _sum_onto([[loss.reshape(1)] + grads for loss, grads in outs], home)
        total = distributed.all_reduce_sum(mesh, total)
        scale = 1.0 / distributed.extent(mesh, axis)
        torch._foreach_mul_(total, scale)
        _apply(state, model, total[1:])
        return state, total[0][0]

    step.captured = None
    # A weak reference: a cycle through the step would keep its graphs and
    # their memory until Python's cycle collector ran.
    step_ref = weakref.ref(step)
    return step


# ----------------------------------------------------------------------
# The ('data', 'model') step
# ----------------------------------------------------------------------
def _bind(row_transform, model: ConvModel):
    """``row_transform`` on ``model``'s parameters (a
    :class:`~gnn_recsys_tpu_torch.models.conv_model.RowTransform`), or as it is."""
    return row_transform.on(model) if hasattr(row_transform, "on") else row_transform


def make_shardmap_tp_dp_step(
    model: ConvModel,
    cfg: MinibatchConfig,
    train_etypes,
    mesh: Mesh,
    data_axis: str = "data",
    model_axis: str = "model",
    row_shard_ntypes: Tuple[str, ...] = ("item",),
    has_reverse: Optional[Dict] = None,
    a2a_capacity_factor: Optional[float] = None,
    hash_mix_logs: Optional[Dict[str, int]] = None,
    tp_transform: bool = True,
    graph_shard_etypes: Tuple[CanonicalEtype, ...] = (),
    adj_capacity: Optional[int] = None,
) -> Callable:
    """The ('data', 'model') step (``sharded.py:194-429``):
    ``step(state, graph, features, batch, edge_tables[, adj], draws)``, one
    draw source a data shard, shared by the shard's model entries
    (``:291-295``).  The tables of ``row_shard_ntypes`` are split by rows
    over ``model_axis`` (pass them whole, laid out by
    :func:`hash_shard_table` for the node types of ``hash_mix_logs``).

    Per data shard the tree runs once, on the shard's entry at model index
    0, and every raw read of a row-sharded table goes through the
    ``feature_lookup`` hook: the frontier split over the model axis, each
    slice resolved by :func:`row_sharded_lookup_a2a` (ids mixed first for
    hash-sharded tables), the slices reassembled.  ``tp_transform``: the
    hook takes the leaf's per-row map for the row-sharded node types only
    (the replicated tables keep the model's own leaf), and applies it at the
    owner when a capacity is set, else at the requester before the
    reassembly; both ride the exchange at the map's width.

    ``graph_shard_etypes``: those relations' adjacency comes in ``adj``
    (:func:`shard_adjacency`, split over the model axis; the graph may be
    :func:`strip_adjacency`'d) and every expansion of them goes through
    :func:`sample_neighbors_sharded`, the exclusion table of each etype
    built once a forward.  ``adj_capacity`` bounds its buckets.

    With ``a2a_capacity_factor`` or ``adj_capacity`` set, the step returns
    ``(state, loss, dropped)``: ids lost beyond both budgets, over every
    exchange of the step (the JAX package counts the feature exchange only);
    ``step.drops`` holds the two exchanges' counts apart and
    ``step.exchange_bytes`` the bytes of the last step's exchanges, from the
    buckets' shapes.  Losses and gradients are averaged over the data
    shards; the model runs in eval mode, as JAX's ``with_update=False`` step
    does."""
    if has_reverse is None:
        has_reverse = {et: True for et in train_etypes}
    etypes = tuple(train_etypes)
    m = mesh.shape[model_axis]
    data_devices = mesh.shard_devices(data_axis)
    rows_of = _model_rows(mesh, data_axis, model_axis)
    shard_adj = tuple(graph_shard_etypes)
    with_drops = a2a_capacity_factor is not None or adj_capacity is not None
    replicas, placer = _Replicas(model), _Placer(mesh)
    row_ntypes = frozenset(row_shard_ntypes)

    def local(i, graph, features, tables, batch, edge_tables, adj, draws, drops, nbytes):
        home, row_devs = data_devices[i], rows_of[i]
        rep = replicas.on(home)
        feats_home = placer.at(placer._keep("replicated", features, lambda: {
            nt: x for nt, x in features.items() if nt not in row_ntypes}), home)
        graph_at = {d: placer.at(graph, d) for d in dict.fromkeys(row_devs)}

        def feature_lookup(nt, flat_ids, row_transform=None):
            if nt not in row_ntypes:
                table = feats_home[nt]
                rows = table[flat_ids.long().clamp(0, table.shape[0] - 1)]
                return rows if row_transform is None else row_transform(rows)
            ids = flat_ids
            if hash_mix_logs and nt in hash_mix_logs:
                ids = hash_mix_ids(ids, hash_mix_logs[nt])
            b = ids.shape[0]
            ids_p = torch.cat([ids, ids.new_zeros((-b) % m)])
            chunk = ids_p.shape[0] // m
            mine = [ids_p[k * chunk:(k + 1) * chunk].to(d) for k, d in enumerate(row_devs)]
            owners = tables[nt].owners(row_devs)
            maps = (None if row_transform is None
                    else [_bind(row_transform, replicas.on(d)) for d in row_devs])
            if a2a_capacity_factor is not None:
                cap = statistical_a2a_capacity(chunk, m, a2a_capacity_factor)
                rows, dropped = row_sharded_lookup_a2a(owners, mine, capacity=cap,
                                                       return_dropped=True, row_transform=maps,
                                                       stats=nbytes)
                drops["features"].append(dropped.to(home))
            else:
                rows = row_sharded_lookup_a2a(owners, mine, stats=nbytes)
                if maps is not None:  # at the requester, before the reassembly
                    rows = [f(r) for f, r in zip(maps, rows)]
            nbytes["reassembly_bytes"] = nbytes.get("reassembly_bytes", 0) + (
                m * chunk * rows[0].shape[-1] * rows[0].element_size())
            return torch.cat([r.to(home) for r in rows])[:b]

        feature_lookup.transform_ntypes = row_ntypes if tp_transform else frozenset()

        neighbor_sample = None
        if shard_adj:
            marked: Dict = {}  # one exclusion table an etype a forward

            def neighbor_sample(et, ids, fanout, u, mode, with_eids, excl):
                a = adj[et]
                blocks = {name: t.owners(row_devs) for name, t in a.items()}
                table = None
                if excl is not None:
                    if et not in marked:
                        marked[et] = [exclusion_table_sharded(
                            blocks["nbr"][k], graph_at[d].rels[et].eid_pos, excl.to(d), k)
                            for k, d in enumerate(row_devs)]
                    table = marked[et]
                nbr, eid, mask, dropped = sample_neighbors_sharded(
                    blocks["nbr"], blocks["eid"], blocks["mask"], blocks["deg"], ids, fanout,
                    u=u, mode=mode, capacity=adj_capacity, with_eids=with_eids,
                    nbr_table_shards=table, requesters=row_devs, return_dropped=True,
                    stats=nbytes)
                drops["adjacency"].append(dropped.to(home))
                return nbr, eid, mask

            neighbor_sample.etypes = frozenset(shard_adj)

        loss_fn = make_minibatch_loss(rep, cfg, etypes, cfg.exclude_batch_edges, has_reverse,
                                      feature_lookup, neighbor_sample)
        for r in {id(replicas.on(d)): replicas.on(d) for d in row_devs}.values():
            r.train(False)
        loss = loss_fn(graph_at[home], feats_home, batch, placer.at(edge_tables, home), draws)
        involved = list({id(replicas.on(d)): replicas.on(d) for d in [home] + row_devs}.values())
        return loss.detach(), _grads(loss, involved)

    def run(state, graph, features, batch, edge_tables, adj, draws):
        draws = _check_draws(draws, len(data_devices))
        replicas.sync()
        tables = placer.rows(features, row_ntypes, model_axis)
        adj_blocks = {et: {name: placer._keep(("adj", model_axis), t,
                                              lambda t=t: RowBlocks(mesh, t, model_axis))
                           for name, t in a.items()} for et, a in (adj or {}).items()}
        first = distributed.first_shard(mesh, data_axis)
        blocks = _batch_blocks(mesh, batch, data_axis, data_devices, first,
                               distributed.extent(mesh, data_axis))
        drops = {"features": [], "adjacency": []}
        nbytes: Dict[str, int] = {}
        outs = [local(i, graph, features, tables, b, edge_tables, adj_blocks, d, drops, nbytes)
                for i, (b, d) in enumerate(zip(blocks, draws))]
        home = replicas.home
        total = _sum_onto([[loss.reshape(1)] + grads for loss, grads in outs], home)
        total = distributed.all_reduce_sum(mesh, total)
        torch._foreach_mul_(total, 1.0 / distributed.extent(mesh, data_axis))
        _apply(state, model, total[1:])
        step_ref().exchange_bytes = nbytes
        if not with_drops:
            return state, total[0][0]
        zero = torch.zeros((), dtype=torch.int32, device=home)
        counts = {k: sum((v.to(home) for v in vs), zero) for k, vs in drops.items()}
        step_ref().drops = counts
        return state, total[0][0], counts["features"] + counts["adjacency"]

    if shard_adj:
        def step(state, graph, features, batch, edge_tables, adj, draws):
            return run(state, graph, features, batch, edge_tables, adj, draws)
    else:
        def step(state, graph, features, batch, edge_tables, draws):
            return run(state, graph, features, batch, edge_tables, None, draws)
    step.drops, step.exchange_bytes = None, None
    step_ref = weakref.ref(step)
    return step


# ----------------------------------------------------------------------
# The single-device program over the data axis
# ----------------------------------------------------------------------
class _DrawTape:
    """The single-device step's tree draws, taken once from ``base`` in its
    order (by the first data shard's walk) and handed to every shard's walk
    by rows."""

    def __init__(self, base):
        self.base = base
        self.taken: Dict = {}
        self.home = getattr(base, "device", torch.device("cpu"))

    def full(self, key, k: int, shape, make) -> torch.Tensor:
        got = self.taken.setdefault(key, [])
        if k == len(got):
            got.append(make(shape))
        if tuple(got[k].shape) != tuple(shape):
            raise ValueError(f"shard walk asks {tuple(shape)} where the first asked "
                             f"{tuple(got[k].shape)}")
        return got[k]


class _SeedRows:
    """One data shard's view of a seed type's tree draws: request ``q`` of
    the walk is the rows ``sel`` of the single-device walk's request ``q``
    (whose leading size is ``n_full`` seeds' frontier), on ``dev``."""

    def __init__(self, tape: _DrawTape, key, dev, n_full: int, sel: Optional[torch.Tensor]):
        self.tape, self.key, self.dev = tape, key, dev
        self.n_full, self.sel = n_full, sel
        self.n_sel = n_full if sel is None else int(sel.shape[0])
        self.counts = {"u": 0, "m": 0}

    def _full_shape(self, shape) -> Tuple[int, ...]:
        if shape[0] % self.n_sel:
            raise ValueError(f"a draw of {tuple(shape)} is not {self.n_sel} seeds' frontier")
        return (shape[0] // self.n_sel * self.n_full, *shape[1:])

    def _take(self, kind, shape, make) -> torch.Tensor:
        shape = tuple(shape)
        full = self.tape.full((self.key, kind), self.counts[kind], self._full_shape(shape), make)
        self.counts[kind] += 1
        if self.sel is not None:
            full = full.reshape(self.n_full, -1)[self.sel.to(full.device)].reshape(shape)
        return full.to(self.dev)

    def uniform(self, shape) -> torch.Tensor:
        return self._take("u", shape, self.tape.base.uniform)

    def keep_mask(self, like: torch.Tensor, p: float) -> torch.Tensor:
        home = self.tape.home

        def make(s):
            return dropout_keep_mask(torch.empty(s, dtype=like.dtype, device=home), p)

        return self._take("m", like.shape, make)


class _ShardDraws:
    """A data shard's draw source: per seed type a :class:`_SeedRows`."""

    def __init__(self, tape: _DrawTape, dev, rows: Dict[str, Tuple[int, Optional[torch.Tensor]]]):
        self.tape, self.dev, self.rows = tape, dev, rows

    def for_seeds(self, ntype: str) -> _SeedRows:
        n_full, sel = self.rows[ntype]
        return _SeedRows(self.tape, ntype, self.dev, n_full, sel)


def make_gspmd_minibatch_step(model: ConvModel, cfg: MinibatchConfig, train_etypes, mesh: Mesh,
                              with_update: bool = True, with_exclusion: bool = True,
                              has_reverse: Optional[Dict] = None) -> Callable:
    """The single-device minibatch step over the mesh's data axis
    (``sharded.py:93-115``): ``step(state, graph, features, batch,
    edge_tables, draws) -> (state, loss)`` with one draw source, the
    single-device step's.  Its numbers and its loss are the single-device
    step's: the pool and the shared-pool picks are drawn as one device draws
    them, and each data shard takes its rows of every per-edge draw of the
    tree walk (:class:`_DrawTape`; dropout masks too).  Each data shard runs
    the tree of its positives and, replicated, of the whole negative pool
    (with ``dedup``, the whole block forward, whose plan is not split by
    edge), excluding every batch edge; the shards' loss numerators and
    denominators are added before the division, and their gradients before
    Adam's update.  Feature tables placed by :func:`shard_inputs` as
    :class:`RowBlocks` are read through :func:`row_sharded_lookup` from the
    shard's row of the mesh; everything else is replicated.  Batch sizes
    must divide the data extent (``train_minibatch(mesh=...)`` rounds them)."""
    if has_reverse is None:
        has_reverse = {et: True for et in train_etypes}
    etypes = tuple(train_etypes)
    axis = "data" if "data" in mesh.shape else mesh.axis_names[0]
    devices = mesh.shard_devices(axis)
    rows_of = _model_rows(mesh, axis, "model")
    replicas, placer = _Replicas(model), _Placer(mesh)
    clamp = 1e-9 if cfg.loss == "sampled_softmax" else 1.0

    def shard_pass(i, g, graph, features, tables_rows, batch, edge_tables, tape, pool, neg_idx,
                   sizes, extent):
        dev, rep = devices[i], replicas.on(devices[i])
        # Index tensors made where they are used: a captured step copies
        # nothing from the host.
        rows = {et: torch.arange(g * (b // extent), (g + 1) * (b // extent), device=tape.home)
                for et, b in sizes.items()}
        graph_d, feats_d = placer.at(graph, dev), placer.at(features, dev)
        full_batch = {et: {k: v.to(dev) for k, v in cols.items()} for et, cols in batch.items()}
        mine = {et: {k: v[rows[et].to(v.device)] for k, v in cols.items()}
                for et, cols in full_batch.items()}
        lookup = None
        if tables_rows:
            def lookup(nt, flat_ids):
                if nt in tables_rows:
                    return row_sharded_lookup(tables_rows[nt].owners(rows_of[i]), flat_ids,
                                              device=dev)
                table = feats_d[nt]
                return table[flat_ids.long().clamp(0, table.shape[0] - 1)]

        exclude = batch_exclusion(full_batch, etypes, has_reverse) if with_exclusion else None
        n_pos = sum(sizes.values())
        if cfg.dedup:
            # The block forward's plan is not split by edge: every shard
            # computes it whole and scores its own rows.
            view = _SeedRows(tape, "all", dev, 1, None)
            pairs = {et: (full_batch[et]["u"], full_batch[et]["i"]) for et in etypes}
            scores = rep.minibatch_forward(graph_d, feats_d, pairs, pool.to(dev),
                                           {et: None if x is None else x.to(dev)
                                            for et, x in neg_idx.items()},
                                           cfg.fanouts, view, exclude_eids=exclude, dedup=True)
            scores = tuple({et: x[rows[et].to(x.device)] for et, x in part.items()}
                           for part in scores)
            pool_i = pool.to(dev)
        else:
            offsets, off = {}, 0
            for et in etypes:
                offsets[et], off = off, off + sizes[et]
            pos_sel = torch.cat([rows[et] + offsets[et] for et in etypes])
            if cfg.neg_mode == "per_edge":
                s = cfg.neg_sample_size
                pool_sel = torch.cat([((rows[et] + offsets[et]) * s)[:, None]
                                      + torch.arange(s, device=tape.home)
                                      for et in etypes]).reshape(-1)
                pool_i = pool[pool_sel.to(pool.device)].to(dev)
                idx_i, o = {}, 0
                for et in etypes:
                    n = rows[et].shape[0]
                    idx_i[et] = torch.arange(o, o + n * s, device=dev).reshape(n, s)
                    o += n * s
            else:
                pool_sel = torch.arange(pool.shape[0], device=tape.home)
                pool_i = pool.to(dev)
                idx_i = {et: None if x is None else x[rows[et].to(x.device)].to(dev)
                         for et, x in neg_idx.items()}
            view = _ShardDraws(tape, dev, {
                "user": (n_pos, pos_sel),
                "item": (n_pos + pool.shape[0], torch.cat([pos_sel, pool_sel + n_pos]))})
            pairs = {et: (mine[et]["u"], mine[et]["i"]) for et in etypes}
            scores = rep.minibatch_forward(graph_d, feats_d, pairs, pool_i, idx_i, cfg.fanouts,
                                           view, exclude_eids=exclude, dedup=False,
                                           feature_lookup=lookup)
        return scored_loss(cfg, etypes, mine, pool_i, scores, placer.at(edge_tables, dev),
                           parts=True)

    def step(state, graph, features, batch, edge_tables, draws):
        if isinstance(batch, list):
            raise ValueError("the step splits the whole batch itself (pass the batch dict)")
        replicas.sync()
        extent = distributed.extent(mesh, axis)
        first = distributed.first_shard(mesh, axis)
        sizes = {et: int(batch[et]["u"].shape[0]) for et in etypes}
        for et, b in sizes.items():
            if b % extent:
                raise ValueError(f"{et}: a batch of {b} edges does not split over {extent} "
                                 "data shards")
        tables_rows = {nt: x for nt, x in features.items() if isinstance(x, RowBlocks)}
        num_items = (graph.value if isinstance(graph, Replicated) else graph).num_nodes("item")
        tape = _DrawTape(draws)
        pool, neg_idx = draw_negatives(cfg, etypes, sizes, num_items, draws, tape.home)
        for r in {id(replicas.on(d)): replicas.on(d) for d in devices}.values():
            r.train(with_update)
        with torch.set_grad_enabled(with_update):
            parts = [shard_pass(i, first + i, graph, features, tables_rows, batch, edge_tables,
                                tape, pool, neg_idx, sizes, extent)
                     for i in range(len(devices))]
        home = replicas.home
        counts = _sum_onto([[c.reshape(1).float()] for _, c in parts], home)
        counts = distributed.all_reduce_sum(mesh, counts)
        inv = 1.0 / counts[0][0].clamp(min=clamp)
        if not with_update:
            totals = _sum_onto([[t.reshape(1)] for t, _ in parts], home)
            totals = distributed.all_reduce_sum(mesh, totals)
            return state, (totals[0][0] * inv).detach()
        outs = [[t.detach().reshape(1)] + _grads(t * inv.to(t.device), [replicas.on(devices[i])])
                for i, (t, _) in enumerate(parts)]
        total = _sum_onto(outs, home)
        total = distributed.all_reduce_sum(mesh, total)
        _apply(state, model, total[1:])
        return state, total[0][0] * inv

    return step


def _model_rows(mesh: Mesh, data_axis: str, model_axis: str) -> List[List[torch.device]]:
    """For each shard of ``data_axis``, the devices of its entries along
    ``model_axis`` (just its own where the mesh has no such axis)."""
    if model_axis not in mesh.shape:
        return [[d] for d in mesh.shard_devices(data_axis)]
    if mesh.devices.ndim != 2:
        raise ValueError(f"a ({data_axis!r}, {model_axis!r}) step needs a 2-d mesh, "
                         f"not {mesh.axis_names}")
    grid = mesh.devices if mesh.axis_names[0] == data_axis else mesh.devices.T
    return [list(row) for row in grid]


def _shard_coords(mesh: Mesh, axis: str) -> List[Tuple[int, ...]]:
    """The grid coordinates of :meth:`Mesh.shard_devices`'s entries."""
    pos = mesh.axis_names.index(axis)
    out = []
    for k in range(mesh.shape[axis]):
        coord = [0] * len(mesh.axis_names)
        coord[pos] = k
        out.append(tuple(coord))
    return out
