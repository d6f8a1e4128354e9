"""Catalog-sharded full-catalog retrieval and mesh-sharded embedding
inference.

Port of ``gnn_recsys_tpu/retrieval/sharded.py``.  One process drives every
device of a :class:`~gnn_recsys_tpu_torch.parallel.mesh.Mesh`, as JAX's
``shard_map`` does: each shard's work is launched on its own device, every
shard before anything waits on the host (no ``.item()``, ``nonzero`` or
boolean-mask indexing inside a shard's work), so that on several cards the
shards run at once.  JAX's collectives are explicit copies onto the mesh's
first device: ``all_gather`` of the candidates, ``pmax`` / ``psum`` of the
row statistics.

* :func:`get_recs_sharded`: the catalog (and the popularity vector) split
  by rows over a mesh axis; each shard ranks every queried user against its
  rows and keeps its local top-``fl``; the candidates, laid out ``[U,
  m * fl]`` in shard order, are merged by a tie-stable top-``fetch``.  Every
  element of the global top-``fetch`` is inside its own shard's local
  top-``fetch``, so the merge is exact, ties to the lowest global id as in
  :func:`~gnn_recsys_tpu_torch.retrieval.recs.get_recs`.  The popularity
  boost ``softmax(ratings) + w * pop`` normalises over the whole catalog:
  the shards' row maxima and sum-exps are combined into the global ones
  before ranking.  Already-bought filtering routes as on one device:
  over-fetch and drop for bounded rows, in-shard mask-then-rank for hub rows.

  On the ``cuda`` route each shard runs the MIPS kernels over its real rows
  only: a zero padding row scores 0 and would push a real item with a
  negative score out of the last shard's local top-``fl`` (the JAX
  package's Pallas route ranks before it masks, ``sharded.py:236-239``).

* :func:`infer_embeddings_sharded`: the full-fanout sampled-tree embedding
  pass, node ids split over every device of the mesh, one model copy a
  distinct device.  It reads every in-edge of a node: rows that a
  ``max_fanout`` cap cut are rebuilt whole first, so that the pass equals the
  single-device full-graph pass (the JAX package's reads the capped rows,
  and on a capped graph its embeddings are not its single-device ones).
"""

from __future__ import annotations

import copy
from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

from gnn_recsys_tpu_torch.graph.hetero import uncap
from gnn_recsys_tpu_torch.models.layers import l2_normalize
from gnn_recsys_tpu_torch.ops.cuda.topk_mips import mips_boost, mips_lse, mips_topk, stable_topk
from gnn_recsys_tpu_torch.ops.membership import PaddedPairSet, scatter_row_mask
from gnn_recsys_tpu_torch.parallel.mesh import Axes, Mesh
from gnn_recsys_tpu_torch.retrieval.recs import (
    OVERFETCH_MAX_ROW,
    ScoreFn,
    _drop_bought,
    as_device_tensor,
    cosine_score_fn,
    ranking_route,
)

Blocks = List[torch.Tensor]


def catalog_axis(mesh: Mesh) -> str:
    """The axis serving splits the catalog over: ``model`` where it is
    above 1, else ``data`` (``inference.py:162``, ``metrics.py:152``)."""
    return "model" if mesh.shape.get("model", 1) > 1 else "data"


def _split_rows(x: torch.Tensor, devices: Sequence[torch.device]) -> Blocks:
    """``x`` zero-padded to a multiple of the shard count and cut into one
    row block a shard, each on its shard's device."""
    m = len(devices)
    pad = (-x.shape[0]) % m
    if pad:
        x = F.pad(x, (0, 0) * (x.dim() - 1) + (0, pad))
    per = x.shape[0] // m
    return [x[j * per:(j + 1) * per].to(d) for j, d in enumerate(devices)]


def shard_catalog(
    mesh: Mesh,
    item_emb,
    popularity=None,
    axis: Axes = "model",
) -> Tuple[Blocks, Optional[Blocks], int]:
    """The catalog padded to the shard count and split by rows over
    ``axis`` (``sharded.py:64-89``): ``(item blocks, popularity blocks or
    None, num_items)``, each block on its shard's device.  Padding rows are
    kept out of the ranking by :func:`get_recs_sharded`, given
    ``num_items``."""
    devices = mesh.shard_devices(axis)
    item_emb = as_device_tensor(item_emb, torch.float32, _home(item_emb))
    pop = None
    if popularity is not None:
        pop = _split_rows(as_device_tensor(popularity, torch.float32,
                                           _home(popularity)).reshape(-1), devices)
    return _split_rows(item_emb, devices), pop, int(item_emb.shape[0])


def _home(x) -> torch.device:
    return x.device if isinstance(x, torch.Tensor) else torch.device("cpu")


def _place(x, devices, dtype) -> Blocks:
    """A catalog-long tensor split over ``devices``, or blocks already split
    (as :func:`shard_catalog` returns them) moved onto them."""
    if isinstance(x, (list, tuple)):
        if len(x) != len(devices):
            raise ValueError(f"{len(x)} catalog blocks for {len(devices)} shards")
        return [as_device_tensor(b, dtype, d) for b, d in zip(x, devices)]
    return _split_rows(as_device_tensor(x, dtype, _home(x)), devices)


def merge_candidates(vals: Blocks, idx: Blocks, fetch: int,
                     device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The shards' candidates (``[U, fl]`` values and global ids, one pair a
    shard) gathered onto ``device`` in shard order, ``[U, m * fl]``, and the
    top ``fetch`` of each row, ties to the earlier candidate
    (``sharded.py:240-246``): (values, ids)."""
    cand_v = torch.stack([v.to(device) for v in vals], dim=1).flatten(1)
    cand_i = torch.stack([i.to(device) for i in idx], dim=1).flatten(1)
    top_v, pos = stable_topk(cand_v, fetch)
    return top_v, torch.take_along_dim(cand_i, pos, dim=1)


def _pad_candidates(v: torch.Tensor, i: torch.Tensor, fl: int):
    """A shard's ``[U, kj]`` top list widened to ``fl`` with ``-inf``
    fillers (id -1), which the merge ranks last."""
    short = fl - v.shape[1]
    if not short:
        return v, i
    return (F.pad(v, (0, short), value=float("-inf")), F.pad(i, (0, short), value=-1))


def _per_device(devices: Sequence[torch.device], fn) -> Dict[torch.device, object]:
    """``fn(device)`` once for each distinct device of ``devices``."""
    return {d: fn(d) for d in dict.fromkeys(devices)}


def _cuda_candidates(devices, users, blocks, pop_blocks, num_items, fl, weight):
    """Each shard's local top-``fl`` through the MIPS kernels over its real
    rows (``sharded.py:220-246``; see the module note on padding).  With the
    boost: ``mips_lse`` on each shard, the global max ``m = max_j m_j`` and
    sum-exp ``s = sum_j s_j * exp(m_j - m)`` (JAX's ``pmax`` / ``psum``,
    ``:256-262``), then ``mips_boost`` on each shard with them."""
    per = blocks[0].shape[0]
    num_users = next(iter(users.values())).shape[0]
    reals = [max(0, min(per, num_items - j * per)) for j in range(len(devices))]
    ie = [l2_normalize(b[:r]) for b, r in zip(blocks, reals)]
    live = [j for j, r in enumerate(reals) if r]
    out = {}
    if pop_blocks is None:
        for j in live:
            out[j] = mips_topk(users[devices[j]], ie[j], min(fl, reals[j]))
    else:
        stats = {j: mips_lse(users[devices[j]], ie[j]) for j in live}
        home = devices[0]
        gmax = torch.stack([stats[j][0].to(home) for j in live]).amax(dim=0)
        gsum = torch.zeros_like(gmax)
        for j in live:
            m_j, s_j = (t.to(home) for t in stats[j])
            gsum = gsum + s_j * torch.exp(m_j - gmax)
        on = _per_device(devices, lambda d: (gmax.to(d), gsum.to(d)))
        for j in live:
            m, s = on[devices[j]]
            out[j] = mips_boost(users[devices[j]], ie[j], pop_blocks[j][:reals[j]], m, s,
                                min(fl, reals[j]), weight=weight)
    vals, idx = [], []
    for j, d in enumerate(devices):
        v, i = out[j] if j in out else (
            torch.empty((num_users, 0), device=d),
            torch.empty((num_users, 0), dtype=torch.int64, device=d))
        v, i = _pad_candidates(v, i + j * per, fl)
        vals.append(v)
        idx.append(i)
    return vals, idx


def _torch_candidates(devices, users, uids, blocks, pop_blocks, num_items, fl, score_fn,
                      weight, bought, chunk_size):
    """Each shard's local top-``fl`` by user chunk (JAX's ``one_chunk``,
    ``sharded.py:248-277``): ``score_fn`` on the shard, padding rows at
    ``-inf``; with the boost, the global softmax from the shards' row maxima
    and sum-exps; for hub rows, each user's bought row scattered into the
    shard's columns (mask-then-rank)."""
    home = devices[0]
    per = blocks[0].shape[0]
    lo = [j * per for j in range(len(devices))]
    invalid = [torch.arange(per, device=d) >= num_items - lo[j] for j, d in enumerate(devices)]
    parts = [([], []) for _ in devices]
    for c0 in range(0, uids[home].shape[0], chunk_size):
        ratings = []
        for j, d in enumerate(devices):
            u = uids[d][c0:c0 + chunk_size]
            ratings.append(score_fn(users[d][u], blocks[j]).masked_fill(invalid[j],
                                                                          float("-inf")))
        if pop_blocks is not None:
            gmax = torch.stack([r.amax(dim=1).to(home) for r in ratings]).amax(dim=0)
            gmax_on = _per_device(devices, lambda d: gmax.to(d))
            ex = [torch.exp(r - gmax_on[d][:, None]).masked_fill(invalid[j], 0.0)
                  for j, (r, d) in enumerate(zip(ratings, devices))]
            gsum = torch.stack([e.sum(dim=1).to(home) for e in ex]).sum(dim=0)
            gsum_on = _per_device(devices, lambda d: gsum.to(d))
            ratings = [(e / gsum_on[d][:, None] + pop_blocks[j][None, :] * weight)
                       .masked_fill(invalid[j], float("-inf"))
                       for j, (e, d) in enumerate(zip(ex, devices))]
        for j, d in enumerate(devices):
            r = ratings[j]
            if bought is not None:
                u = uids[d][c0:c0 + chunk_size]
                r = r.masked_fill(scatter_row_mask(bought[d], u, per, lo=lo[j]), float("-inf"))
            v, i = stable_topk(r, fl)
            parts[j][0].append(v)
            parts[j][1].append(i + lo[j])
    vals = [torch.cat(v) for v, _ in parts]
    idx = [torch.cat(i) for _, i in parts]
    return vals, idx


def get_recs_sharded(
    mesh: Mesh,
    user_emb,
    item_emb: Union[torch.Tensor, Blocks],
    user_ids,
    k: int,
    already_bought: Optional[PaddedPairSet] = None,
    remove_already_bought: bool = True,
    score_fn: Optional[ScoreFn] = None,
    popularity=None,
    weight_popularity: float = 1.0,
    chunk_size: int = 128,
    backend: str = "auto",
    axis: Axes = "model",
    num_items: Optional[int] = None,
) -> torch.Tensor:
    """Top-k recommendations with the catalog split by rows over ``axis``
    (one mesh axis name, or several: the catalog then splits over their
    product): ``[U, k]`` int64 on the mesh's first device.

    Same contract and results as
    :func:`~gnn_recsys_tpu_torch.retrieval.recs.get_recs` (``sharded.py:
    92-309``).  ``item_emb`` and ``popularity``: whole tensors, or the
    blocks :func:`shard_catalog` returns (then pass its ``num_items``).
    backend: ``torch`` (the JAX ``xla`` route), ``cuda`` (the MIPS kernels
    on each shard, cosine scoring only, boosted or not), or ``auto``:
    ``cuda`` for cosine scoring on CUDA devices, else ``torch``.  Hub rows
    (``max_row > OVERFETCH_MAX_ROW``) take the ``torch`` route on both.
    """
    devices = mesh.shard_devices(axis)
    home = devices[0]
    if num_items is None:
        num_items = (sum(int(b.shape[0]) for b in item_emb)
                     if isinstance(item_emb, (list, tuple)) else int(item_emb.shape[0]))
    blocks = _place(item_emb, devices, torch.float32)
    pop_blocks = None
    if popularity is not None:
        pop = popularity if isinstance(popularity, (list, tuple)) else (
            as_device_tensor(popularity, torch.float32, _home(popularity)).reshape(-1))
        pop_blocks = _place(pop, devices, torch.float32)
    user_ids = as_device_tensor(user_ids, torch.int64, home)
    users = _per_device(devices, lambda d: as_device_tensor(user_emb, torch.float32, d))
    uids = _per_device(devices, lambda d: user_ids.to(d))
    mask_rows = (already_bought is not None and remove_already_bought
                 and already_bought.max_row > 0)
    hub_rows = mask_rows and already_bought.max_row > OVERFETCH_MAX_ROW
    # No sharded mlp_topk route: the MLP head ranks on the torch route.
    route = ranking_route(backend, home, score_fn, popularity is not None, hub_rows,
                          mlp=False)
    fetch = k if hub_rows else min(k + (already_bought.max_row if mask_rows else 0), num_items)
    fl = min(fetch, blocks[0].shape[0])
    if route == "mips":
        queried = _per_device(devices, lambda d: l2_normalize(users[d][uids[d]]))
        vals, idx = _cuda_candidates(devices, queried, blocks, pop_blocks, num_items, fl,
                                     weight_popularity)
    else:
        bought = (_per_device(devices, lambda d: already_bought.to(d)) if hub_rows else None)
        vals, idx = _torch_candidates(devices, users, uids, blocks, pop_blocks, num_items, fl,
                                      score_fn or cosine_score_fn, weight_popularity, bought,
                                      chunk_size)
    top_v, top_i = merge_candidates(vals, idx, fetch, home)
    if hub_rows:
        # Fewer than k unbought items: trailing -inf slots become -1.
        return torch.where(torch.isfinite(top_v), top_i, torch.full_like(top_i, -1))[:, :k]
    if not mask_rows:
        return top_i[:, :k]
    return _drop_bought(top_i, user_ids, already_bought.to(home), k)


def infer_embeddings_sharded(
    model,
    graph,
    features: Dict[str, torch.Tensor],
    mesh: Mesh,
    axis: Axes = ("data", "model"),
    node_chunk: int = 128,
    fanouts: Optional[Tuple[int, ...]] = None,
    ntypes: Optional[Tuple[str, ...]] = None,
) -> Dict[str, torch.Tensor]:
    """Embeddings of every node, data-parallel over the devices of ``axis``
    (by default every device of the mesh; ``sharded.py:312-383``): the node
    ids of each type split into one contiguous run a shard, each run through
    :func:`~gnn_recsys_tpu_torch.train.minibatch.compute_embeddings_minibatch`
    on its shard's device (chunks of ``node_chunk``), the outputs
    concatenated: one ``[n, out_dim]`` table per node type on the mesh's
    first device, equal to
    :func:`~gnn_recsys_tpu_torch.train.full_batch.compute_embeddings` up to
    the order of sums.  Rows capped by ``max_fanout`` are read whole
    (:func:`~gnn_recsys_tpu_torch.graph.hetero.uncap`, which keeps a graph
    with none as it is: a caller that embeds one graph again can uncap it
    once).  The model, graph and features are copied once a distinct
    device."""
    # Imported here: the trainer's module imports this one.
    from gnn_recsys_tpu_torch.train.minibatch import compute_embeddings_minibatch

    graph = uncap(graph)
    devices = mesh.shard_devices(axis)
    at = next(model.parameters()).device
    replicas = _per_device(devices, lambda d: (
        model if at == d else copy.deepcopy(model).to(d), graph.to(d),
        {nt: x.to(d) for nt, x in features.items()}))
    splits = {nt: torch.arange(graph.num_nodes(nt)).tensor_split(len(devices))
              for nt in ntypes or graph.ntypes}
    parts = []
    for j, d in enumerate(devices):
        mdl, g, feats = replicas[d]
        ids = {nt: s[j] for nt, s in splits.items() if s[j].numel()}
        parts.append(compute_embeddings_minibatch(mdl, g, feats, node_batch_size=node_chunk,
                                                  fanouts=fanouts, device=d, ids=ids))
    home = devices[0]
    return {nt: torch.cat([p[nt].to(home) for p in parts if nt in p]) for nt in splits}
