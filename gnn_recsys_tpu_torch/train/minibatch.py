"""Minibatch training over sampled neighbour trees, and embedding inference.

Port of ``gnn_recsys_tpu/train/minibatch.py``.  One step samples a negative
pool, expands sampled trees around the batch's users, items and pool items
(excluding the batch's edges and their reverses from the neighbourhoods),
scores positives and negatives, masks false negatives, and takes the loss
and an Adam update.  Every random number of a step comes from one draw
source (:class:`~gnn_recsys_tpu_torch.ops.sampling.Draws`), so a step can be
replayed with given numbers.

Semantics kept from the JAX package (and the reference loop,
``src/train/run.py:11-308``): epoch 0 is a loss-only pass over at most 10
batches; a validation-loss pass per epoch over held-out edges sampled on the
train graph; precision / recall / coverage every ``metrics_every`` epochs
(``epoch % metrics_every == 1``); early stopping on validation loss.

Two routes drive the same step (``MinibatchConfig.device_epoch``):

* the device epochs (the default, as in the JAX package): each epoch's edges
  are permuted and sliced on the device (:func:`make_epoch_fns`,
  :func:`run_device_epoch`).  On a CUDA device each step is one replay of a
  CUDA graph of the whole step, slicing, sampling, forward, loss, backward
  and Adam's update (``train/graph_step.py``), and the host reads the losses
  once an epoch; on the CPU the same body runs eagerly;
* the host loop (``device_epoch=False``): numpy permutes and slices each
  epoch, and every batch is copied to the device (:class:`EdgeStore`).
"""

from __future__ import annotations

import dataclasses
import time
import weakref
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from gnn_recsys_tpu_torch.graph.hetero import CanonicalEtype, HeteroGraph
from gnn_recsys_tpu_torch.models.conv_model import ConvModel
from gnn_recsys_tpu_torch.models.loss import max_margin_loss, sampled_softmax_loss
from gnn_recsys_tpu_torch.ops.membership import (
    build_padded_pair_set,
    pair_set_contains,
    pair_set_contains_pool,
)
from gnn_recsys_tpu_torch.ops.sampling import Draws, _rows
from gnn_recsys_tpu_torch.retrieval.metrics import get_metrics_at_k
from gnn_recsys_tpu_torch.retrieval.recs import model_score_fn
from gnn_recsys_tpu_torch.retrieval.sharded import infer_embeddings_sharded
from gnn_recsys_tpu_torch.train.full_batch import TrainState, compute_embeddings, init_model
from gnn_recsys_tpu_torch.utils.profiling import (ThroughputMeter, profiler_trace, span,
                                                 to_device)

# Reference reverse-etype names (src/utils_data.py:96-99).
REVERSE_NAMES = {
    "buys": "bought-by",
    "bought-by": "buys",
    "clicks": "clicked-by",
    "clicked-by": "clicks",
    "practices": "practiced-by",
    "practiced-by": "practices",
    "utilized-for": "utilizes",
    "utilizes": "utilized-for",
    "belongs-to": "includes",
    "includes": "belongs-to",
}

NEG_MODES = ("shared_pool", "per_edge", "dense_pool")


@dataclasses.dataclass
class MinibatchConfig:
    """Hyperparameters of the minibatch regime (the JAX package's
    ``MinibatchConfig``; reference defaults main.py:485-511)."""

    edge_batch_size: int = 2048
    fanouts: Tuple[int, ...] = (-1, -1)  # -1 = the full padded neighbour row
    neg_sample_size: int = 63
    # 'shared_pool': S uniform picks per positive from one uniform pool;
    # 'per_edge': S independent draws per positive (the reference's);
    # 'dense_pool': every positive scores the whole pool, one [B, P] product.
    neg_mode: str = "shared_pool"
    neg_pool_size: int = 1024
    # The dense-pool false-negative mask through the pool_membership_mask
    # kernel (its plain version for CPU tensors).
    pool_mask_kernel: bool = False
    delta: float = 0.266
    loss: str = "max_margin"  # or 'sampled_softmax'
    softmax_tau: float = 0.1
    lr: float = 1e-3
    lr_schedule: str = "const"  # or 'cosine' (decay to 0 over the run)
    num_epochs: int = 50
    remove_false_negative: bool = True
    use_recency: bool = False
    exclude_batch_edges: bool = True
    # The step's forward as the dedup'd block forward (each level's unique
    # nodes once) instead of the tree; embedding inference stays on the tree.
    dedup: bool = False
    # Epochs permuted and sliced on the device, each step one replay of a
    # CUDA graph on a CUDA device (the JAX package's one-dispatch epochs);
    # False: the host loop.
    device_epoch: bool = True
    # Steps between the host's checkpoints in a device epoch (the JAX
    # package's scan chunk).  The permutation is drawn once an epoch, so
    # chunking does not change which batches an epoch visits.
    epoch_chunk_steps: int = 16
    k: int = 10
    metrics_every: int = 10  # reference: epoch % 10 == 1
    patience: int = 3
    seed: int = 11
    inference_mode: str = "full_graph"  # or 'node_batches'


def _per_etype_batch_sizes(
    counts: Dict[CanonicalEtype, int], batch_size: int, round_to: int = 1
) -> Tuple[Dict[CanonicalEtype, int], int]:
    """Per-etype slice widths (proportional to the etype's edge count,
    rounded up to ``round_to``) and the number of batches per epoch."""
    total = sum(counts.values())
    per_et = {
        et: max(round_to, int(np.ceil(
            max(1, round(batch_size * counts[et] / max(total, 1))) / round_to)) * round_to)
        for et in counts
    }
    return per_et, max(1, int(np.ceil(total / batch_size)))


def iter_edge_batches(rng: np.random.Generator, eids: Dict[CanonicalEtype, np.ndarray],
                      batch_size: int, round_to: int = 1):
    """Proportional per-etype slices of a shuffled epoch, wrapping at the end
    so every batch has the same shapes."""
    counts = {et: len(v) for et, v in eids.items()}
    per_et, n_batches = _per_etype_batch_sizes(counts, batch_size, round_to)
    perms = {et: rng.permutation(eids[et]) for et in eids}
    for b in range(n_batches):
        yield {et: perms[et][np.arange(b * n, (b + 1) * n) % max(counts[et], 1)]
               for et, n in per_et.items()}


def _reverse(et: CanonicalEtype) -> CanonicalEtype:
    return (et[2], REVERSE_NAMES.get(et[1], et[1]), et[0])


def draw_negatives(cfg: MinibatchConfig, train_etypes: Tuple[CanonicalEtype, ...],
                   sizes: Dict[CanonicalEtype, int], num_items: int, draws, device):
    """The step's negatives (``minibatch.py:239-273``): the pool (``per_edge``:
    every positive's own ``neg_sample_size`` draws, etype after etype) and,
    per etype, the positives' indices into it ([B, S]; None for the dense
    pool, which every positive scores whole).  Draw order: the pool, then the
    shared-pool picks etype by etype."""
    if cfg.neg_mode not in NEG_MODES:
        raise KeyError(f"unknown neg_mode {cfg.neg_mode!r}")
    if cfg.neg_mode == "per_edge":
        pool = draws.randint((sum(sizes.values()) * cfg.neg_sample_size,), num_items)
    else:
        pool = draws.randint((cfg.neg_pool_size,), num_items)
    neg_idx, offset = {}, 0
    for et in train_etypes:
        b = sizes[et]
        if cfg.neg_mode == "dense_pool":
            neg_idx[et] = None
        elif cfg.neg_mode == "shared_pool":
            neg_idx[et] = draws.randint((b, cfg.neg_sample_size), cfg.neg_pool_size)
        else:
            s = cfg.neg_sample_size
            neg_idx[et] = torch.arange(offset, offset + b * s, device=device).reshape(b, s)
            offset += b * s
    return pool, neg_idx


def scored_loss(cfg: MinibatchConfig, train_etypes: Tuple[CanonicalEtype, ...], batch, pool,
                scores, edge_tables, parts: bool = False):
    """The loss of :meth:`ConvModel.minibatch_forward`'s ``scores`` (pos,
    neg, neg_dst): false negatives masked against ``edge_tables``, the
    positives' recency where ``cfg.use_recency``.  ``parts``: the mean's
    ``(total, count)`` (``models/loss.py``)."""
    pos_s, neg_s, neg_dst = scores
    users = {et: batch[et]["u"] for et in train_etypes}
    neg_mask = None
    if cfg.remove_false_negative:
        if cfg.neg_mode == "dense_pool":  # every positive probes the same pool
            neg_mask = {et: pair_set_contains_pool(edge_tables[et], users[et], pool,
                                                   use_kernel=cfg.pool_mask_kernel)
                        for et in train_etypes}
        else:
            neg_mask = {et: pair_set_contains(edge_tables[et], users[et], neg_dst[et]).float()
                        for et in train_etypes}
    recency = ({et: batch[et]["recency"] for et in train_etypes} if cfg.use_recency else None)
    if cfg.loss == "sampled_softmax":
        return sampled_softmax_loss(pos_s, neg_s, tau=cfg.softmax_tau, negative_mask=neg_mask,
                                    recency_scores=recency, parts=parts)
    return max_margin_loss(pos_s, neg_s, delta=cfg.delta, negative_mask=neg_mask,
                           recency_scores=recency, parts=parts)


def batch_exclusion(batch, train_etypes, has_reverse) -> Dict:
    """etype -> the batch's edge ids to keep out of the neighbourhoods: each
    training etype's own, and its reverse's (reverse relations share edge
    ids)."""
    exclude = {}
    for et in train_etypes:
        exclude[et] = batch[et]["eids"]
        if has_reverse[et]:
            exclude[_reverse(et)] = batch[et]["eids"]
    return exclude


def make_minibatch_loss(model: ConvModel, cfg: MinibatchConfig,
                        train_etypes: Tuple[CanonicalEtype, ...], with_exclusion: bool,
                        has_reverse: Dict[CanonicalEtype, bool], feature_lookup=None,
                        neighbor_sample=None) -> Callable:
    """The step's loss: ``(graph, features, batch, edge_tables, draws) ->
    loss``, where batch maps etype -> dict of 'u' [B], 'i' [B], 'recency'
    [B] and (with exclusion) 'eids' [B] edge ids of the sampling graph, and
    ``edge_tables`` maps etype -> the full edge set's
    :class:`~gnn_recsys_tpu_torch.ops.membership.PaddedPairSet` (on the
    graph's device).  Draw order: the pool, the shared-pool picks per
    etype, then the tree walk (``minibatch.py:221-329``).  The hooks go to
    the tree forward (:meth:`ConvModel.sampled_repr`)."""
    if cfg.loss not in ("max_margin", "sampled_softmax"):
        raise KeyError(f"unknown loss {cfg.loss!r} (expected 'max_margin' or 'sampled_softmax')")
    if cfg.neg_mode not in NEG_MODES:
        raise KeyError(f"unknown neg_mode {cfg.neg_mode!r}")

    def loss_fn(graph, features, batch, edge_tables, draws) -> torch.Tensor:
        pairs = {et: (batch[et]["u"], batch[et]["i"]) for et in train_etypes}
        exclude = batch_exclusion(batch, train_etypes, has_reverse) if with_exclusion else None
        pool, neg_idx = draw_negatives(
            cfg, train_etypes, {et: int(pairs[et][0].shape[0]) for et in train_etypes},
            graph.num_nodes("item"), draws, pairs[train_etypes[0]][0].device)
        scores = model.minibatch_forward(
            graph, features, pairs, pool, neg_idx, cfg.fanouts, draws,
            exclude_eids=exclude, dedup=cfg.dedup, feature_lookup=feature_lookup,
            neighbor_sample=neighbor_sample)
        return scored_loss(cfg, train_etypes, batch, pool, scores, edge_tables)

    return loss_fn


def make_minibatch_step(model: ConvModel, cfg: MinibatchConfig,
                        train_etypes: Tuple[CanonicalEtype, ...], with_update: bool,
                        with_exclusion: bool, has_reverse: Dict[CanonicalEtype, bool],
                        feature_lookup=None, neighbor_sample=None) -> Callable:
    """``(state, graph, features, batch, edge_tables, draws) -> (state,
    loss)``: the loss of :func:`make_minibatch_loss` and, ``with_update``,
    its gradients and one optimizer update of ``state`` (in place).  Without
    update the model runs in eval mode (no dropout) and without autograd.
    ``feature_lookup`` / ``neighbor_sample``: the tree forward's hooks
    (``minibatch.py:207-208``)."""
    loss_fn = make_minibatch_loss(model, cfg, train_etypes, with_exclusion, has_reverse,
                                  feature_lookup, neighbor_sample)

    def step(state: TrainState, graph, features, batch, edge_tables, draws):
        model.train(with_update)
        if not with_update:
            with torch.no_grad():
                return state, loss_fn(graph, features, batch, edge_tables, draws)
        state.tx.zero_grad(set_to_none=True)
        loss = loss_fn(graph, features, batch, edge_tables, draws)
        loss.backward()
        state.apply_gradients()
        return state, loss.detach()

    return step


def _epoch_seed(seed: int, tag: int, epoch: int) -> int:
    """Seed of one epoch's draw stream (tag 0 train, 1 validation): a
    function of (seed, tag, epoch) alone, so a resumed run sees the same
    numbers."""
    return int(np.random.SeedSequence((seed, tag, epoch)).generate_state(1)[0])


class EdgeStore:
    """Host-side per-etype COO copies of a graph, sliced into batches."""

    def __init__(self, graph: HeteroGraph, etypes):
        rels = {et: graph.rels[et] for et in etypes}
        self.src = {et: r.src.cpu().numpy() for et, r in rels.items()}
        self.dst = {et: r.dst.cpu().numpy() for et, r in rels.items()}
        self.recency = {
            et: (r.edata["recency"].cpu().numpy() if "recency" in r.edata
                 else np.ones(r.num_edges, dtype=np.float32))
            for et, r in rels.items()
        }

    def batch(self, batch_np, with_eids: bool, dev) -> Dict:
        """etype -> edge ids  ->  etype -> 'u', 'i', 'recency' (and 'eids')
        tensors on ``dev``."""
        out = {}
        for et, eids in batch_np.items():
            d = {"u": torch.as_tensor(self.src[et][eids], dtype=torch.int64, device=dev),
                 "i": torch.as_tensor(self.dst[et][eids], dtype=torch.int64, device=dev),
                 "recency": torch.as_tensor(self.recency[et][eids], dtype=torch.float32,
                                            device=dev)}
            if with_eids:
                d["eids"] = torch.as_tensor(eids, dtype=torch.int64, device=dev)
            out[et] = d
        return out


def device_edge_store(graph: HeteroGraph, etypes, device) -> Dict:
    """Per etype, ``(src, dst, recency)`` on ``device``, indexed by edge id
    (int64, int64, f32; ones where the graph has no recency): what a device
    epoch slices its batches from (the JAX package's ``_dev_store``)."""
    out = {}
    for et in etypes:
        r = graph.rels[et]
        rec = r.edata["recency"] if "recency" in r.edata else torch.ones(r.num_edges)
        out[et] = (r.src.to(device, torch.int64), r.dst.to(device, torch.int64),
                   rec.to(device, torch.float32))
    return out


def make_epoch_fns(model: ConvModel, cfg: MinibatchConfig,
                   train_etypes: Tuple[CanonicalEtype, ...], with_update: bool,
                   with_exclusion: bool, has_reverse: Dict[CanonicalEtype, bool],
                   counts: Dict[CanonicalEtype, int],
                   capture: Optional[bool] = None, mesh=None) -> Tuple[Callable, Callable]:
    """Device epochs (``gnn_recsys_tpu/train/minibatch.py:363-461``).

    Returns ``(perm_fn, chunk_fn)``:

    * ``perm_fn(eids, generator) -> perms``: each etype's candidate edge ids
      (a device tensor) shuffled on the device, once an epoch;
    * ``chunk_fn(state, graph, features, edge_tables, store, perms, t0,
      draws, n_steps) -> (state, losses [n_steps])``: steps ``t0`` to
      ``t0 + n_steps - 1`` of the epoch.  ``store`` is
      :func:`device_edge_store`'s; step ``t`` takes, per etype, the edges
      ``perms[et][(t * n + arange(n)) % count]`` (n its slice width, as in
      :func:`iter_edge_batches`), and the step is
      :func:`make_minibatch_step`'s.

    ``capture`` (by default: whether ``draws`` are on a CUDA device) runs
    each step as one replay of a CUDA graph (:class:`~gnn_recsys_tpu_torch.
    train.graph_step.CapturedStep`), captured at the first call: later calls
    must pass the same state, graph, features, tables and store, and draws
    from the same generator (anything else raises).  The graph reads the
    permutation from its own buffers, which ``perm_fn`` then fills in place.
    Otherwise the same body runs eagerly, with any draw source (replayed
    draws too).  ``chunk_fn.captured`` is the :class:`CapturedStep`, once
    made.  A captured chunk takes at most an epoch's steps.

    Spans (:func:`~gnn_recsys_tpu_torch.utils.profiling.span`):
    ``gnn.train.permutation`` around ``perm_fn``, ``gnn.train.chunk``
    around ``chunk_fn`` (either route); none inside the step, which a graph
    would capture and its replays never run.

    ``mesh``: each step is :func:`~gnn_recsys_tpu_torch.parallel.sharded.
    make_gspmd_minibatch_step`'s over the mesh's data axis, the slice widths
    rounded up to the data extent (``minibatch.py:396-410``); the batch is
    sliced on the device of ``store`` and split by the step.  It is captured
    by default only where every entry of the mesh is one device."""
    if mesh is None:
        step = make_minibatch_step(model, cfg, train_etypes, with_update=with_update,
                                   with_exclusion=with_exclusion, has_reverse=has_reverse)
        round_to = 1
    else:
        from gnn_recsys_tpu_torch.parallel import distributed
        from gnn_recsys_tpu_torch.parallel.sharded import make_gspmd_minibatch_step

        step = make_gspmd_minibatch_step(model, cfg, train_etypes, mesh, with_update=with_update,
                                         with_exclusion=with_exclusion, has_reverse=has_reverse)
        axis = "data" if "data" in mesh.shape else mesh.axis_names[0]
        round_to = distributed.extent(mesh, axis)
        if capture is None and len(set(mesh.devices.flat)) > 1:
            capture = False
    per_et, n_batches = _per_etype_batch_sizes(counts, cfg.edge_batch_size, round_to)
    static: Dict = {}  # the captured route's step, its step index and losses

    def perm_fn(eids, generator):
        with span("gnn.train.permutation"):
            perms = {et: eids[et][torch.randperm(eids[et].shape[0], generator=generator,
                                                 device=eids[et].device)]
                     for et in train_etypes}
            if static:  # straight into the graph's buffers
                for et in train_etypes:
                    static["step"].fed[et].copy_(perms[et])
                return static["step"].fed
            return perms

    def batch_at(store, perms, t):
        """Step ``t``'s batch (``t`` an int or a 0-d device tensor)."""
        batch = {}
        for et in train_etypes:
            n = per_et[et]
            pos = (t * n + torch.arange(n, device=perms[et].device)) % max(counts[et], 1)
            eids = _rows(perms[et], pos)  # jnp.take(..., mode="clip")
            src, dst, recency = store[et]
            d = {"u": _rows(src, eids), "i": _rows(dst, eids), "recency": _rows(recency, eids)}
            if with_exclusion:
                d["eids"] = eids
            batch[et] = d
        return batch

    def capture_step(state, graph, features, edge_tables, store, perms, draws):
        from gnn_recsys_tpu_torch.train.graph_step import CapturedStep

        dev = draws.generator.device
        t = torch.zeros((), dtype=torch.int64, device=dev)
        losses = torch.zeros(n_batches, dtype=torch.float32, device=dev)
        buffers = {et: perms[et].clone() for et in train_etypes}

        def body(update, step_draws):
            _, loss = step(update, graph, features, batch_at(store, buffers, t), edge_tables,
                           step_draws)
            losses.index_copy_(0, (t % n_batches).reshape(1), loss.detach().reshape(1))
            t.add_(1)

        static.update(t=t, losses=losses, step=CapturedStep(
            body, draws, state if with_update else None,
            held=(state, graph, features, edge_tables, store), fed=buffers))
        chunk_ref().captured = static["step"]

    def chunk_fn(state, graph, features, edge_tables, store, perms, t0, draws, n_steps: int):
        with span("gnn.train.chunk"):
            on_graph = capture
            if on_graph is None:
                on_graph = isinstance(draws, Draws) and draws.device.type == "cuda"
            if not on_graph:
                losses = []
                for i in range(n_steps):
                    _, loss = step(state, graph, features, batch_at(store, perms, t0 + i),
                                   edge_tables, draws)
                    losses.append(loss)
                return state, torch.stack(losses)
            if not isinstance(draws, Draws):
                raise ValueError("a captured step draws from a torch.Generator (Draws), "
                                 f"not {type(draws).__name__}")
            if not static:
                capture_step(state, graph, features, edge_tables, store, perms, draws)
            static["step"].check((state, graph, features, edge_tables, store), draws.generator,
                                 perms)
            if n_steps > n_batches:
                raise ValueError(f"a captured chunk takes at most the epoch's {n_batches} steps, "
                                 f"not {n_steps}")
            static["t"].fill_(t0)
            for _ in range(n_steps):
                static["step"].replay()
            # Step t wrote its loss at t % n_batches.
            pos = torch.arange(t0, t0 + n_steps, device=static["t"].device) % n_batches
            return state, static["losses"][pos]

    chunk_fn.captured = None
    # A weak reference: a cycle between the two closures would keep the
    # graph and its memory pool alive until Python's cycle collector ran.
    chunk_ref = weakref.ref(chunk_fn)
    return perm_fn, chunk_fn


def run_device_epoch(perm_fn: Callable, chunk_fn: Callable, state, graph, features,
                     edge_tables, store, eids, generator: torch.Generator, seed: int,
                     n_batches: int, chunk_steps: int):
    """One epoch in ``ceil(n_batches / chunk_steps)`` chunks
    (``gnn_recsys_tpu/train/minibatch.py:464-496``): ``generator`` is seeded
    ``seed``, draws the epoch's permutation once, then every step's numbers,
    so the chunks together visit the batches of one unchunked epoch.
    Returns (state, the device losses [n_batches])."""
    generator.manual_seed(seed)
    perms = perm_fn(eids, generator)
    draws = Draws(generator)
    chunk = max(1, min(chunk_steps, n_batches))
    losses, t = [], 0
    while t < n_batches:
        n = min(chunk, n_batches - t)
        state, ls = chunk_fn(state, graph, features, edge_tables, store, perms, t, draws,
                             n_steps=n)
        losses.append(ls)
        t += n
    return state, torch.cat(losses)


def compute_embeddings_minibatch(model: ConvModel, graph: HeteroGraph,
                                 features: Dict[str, torch.Tensor], node_batch_size: int = 128,
                                 fanouts: Optional[Tuple[int, ...]] = None,
                                 ntypes: Optional[Tuple[str, ...]] = None,
                                 device=None, seed: int = 0,
                                 ids: Optional[Dict[str, torch.Tensor]] = None,
                                 ) -> Dict[str, torch.Tensor]:
    """Node-loader embedding inference (reference ``get_embeddings``,
    src/train/run.py:311-349): the sampled-tree forward over chunks of node
    ids, full fanouts by default, in eval mode and without autograd.
    ``device``: by default the device of ``features``.  ``ids``: the node
    ids to embed, by node type (by default every node of each of
    ``ntypes``); the output has a row for each, in their order."""
    dev = torch.device(device) if device is not None else next(iter(features.values())).device
    if fanouts is None:
        fanouts = (-1,) * model.num_conv_layers
    if ids is None:
        ids = {nt: torch.arange(graph.num_nodes(nt)) for nt in ntypes or graph.ntypes}
    graph = graph.to(dev)
    features = {nt: to_device(x, dev) for nt, x in features.items()}
    draws = Draws(torch.Generator(device=dev).manual_seed(seed))
    was_training = model.training
    model.eval()
    out = {}
    try:
        with torch.no_grad():
            for nt, nodes in ids.items():
                out[nt] = torch.cat([
                    model.sampled_repr(graph, features, {nt: chunk}, fanouts, draws)[nt]
                    for chunk in nodes.to(dev).split(max(1, node_batch_size))
                ])
    finally:
        model.train(was_training)
    return out


def infer_embeddings(
    model: ConvModel,
    graph: HeteroGraph,
    features: Dict[str, torch.Tensor],
    mode: str = "full_graph",
    node_batch_size: int = 128,
    ntypes: Optional[Tuple[str, ...]] = None,
    device=None,
    mesh=None,
) -> Dict[str, torch.Tensor]:
    """Embeddings of every node.  ``mode='full_graph'`` is one layer-wise
    pass over the whole graph (:func:`compute_embeddings`);
    ``'node_batches'`` the sampled-tree forward over node chunks
    (:func:`compute_embeddings_minibatch`).  With a ``mesh``, whatever
    ``mode`` says, the sampled-tree forward data-parallel over every device
    of the mesh, chunks of ``node_batch_size``
    (:func:`~gnn_recsys_tpu_torch.retrieval.sharded.infer_embeddings_sharded`;
    ``minibatch.py:563-572``)."""
    if mesh is not None:
        return infer_embeddings_sharded(model, graph, features, mesh,
                                        axis=tuple(a for a in ("data", "model")
                                                   if a in mesh.shape),
                                        node_chunk=node_batch_size, ntypes=ntypes)
    if mode == "full_graph":
        return compute_embeddings(model, graph, features, device=device)
    if mode == "node_batches":
        return compute_embeddings_minibatch(model, graph, features,
                                            node_batch_size=node_batch_size, ntypes=ntypes,
                                            device=device)
    raise ValueError(f"unknown inference mode {mode!r}")


def train_minibatch(
    model: ConvModel,
    train_graph: HeteroGraph,
    full_graph: HeteroGraph,
    features: Dict[str, torch.Tensor],
    train_eids: Dict[CanonicalEtype, np.ndarray],
    valid_eids: Optional[Dict[CanonicalEtype, np.ndarray]],
    cfg: MinibatchConfig,
    test_ground_truth: Optional[Tuple[np.ndarray, np.ndarray]] = None,
    subtrain_ground_truth: Optional[Tuple[np.ndarray, np.ndarray]] = None,
    already_bought: Optional[Tuple[np.ndarray, np.ndarray]] = None,
    verbose: bool = False,
    state: Optional[TrainState] = None,
    start_epoch: int = 0,
    device="cuda",
    host_edges: Optional[Dict] = None,
    profile_logdir: Optional[str] = None,
    mesh=None,
    row_shard_ntypes: Tuple[str, ...] = ("item",),
):
    """Run the training regime end to end on ``device``; returns (state,
    history).  ``train_eids`` index ``train_graph``'s relations,
    ``valid_eids`` ``full_graph``'s (held-out edges, sampled over the train
    graph).  False negatives are masked against the full graph's edges,
    whose pair sets are built from ``host_edges`` where it gives an etype
    (``{etype: (src, dst[, recency])}``, host numpy copies of the full
    graph's COO arrays; the JAX package's ``minibatch.py:671-676``) and
    otherwise from the graph's own arrays.  Without ``state`` the model's
    parameters are drawn from ``cfg.seed``.  Every epoch's draws and batch
    order are a function of (seed, epoch), so ``start_epoch`` with a saved
    ``state`` resumes exactly.  ``profile_logdir``: a ``torch.profiler``
    trace of the epochs is written there (:func:`~gnn_recsys_tpu_torch.
    utils.profiling.profiler_trace`).

    ``mesh`` (``minibatch.py:700-731``): every step is the single-device
    step over the mesh's data axis (:func:`~gnn_recsys_tpu_torch.parallel.
    sharded.make_gspmd_minibatch_step`: the same program and draws), each
    etype's batch rounded up to a multiple of the data extent, the feature
    tables of ``row_shard_ntypes`` split by rows over the ``model`` axis
    where there is one, the rest replicated; ``device`` is then the mesh's
    first device.  The kernel flags are refused there, as in the JAX
    package: kernels on a mesh run through the shard-map steps."""
    if mesh is not None:
        if getattr(model, "leaf_kernel", False) or cfg.pool_mask_kernel:
            raise ValueError(
                "Pallas kernel flags (ConvModel.leaf_kernel, MinibatchConfig.pool_mask_kernel) "
                "are not supported on the GSPMD mesh path: pallas_call is opaque to the "
                "auto-partitioner. Use make_shardmap_dp_step / make_shardmap_tp_dp_step "
                "(parallel/sharded.py), which run the kernels on per-device blocks, or "
                "disable the kernel flags.")
        device = mesh.first_device
    dev = torch.device(device)
    model.to(dev)
    if state is None:
        init_model(model, seed=cfg.seed)
        decay_steps = None
        if cfg.lr_schedule == "cosine":
            total = sum(len(v) for v in train_eids.values())
            decay_steps = cfg.num_epochs * max(1, int(np.ceil(total / cfg.edge_batch_size)))
        elif cfg.lr_schedule != "const":
            raise ValueError(f"unknown lr_schedule {cfg.lr_schedule!r}")
        state = TrainState.create(model, lr=cfg.lr, decay_steps=decay_steps)
    train_etypes = tuple(train_eids)
    valid_etypes = tuple(valid_eids) if valid_eids else ()
    has_reverse = {et: _reverse(et) in train_graph.rels for et in train_etypes}

    num_users = full_graph.num_nodes("user")

    def full_coo(et):
        if host_edges is not None and et in host_edges:
            return host_edges[et][0], host_edges[et][1]
        return full_graph.rels[et].src.cpu().numpy(), full_graph.rels[et].dst.cpu().numpy()

    edge_tables = {et: build_padded_pair_set(*full_coo(et), num_src=num_users).to(dev)
                   for et in set(train_etypes) | set(valid_etypes)}
    graph = train_graph.to(dev)
    feats = {nt: x.to(dev) for nt, x in features.items()}
    # What the steps read: the same, placed on the mesh where there is one.
    step_graph, step_feats, step_tables = graph, feats, edge_tables
    round_to = 1
    if mesh is not None:
        from gnn_recsys_tpu_torch.parallel import distributed
        from gnn_recsys_tpu_torch.parallel.sharded import make_gspmd_minibatch_step, shard_inputs

        axis = "data" if "data" in mesh.shape else mesh.axis_names[0]
        round_to = distributed.extent(mesh, axis)
        _, step_graph, step_feats, step_tables = shard_inputs(
            mesh, state, graph, feats, edge_tables,
            row_shard_ntypes=row_shard_ntypes if "model" in mesh.shape else ())

    if cfg.device_epoch:
        def epoch_pass(etypes, eids, with_update, with_exclusion, store_graph) -> Dict:
            counts = {et: len(eids[et]) for et in etypes}
            per_et, n_batches = _per_etype_batch_sizes(counts, cfg.edge_batch_size, round_to)
            return {"fns": make_epoch_fns(model, cfg, etypes, with_update, with_exclusion,
                                          has_reverse, counts, mesh=mesh),
                    "store": device_edge_store(store_graph, etypes, dev),
                    "eids": {et: torch.as_tensor(eids[et], dtype=torch.int64, device=dev)
                             for et in etypes},
                    "generator": torch.Generator(device=dev),
                    "width": sum(per_et.values()), "batches": n_batches}

        def run_pass(p, tag, epoch, n_batches):
            """One pass of ``n_batches`` steps: its device losses and edges."""
            _, losses = run_device_epoch(*p["fns"], state, step_graph, step_feats, step_tables,
                                         p["store"],
                                         p["eids"], p["generator"],
                                         _epoch_seed(cfg.seed, tag, epoch), n_batches,
                                         cfg.epoch_chunk_steps)
            return losses, n_batches * p["width"]

        train_pass = epoch_pass(train_etypes, train_eids, True, cfg.exclude_batch_edges,
                                train_graph)
        smoke_pass = epoch_pass(train_etypes, train_eids, False, cfg.exclude_batch_edges,
                                train_graph)
        if valid_eids:
            # Held-out pairs from the full graph, sampled over the train graph.
            valid_pass = epoch_pass(valid_etypes, valid_eids, False, False, full_graph)
    else:
        def step_fn(etypes, with_update, with_exclusion):
            if mesh is not None:
                return make_gspmd_minibatch_step(model, cfg, etypes, mesh,
                                                 with_update=with_update,
                                                 with_exclusion=with_exclusion,
                                                 has_reverse=has_reverse)
            return make_minibatch_step(model, cfg, etypes, with_update=with_update,
                                       with_exclusion=with_exclusion, has_reverse=has_reverse)

        train_step = step_fn(train_etypes, True, cfg.exclude_batch_edges)
        smoke_step = step_fn(train_etypes, False, cfg.exclude_batch_edges)
        valid_step = step_fn(valid_etypes, False, False)
        train_store = EdgeStore(train_graph, train_etypes)
        valid_store = EdgeStore(full_graph, valid_etypes)

        def draws_for(tag: int, epoch: int) -> Draws:
            return Draws(torch.Generator(device=dev).manual_seed(
                _epoch_seed(cfg.seed, tag, epoch)))

    history = {"train_loss": [], "valid_loss": [], "recall": [], "precision": [],
               "coverage": [], "subtrain_recall": [], "epoch_time": [], "edges_per_s": []}
    best_val, best_epoch = np.inf, 0
    meter = ThroughputMeter()
    with profiler_trace(profile_logdir):
        for epoch in range(start_epoch, cfg.num_epochs):
            t0 = time.perf_counter()
            meter.start()
            if cfg.device_epoch:
                if epoch == 0:  # the loss-only pass (run.py:136-142)
                    losses, epoch_edges = run_pass(smoke_pass, 0, epoch,
                                                   min(10, smoke_pass["batches"]))
                else:
                    losses, epoch_edges = run_pass(train_pass, 0, epoch, train_pass["batches"])
            else:
                host_rng = np.random.default_rng((cfg.seed, epoch))
                draws = draws_for(0, epoch)
                losses, epoch_edges = [], 0
                for bi, batch_np in enumerate(iter_edge_batches(host_rng, train_eids,
                                                                cfg.edge_batch_size, round_to)):
                    if epoch == 0 and bi >= 10:
                        break  # epoch-0 loss-only pass (run.py:136-142)
                    step = smoke_step if epoch == 0 else train_step
                    _, loss = step(state, step_graph, step_feats,
                                   train_store.batch(batch_np, True, dev), step_tables, draws)
                    losses.append(loss)
                    epoch_edges += sum(len(v) for v in batch_np.values())
                losses = torch.stack(losses)
            history["train_loss"].append(float(losses.mean()))  # the host's one read
            history["edges_per_s"].append(meter.stop(epoch_edges))

            val_loss = None
            if valid_eids:
                if cfg.device_epoch:
                    vlosses = run_pass(valid_pass, 1, epoch, valid_pass["batches"])[0]
                else:
                    draws = draws_for(1, epoch)
                    vlosses = torch.stack([
                        valid_step(state, step_graph, step_feats,
                                   valid_store.batch(b, False, dev), step_tables, draws)[1]
                        for b in iter_edge_batches(host_rng, valid_eids, cfg.edge_batch_size,
                                                   round_to)])
                val_loss = float(vlosses.mean())
                history["valid_loss"].append(val_loss)
            history["epoch_time"].append(time.perf_counter() - t0)

            if test_ground_truth is not None and cfg.metrics_every and \
                    epoch % cfg.metrics_every == 1:
                h = infer_embeddings(model, graph, feats, mode=cfg.inference_mode,
                                     ntypes=("user", "item"), device=dev)
                score_fn = model_score_fn(model.pred, model)
                precision, recall, coverage = get_metrics_at_k(
                    h["user"], h["item"], test_ground_truth, already_bought, cfg.k,
                    score_fn=score_fn, device=dev)
                history["recall"].append(recall)
                history["precision"].append(precision)
                history["coverage"].append(coverage)
                if subtrain_ground_truth is not None and len(subtrain_ground_truth[0]):
                    history["subtrain_recall"].append(get_metrics_at_k(
                        h["user"], h["item"], subtrain_ground_truth, already_bought, cfg.k,
                        score_fn=score_fn, device=dev)[1])
            if verbose:
                extra = f" recall@{cfg.k}={history['recall'][-1]:.4f}" if history["recall"] else ""
                print(f"epoch {epoch}: train_loss={history['train_loss'][-1]:.4f} "
                      f"val_loss={val_loss}{extra}")

            # Early stopping on validation loss (run.py:285-291).
            if val_loss is not None and epoch > 0:
                if val_loss < best_val:
                    best_val, best_epoch = val_loss, epoch
                elif epoch - best_epoch >= cfg.patience:
                    if verbose:
                        print(f"early stop at epoch {epoch}")
                    break
    return state, history
