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
(``epoch % metrics_every == 1``); early stopping on validation loss.  The JAX
package's ``device_epoch`` (its epochs as one device dispatch) has no
counterpart here: the host loop runs the same per-step math either way.
"""

from __future__ import annotations

import dataclasses
import time
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
from gnn_recsys_tpu_torch.ops.sampling import Draws
from gnn_recsys_tpu_torch.retrieval.metrics import get_metrics_at_k
from gnn_recsys_tpu_torch.retrieval.recs import model_score_fn
from gnn_recsys_tpu_torch.train.full_batch import TrainState, compute_embeddings, init_model

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
    # The JAX package's one-dispatch epochs; accepted and ignored (the host
    # loop runs the same per-step math).
    device_epoch: bool = True
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


def make_minibatch_loss(model: ConvModel, cfg: MinibatchConfig,
                        train_etypes: Tuple[CanonicalEtype, ...], with_exclusion: bool,
                        has_reverse: Dict[CanonicalEtype, bool]) -> Callable:
    """The step's loss: ``(graph, features, batch, edge_tables, draws) ->
    loss``, where batch maps etype -> dict of 'u' [B], 'i' [B], 'recency'
    [B] and (with exclusion) 'eids' [B] edge ids of the sampling graph, and
    ``edge_tables`` maps etype -> the full edge set's
    :class:`~gnn_recsys_tpu_torch.ops.membership.PaddedPairSet` (on the
    graph's device).  Draw order: the pool, the shared-pool picks per
    etype, then the tree walk (``minibatch.py:221-329``)."""
    if cfg.loss not in ("max_margin", "sampled_softmax"):
        raise KeyError(f"unknown loss {cfg.loss!r} (expected 'max_margin' or 'sampled_softmax')")
    if cfg.neg_mode not in NEG_MODES:
        raise KeyError(f"unknown neg_mode {cfg.neg_mode!r}")

    def loss_fn(graph, features, batch, edge_tables, draws) -> torch.Tensor:
        num_items = graph.num_nodes("item")
        pairs = {et: (batch[et]["u"], batch[et]["i"]) for et in train_etypes}
        exclude = None
        if with_exclusion:
            exclude = {}
            for et in train_etypes:
                exclude[et] = batch[et]["eids"]
                if has_reverse[et]:
                    exclude[_reverse(et)] = batch[et]["eids"]
        if cfg.neg_mode == "per_edge":  # the "pool" holds every drawn negative
            total = sum(int(pairs[et][0].shape[0]) for et in train_etypes)
            pool = draws.randint((total * cfg.neg_sample_size,), num_items)
        else:
            pool = draws.randint((cfg.neg_pool_size,), num_items)
        neg_idx, offset = {}, 0
        for et in train_etypes:
            b = int(pairs[et][0].shape[0])
            if cfg.neg_mode == "dense_pool":
                neg_idx[et] = None
            elif cfg.neg_mode == "shared_pool":
                neg_idx[et] = draws.randint((b, cfg.neg_sample_size), cfg.neg_pool_size)
            else:
                s = cfg.neg_sample_size
                neg_idx[et] = torch.arange(offset, offset + b * s,
                                           device=pool.device).reshape(b, s)
                offset += b * s
        pos_s, neg_s, neg_dst = model.minibatch_forward(
            graph, features, pairs, pool, neg_idx, cfg.fanouts, draws,
            exclude_eids=exclude, dedup=cfg.dedup)
        neg_mask = None
        if cfg.remove_false_negative:
            if cfg.neg_mode == "dense_pool":  # every positive probes the same pool
                neg_mask = {et: pair_set_contains_pool(edge_tables[et], pairs[et][0], pool,
                                                       use_kernel=cfg.pool_mask_kernel)
                            for et in train_etypes}
            else:
                neg_mask = {et: pair_set_contains(edge_tables[et], pairs[et][0],
                                                  neg_dst[et]).float()
                            for et in train_etypes}
        recency = ({et: batch[et]["recency"] for et in train_etypes}
                   if cfg.use_recency else None)
        if cfg.loss == "sampled_softmax":
            return sampled_softmax_loss(pos_s, neg_s, tau=cfg.softmax_tau,
                                        negative_mask=neg_mask, recency_scores=recency)
        return max_margin_loss(pos_s, neg_s, delta=cfg.delta, negative_mask=neg_mask,
                               recency_scores=recency)

    return loss_fn


def make_minibatch_step(model: ConvModel, cfg: MinibatchConfig,
                        train_etypes: Tuple[CanonicalEtype, ...], with_update: bool,
                        with_exclusion: bool, has_reverse: Dict[CanonicalEtype, bool]) -> Callable:
    """``(state, graph, features, batch, edge_tables, draws) -> (state,
    loss)``: the loss of :func:`make_minibatch_loss` and, ``with_update``,
    its gradients and one optimizer update of ``state`` (in place).  Without
    update the model runs in eval mode (no dropout) and without autograd."""
    loss_fn = make_minibatch_loss(model, cfg, train_etypes, with_exclusion, has_reverse)

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


def compute_embeddings_minibatch(model: ConvModel, graph: HeteroGraph,
                                 features: Dict[str, torch.Tensor], node_batch_size: int = 128,
                                 fanouts: Optional[Tuple[int, ...]] = None,
                                 ntypes: Optional[Tuple[str, ...]] = None,
                                 device=None, seed: int = 0) -> Dict[str, torch.Tensor]:
    """Node-loader embedding inference (reference ``get_embeddings``,
    src/train/run.py:311-349): the sampled-tree forward over chunks of node
    ids, full fanouts by default, in eval mode and without autograd.
    ``device``: by default the device of ``features``."""
    dev = torch.device(device) if device is not None else next(iter(features.values())).device
    if fanouts is None:
        fanouts = (-1,) * model.num_conv_layers
    graph = graph.to(dev)
    features = {nt: x.to(dev) for nt, x in features.items()}
    draws = Draws(torch.Generator(device=dev).manual_seed(seed))
    was_training = model.training
    model.eval()
    out = {}
    try:
        with torch.no_grad():
            for nt in ntypes or graph.ntypes:
                ids = torch.arange(graph.num_nodes(nt), device=dev)
                out[nt] = torch.cat([
                    model.sampled_repr(graph, features, {nt: chunk}, fanouts, draws)[nt]
                    for chunk in ids.split(max(1, node_batch_size))
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
) -> Dict[str, torch.Tensor]:
    """Embeddings of every node.  ``mode='full_graph'`` is one layer-wise
    pass over the whole graph (:func:`compute_embeddings`);
    ``'node_batches'`` the sampled-tree forward over node chunks
    (:func:`compute_embeddings_minibatch`)."""
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
):
    """Run the training regime end to end on ``device``; returns (state,
    history).  ``train_eids`` index ``train_graph``'s relations,
    ``valid_eids`` ``full_graph``'s (held-out edges, sampled over the train
    graph).  False negatives are masked against the full graph's edges.
    Without ``state`` the model's parameters are drawn from ``cfg.seed``.
    Every epoch's draws and batch order are a function of (seed, epoch), so
    ``start_epoch`` with a saved ``state`` resumes exactly."""
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

    def step_fn(etypes, with_update, with_exclusion):
        return make_minibatch_step(model, cfg, etypes, with_update=with_update,
                                   with_exclusion=with_exclusion, has_reverse=has_reverse)

    train_step = step_fn(train_etypes, True, cfg.exclude_batch_edges)
    smoke_step = step_fn(train_etypes, False, cfg.exclude_batch_edges)
    valid_step = step_fn(valid_etypes, False, False)
    train_store = EdgeStore(train_graph, train_etypes)
    valid_store = EdgeStore(full_graph, valid_etypes)
    num_users = full_graph.num_nodes("user")
    edge_tables = {
        et: build_padded_pair_set(full_graph.rels[et].src.cpu().numpy(),
                                  full_graph.rels[et].dst.cpu().numpy(),
                                  num_src=num_users).to(dev)
        for et in set(train_etypes) | set(valid_etypes)
    }
    graph = train_graph.to(dev)
    feats = {nt: x.to(dev) for nt, x in features.items()}

    def draws_for(tag: int, epoch: int) -> Draws:
        return Draws(torch.Generator(device=dev).manual_seed(_epoch_seed(cfg.seed, tag, epoch)))

    history = {"train_loss": [], "valid_loss": [], "recall": [], "precision": [],
               "coverage": [], "subtrain_recall": [], "epoch_time": [], "edges_per_s": []}
    best_val, best_epoch = np.inf, 0
    for epoch in range(start_epoch, cfg.num_epochs):
        t0 = time.perf_counter()
        host_rng = np.random.default_rng((cfg.seed, epoch))
        draws = draws_for(0, epoch)
        losses, epoch_edges = [], 0
        for bi, batch_np in enumerate(iter_edge_batches(host_rng, train_eids,
                                                        cfg.edge_batch_size)):
            if epoch == 0 and bi >= 10:
                break  # epoch-0 loss-only pass (run.py:136-142)
            step = smoke_step if epoch == 0 else train_step
            _, loss = step(state, graph, feats, train_store.batch(batch_np, True, dev),
                           edge_tables, draws)
            losses.append(loss)
            epoch_edges += sum(len(v) for v in batch_np.values())
        history["train_loss"].append(float(torch.stack(losses).mean()))
        elapsed = time.perf_counter() - t0
        history["edges_per_s"].append(epoch_edges / max(elapsed, 1e-9))

        val_loss = None
        if valid_eids:
            draws = draws_for(1, epoch)
            vlosses = [valid_step(state, graph, feats, valid_store.batch(b, False, dev),
                                  edge_tables, draws)[1]
                       for b in iter_edge_batches(host_rng, valid_eids, cfg.edge_batch_size)]
            val_loss = float(torch.stack(vlosses).mean())
            history["valid_loss"].append(val_loss)
        history["epoch_time"].append(time.perf_counter() - t0)

        if test_ground_truth is not None and cfg.metrics_every and \
                epoch % cfg.metrics_every == 1:
            h = infer_embeddings(model, graph, feats, mode=cfg.inference_mode,
                                 ntypes=("user", "item"), device=dev)
            score_fn = model_score_fn(model.pred)
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
