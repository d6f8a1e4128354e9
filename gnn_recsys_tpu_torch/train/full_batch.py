"""The full-batch trainer (BASELINE config[0]), parameter init, the
optimizer state, and full-graph embedding inference.

Port of ``gnn_recsys_tpu/train/full_batch.py``.  The full-batch mode treats
all training edges as one batch: one step draws uniform negatives per
positive edge, masks false negatives against the full (train + valid) edge
set, runs the full-graph forward and scores every pair, and applies the
max-margin loss and one Adam update (reference ``src/train/run.py:83-139``,
``src/sampling.py:163-165``, ``src/model.py:526-531``).

``TrainState`` holds ``torch.optim.Adam`` (optax's ``adam``) and,
optionally, the cosine schedule; the host training loops step it eagerly,
and the minibatch trainer's device-epoch route switches it to Adam's
capturable form so that a CUDA graph replays the whole step, update
included.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from gnn_recsys_tpu_torch.graph.hetero import CanonicalEtype, HeteroGraph
from gnn_recsys_tpu_torch.models.conv_model import ConvModel
from gnn_recsys_tpu_torch.models.loss import max_margin_loss
from gnn_recsys_tpu_torch.ops.membership import build_padded_pair_set, pair_set_contains
from gnn_recsys_tpu_torch.ops.negative import uniform_negative_dst
from gnn_recsys_tpu_torch.ops.sampling import Draws
from gnn_recsys_tpu_torch.retrieval.metrics import get_metrics_at_k
from gnn_recsys_tpu_torch.retrieval.recs import model_score_fn
from gnn_recsys_tpu_torch.utils.profiling import to_device


@dataclasses.dataclass
class FullBatchConfig:
    """The full-batch trainer's settings (the JAX package's defaults)."""

    delta: float = 0.266
    neg_sample_size: int = 63
    lr: float = 1e-3
    num_epochs: int = 100
    remove_false_negative: bool = True
    use_recency: bool = False
    k: int = 10
    eval_every: int = 10
    patience: int = 5
    seed: int = 11


def init_model(model: ConvModel, seed: int = 0) -> Dict[str, torch.Tensor]:
    """Draw every parameter (every (layer, etype) pair, as the JAX package's
    schema-complete init, and the MLP head of ``pred='nn'``) from a CPU
    ``torch.Generator`` seeded ``seed``, so the values do not depend on
    where the model lives; returns the model's state_dict.  Parameter shapes
    do not depend on the graph."""
    dev = next(model.parameters()).device
    model.to("cpu").reset_parameters(torch.Generator().manual_seed(seed))
    model.to(dev)
    return model.state_dict()


@dataclasses.dataclass
class TrainState:
    """The model, its Adam optimizer and the number of updates applied.

    optax's ``adam`` and ``torch.optim.Adam`` apply the same update,
    ``lr * m_hat / (sqrt(v_hat) + eps)`` with eps outside the square root
    (b1 0.9, b2 0.999, eps 1e-8).  Unlike flax's immutable state, this one
    updates the model's parameters in place.  An update has a device half,
    Adam's step, and a host half (:meth:`advance`): the schedule, which
    writes a Python float ``lr``, and the count.  A CUDA graph of the
    training step (``train/graph_step.py``) captures the device half in
    Adam's capturable form (:meth:`make_capturable`), its learning rate read
    from a device tensor filled before each replay; the host half runs after
    each replay."""

    model: ConvModel
    tx: torch.optim.Optimizer
    schedule: Optional[torch.optim.lr_scheduler.LRScheduler] = None
    step: int = 0

    @classmethod
    def create(cls, model: ConvModel, lr: float = 1e-3,
               decay_steps: Optional[int] = None) -> "TrainState":
        """Adam at ``lr``; with ``decay_steps``, decayed to 0 over that many
        updates (the values of optax's ``cosine_decay_schedule``, alpha 0,
        up to ``decay_steps``)."""
        tx = torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8)
        schedule = None
        if decay_steps is not None:
            schedule = torch.optim.lr_scheduler.CosineAnnealingLR(
                tx, T_max=max(1, decay_steps), eta_min=0.0)
        return cls(model=model, tx=tx, schedule=schedule)

    def apply_gradients(self) -> None:
        """One update from the gradients in the parameters' ``.grad``."""
        self.tx.step()
        self.advance()

    def advance(self) -> None:
        """The host half of an update: the schedule's next ``lr`` and the count."""
        if self.schedule is not None:
            self.schedule.step()
        self.step += 1

    def make_capturable(self) -> None:
        """Switch Adam to its capturable form (``capturable=True``: its
        update counts live on the parameters' device, so a CUDA graph can
        capture its step); the update it applies is the same."""
        for group in self.tx.param_groups:
            group["capturable"] = True
        for p, st in self.tx.state.items():
            if torch.is_tensor(st.get("step")):
                st["step"] = st["step"].to(p.device, torch.float32)


def compute_embeddings(
    model: ConvModel,
    graph: HeteroGraph,
    features: Dict[str, torch.Tensor],
    device=None,
) -> Dict[str, torch.Tensor]:
    """Embeddings of every node in one layer-wise pass over the whole graph
    (reference ``get_embeddings``, src/train/run.py:311-349), in eval mode
    and without autograd.

    ``device``: where to run; by default the device of ``features``.  The
    graph and features are moved there; the model must already live there.
    """
    dev = torch.device(device) if device is not None else next(iter(features.values())).device
    graph = graph.to(dev)
    features = {nt: to_device(x, dev) for nt, x in features.items()}
    was_training = model.training
    model.eval()
    try:
        with torch.no_grad():
            return model(graph, features)
    finally:
        model.train(was_training)


def make_full_batch_step(model: ConvModel, cfg: FullBatchConfig,
                         train_etypes: Tuple[CanonicalEtype, ...]) -> Callable:
    """``(state, graph, features, pos_pairs, edge_tables, recency, draws) ->
    (state, loss)``: one full-batch update (``full_batch.py:98-142``).

    pos_pairs: etype -> (user ids [B], item ids [B]) of every training edge;
    edge_tables: etype -> the full edge set's ``PaddedPairSet``; recency:
    etype -> [B] divisors (used with ``cfg.use_recency``).  The negatives'
    ints come from ``draws``, one ``randint`` of [B, S] per etype in
    ``train_etypes`` order (JAX's key order).  The forward runs in train
    mode (dropout), then one Adam update of ``state`` in place."""

    def step(state: TrainState, graph, features, pos_pairs, edge_tables, recency, draws):
        num_items = graph.num_nodes("item")
        neg_pairs, neg_mask = {}, {}
        for et in train_etypes:
            pos_u = pos_pairs[et][0]
            neg_pairs[et] = uniform_negative_dst(draws, pos_u, num_items, cfg.neg_sample_size)
            if cfg.remove_false_negative:
                neg_mask[et] = pair_set_contains(edge_tables[et], pos_u,
                                                 neg_pairs[et][1]).float()
        model.train()
        state.tx.zero_grad(set_to_none=True)
        _, pos_s, neg_s = model.full_pass(graph, features, pos_pairs, neg_pairs)
        loss = max_margin_loss(pos_s, neg_s, delta=cfg.delta,
                               negative_mask=neg_mask if cfg.remove_false_negative else None,
                               recency_scores=recency if cfg.use_recency else None)
        loss.backward()
        state.apply_gradients()
        return state, loss.detach()

    return step


def full_batch_inputs(data_graph: HeteroGraph, full_graph: HeteroGraph,
                      features: Dict[str, torch.Tensor],
                      train_pairs: Dict[CanonicalEtype, Tuple[np.ndarray, np.ndarray]],
                      device) -> tuple:
    """What a full-batch step takes besides its state and draws, on
    ``device``: (graph, features, pos_pairs, edge_tables, recency).  The
    positives are every training pair; false negatives are masked against
    the full (train + valid) edge set (the reference's valid_graph query,
    run.py:100); recency comes from the message-passing graph's edges."""
    dev = torch.device(device)
    graph = data_graph.to(dev)
    pos_pairs = {et: (torch.as_tensor(np.asarray(u), dtype=torch.int64, device=dev),
                      torch.as_tensor(np.asarray(i), dtype=torch.int64, device=dev))
                 for et, (u, i) in train_pairs.items()}
    num_users = full_graph.num_nodes("user")
    edge_tables = {et: build_padded_pair_set(full_graph.rels[et].src.cpu().numpy(),
                                             full_graph.rels[et].dst.cpu().numpy(),
                                             num_src=num_users).to(dev)
                   for et in train_pairs}
    recency = {et: graph.rels[et].edata["recency"] for et in train_pairs
               if "recency" in graph.rels[et].edata}
    return (graph, {nt: x.to(dev) for nt, x in features.items()}, pos_pairs, edge_tables,
            recency)


def train_full_batch(
    model: ConvModel,
    data_graph: HeteroGraph,
    full_graph: HeteroGraph,
    features: Dict[str, torch.Tensor],
    train_pairs: Dict[CanonicalEtype, Tuple[np.ndarray, np.ndarray]],
    test_ground_truth: Tuple[np.ndarray, np.ndarray],
    cfg: FullBatchConfig,
    already_bought: Optional[Tuple[np.ndarray, np.ndarray]] = None,
    verbose: bool = False,
    state: Optional[TrainState] = None,
    draws=None,
    device="cuda",
):
    """Train on all edges each step on ``device``; returns (state, history)
    (``full_batch.py:162-254``).

    ``data_graph`` is the message-passing graph (train edges);
    ``full_graph`` gives the edge set that false negatives are masked
    against (the reference masks against the train + valid graph,
    run.py:100).  Without ``state`` the parameters are drawn from
    ``cfg.seed``; ``draws`` (a ``Draws`` on ``device`` seeded ``cfg.seed``
    by default) gives every epoch's negatives in turn.  Evaluation (recall@k
    with the model's own predictor) runs every ``cfg.eval_every`` epochs
    (0: never) and at the last epoch; training stops once recall has not
    improved for ``cfg.patience`` evaluations' worth of epochs.  History:
    loss, recall, precision, coverage and epoch_time (host seconds of the
    step, which ends in reading the loss)."""
    dev = torch.device(device)
    model.to(dev)
    if state is None:
        init_model(model, seed=cfg.seed)
        state = TrainState.create(model, lr=cfg.lr)
    if draws is None:
        draws = Draws(torch.Generator(device=dev).manual_seed(cfg.seed))
    step_fn = make_full_batch_step(model, cfg, tuple(train_pairs))
    graph, feats, pos_pairs, edge_tables, recency = full_batch_inputs(
        data_graph, full_graph, features, train_pairs, dev)

    history = {"loss": [], "recall": [], "precision": [], "coverage": [], "epoch_time": []}
    best_recall, best_epoch = -1.0, -1
    for epoch in range(cfg.num_epochs):
        t0 = time.perf_counter()
        state, loss = step_fn(state, graph, feats, pos_pairs, edge_tables, recency, draws)
        loss = float(loss)
        history["loss"].append(loss)
        history["epoch_time"].append(time.perf_counter() - t0)
        # eval_every=0 turns the cadence off; the last epoch always evaluates.
        if (cfg.eval_every and epoch % cfg.eval_every == cfg.eval_every - 1) \
                or epoch == cfg.num_epochs - 1:
            h = compute_embeddings(model, graph, feats, device=dev)
            precision, recall, coverage = get_metrics_at_k(
                h["user"], h["item"], test_ground_truth, already_bought, cfg.k,
                score_fn=model_score_fn(model.pred, model), device=dev)
            history["recall"].append(recall)
            history["precision"].append(precision)
            history["coverage"].append(coverage)
            if verbose:
                print(f"epoch {epoch}: loss={loss:.4f} recall@{cfg.k}={recall:.4f} "
                      f"precision={precision:.4f} coverage={coverage:.4f}")
            if recall > best_recall:
                best_recall, best_epoch = recall, epoch
            elif epoch - best_epoch >= cfg.patience * cfg.eval_every:
                break
    return state, history
