"""One search trial: its model, training config, and the trial itself on a
graph that is already built.

Port of ``gnn_recsys_tpu/trial.py``: the model-save thresholds,
:class:`TrialResult`, :func:`build_model`, :func:`minibatch_config`, and
:func:`run_trial_on_graph`, which is ``run_trial`` (JAX ``trial.py:133-409``)
from the split on (``:166-300``: split, model, config, packed leaf cache,
training, embeddings on the full graph, metrics, saving).  The start of
``run_trial``, the pandas ETL (``GraphData.from_dataframes`` /
``from_paths``), waits for the port's decision about pandas (ROADMAP.md,
queue 1); so do its in-loop inference evaluation and plots.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from gnn_recsys_tpu_torch.config import GENERAL, SPECIFIC, FixedParams, HyperParams
from gnn_recsys_tpu_torch.data.split import TrainValSplit, train_valid_split
from gnn_recsys_tpu_torch.graph.hetero import attach_leaf_features
from gnn_recsys_tpu_torch.models.conv_model import ConvModel
from gnn_recsys_tpu_torch.retrieval.metrics import get_metrics_at_k
from gnn_recsys_tpu_torch.retrieval.recs import model_score_fn
from gnn_recsys_tpu_torch.train.checkpoint import save_run
from gnn_recsys_tpu_torch.train.minibatch import (
    MinibatchConfig,
    TrainState,
    infer_embeddings,
    train_minibatch,
)

Pairs = Tuple[np.ndarray, np.ndarray]

# Model-save thresholds (reference main.py:404-405).
SAVE_THRESHOLDS = {SPECIFIC: 0.08, GENERAL: 0.20}


@dataclasses.dataclass
class TrialResult:
    recall: float
    precision: float
    coverage: float
    recall_purchase: float
    history: Dict
    train_time_s: float
    saved_to: Optional[str] = None
    # In-loop inference evaluation (reference main.py:418-436): the trained
    # weights' recall on a graph rebuilt with ``remove_on_inference`` user
    # sampling (fixed.run_inference > 0), and with 710-day windows
    # (run_inference > 1).
    inference_recall: Optional[float] = None
    inference_recall_all_users: Optional[float] = None


def build_model(graph_data, fixed: FixedParams, hyper: HyperParams,
                dtype: Optional[torch.dtype] = None) -> ConvModel:
    """The ConvModel of a trial (reference main.py:189-205); reads only
    ``graph_data.graph``.  Weights are drawn from the default seed."""
    g = graph_data.graph
    feat_dims = {nt: int(g.ndata[nt]["features"].shape[1]) for nt in g.ntypes
                 if "features" in g.ndata[nt]}
    dims = tuple(sorted({**feat_dims, "hidden": hyper.hidden_dim,
                         "out": hyper.out_dim}.items()))
    return ConvModel(
        canonical_etypes=g.canonical_etypes,
        dims=dims,
        n_layers=hyper.n_layers,
        norm=hyper.norm,
        dropout=hyper.dropout,
        aggregator_type=hyper.resolved_aggregator_type(fixed.duplicates),
        pred=fixed.pred,
        aggregator_hetero=hyper.aggregator_hetero,
        embedding_layer=hyper.embedding_layer,
        dtype=dtype,
        remat_levels=fixed.remat_levels,
    )


def minibatch_config(fixed: FixedParams, hyper: HyperParams, model: ConvModel,
                     neg_pool_size: int = 2048) -> MinibatchConfig:
    """The trial's :class:`MinibatchConfig` (JAX ``trial.py:93-130``)."""
    n_conv = model.num_conv_layers
    if fixed.neighbor_sampler == "full":
        fanouts = tuple([-1] * n_conv)
    else:  # 'partial' = fanout-1 sampler (reference sampling.py:158-159)
        fanouts = tuple([1] * n_conv)
    neg_sample_size = hyper.neg_sample_size
    if fixed.bucket_shapes:
        # One shape across HP points: the negative count rounded UP to a
        # multiple of 128 (never fewer negatives than asked).
        neg_sample_size = -(-neg_sample_size // 128) * 128
    # A full-neighbour tree grows as K^depth; from 3 conv layers the dedup'd
    # block forward bounds each level by the node count (DGL's blocks).
    dedup = fixed.neighbor_sampler == "full" and n_conv >= 3
    return MinibatchConfig(
        edge_batch_size=fixed.edge_batch_size,
        fanouts=fanouts,
        neg_sample_size=neg_sample_size,
        neg_mode="shared_pool",
        neg_pool_size=neg_pool_size,
        dedup=dedup,
        delta=hyper.delta,
        loss=hyper.loss,
        softmax_tau=hyper.softmax_tau,
        lr=hyper.lr,
        num_epochs=fixed.num_epochs,
        remove_false_negative=fixed.remove_false_negative,
        use_recency=hyper.use_recency,
        k=fixed.k,
        patience=fixed.patience,
    )


@dataclasses.dataclass
class TrialRun:
    """The parts of a trial as :func:`run_trial_on_graph` makes them, handed
    to its ``on_stage`` callback: the split (its train graph with the packed
    leaf cache under the full sampler), then the model, config and node
    features, then the training's state and history, then the embeddings."""
    split: TrainValSplit
    model: Optional[ConvModel] = None
    cfg: Optional[MinibatchConfig] = None
    features: Optional[Dict[str, torch.Tensor]] = None
    state: Optional[TrainState] = None
    history: Optional[Dict] = None
    embeddings: Optional[Dict[str, torch.Tensor]] = None


def trial_embeddings(model: ConvModel, graph, features, fixed: FixedParams,
                     device="cuda") -> Dict[str, torch.Tensor]:
    """User and item embeddings on the full graph (JAX ``trial.py:231-237``:
    the test-time message passing runs over the full graph, not the train
    graph)."""
    return infer_embeddings(model, graph, features, mode=fixed.inference_mode,
                            node_batch_size=fixed.node_batch_size, ntypes=("user", "item"),
                            device=device)


def trial_metrics(embeddings, model: ConvModel, ground_truth: Pairs, already_bought: Pairs,
                  fixed: FixedParams, hyper: HyperParams, popularity=None,
                  device="cuda") -> Tuple[float, float, float]:
    """(precision, recall, coverage) at ``fixed.k`` (JAX ``trial.py:238-250``),
    ranked with the popularity boost where ``hyper`` serves with it and
    ``popularity`` is given."""
    boost = hyper.serve_with_popularity_boost and popularity is not None
    return get_metrics_at_k(embeddings["user"], embeddings["item"], ground_truth,
                            already_bought, fixed.k, score_fn=model_score_fn(model.pred, model),
                            popularity=popularity if boost else None,
                            weight_popularity=hyper.weight_popularity, device=device)


def run_trial_on_graph(
    graph_data,
    ground_truth_test: Pairs,
    already_bought: Pairs,
    fixed: FixedParams,
    hyper: HyperParams,
    ground_truth_purchase_test: Optional[Pairs] = None,
    popularity=None,
    save_dir: Optional[str] = None,
    save_threshold: Optional[float] = None,
    dtype: Optional[torch.dtype] = None,
    neg_pool_size: int = 2048,
    max_fanout: Optional[int] = None,
    verbose: bool = False,
    device="cuda",
    on_stage: Optional[Callable[[str, TrialRun], None]] = None,
) -> TrialResult:
    """Split -> train -> test metrics on ``graph_data.graph`` (JAX
    ``run_trial:166-300``, after the ETL).  ``already_bought``: the purchase
    pairs, which recommendations leave out.  ``popularity``: each item's
    boost; None takes the item feature ``popularity`` of the graph where it
    has one, as ``run_trial`` does.  ``max_fanout``: the train graph's row
    cap; ``run_trial`` passes none, so its train graph is uncapped whatever
    cap built the full graph (a reference flaw, ROADMAP.md queue 3).
    ``on_stage(stage, run)`` is called with ``"split"``, ``"built"`` (model,
    config and features made; not trained), ``"trained"`` and
    ``"evaluated"`` (embeddings and metrics made)."""
    stage = on_stage or (lambda name, run: None)
    t0 = time.perf_counter()
    g = graph_data.graph
    run = TrialRun(split=train_valid_split(g, ground_truth_test, fixed,
                                           clicks_sample=hyper.clicks_sample,
                                           purchases_sample=hyper.purchases_sample,
                                           max_fanout=max_fanout))
    stage("split", run)
    run.model = model = build_model(graph_data, fixed, hyper, dtype=dtype)
    if fixed.bucket_shapes:
        # One compile key across HP points: each etype's eids cut DOWN to a
        # multiple of 256, dropping the oldest edges (eids are time-ordered).
        def _trunc(eids):
            return {et: v[len(v) % 256:] if len(v) >= 256 else v for et, v in eids.items()}

        run.split = dataclasses.replace(run.split, train_eids=_trunc(run.split.train_eids),
                                        valid_eids=_trunc(run.split.valid_eids))
    # A shared negative pool larger than the catalog is pure waste.
    run.cfg = minibatch_config(fixed, hyper, model,
                               neg_pool_size=min(neg_pool_size, g.num_nodes("item")))
    run.features = {nt: g.ndata[nt]["features"] for nt in g.ntypes
                    if "features" in g.ndata[nt]}
    if fixed.neighbor_sampler == "full":
        # The packed leaf cache: one contiguous [K*F] row a parent.
        run.split = dataclasses.replace(
            run.split, train_graph=attach_leaf_features(run.split.train_graph, run.features))
    stage("built", run)
    split = run.split
    run.state, run.history = train_minibatch(
        model, split.train_graph, g, run.features, split.train_eids, split.valid_eids, run.cfg,
        test_ground_truth=split.ground_truth_valid,
        subtrain_ground_truth=split.ground_truth_subtrain, already_bought=already_bought,
        verbose=verbose, start_epoch=fixed.start_epoch, device=device)
    stage("trained", run)

    h = run.embeddings = trial_embeddings(model, g, run.features, fixed, device)
    if popularity is None and "popularity" in g.ndata.get("item", {}):
        popularity = g.ndata["item"]["popularity"].reshape(-1)
    precision, recall, coverage = trial_metrics(h, model, ground_truth_test, already_bought,
                                                fixed, hyper, popularity, device)
    recall_purchase = 0.0
    if ground_truth_purchase_test is not None and len(ground_truth_purchase_test[0]):
        recall_purchase = trial_metrics(h, model, ground_truth_purchase_test, already_bought,
                                        fixed, hyper, popularity, device)[1]
    stage("evaluated", run)

    saved_to = None
    threshold = (save_threshold if save_threshold is not None
                 else SAVE_THRESHOLDS.get(fixed.item_id_type, 0.08))
    if save_dir is not None and recall > threshold:
        save_run(
            save_dir, model.state_dict(),
            model_kwargs={
                "canonical_etypes": [list(e) for e in model.canonical_etypes],
                "dims": [list(d) for d in model.dims],
                "n_layers": model.n_layers, "norm": model.norm, "dropout": model.dropout,
                "aggregator_type": model.aggregator_type, "pred": model.pred,
                "aggregator_hetero": model.aggregator_hetero,
                "embedding_layer": model.embedding_layer,
            },
            fixed_params=fixed, hyper_params=hyper, graph=g,
            extras={"user_embeddings": h["user"].cpu().numpy(),
                    "item_embeddings": h["item"].cpu().numpy(),
                    "already_bought": already_bought, "ground_truth_test": ground_truth_test,
                    "ground_truth_purchase_test": ground_truth_purchase_test})
        saved_to = save_dir
    return TrialResult(recall=recall, precision=precision, coverage=coverage,
                       recall_purchase=recall_purchase, history=run.history,
                       train_time_s=time.perf_counter() - t0, saved_to=saved_to)
