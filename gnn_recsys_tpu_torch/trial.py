"""One build / train / evaluate trial, the unit of work of the search and
training CLIs.

Port of ``gnn_recsys_tpu/trial.py``: the model-save thresholds,
:class:`TrialResult`, :func:`build_model`, :func:`minibatch_config`,
:func:`run_trial` (JAX ``trial.py:133-409``: the ETL, then the trial on the
built graph, then the in-loop inference evaluation, the qualitative checks
and the plots), and :func:`run_trial_on_graph`, its part from the split on
(``:166-300``: split, model, config, packed leaf cache, training, embeddings
on the full graph, metrics, saving).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from gnn_recsys_tpu_torch.config import (
    GENERAL,
    SPECIFIC,
    ColumnConfig,
    DataPaths,
    FixedParams,
    HyperParams,
)
from gnn_recsys_tpu_torch.data.etl import GraphData, raw_inputs
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
    # The trial's parts (:class:`TrialRun`): the trained model for
    # :func:`run_trial`'s inference evaluation and checks.
    run: Optional["TrialRun"] = dataclasses.field(default=None, repr=False, compare=False)


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
    to its ``on_stage`` callback: the built graph data and the split (its
    train graph with the packed leaf cache under the full sampler), then the
    model, config and node features, then the training's state and history,
    then the embeddings."""
    split: TrainValSplit
    graph_data: Any = None
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
    id_maps: Optional[Dict] = None,
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
    ``"evaluated"`` (embeddings and metrics made).  ``id_maps``: saved with
    the run (``id_maps.pkl``).  The result's ``run`` holds the trial's
    parts."""
    stage = on_stage or (lambda name, run: None)
    t0 = time.perf_counter()
    g = graph_data.graph
    run = TrialRun(split=train_valid_split(g, ground_truth_test, fixed,
                                           clicks_sample=hyper.clicks_sample,
                                           purchases_sample=hyper.purchases_sample,
                                           max_fanout=max_fanout), graph_data=graph_data)
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
            fixed_params=fixed, hyper_params=hyper, graph=g, id_maps=id_maps,
            extras={"user_embeddings": h["user"].cpu().numpy(),
                    "item_embeddings": h["item"].cpu().numpy(),
                    "already_bought": already_bought, "ground_truth_test": ground_truth_test,
                    "ground_truth_purchase_test": ground_truth_purchase_test})
        saved_to = save_dir
    return TrialResult(recall=recall, precision=precision, coverage=coverage,
                       recall_purchase=recall_purchase, history=run.history,
                       train_time_s=time.perf_counter() - t0, saved_to=saved_to, run=run)


def run_trial(
    fixed: FixedParams,
    hyper: HyperParams,
    paths: Optional[DataPaths] = None,
    dataframes: Optional[Dict] = None,
    save_dir: Optional[str] = None,
    save_threshold: Optional[float] = None,
    plots_dir: Optional[str] = None,
    dtype: Optional[torch.dtype] = None,
    neg_pool_size: int = 2048,
    verbose: bool = False,
    check_embedding: bool = False,
    device="cuda",
    on_stage: Optional[Callable[[str, TrialRun], None]] = None,
) -> TrialResult:
    """Build the data, train, evaluate (JAX ``trial.py:133-409``; reference
    main.py:42-447).  The graph comes from ``dataframes`` (the keyword
    arguments of :meth:`GraphData.from_dataframes`) or the files of
    ``paths``, built with ``fixed.max_fanout``; then
    :func:`run_trial_on_graph` with no row cap on the split, as JAX's
    ``run_trial`` (ROADMAP.md queue 3, flaw 1), saving ``id_maps`` with the
    run.  Then, by ``fixed.run_inference``, the recall of the trained
    weights on the graph rebuilt with ``remove_on_inference`` (1), and also
    with 710-day windows (2); with ``check_embedding``, example
    recommendations, similar sports and demographic coverage; with
    ``plots_dir``, the loss and metric curves.  ``device``: where the model
    trains, embeds and ranks.  ``on_stage``: :func:`run_trial_on_graph`'s
    stages, then ``"inference_evaluated"``."""
    t0 = time.perf_counter()
    inputs = dataframes if dataframes is not None else raw_inputs(paths)
    gd = GraphData.from_dataframes(fixed, use_recency=hyper.use_recency,
                                   use_popularity=hyper.use_popularity,
                                   days_popularity=hyper.days_popularity,
                                   max_fanout=fixed.max_fanout, **inputs)
    result = run_trial_on_graph(
        gd, gd.ground_truth_test, gd.already_bought, fixed, hyper,
        ground_truth_purchase_test=gd.ground_truth_purchase_test, save_dir=save_dir,
        save_threshold=save_threshold, dtype=dtype, neg_pool_size=neg_pool_size,
        verbose=verbose, device=device, on_stage=on_stage,
        id_maps={"ctm_id": gd.ctm_id, "pdt_id": gd.pdt_id, "spt_id": gd.spt_id})
    run = result.run

    # In-loop inference evaluation (reference main.py:418-436): the same
    # weights on the data rebuilt under the inference regime.
    if fixed.run_inference > 0:
        from gnn_recsys_tpu_torch.inference_eval import inference_fn

        result.inference_recall = inference_fn(
            run.model, fixed, hyper, inputs, remove_on_inference=fixed.remove_on_inference,
            device=device)[1]
        if verbose:
            print(f"inference eval (remove={fixed.remove_on_inference}): "
                  f"recall@{fixed.k}={result.inference_recall:.4f}")
        if fixed.run_inference > 1:
            # "For all users": 710-day windows (reference main.py:426-436).
            result.inference_recall_all_users = inference_fn(
                run.model, fixed, hyper, inputs, remove_on_inference=fixed.remove_on_inference,
                days_of_purchases=710, days_of_clicks=710, lifespan_of_items=710,
                device=device)[1]
            if verbose:
                print(f"inference eval (all users, 710-day windows): "
                      f"recall@{fixed.k}={result.inference_recall_all_users:.4f}")
        if on_stage is not None:
            on_stage("inference_evaluated", run)

    if check_embedding:
        _check_embedding(gd, run, fixed, device)

    if plots_dir is not None:
        from gnn_recsys_tpu_torch.utils.viz import plot_train_loss

        history = result.history
        hp_str = ", ".join(f"{k}={v}" for k, v in dataclasses.asdict(hyper).items())
        plot_train_loss(hp_str, {"train_loss_list": history["train_loss"],
                                 "loss_list": history["valid_loss"],
                                 "val_recall_list": history["recall"]}, out_dir=plots_dir)
    result.train_time_s = time.perf_counter() - t0
    return result


def _check_embedding(gd: GraphData, run: TrialRun, fixed: FixedParams, device) -> None:
    """Qualitative evaluation (JAX ``trial.py:336-386``, reference
    main.py:314-400): example recommendations, demographic coverage and
    similar sports."""
    from gnn_recsys_tpu_torch.evaluation.explore import (
        check_coverage,
        explore_recs,
        explore_sports,
    )
    from gnn_recsys_tpu_torch.ops.membership import build_padded_pair_set
    from gnn_recsys_tpu_torch.retrieval.recs import get_recs

    item_col = ColumnConfig().item_id(fixed.item_id_type)
    h, model = run.embeddings, run.model
    user_ids = np.unique(np.asarray(gd.ground_truth_test[0]))[: fixed.num_choices * 4]
    if len(user_ids):
        bought = gd.already_bought
        ab_set = build_padded_pair_set(bought[0], bought[1], num_src=gd.num_nodes["user"])
        recs = get_recs(h["user"], h["item"], user_ids.astype(np.int64), fixed.k,
                        already_bought=ab_set, score_fn=model_score_fn(model.pred, model),
                        device=device).cpu().numpy()
        recs_dict = {int(u): row.tolist() for u, row in zip(user_ids, recs)}
        gt_dict: Dict[int, list] = {}
        for u, i in zip(*gd.ground_truth_test):
            gt_dict.setdefault(int(u), []).append(int(i))
        explore_recs(recs_dict, gd.user_item_train_grouped, gd.item_feat_df, gd.pdt_id,
                     gd.ctm_id, ground_truth=gt_dict, num_choices=fixed.num_choices,
                     item_id_type=item_col)
        if gd.item_feat_df is not None:
            check_coverage(gd.user_item_train_grouped, gd.item_feat_df, gd.pdt_id, recs_dict,
                           item_id_type=item_col)
    g = gd.graph
    if "sport" in g.ntypes and gd.sport_feat_df is not None and len(gd.sport_feat_df):
        h_sport = infer_embeddings(model, g, run.features, mode=fixed.inference_mode,
                                   node_batch_size=fixed.node_batch_size, ntypes=("sport",),
                                   device=device)["sport"]
        explore_sports(h_sport.cpu().numpy(), gd.sport_feat_df, gd.spt_id,
                       num_choices=fixed.num_choices)
