"""In-loop inference evaluation: rebuild the data under other windows and
evaluate a trained model on it.

Port of ``gnn_recsys_tpu/inference_eval.py`` (the reference's
``inference_hp.inference_fn``): after training, rebuild the graph from the
raw data with ``remove`` and the time windows overridden, embed it with the
trained weights and report the test metrics.  The model is parametric over
the graph, so the same weights apply to the rebuilt graph.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

from gnn_recsys_tpu_torch.config import FixedParams, HyperParams
from gnn_recsys_tpu_torch.data.etl import GraphData
from gnn_recsys_tpu_torch.models.conv_model import ConvModel
from gnn_recsys_tpu_torch.retrieval.metrics import get_metrics_at_k
from gnn_recsys_tpu_torch.retrieval.recs import model_score_fn
from gnn_recsys_tpu_torch.train.minibatch import infer_embeddings


def inference_fn(
    model: ConvModel,
    fixed: FixedParams,
    hyper: HyperParams,
    dataframes: Dict,
    remove_on_inference: Optional[float] = None,
    days_of_purchases: Optional[int] = None,
    days_of_clicks: Optional[int] = None,
    lifespan_of_items: Optional[int] = None,
    k: Optional[int] = None,
    device="cuda",
) -> Tuple[float, float, float]:
    """(precision, recall, coverage) of the trained ``model`` (it holds its
    weights: JAX ``inference_fn(params, model, ...)``) on the test ground
    truth of a graph rebuilt from ``dataframes`` (the keyword arguments of
    :meth:`GraphData.from_dataframes`: paths, Tables or DataFrames) with the
    overrides given.  ``device``: where the model embeds and ranks."""
    overrides = {name: value for name, value in (
        ("remove", remove_on_inference), ("days_of_purchases", days_of_purchases),
        ("days_of_clicks", days_of_clicks), ("lifespan_of_items", lifespan_of_items))
        if value is not None}
    inf_fixed = dataclasses.replace(fixed, **overrides)
    gd = GraphData.from_dataframes(inf_fixed, use_recency=hyper.use_recency,
                                   use_popularity=hyper.use_popularity,
                                   days_popularity=hyper.days_popularity, **dataframes)
    g = gd.graph
    features = {nt: g.ndata[nt]["features"] for nt in g.ntypes if "features" in g.ndata[nt]}
    h = infer_embeddings(model, g, features, mode=inf_fixed.inference_mode,
                         node_batch_size=inf_fixed.node_batch_size, ntypes=("user", "item"),
                         device=device)
    popularity = None
    # Boost only where it transfers (HyperParams.serve_with_popularity_boost).
    if hyper.serve_with_popularity_boost and "popularity" in g.ndata.get("item", {}):
        popularity = g.ndata["item"]["popularity"].reshape(-1)
    return get_metrics_at_k(h["user"], h["item"], gd.ground_truth_test, gd.already_bought,
                            k or inf_fixed.k, score_fn=model_score_fn(model.pred, model),
                            popularity=popularity, weight_popularity=hyper.weight_popularity,
                            device=device)
