"""On-demand inference: load a saved run, embed, recommend.

Port of ``gnn_recsys_tpu/inference.py`` (the reference's
``main_inference.py:20-175``): map external customer ids to node ids,
rebuild the model from the saved config, embed every user and item on the
device, rank the full catalog with already-bought exclusion, and map node
ids back to external item ids.  Id maps are pandas DataFrames; pandas is
needed only when the run directory holds them.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from gnn_recsys_tpu_torch.config import HyperParams
from gnn_recsys_tpu_torch.graph.hetero import HeteroGraph
from gnn_recsys_tpu_torch.models.conv_model import ConvModel
from gnn_recsys_tpu_torch.ops.membership import PaddedPairSet, build_padded_pair_set
from gnn_recsys_tpu_torch.retrieval.recs import get_recs, model_score_fn
from gnn_recsys_tpu_torch.train.checkpoint import load_run, model_kwargs_to_config
from gnn_recsys_tpu_torch.train.minibatch import infer_embeddings


def fetch_uids(user_ids: Sequence, ctm_id_df) -> np.ndarray:
    """External customer ids -> node ids (reference utils_inference.py:15-28)."""
    ext_col = [c for c in ctm_id_df.columns if c != "ctm_new_id"][0]
    mapping = dict(zip(ctm_id_df[ext_col], ctm_id_df["ctm_new_id"]))
    missing = [u for u in user_ids if u not in mapping]
    if missing:
        raise KeyError(f"unknown user ids: {missing[:5]}")
    return np.asarray([mapping[u] for u in user_ids], dtype=np.int32)


def postprocess_recs(recs, user_node_ids: np.ndarray, pdt_id_df, ctm_id_df) -> Dict:
    """Node-id recs -> external-id recs (reference utils_inference.py:31-40)."""
    item_col = [c for c in pdt_id_df.columns if c != "pdt_new_id"][0]
    user_col = [c for c in ctm_id_df.columns if c != "ctm_new_id"][0]
    item_map = dict(zip(pdt_id_df["pdt_new_id"], pdt_id_df[item_col]))
    user_map = dict(zip(ctm_id_df["ctm_new_id"], ctm_id_df[user_col]))
    return {
        user_map[int(u)]: [item_map[int(i)] for i in row]
        for u, row in zip(user_node_ids, np.asarray(recs))
    }


def already_bought_from_graph(
    graph: HeteroGraph, etype=("user", "buys", "item")
) -> Tuple[np.ndarray, np.ndarray]:
    """(user, item) pairs already purchased (reference main_inference.py:95-99)."""
    rel = graph.rels[etype]
    return rel.src.cpu().numpy(), rel.dst.cpu().numpy()


def inference_ondemand(
    run_dir: str,
    user_ids: Sequence,
    k: int = 10,
    remove_already_bought: bool = True,
    inference_mode: str = "full_graph",
    use_popularity: Optional[bool] = None,
    weight_popularity: float = 1.0,
    device="cuda",
) -> Dict:
    """Recommendations for external user ids from a saved run directory.

    ``user_ids='all'`` recommends for every known user.  ``device``: where
    the model embeds and ranks (the CUDA device unless the caller asks for
    the CPU).  ``use_popularity=None`` resolves from the saved run's
    hyperparameters (``HyperParams.serve_with_popularity_boost``); pass
    True/False to override.
    """
    dev = torch.device(device)
    run = load_run(run_dir)
    graph = run["graph"]
    if graph is None:
        raise FileNotFoundError(f"{run_dir}/graph.npz missing")
    id_maps = run["id_maps"] or {}
    ctm_id_df = id_maps.get("ctm_id")
    pdt_id_df = id_maps.get("pdt_id")

    model = ConvModel(**model_kwargs_to_config(run["model_kwargs"]))
    model.load_state_dict(run["params"])
    model.to(dev)

    if isinstance(user_ids, str) and user_ids == "all":
        user_node_ids = np.arange(graph.num_nodes("user"), dtype=np.int32)
    elif ctm_id_df is not None:
        user_node_ids = fetch_uids(user_ids, ctm_id_df)
    else:
        user_node_ids = np.asarray(user_ids, dtype=np.int32)

    features = {nt: graph.ndata[nt]["features"] for nt in graph.ntypes}
    h = infer_embeddings(model, graph, features, mode=inference_mode, device=dev)

    already: Optional[PaddedPairSet] = None
    if remove_already_bought:
        ab_u, ab_i = already_bought_from_graph(graph)
        already = build_padded_pair_set(ab_u, ab_i, num_src=graph.num_nodes("user"))
    if use_popularity is None:
        hp_dict = run["hyper_params"] or {}
        known = {f.name for f in dataclasses.fields(HyperParams)}
        hyper = HyperParams(**{k: v for k, v in hp_dict.items() if k in known})
        use_popularity = hyper.serve_with_popularity_boost
    popularity = None
    if use_popularity and "popularity" in graph.ndata.get("item", {}):
        popularity = graph.ndata["item"]["popularity"].reshape(-1)

    recs = get_recs(
        h["user"], h["item"], user_node_ids, k,
        already_bought=already, remove_already_bought=remove_already_bought,
        score_fn=model_score_fn(model.pred), popularity=popularity,
        weight_popularity=weight_popularity, backend="auto", device=dev,
    ).cpu().numpy()
    if pdt_id_df is not None and ctm_id_df is not None:
        return postprocess_recs(recs, user_node_ids, pdt_id_df, ctm_id_df)
    return {int(u): row.tolist() for u, row in zip(user_node_ids, recs)}
