"""On-demand inference: load a saved run, embed, recommend.

Port of ``gnn_recsys_tpu/inference.py`` (the reference's
``main_inference.py:20-175``): map external customer ids to node ids,
rebuild the model from the saved config, embed every user and item on the
device, rank the full catalog with already-bought exclusion, and map node
ids back to external item ids.  Id maps are the port's
``dict[str, np.ndarray]`` (``data/etl.py``) or, from a run directory the JAX
package wrote, pandas DataFrames (unpickling those needs pandas).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from gnn_recsys_tpu_torch.config import FixedParams, HyperParams
from gnn_recsys_tpu_torch.graph.hetero import HeteroGraph
from gnn_recsys_tpu_torch.models.conv_model import ConvModel
from gnn_recsys_tpu_torch.ops.membership import PaddedPairSet, build_padded_pair_set
from gnn_recsys_tpu_torch.parallel.mesh import Mesh
from gnn_recsys_tpu_torch.retrieval.recs import get_recs, model_score_fn
from gnn_recsys_tpu_torch.retrieval.sharded import catalog_axis, get_recs_sharded
from gnn_recsys_tpu_torch.train.checkpoint import load_run, model_kwargs_to_config
from gnn_recsys_tpu_torch.train.minibatch import infer_embeddings
from gnn_recsys_tpu_torch.utils.profiling import counter, span, to_device


def _pairs(id_map, new_col: str) -> Tuple[list, list]:
    """(external ids, node ids) of an id map: a dict of columns or a
    DataFrame, whose one column besides ``new_col`` is the external id."""
    names = list(id_map.columns) if hasattr(id_map, "columns") else list(id_map)
    ext_col = [c for c in names if c != new_col][0]
    return np.asarray(id_map[ext_col]).tolist(), np.asarray(id_map[new_col]).tolist()


def fetch_uids(user_ids: Sequence, ctm_id_df) -> np.ndarray:
    """External customer ids -> node ids (reference utils_inference.py:15-28)."""
    mapping = dict(zip(*_pairs(ctm_id_df, "ctm_new_id")))
    missing = [u for u in user_ids if u not in mapping]
    if missing:
        raise KeyError(f"unknown user ids: {missing[:5]}")
    return np.asarray([mapping[u] for u in user_ids], dtype=np.int32)


def postprocess_recs(recs, user_node_ids: np.ndarray, pdt_id_df, ctm_id_df) -> Dict:
    """Node-id recs -> external-id recs (reference utils_inference.py:31-40)."""
    items, item_nodes = _pairs(pdt_id_df, "pdt_new_id")
    users, user_nodes = _pairs(ctm_id_df, "ctm_new_id")
    item_map, user_map = dict(zip(item_nodes, items)), dict(zip(user_nodes, users))
    return {
        user_map[int(u)]: [item_map[int(i)] for i in row]
        for u, row in zip(user_node_ids, np.asarray(recs))
    }


BUYS = ("user", "buys", "item")
BOUGHT_BY = FixedParams().reverse_etype[BUYS]


def already_bought_from_graph(
    graph: HeteroGraph, etype=BUYS
) -> Tuple[np.ndarray, np.ndarray]:
    """(user, item) pairs already purchased (reference main_inference.py:95-99)."""
    rel = graph.rels[etype]
    return rel.src.cpu().numpy(), rel.dst.cpu().numpy()


def bought_table(graph: HeteroGraph) -> PaddedPairSet:
    """A request's already-bought table: each user's bought items, -1
    padded, as :func:`build_padded_pair_set` packs
    :func:`already_bought_from_graph`'s pairs.

    The reverse relation ``bought-by`` already holds that table in its
    padded rows (``nbr``: keyed by user, items in edge-id order, -1 at
    padding) wherever every one of these holds: no row was cut by a
    ``max_fanout`` cap, its COO is the purchases' swapped element for
    element (so each row's slots come in the same order), and its width is
    the one the pack would choose (so ``max_row``, and with it retrieval's
    fetch width and route, stay the same).  There the table is those rows,
    no copy, and adds one to ``bought_table.from_graph``; elsewhere the host
    packs it, and adds one to ``bought_table.packed``.  Either way the same
    bits.  Nothing may write into the rows: they may be the graph's own."""
    num_users = graph.num_nodes(BUYS[0])
    rev = graph.rels.get(BOUGHT_BY)
    if rev is not None and rev.nbr.dtype == torch.int32 and rev.nbr.shape[0] == num_users:
        fwd = graph.rels[BUYS]
        natural = int(rev.deg.max()) if rev.num_edges else 0
        width = max(-(-natural // 8) * 8, 8)  # the pack's: largest row up to a multiple of 8
        if (int(rev.deg.sum()) == rev.num_edges and rev.nbr.shape[1] == width
                and torch.equal(rev.src, fwd.dst) and torch.equal(rev.dst, fwd.src)):
            bought_table.from_graph += 1
            return PaddedPairSet(rows=rev.nbr, num_src=num_users)
    bought_table.packed += 1
    return build_padded_pair_set(*already_bought_from_graph(graph), num_src=num_users)


counter(bought_table, "from_graph", "packed")


def inference_ondemand(
    run_dir: str,
    user_ids: Sequence,
    k: int = 10,
    remove_already_bought: bool = True,
    node_batch_size: int = 128,
    inference_mode: str = "full_graph",
    use_popularity: Optional[bool] = None,
    weight_popularity: float = 1.0,
    rebuild_dataframes: Optional[Dict] = None,
    device="cuda",
    mesh: Optional[Mesh] = None,
) -> Dict:
    """Recommendations for external user ids from a saved run directory.

    ``user_ids='all'`` recommends for every known user.  When the run has
    no saved graph, ``rebuild_dataframes`` (the keyword arguments of
    :meth:`GraphData.from_dataframes`) rebuilds it from the raw data with
    the run's fixed parameters (reference main_inference.py:69-87).
    ``node_batch_size``: the users or items a batch of the
    ``"node_batches"`` inference mode.  ``device``: where the model embeds
    and ranks (the CUDA device unless the caller asks for the CPU).
    ``use_popularity=None`` resolves from the saved run's hyperparameters
    (``HyperParams.serve_with_popularity_boost``); pass True/False to
    override.

    Each request that returns adds one to ``inference_ondemand.requests``
    (the caller resets it).  Spans (:func:`~gnn_recsys_tpu_torch.utils.
    profiling.span`): ``gnn.serve.request`` around the whole request, and
    inside it ``load_run``'s, ``gnn.serve.build`` (the model and its
    parameters' copy), ``gnn.serve.embed``, ``gnn.serve.bought_table``,
    ``gnn.serve.rank`` and ``gnn.serve.to_host`` (the wait for the ranking,
    and the id maps).  Ranking a ``pred='nn'`` run opens ``gnn.pred.rank``
    spans inside ``gnn.serve.rank``: on a card without the boost one, around
    the head's first layer and ``mlp_topk`` (the MLP head and the top-k over
    the whole catalog in one kernel); else one a chunk of users
    (:func:`~gnn_recsys_tpu_torch.retrieval.recs.make_mlp_score_fn`: the MLP
    head over the whole catalog), apart from the top-k.

    ``mesh``: serve over the devices of a
    :class:`~gnn_recsys_tpu_torch.parallel.mesh.Mesh` (``inference.py:
    159-175``): the sampled-tree embedding pass data-parallel over every
    device, retrieval with the catalog split over the ``model`` axis where
    it is above 1, else ``data`` (:mod:`~gnn_recsys_tpu_torch.retrieval.sharded`).
    The recommendations are the single-device ones up to near-ties: the
    sharded pass's embeddings are the full-graph pass's summed in another
    order.  ``device`` must then be of the mesh's device type.
    """
    with span("gnn.serve.request"):
        dev = torch.device(device)
        if mesh is not None:
            if mesh.first_device.type != dev.type:
                raise ValueError(f"device={device!r}, but the mesh's devices are "
                                 f"{mesh.first_device.type}")
            dev = mesh.first_device
        run = load_run(run_dir)
        graph = run["graph"]
        id_maps = run["id_maps"] or {}
        if graph is None and rebuild_dataframes is not None:
            from gnn_recsys_tpu_torch.data.etl import GraphData

            gd = GraphData.from_dataframes(FixedParams(**(run["fixed_params"] or {})),
                                           **rebuild_dataframes)
            graph = gd.graph
            id_maps = {"ctm_id": gd.ctm_id, "pdt_id": gd.pdt_id, "spt_id": gd.spt_id}
        if graph is None:
            raise FileNotFoundError(f"{run_dir}/graph.npz missing (pass rebuild_dataframes to "
                                    f"rebuild it from the raw data)")
        ctm_id_df = id_maps.get("ctm_id")
        pdt_id_df = id_maps.get("pdt_id")

        with span("gnn.serve.build"):
            model = ConvModel(**model_kwargs_to_config(run["model_kwargs"]))
            model.load_state_dict(run["params"])
            to_device(model, dev)

        if isinstance(user_ids, str) and user_ids == "all":
            user_node_ids = np.arange(graph.num_nodes("user"), dtype=np.int32)
        elif ctm_id_df is not None:
            user_node_ids = fetch_uids(user_ids, ctm_id_df)
        else:
            user_node_ids = np.asarray(user_ids, dtype=np.int32)

        with span("gnn.serve.embed"):
            features = {nt: graph.ndata[nt]["features"] for nt in graph.ntypes}
            h = infer_embeddings(model, graph, features, mode=inference_mode,
                                 node_batch_size=node_batch_size, ntypes=("user", "item"),
                                 device=dev, mesh=mesh)

        already: Optional[PaddedPairSet] = None
        if remove_already_bought:
            with span("gnn.serve.bought_table"):
                already = bought_table(graph)
        if use_popularity is None:
            hp_dict = run["hyper_params"] or {}
            known = {f.name for f in dataclasses.fields(HyperParams)}
            hyper = HyperParams(**{k: v for k, v in hp_dict.items() if k in known})
            use_popularity = hyper.serve_with_popularity_boost
        popularity = None
        if use_popularity and "popularity" in graph.ndata.get("item", {}):
            popularity = graph.ndata["item"]["popularity"].reshape(-1)

        with span("gnn.serve.rank"):
            route = dict(already_bought=already, remove_already_bought=remove_already_bought,
                         score_fn=model_score_fn(model.pred, model), popularity=popularity,
                         weight_popularity=weight_popularity, backend="auto")
            if mesh is not None:
                recs = get_recs_sharded(mesh, h["user"], h["item"], user_node_ids, k,
                                        axis=catalog_axis(mesh), **route)
            else:
                recs = get_recs(h["user"], h["item"], user_node_ids, k, device=dev, **route)
        with span("gnn.serve.to_host"):
            recs = recs.cpu().numpy()
            if pdt_id_df is not None and ctm_id_df is not None:
                out = postprocess_recs(recs, user_node_ids, pdt_id_df, ctm_id_df)
            else:
                out = {int(u): row.tolist() for u, row in zip(user_node_ids, recs)}
    inference_ondemand.requests += 1
    return out


counter(inference_ondemand, "requests")
