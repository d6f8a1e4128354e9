"""The system under test built from a configuration and the seed's inputs,
and the reference's view of the same inputs.  Only this module and the
drivers import the measured package."""

from __future__ import annotations

import gc
from typing import Dict

import numpy as np
import torch

from portbench.harness import data as bdata
from portbench.reference import model as ref

DTYPES = {"float32": None, "bfloat16": torch.bfloat16}


def inputs(config: dict, seed: int) -> dict:
    """The graph's COO lists and the weights' seed for this run."""
    return {"graph": bdata.make_graph(config["graph"], bdata.sub_seed(seed, 1)),
            "weight_seed": bdata.sub_seed(seed, 2)}


def spec(config: dict, graph: dict) -> Dict[str, tuple]:
    m, g = config["model"], config["graph"]
    return ref.param_spec(tuple(graph["schema"]), {nt: g["feat_dim"] for nt in graph["num_nodes"]},
                          m["hidden_dim"], m["out_dim"], m["n_layers"], m["aggregator_type"])


def model_kwargs(config: dict, graph: dict) -> dict:
    """The ``ConvModel`` arguments a run directory stores (JSON lists)."""
    m, f = config["model"], config["graph"]["feat_dim"]
    return {"canonical_etypes": [list(et) for et in graph["schema"]],
            "dims": [[nt, f] for nt in graph["num_nodes"]] + [["hidden", m["hidden_dim"]],
                                                             ["out", m["out_dim"]]],
            "n_layers": m["n_layers"], "norm": m["norm"], "dropout": m["dropout"],
            "aggregator_type": m["aggregator_type"], "pred": m["pred"],
            "aggregator_hetero": m["aggregator_hetero"], "embedding_layer": m["embedding_layer"]}


def program_graph(config: dict, graph: dict):
    from gnn_recsys_tpu_torch.graph.hetero import build_hetero_graph

    return build_hetero_graph(graph["schema"], graph["num_nodes"], edata=graph["edata"],
                              ndata=graph["ndata"], max_fanout=config["graph"]["max_fanout"])


def program_model(config: dict, graph: dict, weights: Dict[str, torch.Tensor], dev):
    from gnn_recsys_tpu_torch.models.conv_model import ConvModel
    from gnn_recsys_tpu_torch.train.checkpoint import model_kwargs_to_config

    m = config["model"]
    model = ConvModel(**model_kwargs_to_config(model_kwargs(config, graph)),
                      leaf_kernel=m["leaf_kernel"], dtype=DTYPES[m["dtype"]]).to(dev)
    model.load_state_dict(weights)
    return model


def reference_inputs(config: dict, graph: dict, dev):
    """The reference's graph and feature tables."""
    return (ref.Graph(graph["schema"], graph["num_nodes"], config["graph"]["max_fanout"], dev),
            {nt: torch.from_numpy(graph["ndata"][nt]["features"]).to(dev)
             for nt in graph["num_nodes"]})


def free(dev) -> None:
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()


def peak_bytes(dev) -> int:
    return int(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda" else 0


def sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def max_out_degree(src: np.ndarray, n: int) -> int:
    return int(np.bincount(src, minlength=n).max())
