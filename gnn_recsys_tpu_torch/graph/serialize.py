"""Graph serialization: HeteroGraph <-> npz on disk.

Port of ``gnn_recsys_tpu/graph/serialize.py`` in the same file format: one
compressed ``.npz`` of arrays keyed ``rel|ndata|edata \\x1f <etype or ntype>
\\x1f <name>`` plus a JSON header under ``__header__``.  A ``graph.npz``
written by either package loads in the other with equal arrays.
"""

from __future__ import annotations

import json
from typing import Dict

import numpy as np
import torch

from gnn_recsys_tpu_torch.graph.hetero import HeteroGraph, Relation, compute_eid_pos


def _flat_key(*parts: str) -> str:
    return "\x1f".join(parts)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def save_graph(graph: HeteroGraph, path: str) -> None:
    """Write the graph to ``path`` (.npz)."""
    arrays: Dict[str, np.ndarray] = {}
    header = {"ntypes": dict(graph.num_nodes_tuple), "etypes": [], "ndata": {}}
    for et, rel in graph.rels.items():
        et_key = "/".join(et)
        header["etypes"].append({"etype": list(et), "edata": sorted(rel.edata.keys())})
        names = ["src", "dst", "nbr", "nbr_eid", "nbr_mask", "deg"]
        if rel.eid_pos is not None:
            names.append("eid_pos")
        for name in names:
            arrays[_flat_key("rel", et_key, name)] = _np(getattr(rel, name))
        for name, arr in rel.edata.items():
            arrays[_flat_key("edata", et_key, name)] = _np(arr)
    for nt, feats in graph.ndata.items():
        header["ndata"][nt] = sorted(feats.keys())
        for name, arr in feats.items():
            arrays[_flat_key("ndata", nt, name)] = _np(arr)
    arrays["__header__"] = np.frombuffer(json.dumps(header).encode(), dtype=np.uint8)
    with open(path, "wb") as f:
        np.savez_compressed(f, **arrays)


def load_graph(path: str) -> HeteroGraph:
    """Read a graph written by :func:`save_graph` (of either package) onto
    the CPU."""
    with np.load(path) as z:
        header = json.loads(bytes(z["__header__"]).decode())

        def t(key: str) -> torch.Tensor:
            return torch.from_numpy(np.array(z[key]))

        rels = {}
        for entry in header["etypes"]:
            et = tuple(entry["etype"])
            et_key = "/".join(et)

            def key(name):
                return _flat_key("rel", et_key, name)

            if key("eid_pos") in z:
                eid_pos = t(key("eid_pos"))
            else:  # written before eid_pos existed: recompute
                eid_pos = torch.from_numpy(compute_eid_pos(
                    z[key("nbr_eid")], z[key("nbr_mask")], int(z[key("src")].shape[0])
                ))
            # Normalize the -1 padding invariant for files from old writers.
            nbr_mask = np.asarray(z[key("nbr_mask")])
            nbr = np.where(nbr_mask, np.asarray(z[key("nbr")]), -1).astype(np.int32)
            rels[et] = Relation(
                src=t(key("src")), dst=t(key("dst")), nbr=torch.from_numpy(nbr),
                nbr_eid=t(key("nbr_eid")), nbr_mask=torch.from_numpy(nbr_mask.copy()),
                deg=t(key("deg")),
                edata={name: t(_flat_key("edata", et_key, name)) for name in entry["edata"]},
                eid_pos=eid_pos,
            )
        ndata = {
            nt: {name: t(_flat_key("ndata", nt, name)) for name in names}
            for nt, names in header["ndata"].items()
        }
        for nt in header["ntypes"]:
            ndata.setdefault(nt, {})
        return HeteroGraph(
            rels=rels, ndata=ndata,
            num_nodes_tuple=tuple(sorted(header["ntypes"].items())),
        )
