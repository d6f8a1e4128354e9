"""Heterogeneous graph container: COO edges plus a padded CSC view.

Port of ``gnn_recsys_tpu/graph/hetero.py``.  Per canonical edge type the
graph keeps its COO edge list (``src``, ``dst``, edge features) and a padded
by-destination neighbour table (``nbr``/``nbr_eid``/``nbr_mask``/``deg``);
per node type, dense feature matrices.  Arrays are built on the host with
numpy and held as tensors; :meth:`HeteroGraph.to` moves a graph to a device.
Index arrays stay int32, the JAX package's (and the saved files') type.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

# A canonical edge type, e.g. ("user", "buys", "item").
CanonicalEtype = Tuple[str, str, str]


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass
class Relation:
    """One canonical edge type: COO edges + padded CSC (by destination).

    ``nbr[d, k]`` is the source id of the k-th incoming edge of destination
    ``d``, -1 where ``nbr_mask`` is False; ``nbr_eid[d, k]`` indexes the COO
    arrays (0 at padding).  ``eid_pos[e]`` is the flat position
    ``row * K + slot`` of edge ``e`` in the padded table, ``N_dst * K`` for
    an edge dropped by the fanout cap.
    """

    src: torch.Tensor  # [E] int32
    dst: torch.Tensor  # [E] int32
    nbr: torch.Tensor  # [N_dst, K] int32, -1 padded
    nbr_eid: torch.Tensor  # [N_dst, K] int32
    nbr_mask: torch.Tensor  # [N_dst, K] bool
    deg: torch.Tensor  # [N_dst] int32, clipped at K
    edata: Dict[str, torch.Tensor]  # per-edge features, [E] or [E, F] f32
    eid_pos: Optional[torch.Tensor] = None  # [E] int32
    # The packed leaf cache (attach_leaf_features): [N_dst, K*F] row-major,
    # nbr_feat[d, k*F:(k+1)*F] = the source features of nbr[d, k] (zeros at
    # padding).  Derived, never serialized.
    nbr_feat: Optional[torch.Tensor] = None

    @property
    def num_edges(self) -> int:
        return self.src.shape[0]

    @property
    def max_fanout(self) -> int:
        """Padded row width K of the neighbour table."""
        return self.nbr.shape[1]

    def to(self, device) -> "Relation":
        def opt(t):
            return None if t is None else t.to(device)

        return Relation(
            src=self.src.to(device), dst=self.dst.to(device),
            nbr=self.nbr.to(device), nbr_eid=self.nbr_eid.to(device),
            nbr_mask=self.nbr_mask.to(device), deg=self.deg.to(device),
            edata={k: v.to(device) for k, v in self.edata.items()},
            eid_pos=opt(self.eid_pos), nbr_feat=opt(self.nbr_feat),
        )


@dataclasses.dataclass
class HeteroGraph:
    """Heterogeneous graph: ``rels`` maps canonical etypes to
    :class:`Relation`, ``ndata`` maps node type -> feature name -> [N, F]."""

    rels: Dict[CanonicalEtype, Relation]
    ndata: Dict[str, Dict[str, torch.Tensor]]
    num_nodes_tuple: Tuple[Tuple[str, int], ...]

    @property
    def num_nodes_dict(self) -> Dict[str, int]:
        return dict(self.num_nodes_tuple)

    @property
    def canonical_etypes(self) -> Tuple[CanonicalEtype, ...]:
        return tuple(self.rels.keys())

    @property
    def ntypes(self) -> Tuple[str, ...]:
        return tuple(n for n, _ in self.num_nodes_tuple)

    def num_nodes(self, ntype: str) -> int:
        return self.num_nodes_dict[ntype]

    def num_edges(self, etype: CanonicalEtype) -> int:
        return self.rels[etype].num_edges

    def to(self, device) -> "HeteroGraph":
        return HeteroGraph(
            rels={et: rel.to(device) for et, rel in self.rels.items()},
            ndata={nt: {k: v.to(device) for k, v in f.items()}
                   for nt, f in self.ndata.items()},
            num_nodes_tuple=self.num_nodes_tuple,
        )


# ----------------------------------------------------------------------
# Host-side construction (numpy)
# ----------------------------------------------------------------------

def coo_to_padded_csc(
    src: np.ndarray,
    dst: np.ndarray,
    num_dst: int,
    max_fanout: Optional[int] = None,
    fanout_multiple: int = 8,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Pack a COO edge list into a padded by-destination neighbour table.

    Returns ``(nbr, nbr_eid, nbr_mask, deg)``, shapes ``[num_dst, K]`` (x3)
    and ``[num_dst]``.  ``K`` is the max in-degree rounded up to a multiple
    of ``fanout_multiple``, or ``max_fanout`` if smaller — then each
    destination keeps its LAST ``K`` incoming edges (the most recent ones;
    edges arrive in time order).  Slot order within a row follows
    edge-id order.  Padding slots hold 0 here (``build_relation`` marks
    ``nbr`` padding with -1).
    """
    src = np.asarray(src, dtype=np.int32)
    dst = np.asarray(dst, dtype=np.int32)
    num_edges = src.shape[0]
    counts = np.bincount(dst, minlength=num_dst).astype(np.int32)
    natural_k = int(counts.max()) if num_edges else 0
    k = max_fanout if (max_fanout is not None and natural_k > max_fanout) else natural_k
    k = max(_round_up(max(k, 1), fanout_multiple), fanout_multiple)

    # Stable sort by dst keeps edge-id order within rows.
    order = np.argsort(dst, kind="stable")
    sorted_dst = dst[order]
    row_start = np.zeros(num_dst + 1, dtype=np.int64)
    np.cumsum(counts, out=row_start[1:])
    pos_in_row = np.arange(num_edges, dtype=np.int64) - row_start[sorted_dst]

    # Keep the LAST k edges per row when capped.
    row_count = counts[sorted_dst]
    keep = pos_in_row >= (row_count - k)
    slot = np.where(row_count > k, pos_in_row - (row_count - k), pos_in_row)

    nbr = np.zeros((num_dst, k), dtype=np.int32)
    nbr_eid = np.zeros((num_dst, k), dtype=np.int32)
    nbr_mask = np.zeros((num_dst, k), dtype=bool)
    kept_rows = sorted_dst[keep]
    kept_slots = slot[keep]
    kept_eids = order[keep].astype(np.int32)
    nbr[kept_rows, kept_slots] = src[kept_eids]
    nbr_eid[kept_rows, kept_slots] = kept_eids
    nbr_mask[kept_rows, kept_slots] = True
    deg = np.minimum(counts, k).astype(np.int32)
    return nbr, nbr_eid, nbr_mask, deg


def compute_eid_pos(nbr_eid: np.ndarray, nbr_mask: np.ndarray,
                    num_edges: int) -> np.ndarray:
    """[E] flat padded-table position per edge id (see Relation.eid_pos)."""
    nbr_eid, nbr_mask = np.asarray(nbr_eid), np.asarray(nbr_mask)
    pos = np.full(num_edges, nbr_eid.size, dtype=np.int32)
    flat_valid = np.flatnonzero(nbr_mask.reshape(-1))
    pos[nbr_eid.reshape(-1)[flat_valid]] = flat_valid
    return pos


def build_relation(
    src: np.ndarray,
    dst: np.ndarray,
    num_dst: int,
    edata: Optional[Mapping[str, np.ndarray]] = None,
    max_fanout: Optional[int] = None,
    fanout_multiple: int = 8,
) -> Relation:
    """Build a :class:`Relation` on the host (CPU tensors); padding slots of
    ``nbr`` are -1."""
    nbr, nbr_eid, nbr_mask, deg = coo_to_padded_csc(
        src, dst, num_dst, max_fanout=max_fanout, fanout_multiple=fanout_multiple
    )
    nbr = np.where(nbr_mask, nbr, -1).astype(np.int32)
    return Relation(
        src=torch.from_numpy(np.asarray(src, dtype=np.int32).copy()),
        dst=torch.from_numpy(np.asarray(dst, dtype=np.int32).copy()),
        nbr=torch.from_numpy(nbr),
        nbr_eid=torch.from_numpy(nbr_eid),
        nbr_mask=torch.from_numpy(nbr_mask),
        deg=torch.from_numpy(deg),
        edata={k: torch.from_numpy(np.asarray(v, dtype=np.float32).copy())
               for k, v in (edata or {}).items()},
        eid_pos=torch.from_numpy(compute_eid_pos(nbr_eid, nbr_mask, len(src))),
    )


def build_hetero_graph(
    schema: Mapping[CanonicalEtype, Tuple[np.ndarray, np.ndarray]],
    num_nodes_dict: Mapping[str, int],
    edata: Optional[Mapping[CanonicalEtype, Mapping[str, np.ndarray]]] = None,
    ndata: Optional[Mapping[str, Mapping[str, np.ndarray]]] = None,
    max_fanout: Optional[int] = None,
    fanout_multiple: int = 8,
) -> HeteroGraph:
    """Build a :class:`HeteroGraph` from a schema of COO edge lists
    (canonical etype -> (src ids, dst ids))."""
    edata = edata or {}
    rels = {
        etype: build_relation(
            np.asarray(src), np.asarray(dst), num_dst=num_nodes_dict[etype[2]],
            edata=edata.get(etype) or {}, max_fanout=max_fanout,
            fanout_multiple=fanout_multiple,
        )
        for etype, (src, dst) in schema.items()
    }
    nd: Dict[str, Dict[str, torch.Tensor]] = {
        ntype: {name: torch.from_numpy(np.asarray(arr, dtype=np.float32).copy())
                for name, arr in feats.items()}
        for ntype, feats in (ndata or {}).items()
    }
    for ntype in num_nodes_dict:
        nd.setdefault(ntype, {})
    return HeteroGraph(
        rels=rels, ndata=nd, num_nodes_tuple=tuple(sorted(num_nodes_dict.items()))
    )


def attach_leaf_features(graph: HeteroGraph, features: Mapping[str, torch.Tensor],
                         dtype: Optional[torch.dtype] = None,
                         max_width: int = 64) -> HeteroGraph:
    """A graph whose relations carry the packed leaf cache ``nbr_feat``
    (``hetero.py:279-320``): per relation, the source features of every
    neighbour slot, zeros at padding, stored ``[N_dst, K*F]``.  Node features
    are constant in training, so a full-fanout tree's deepest level reads one
    contiguous row a node (:func:`~gnn_recsys_tpu_torch.ops.sampling.full_neighbors_packed`).

    dtype: the cache's type (default: the features'); max_width: relations
    whose padded width K exceeds it keep no cache (it takes N_dst*K*F
    elements).  The cache lies where ``features`` lie."""
    rels = {}
    for et, rel in graph.rels.items():
        feats = features.get(et[0])
        if feats is None or rel.max_fanout > max_width:
            rels[et] = rel
            continue
        f = feats if dtype is None else feats.to(dtype)
        nbr = rel.nbr.to(f.device)
        packed = f[nbr.long().clamp(min=0)] * rel.nbr_mask.to(f.device)[..., None].to(f.dtype)
        rels[et] = dataclasses.replace(rel, nbr_feat=packed.reshape(nbr.shape[0], -1))
    return dataclasses.replace(graph, rels=rels)
