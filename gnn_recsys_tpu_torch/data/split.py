"""Temporal train/validation split over the built graph.

Port of ``gnn_recsys_tpu/data/split.py`` (reference ``train_valid_split``,
``src/sampling.py:5-114``), on the host with numpy:

* validation eids: the most recent ``valid_size`` share of each training
  etype's edges (a graph keeps each etype's edges in time order);
* the train graph: the full graph without the validation edges and their
  reverses (a reverse relation shares its edge ids);
* recency subsampling: only the most recent ``purchases_sample`` /
  ``clicks_sample`` share of the train and validation eids is kept;
* ``remove_train_eids`` removes the training edges from the train graph too;
* a random ``subtrain_size`` sample of training users, with their edges, as
  the ground truth of train-set metrics;
* test users: the unique users of the test ground truth; all item ids.

The subtrain users come from the global ``np.random`` seeded ``seed``, as in
the JAX package, so both packages draw the same users.  ``max_fanout`` caps
the rebuilt train graph's neighbour rows as ``build_relation`` does; None,
the default (and what the JAX ``run_trial`` passes), leaves them uncapped
even when the full graph was capped (ROADMAP.md, queue 3).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np

from gnn_recsys_tpu_torch.config import FixedParams
from gnn_recsys_tpu_torch.graph.hetero import CanonicalEtype, HeteroGraph, remove_edges


@dataclasses.dataclass
class TrainValSplit:
    train_graph: HeteroGraph
    train_eids: Dict[CanonicalEtype, np.ndarray]  # into train_graph
    valid_eids: Dict[CanonicalEtype, np.ndarray]  # into the FULL graph
    subtrain_uids: np.ndarray
    valid_uids: np.ndarray
    test_uids: np.ndarray
    all_iids: np.ndarray
    ground_truth_subtrain: Tuple[np.ndarray, np.ndarray]
    ground_truth_valid: Tuple[np.ndarray, np.ndarray]
    all_eids: Dict[CanonicalEtype, np.ndarray]


def train_valid_split(
    full_graph: HeteroGraph,
    ground_truth_test: Tuple[np.ndarray, np.ndarray],
    fixed_params: FixedParams,
    clicks_sample: float = 1.0,
    purchases_sample: float = 1.0,
    max_fanout: Optional[int] = None,
    seed: int = 11,
) -> TrainValSplit:
    np.random.seed(seed)
    fp = fixed_params
    etypes = fp.train_etypes
    reverse = fp.reverse_etype

    all_eids: Dict[CanonicalEtype, np.ndarray] = {}
    valid_eids: Dict[CanonicalEtype, np.ndarray] = {}
    valid_u, valid_i = [], []
    for et in etypes:
        e = full_graph.num_edges(et)
        eids = np.arange(e)
        v = eids[int(e * (1 - fp.valid_size)):]
        all_eids[et] = eids
        valid_eids[et] = v
        valid_u.append(full_graph.rels[et].src.cpu().numpy()[v])
        valid_i.append(full_graph.rels[et].dst.cpu().numpy()[v])
    ground_truth_valid = (np.concatenate(valid_u).astype(np.int64),
                          np.concatenate(valid_i).astype(np.int64))
    valid_uids = np.unique(ground_truth_valid[0])

    removals: Dict[CanonicalEtype, np.ndarray] = {}
    for et in etypes:
        removals[et] = valid_eids[et]
        removals[reverse[et]] = valid_eids[et]
    train_graph = remove_edges(full_graph, removals, max_fanout=max_fanout)
    train_eids = {et: np.arange(train_graph.num_edges(et)) for et in etypes}

    samples = {
        ("user", "buys", "item"): purchases_sample,
        ("user", "clicks", "item"): clicks_sample,
    }
    for et, frac in samples.items():
        if frac != 1 and et in train_eids:
            e = train_eids[et]
            train_eids[et] = e[int(len(e) * (1 - frac)):]
            v = valid_eids[et]
            valid_eids[et] = v[int(len(v) * (1 - frac)):]

    if fp.remove_train_eids:
        removals = {}
        for et in etypes:
            removals[et] = train_eids[et]
            removals[reverse[et]] = train_eids[et]
        train_graph = remove_edges(train_graph, removals, max_fanout=max_fanout)

    # Subtrain user sample for train-set metrics (sampling.py:88-106).
    first_et = etypes[0]
    t_src = train_graph.rels[first_et].src.cpu().numpy()[train_eids[first_et]]
    unique_train_uids = np.unique(t_src)
    subtrain_uids = np.random.choice(
        unique_train_uids, int(len(unique_train_uids) * fp.subtrain_size), replace=False)
    sub_u, sub_i = [], []
    for et in train_eids:
        src = train_graph.rels[et].src.cpu().numpy()[train_eids[et]]
        dst = train_graph.rels[et].dst.cpu().numpy()[train_eids[et]]
        keep = np.isin(src, subtrain_uids)
        sub_u.append(src[keep])
        sub_i.append(dst[keep])
    ground_truth_subtrain = (np.concatenate(sub_u).astype(np.int64),
                             np.concatenate(sub_i).astype(np.int64))
    subtrain_uids = np.unique(ground_truth_subtrain[0])

    return TrainValSplit(
        train_graph=train_graph,
        train_eids=train_eids,
        valid_eids=valid_eids,
        subtrain_uids=subtrain_uids,
        valid_uids=valid_uids,
        test_uids=np.unique(np.asarray(ground_truth_test[0])),
        all_iids=np.arange(full_graph.num_nodes("item")),
        ground_truth_subtrain=ground_truth_subtrain,
        ground_truth_valid=ground_truth_valid,
        all_eids=all_eids,
    )
