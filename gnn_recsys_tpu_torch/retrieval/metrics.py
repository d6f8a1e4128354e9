"""Ranking metrics: precision / recall / coverage @ k.

Port of ``gnn_recsys_tpu/retrieval/metrics.py`` (the reference's
``src/metrics.py:81-134`` semantics):

* precision = recommended entries found in the user's ground truth / all
  recommended entries (-1 "no recommendation" slots excluded);
* recall = ground-truth pairs whose item is among that user's recs / all
  ground-truth pairs;
* coverage = distinct recommended items / catalog size.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from gnn_recsys_tpu_torch.ops.membership import build_padded_pair_set, pair_set_contains
from gnn_recsys_tpu_torch.retrieval.recs import as_device_tensor, get_recs, resolve_device


def recs_to_metrics(
    recs,
    user_ids,
    gt_users: np.ndarray,
    gt_items: np.ndarray,
    num_items: int,
) -> Tuple[float, float, float]:
    """(precision, recall, coverage) of ``recs`` [U, k], whose row ``r``
    belongs to ``user_ids[r]``, against ground-truth pairs (duplicates count
    as the reference's lists do).  Runs on the device of ``recs``."""
    dev = recs.device if isinstance(recs, torch.Tensor) else torch.device("cpu")
    recs = as_device_tensor(recs, torch.int64, dev)
    user_ids = as_device_tensor(user_ids, torch.int64, dev)
    gt_users_t = as_device_tensor(gt_users, torch.int64, dev)
    gt_items_t = as_device_tensor(gt_items, torch.int64, dev)
    u = recs.shape[0]

    num_users = int(user_ids.max()) + 1 if u else 1
    gt_set = build_padded_pair_set(
        gt_users, gt_items, num_src=max(num_users, int(np.max(gt_users)) + 1)
    ).to(dev)
    valid = recs >= 0
    rec_hits = pair_set_contains(gt_set, user_ids, recs) & valid
    precision = int(rec_hits.sum()) / max(int(valid.sum()), 1)

    # For each ground-truth pair: is its item among that user's recs?
    order = torch.argsort(user_ids)
    sorted_uids = user_ids[order]
    pos = torch.searchsorted(sorted_uids, gt_users_t).clamp(0, sorted_uids.shape[0] - 1)
    row = order[pos]
    known_user = sorted_uids[pos] == gt_users_t
    gt_in_recs = (recs[row] == gt_items_t[:, None]).any(dim=1)
    recall = int((gt_in_recs & known_user).sum()) / gt_users_t.shape[0]

    # -1 slots go to an overflow column that is dropped.
    flat = recs.reshape(-1)
    covered = torch.zeros(num_items + 1, dtype=torch.bool, device=dev)
    covered[torch.where(flat >= 0, flat, torch.full_like(flat, num_items))] = True
    coverage = int(covered[:num_items].sum()) / num_items
    return precision, recall, coverage


def get_metrics_at_k(
    user_emb,
    item_emb,
    ground_truth: Tuple[np.ndarray, np.ndarray],
    already_bought: Optional[Tuple[np.ndarray, np.ndarray]],
    k: int,
    remove_already_bought: bool = True,
    score_fn=None,
    popularity=None,
    weight_popularity: float = 1.0,
    backend: str = "auto",
    already_bought_cap: Optional[int] = None,
    device=None,
) -> Tuple[float, float, float]:
    """Recs for the unique ground-truth users, then (precision, recall,
    coverage) (reference ``get_metrics_at_k``, src/metrics.py:110-134).

    backend: ``auto`` ranks with the CUDA MIPS kernel for cosine scoring on a
    CUDA device (as the JAX package picks its Pallas kernel on a TPU), else
    with the ``torch`` route.  ``device``: by default the device of
    ``user_emb`` (CUDA when it is not a tensor).
    already_bought_cap: bound on the padded already-bought row width (each
    user keeps its ``cap`` most recent purchases); None is exact.
    """
    dev = resolve_device(device, user_emb)
    gt_users, gt_items = (np.asarray(a) for a in ground_truth)
    uniq = np.unique(gt_users)
    already_table = None
    if already_bought is not None:
        # Rows must cover every queried user id, not just the buyers.
        n_src = int(user_emb.shape[0])
        if len(already_bought[0]):
            n_src = max(n_src, int(np.max(already_bought[0])) + 1)
        if len(uniq):
            n_src = max(n_src, int(uniq.max()) + 1)
        already_table = build_padded_pair_set(
            already_bought[0], already_bought[1], num_src=n_src, cap=already_bought_cap,
        )
    user_ids = torch.as_tensor(uniq, dtype=torch.int64, device=dev)
    recs = get_recs(
        user_emb, item_emb, user_ids, k,
        already_bought=already_table, remove_already_bought=remove_already_bought,
        score_fn=score_fn, popularity=popularity, weight_popularity=weight_popularity,
        backend=backend, device=dev,
    )
    return recs_to_metrics(recs, user_ids, gt_users, gt_items, int(item_emb.shape[0]))
