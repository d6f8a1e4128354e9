"""Qualitative evaluation: example recommendations, similar sports,
demographic coverage.

Port of ``gnn_recsys_tpu/evaluation/explore.py`` (the reference's
``src/evaluation.py:52-226``) on the port's tables: given recommendations
(node-id lists by user), the id maps (``dict[str, np.ndarray]``) and the
ETL's tables, print what random users bought and clicked against what was
recommended (:func:`explore_recs`), the most similar sports by embedding
cosine (:func:`explore_sports`), and the share of junior / male / female /
eco items among recommendations against transactions
(:func:`check_coverage`).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from gnn_recsys_tpu_torch.config import ColumnConfig
from gnn_recsys_tpu_torch.data.table import isna
from gnn_recsys_tpu_torch.models.layers import l2_normalize

FLAGS = ("is_junior", "is_male", "is_female", "eco_design")


def _first_rows(table, col: str) -> Dict:
    """Each value of ``table[col]`` -> the row where it first appears."""
    first: Dict = {}
    for row, value in enumerate(table[col].tolist()):
        first.setdefault(value, row)
    return first


def _rows_of_user(user_item_train, u) -> Dict[str, list]:
    if user_item_train is None or "ctm_new_id" not in user_item_train:
        return {}
    hit = np.asarray(user_item_train["ctm_new_id"]) == u
    return {name: np.asarray(user_item_train[name])[hit].tolist()
            for name in ("pdt_new_id", ColumnConfig().buy)}


def explore_recs(
    recs: Dict[int, Sequence[int]],
    user_item_train,
    item_info_df,
    pdt_id,
    ctm_id,
    ground_truth: Optional[Dict[int, Sequence[int]]] = None,
    num_choices: int = 10,
    item_id_type: Optional[str] = None,
    columns: Optional[ColumnConfig] = None,
    seed: int = 11,
    print_fn=print,
) -> None:
    """Print bought / clicked / recommended / ground-truth items of random
    users (reference src/evaluation.py:52-149)."""
    c = columns or ColumnConfig()
    item_col = item_id_type or c.specific_item_id
    rng = np.random.default_rng(seed)
    uids = list(recs.keys())
    chosen = rng.choice(uids, size=min(num_choices, len(uids)), replace=False)

    item_map = dict(zip(np.asarray(pdt_id["pdt_new_id"]).tolist(),
                        np.asarray(pdt_id[item_col]).tolist()))
    user_map = dict(zip(np.asarray(ctm_id["ctm_new_id"]).tolist(),
                        np.asarray(ctm_id[c.ctm_id]).tolist()))
    has_info = item_info_df is not None and item_col in item_info_df
    if has_info:
        first = _first_rows(item_info_df, item_col)
        shown = [name for name in item_info_df.columns if name != item_col][:4]

    def describe(item_node_ids):
        ext = [item_map.get(int(i), f"<{int(i)}>") for i in item_node_ids]
        if not has_info:
            return ext
        return [f"{e} {dict((name, item_info_df[name][first[e]]) for name in shown)}"
                if e in first else str(e) for e in ext]

    for u in chosen:
        print_fn(f"\nUser {user_map.get(int(u), u)} (node {int(u)}):")
        hist = _rows_of_user(user_item_train, u)
        if hist.get("pdt_new_id"):
            pairs = list(zip(hist["pdt_new_id"], hist[c.buy]))
            print_fn(f"  bought:      {describe([i for i, b in pairs if b == 1][:8])}")
            print_fn(f"  clicked:     {describe([i for i, b in pairs if b == 0][:8])}")
        # Drop the -1 "no recommendation" sentinel (hub users who already
        # bought nearly the whole catalog).
        rec_row = [r for r in list(recs[u]) if int(r) >= 0]
        print_fn(f"  recommended: {describe(rec_row[:10])}")
        if ground_truth is not None and u in ground_truth:
            print_fn(f"  ground truth:{describe(list(ground_truth[u])[:8])}")


def explore_sports(
    sport_emb,
    sport_feat_df,
    spt_id,
    num_choices: int = 10,
    top: int = 5,
    seed: int = 11,
    columns: Optional[ColumnConfig] = None,
    print_fn=print,
) -> Dict[str, list]:
    """Top similar sports by embedding cosine (reference
    src/evaluation.py:152-176).  Returns {sport name: [similar names]}."""
    c = columns or ColumnConfig()
    emb = l2_normalize(torch.as_tensor(np.asarray(sport_emb, dtype=np.float32))).numpy()
    sims = emb @ emb.T
    name_col = [col for col in sport_feat_df.columns if col != c.spt_id][0]
    id_to_name = dict(zip(np.asarray(spt_id["spt_new_id"]).tolist(),
                          np.asarray(spt_id[c.spt_id]).tolist()))
    ext_to_name = dict(zip(np.asarray(sport_feat_df[c.spt_id]).tolist(),
                           np.asarray(sport_feat_df[name_col]).tolist()))

    rng = np.random.default_rng(seed)
    n = emb.shape[0]
    chosen = rng.choice(n, size=min(num_choices, n), replace=False)

    def nm(x):
        e = id_to_name.get(int(x), x)
        return str(ext_to_name.get(e, e))

    out = {}
    for s in chosen:
        similar = [x for x in np.argsort(-sims[s]) if x != s][:top]
        out[nm(s)] = [nm(x) for x in similar]
        print_fn(f"{nm(s)} -> {out[nm(s)]}")
    return out


def check_coverage(
    user_item_train,
    item_feat_df,
    pdt_id,
    recs: Dict[int, Sequence[int]],
    item_id_type: Optional[str] = None,
    columns: Optional[ColumnConfig] = None,
    print_fn=print,
) -> Dict[str, Dict[str, float]]:
    """Demographic shares of recommendations against transactions
    (reference src/evaluation.py:179-226): ``{'transactions': {...},
    'recommendations': {...}}`` with the share of junior / male / female /
    eco items, and ``generic``, the share of items with none of them."""
    c = columns or ColumnConfig()
    item_col = item_id_type or c.specific_item_id
    first = _first_rows(item_feat_df, item_col)
    flag_cols = {f: np.asarray(item_feat_df[f], dtype=np.float64)
                 for f in FLAGS if f in item_feat_df}

    def shares(item_ext_ids):
        rows = np.array([first.get(e, -1) for e in item_ext_ids], dtype=np.int64)
        total = max(len(item_ext_ids), 1)
        vals = {}
        for f, col in flag_cols.items():
            v = np.where(rows >= 0, col[np.maximum(rows, 0)] if len(col) else 0.0, 0.0)
            vals[f] = np.where(isna(v), 0.0, v)
        out = {f: float(vals[f].sum()) / total if f in vals else 0.0 for f in FLAGS}
        known = sum(vals[f] for f in FLAGS) if len(vals) == len(FLAGS) else \
            np.zeros(len(rows))
        out["generic"] = float((known == 0).sum()) / total
        return out

    item_map = dict(zip(np.asarray(pdt_id["pdt_new_id"]).tolist(),
                        np.asarray(pdt_id[item_col]).tolist()))
    tx_ids = np.asarray(user_item_train["pdt_new_id"]).tolist() \
        if "pdt_new_id" in user_item_train else []
    tx_items = [item_map[int(i)] for i in tx_ids if int(i) in item_map]
    rec_items = [item_map[int(i)] for row in recs.values() for i in row if int(i) in item_map]

    result = {"transactions": shares(tx_items), "recommendations": shares(rec_items)}
    for key, val in result.items():
        print_fn(f"{key}: " + ", ".join(f"{k}={v:.3f}" for k, v in val.items()))
    return result
