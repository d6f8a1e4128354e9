"""Batched full-catalog top-k retrieval.

Port of ``gnn_recsys_tpu/retrieval/recs.py``.  Scores are cosine
similarities of L2-normalized embeddings, with the optional popularity boost
``softmax(ratings) + w * popularity`` per row (reference
``src/metrics.py:69-72``).  Backends:

* ``torch`` (the JAX ``xla`` route): user chunks, one full-f32 ``[C, I]``
  product each (no TF32), then a tie-stable top-k.
* ``cuda`` (the JAX ``pallas`` route): the hand-written MIPS kernels of
  :mod:`gnn_recsys_tpu_torch.ops.cuda.topk_mips`, which never hold the
  ``[U, I]`` score block.  On CPU tensors the wrapper runs its plain version.
* ``auto``: ``cuda`` for cosine scoring on CUDA tensors, else ``torch``.

Already-bought filtering routes by row width; both routes are exact and
equal to the reference's filter-after-ranking:

* ``max_row <= OVERFETCH_MAX_ROW``: over-fetch — rank top-``(k + max_row)``
  and drop bought entries afterwards.
* wider rows (hub buyers): mask-then-rank — scatter each chunk user's row
  into a ``[C, I]`` ``-inf`` mask and take the top ``k`` (``torch`` route,
  on both backends).  Empty slots are ``-1``.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from gnn_recsys_tpu_torch.models.layers import l2_normalize
from gnn_recsys_tpu_torch.ops.cuda.topk_mips import (
    full_f32_matmul,
    mips_topk,
    mips_topk_boosted,
    stable_topk,
)
from gnn_recsys_tpu_torch.ops.membership import (
    PaddedPairSet,
    pair_set_contains,
    scatter_row_mask,
)

ScoreFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]  # ([C,D],[I,D]) -> [C,I]

# Widest already-bought row for which retrieval over-fetches; wider rows
# take the mask-then-rank route (see the JAX package's note at recs.py:40).
OVERFETCH_MAX_ROW = 256


def cosine_score_fn(u_chunk: torch.Tensor, item_emb: torch.Tensor) -> torch.Tensor:
    """Cosine similarity of one chunk of users against the full catalog, in
    full f32 (TF32 reorders near-tied rankings)."""
    with full_f32_matmul():
        return l2_normalize(u_chunk) @ l2_normalize(item_emb).T


def model_score_fn(pred: str) -> Optional[ScoreFn]:
    """Retrieval score function for the model's predictor: ``None`` (the
    cosine path) for ``pred='cos'``."""
    if pred == "nn":
        raise NotImplementedError("the MLP head (pred='nn') is not ported yet (ROADMAP.md)")
    return None


def resolve_device(device, like) -> torch.device:
    """``device`` if given, else the device of tensor ``like``, else CUDA."""
    if device is not None:
        return torch.device(device)
    if isinstance(like, torch.Tensor):
        return like.device
    return torch.device("cuda")


def as_device_tensor(x, dtype, dev) -> torch.Tensor:
    """``x`` (tensor or array-like) as a ``dtype`` tensor on ``dev``."""
    if isinstance(x, torch.Tensor):
        return x.to(device=dev, dtype=dtype)
    return torch.as_tensor(np.asarray(x), dtype=dtype, device=dev)


def get_recs(
    user_emb,
    item_emb,
    user_ids,
    k: int,
    already_bought: Optional[PaddedPairSet] = None,
    remove_already_bought: bool = True,
    score_fn: Optional[ScoreFn] = None,
    popularity=None,
    weight_popularity: float = 1.0,
    chunk_size: int = 128,
    backend: str = "auto",
    device=None,
) -> torch.Tensor:
    """Top-k recommended item ids for each listed user: [U, k] int64.

    user_emb: [N_users, D]; item_emb: [I, D]; user_ids: [U] node ids.
    ``device``: where to rank; by default the device of ``user_emb`` (CUDA
    when it is not a tensor).
    """
    dev = resolve_device(device, user_emb)
    user_emb = as_device_tensor(user_emb, torch.float32, dev)
    item_emb = as_device_tensor(item_emb, torch.float32, dev)
    user_ids = as_device_tensor(user_ids, torch.int64, dev)
    if popularity is not None:
        popularity = as_device_tensor(popularity, torch.float32, dev).reshape(-1)
    if already_bought is not None:
        already_bought = already_bought.to(dev)
    if backend == "auto":
        backend = "cuda" if dev.type == "cuda" and score_fn is None else "torch"
    if backend not in ("torch", "cuda"):
        raise ValueError(f"unknown backend {backend!r}")

    mask_rows = (already_bought is not None and remove_already_bought
                 and already_bought.max_row > 0)
    hub_rows = mask_rows and already_bought.max_row > OVERFETCH_MAX_ROW
    if backend == "cuda":
        if score_fn is not None:
            raise ValueError("the cuda backend scores by cosine only (use 'torch' "
                             "for custom score functions)")
        if not hub_rows:
            return _get_recs_cuda(user_emb, item_emb, user_ids, k, already_bought,
                                  mask_rows, popularity, weight_popularity)
        # Hub rows: mask-then-rank on the torch route, bounded by the catalog.
    if score_fn is None:
        score_fn = cosine_score_fn
    num_items = item_emb.shape[0]
    fetch = k if hub_rows else min(k + (already_bought.max_row if mask_rows else 0),
                                   num_items)
    parts = []
    for lo in range(0, user_ids.shape[0], chunk_size):
        uids = user_ids[lo:lo + chunk_size]
        ratings = score_fn(user_emb[uids], item_emb)
        if popularity is not None:
            ratings = torch.softmax(ratings, dim=-1) + popularity[None, :] * weight_popularity
        if hub_rows:
            bought = scatter_row_mask(already_bought, uids, num_items)
            vals, top = stable_topk(ratings.masked_fill(bought, float("-inf")), fetch)
            # Fewer than k unbought items: trailing -inf slots become -1.
            top = torch.where(torch.isfinite(vals), top, torch.full_like(top, -1))
        else:
            _, top = stable_topk(ratings, fetch)
        parts.append(top)
    idx = (torch.cat(parts) if parts
           else torch.empty((0, fetch), dtype=torch.int64, device=dev))
    if hub_rows or not mask_rows:
        return idx[:, :k]
    return _drop_bought(idx, user_ids, already_bought, k)


def _drop_bought(idx: torch.Tensor, user_ids: torch.Tensor,
                 already_bought: PaddedPairSet, k: int) -> torch.Tensor:
    """Keep the first k unbought entries of each over-fetched row, in score
    order; a user with fewer than k unbought candidates gets -1 in the
    trailing slots."""
    bought = pair_set_contains(already_bought, user_ids, idx)  # [U, fetch]
    order = torch.argsort(bought.to(torch.int32), dim=1, stable=True)
    top = torch.take_along_dim(idx, order, dim=1)[:, :k]
    n_unbought = (~bought).sum(dim=1, keepdim=True)
    slot = torch.arange(k, device=idx.device)[None, :]
    return torch.where(slot < n_unbought, top, torch.full_like(top, -1))


def _get_recs_cuda(user_emb, item_emb, user_ids, k, already_bought, mask_rows,
                   popularity, weight_popularity) -> torch.Tensor:
    """Kernel retrieval with over-fetch masking: fetch top-(k + max_row)
    from the MIPS kernel and drop bought entries afterwards (the counterpart
    of the JAX ``_get_recs_pallas``)."""
    fetch = min(k + (already_bought.max_row if mask_rows else 0), item_emb.shape[0])
    ue = l2_normalize(user_emb[user_ids])
    ie = l2_normalize(item_emb)
    if popularity is not None:
        _, idx = mips_topk_boosted(ue, ie, popularity, fetch, weight=float(weight_popularity))
    else:
        _, idx = mips_topk(ue, ie, fetch)
    if not mask_rows:
        return idx[:, :k]
    return _drop_bought(idx, user_ids, already_bought, k)
