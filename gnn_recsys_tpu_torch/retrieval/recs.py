"""Batched full-catalog top-k retrieval.

Port of ``gnn_recsys_tpu/retrieval/recs.py``.  Scores are cosine
similarities of L2-normalized embeddings, or a custom score function (the
MLP head of a ``pred='nn'`` model, :func:`make_mlp_score_fn`), with the
optional popularity boost ``softmax(ratings) + w * popularity`` per row
(reference ``src/metrics.py:69-72``).  Backends:

* ``torch`` (the JAX ``xla`` route): user chunks, one full-f32 ``[C, I]``
  product each (no TF32), then a tie-stable top-k.
* ``cuda`` (the JAX ``pallas`` route): the hand-written kernels of
  :mod:`gnn_recsys_tpu_torch.ops.cuda.topk_mips`, which never hold the
  ``[U, I]`` score block: the MIPS kernels for cosine scoring, ``mlp_topk``
  for the MLP head without a popularity boost (the head's score function
  carries its weights, ``score_fn.head``).  On CPU tensors each wrapper runs
  its plain version.
* ``auto``: ``cuda`` on CUDA tensors for cosine scoring and for the MLP head
  without a boost, else ``torch``.

Already-bought filtering routes by row width; both routes are exact and
equal to the reference's filter-after-ranking:

* ``max_row <= OVERFETCH_MAX_ROW``: over-fetch — rank top-``(k + max_row)``
  and drop bought entries afterwards.
* wider rows (hub buyers): mask-then-rank — scatter each chunk user's row
  into a ``[C, I]`` ``-inf`` mask and take the top ``k`` (``torch`` route,
  on both backends).  Empty slots are ``-1``.
"""

from __future__ import annotations

from typing import Callable, Mapping, Optional, Union

import numpy as np
import torch
from torch import nn

from gnn_recsys_tpu_torch.models.layers import l2_normalize
from gnn_recsys_tpu_torch.ops.cuda.topk_mips import (
    full_f32_matmul,
    mips_topk,
    mips_topk_boosted,
    mlp_scores,
    mlp_topk,
    stable_topk,
)
from gnn_recsys_tpu_torch.ops.membership import (
    PaddedPairSet,
    pair_set_contains,
    scatter_row_mask,
)
from gnn_recsys_tpu_torch.utils.profiling import counter, span, to_device

ScoreFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]  # ([C,D],[I,D]) -> [C,I]

# Widest already-bought row for which retrieval over-fetches; wider rows
# take the mask-then-rank route (see the JAX package's note at recs.py:40).
OVERFETCH_MAX_ROW = 256


def cosine_score_fn(u_chunk: torch.Tensor, item_emb: torch.Tensor) -> torch.Tensor:
    """Cosine similarity of one chunk of users against the full catalog, in
    full f32 (TF32 reorders near-tied rankings)."""
    with full_f32_matmul():
        return l2_normalize(u_chunk) @ l2_normalize(item_emb).T


def head_layer1(w1: torch.Tensor, b1: torch.Tensor, user_rows: torch.Tensor,
                item_emb: torch.Tensor):
    """Layer 1 of the MLP head, factorised: ``concat(u, i) @ W1^T + b1 =
    (u @ W1[:, :D]^T + b1) + i @ W1[:, D:]^T``, so the user half ``a_u``
    [C, 128] and the item half ``a_i`` [I, 128] are one product each.  The
    caller picks the matmul precision."""
    d = user_rows.shape[-1]
    return user_rows @ w1[:, :d].T + b1, item_emb @ w1[:, d:].T


def make_mlp_score_fn(params: Union[nn.Module, Mapping[str, torch.Tensor]],
                      item_tile: int = 512) -> ScoreFn:
    """Full-catalog scores of the trained MLP head (``pred='nn'``;
    ``recs.py:68-115``, reference ``src/metrics.py:61-63``).

    The first Dense on ``concat(u, i)`` factorises exactly
    (:func:`head_layer1`), so the item half is one ``[I, 128]`` product
    shared by every user chunk, and only the ``[C, T, 128]`` broadcast add
    and the 128 -> 32 -> 1 towers run per item tile of ``T = item_tile``
    items (:func:`~gnn_recsys_tpu_torch.ops.cuda.topk_mips.mlp_scores`).
    ``params``: a ``pred='nn'`` model or its state_dict.  Products in full
    f32.  Returns a ``ScoreFn`` for :func:`get_recs` (``torch`` route), which
    carries the head's f32 weights: ``score_fn.head(device)`` gives (w1, b1,
    w2, b2, w3, b3) on ``device``, moved there once (a mesh's shards call
    from several), and :func:`get_recs` ranks by it with ``mlp_topk``.  Each
    call runs in a ``gnn.pred.rank`` span (both halves of the first Dense,
    the tiles and the sigmoid) and adds the score tensor's elements (C x I)
    to the counter ``make_mlp_score_fn.pairs``."""
    sd = params.state_dict() if isinstance(params, nn.Module) else params
    weights = tuple(sd[f"pred_layer.{lin}.{leaf}"].detach().float()
                    for lin in ("hidden_1", "hidden_2", "output") for leaf in ("weight", "bias"))
    on_device = {}

    def head(dev: torch.device):
        if dev not in on_device:
            on_device[dev] = tuple(t.to(dev) for t in weights)
        return on_device[dev]

    def score_fn(u_chunk: torch.Tensor, item_emb: torch.Tensor) -> torch.Tensor:
        w1, b1, w2, b2, w3, b3 = head(u_chunk.device)
        with span("gnn.pred.rank"), full_f32_matmul():
            a_u, a_i = head_layer1(w1, b1, u_chunk, item_emb)
            scores = mlp_scores(a_u, a_i, w2, b2, w3, b3, item_tile)
        make_mlp_score_fn.pairs += scores.numel()
        return scores

    score_fn.head = head
    return score_fn


counter(make_mlp_score_fn, "pairs")


def model_score_fn(pred: str, params) -> Optional[ScoreFn]:
    """Retrieval score function of the model's trained predictor
    (``recs.py:117-128``): ``None`` (the cosine path) for ``pred='cos'``,
    the factorised MLP head of ``params`` (a model or its state_dict) for
    ``pred='nn'``, so that retrieval ranks with the function training
    optimised."""
    if pred == "nn":
        return make_mlp_score_fn(params)
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
        return to_device(x, dev).to(dtype)
    return to_device(torch.as_tensor(np.asarray(x), dtype=dtype), dev)


def ranking_route(backend: str, dev: torch.device, score_fn: Optional[ScoreFn],
                  boosted: bool, hub_rows: bool, mlp: bool = True) -> str:
    """How retrieval ranks: ``"mips"`` (the MIPS kernels, cosine scoring),
    ``"mlp"`` (``mlp_topk``, a score function that carries the MLP head's
    weights, ``score_fn.head``, without a boost) or ``"torch"`` (user chunks
    through the score function, then a stable sort).  ``auto`` takes a
    kernel on CUDA devices where one scores the request; hub rows
    (``hub_rows``) mask-then-rank on the torch route on both backends.
    ``mlp=False``: the caller has no ``mlp`` route, so the head ranks on the
    torch route, and the cuda backend scores by cosine only."""
    kernel_scores = score_fn is None or (mlp and hasattr(score_fn, "head") and not boosted)
    if backend == "auto":
        backend = "cuda" if dev.type == "cuda" and kernel_scores else "torch"
    if backend not in ("torch", "cuda"):
        raise ValueError(f"unknown backend {backend!r}")
    if backend == "cuda" and not kernel_scores:
        what = ", or by the MLP head without a popularity boost," if mlp else " only"
        raise ValueError(f"the cuda backend scores by cosine{what} (use 'torch' for "
                         "other score functions)")
    if backend == "torch" or hub_rows:
        return "torch"
    return "mips" if score_fn is None else "mlp"


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
    mask_rows = (already_bought is not None and remove_already_bought
                 and already_bought.max_row > 0)
    hub_rows = mask_rows and already_bought.max_row > OVERFETCH_MAX_ROW
    route = ranking_route(backend, dev, score_fn, popularity is not None, hub_rows)
    if route == "mlp":
        return _get_recs_mlp(score_fn.head(dev), user_emb, item_emb, user_ids, k,
                             already_bought, mask_rows)
    if route == "mips":
        return _get_recs_cuda(user_emb, item_emb, user_ids, k, already_bought,
                              mask_rows, popularity, weight_popularity)
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
    """Kernel retrieval by cosine (the counterpart of the JAX
    ``_get_recs_pallas``): the MIPS kernel's top-(k + max_row), then
    :func:`_overfetched`."""

    def rank(fetch):
        ue = l2_normalize(user_emb[user_ids])
        ie = l2_normalize(item_emb)
        if popularity is not None:
            return mips_topk_boosted(ue, ie, popularity, fetch, weight=float(weight_popularity))
        return mips_topk(ue, ie, fetch)

    return _overfetched(rank, item_emb.shape[0], user_ids, k, already_bought, mask_rows)


def _get_recs_mlp(weights, user_emb, item_emb, user_ids, k, already_bought,
                  mask_rows) -> torch.Tensor:
    """Ranking by the MLP head's ``weights`` (w1, b1, w2, b2, w3, b3) in one
    kernel: layer 1's two halves once a request, then ``mlp_topk`` for
    top-(k + max_row), inside one ``gnn.pred.rank`` span, then
    :func:`_overfetched`; adds U x I to ``make_mlp_score_fn.pairs``."""
    w1, b1, w2, b2, w3, b3 = weights

    def rank(fetch):
        with span("gnn.pred.rank"), full_f32_matmul():
            a_u, a_i = head_layer1(w1, b1, user_emb[user_ids], item_emb)
            ranked = mlp_topk(a_u, a_i, w2, b2, w3, b3, fetch)
        make_mlp_score_fn.pairs += user_ids.shape[0] * item_emb.shape[0]
        return ranked

    return _overfetched(rank, item_emb.shape[0], user_ids, k, already_bought, mask_rows)


def _overfetched(rank, num_items, user_ids, k, already_bought, mask_rows) -> torch.Tensor:
    """Over-fetch masking around a kernel's ranking: ``rank(fetch)`` gives
    each user's (values, indices) top-``fetch``, fetch = k + max_row (at
    most the catalog); bought entries are dropped afterwards."""
    fetch = min(k + (already_bought.max_row if mask_rows else 0), num_items)
    _, idx = rank(fetch)
    if not mask_rows:
        return idx[:, :k]
    return _drop_bought(idx, user_ids, already_bought, k)
