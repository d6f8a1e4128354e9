"""Ranking losses.

Port of ``gnn_recsys_tpu/models/loss.py``:

* :func:`max_margin_loss` — the reference's hinge (``src/model.py:473-533``):
  per etype ``relu(neg + delta - pos - false_negative_mask)``, optionally
  divided by the positive's recency, then one mean over every score element
  of every etype.
* :func:`sampled_softmax_loss` — InfoNCE over the negatives, an extension of
  the JAX package (not in the reference).

``pair_mask`` (per-positive validity) excludes padded batch rows from the
mean; all-valid masks reproduce the plain mean.  ``parts=True`` returns the
mean's numerator and denominator, ``(total, count)``, so that a step split
over data shards can add the shards' parts before it divides.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from gnn_recsys_tpu_torch.graph.hetero import CanonicalEtype

Scores = Dict[CanonicalEtype, torch.Tensor]


def _zero(*score_dicts: Optional[Scores]) -> torch.Tensor:
    """The loss of no scores: a 0-d f32 zero (JAX's 0 / max(0, 1)), on the
    device of the first tensor given, or on the CPU when none is."""
    for d in score_dicts:
        for t in (d or {}).values():
            return torch.zeros((), dtype=torch.float32, device=t.device)
    return torch.zeros((), dtype=torch.float32)


def max_margin_loss(
    pos_score: Scores,
    neg_score: Scores,
    delta: float,
    negative_mask: Optional[Scores] = None,
    recency_scores: Optional[Scores] = None,
    pair_mask: Optional[Scores] = None,
    parts: bool = False,
):
    """pos_score[et]: [B]; neg_score[et]: [B, S]; negative_mask[et]: [B, S]
    f32 (1.0 cancels a false negative, the reference's subtract-the-mask
    trick); recency_scores[et]: [B] divisors; pair_mask[et]: [B] bool."""
    total = count = None
    for etype, neg in neg_score.items():
        b, s = neg.shape
        scores = neg + delta - pos_score[etype][:, None]
        if negative_mask is not None and etype in negative_mask:
            scores = scores - negative_mask[etype]
        scores = torch.relu(scores)
        if recency_scores is not None and etype in recency_scores:
            scores = scores / recency_scores[etype][:, None]
        if pair_mask is not None and etype in pair_mask:
            valid = pair_mask[etype].to(scores.dtype)[:, None]
            scores = scores * valid
            n = valid.sum() * s
        else:
            n = torch.full((), float(b * s), device=scores.device)  # a fill, no copy
        total = scores.sum() if total is None else total + scores.sum()
        count = n if count is None else count + n
    if total is None:
        zero = _zero(pos_score, negative_mask, recency_scores, pair_mask)
        return (zero, zero) if parts else zero
    if parts:
        return total, count
    return total / count.clamp(min=1.0)


def sampled_softmax_loss(
    pos_score: Scores,
    neg_score: Scores,
    tau: float = 0.1,
    negative_mask: Optional[Scores] = None,
    recency_scores: Optional[Scores] = None,
    pair_mask: Optional[Scores] = None,
    parts: bool = False,
):
    """Per positive, ``-log softmax([pos, neg_1..neg_S] / tau)[0]``; a false
    negative (``negative_mask`` > 0) leaves the partition function.  The
    per-positive weight is 1/recency (and 0 on padded rows)."""
    total = wsum = None
    for etype, neg in neg_score.items():
        neg = neg.float()
        pos = pos_score[etype].float()
        if negative_mask is not None and etype in negative_mask:
            neg = torch.where(negative_mask[etype] > 0, torch.full_like(neg, float("-inf")), neg)
        logits = torch.cat([pos[:, None], neg], dim=1) / tau
        nll = -torch.log_softmax(logits, dim=1)[:, 0]  # [B]
        w = torch.ones_like(nll)
        if recency_scores is not None and etype in recency_scores:
            w = w / recency_scores[etype]
        if pair_mask is not None and etype in pair_mask:
            w = w * pair_mask[etype].to(w.dtype)
        total = (nll * w).sum() if total is None else total + (nll * w).sum()
        wsum = w.sum() if wsum is None else wsum + w.sum()
    if total is None:
        zero = _zero(pos_score, negative_mask, recency_scores, pair_mask)
        return (zero, zero) if parts else zero
    if parts:
        return total, wsum
    return total / wsum.clamp(min=1e-9)
