"""The reference's on-demand answer ranked by the run's own predictor: the
cosine, optionally boosted by popularity, or the MLP pair scorer
(``pred='nn'``), already-bought items removed, and a judge of served top-k
lists against it.

* ``cos``: :mod:`.serve`'s cosine scores.
* Boosted (hieucnm/GNN-RecSys ``src/metrics.py:69-72``): ``softmax(cosine
  row over the whole catalog) + w * popularity``, the softmax taken before
  bought items are removed.
* ``nn`` (``src/model.py:240-305``, ranked as ``src/metrics.py:61-63``
  ranks): every ``[h_u ; h_i]`` pair through :func:`.pred_nn.score`, the
  concatenation and three Denses, unfactorised, so that it stays
  independent of the program's factorised head.

Bought items are then set to -inf and each answer is judged by
:func:`.serve.widest_gap`.  Plain torch; the caller switches TF32 off (or
on, for the control).  ``q`` rounds each product's inputs and output.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from portbench.reference import model as ref
from portbench.reference import pred_nn
from portbench.reference.serve import BUYS, widest_gap

ScoreFn = Callable[[torch.Tensor], torch.Tensor]  # users [n] -> [n, I] scores


def popularity(graph: ref.Graph) -> torch.Tensor:
    """[I] each item's share of the graph's purchases."""
    n = torch.bincount(graph.dst[BUYS].long(), minlength=graph.num_nodes["item"]).double()
    return (n / n.sum()).float()


def scorer(P: Dict[str, torch.Tensor], h: Dict[str, torch.Tensor], pred: str,
           pop: Optional[torch.Tensor] = None, weight: float = 0.0,
           q=ref.identity) -> ScoreFn:
    """The scores of a block of users against the whole catalog, bought
    items not yet removed: the predictor ``pred``, then the boost where
    ``pop`` is given."""
    if pred == "nn":
        head = {k: v for k, v in P.items() if k.startswith("pred_layer.")}
        item = h["item"][None, :, :]
        raw = lambda users: pred_nn.score(head, h["user"][users][:, None, :], item, q)  # noqa: E731
    elif pred == "cos":
        ni = ref.cosine_normalize(h["item"])
        raw = lambda users: q(ref.cosine_normalize(h["user"][users]) @ ni.T)  # noqa: E731
    else:
        raise ValueError(f"unknown predictor {pred!r}")
    if pop is None:
        return raw
    return lambda users: torch.softmax(raw(users), dim=-1) + weight * pop[None, :]


def allowed(scores: torch.Tensor, graph: ref.Graph, users: torch.Tensor,
            bought_keys: torch.Tensor) -> torch.Tensor:
    """``scores`` with -inf at each user's bought items."""
    n_items = scores.shape[1]
    bought = ref.contains(bought_keys, users[:, None],
                          torch.arange(n_items, device=users.device)[None, :], n_items)
    return scores.masked_fill(bought, float("-inf"))


def top_k(score: ScoreFn, graph: ref.Graph, users: torch.Tensor, k: int,
          block: int = 128) -> torch.Tensor:
    """The reference's own answer: each user's k best allowed items."""
    keys = ref.pair_keys(graph.src[BUYS], graph.dst[BUYS], graph.num_nodes["item"])
    with torch.no_grad():
        return torch.cat([torch.topk(allowed(score(users[lo:lo + block]), graph,
                                             users[lo:lo + block], keys), k, dim=1).indices
                          for lo in range(0, users.shape[0], block)])


def judge(score: ScoreFn, graph: ref.Graph, requests: Sequence[Sequence[int]],
          answers: Sequence[torch.Tensor], k: int, block: int = 128) -> float:
    """The widest gap over every row of every answer.  Requests that list
    the same users (every ``'all'`` request) share each block's scores,
    computed once and held against each such answer's rows."""
    if len(requests) != len(answers):
        return float("inf")
    dev = graph.src[BUYS].device
    keys = ref.pair_keys(graph.src[BUYS], graph.dst[BUYS], graph.num_nodes["item"])
    groups: Dict[bytes, list] = {}
    for users, served in zip(requests, answers):
        users = np.asarray(users, dtype=np.int64)
        groups.setdefault(users.tobytes(), [users, []])[1].append(served)
    worst = 0.0
    with torch.no_grad():
        for users, served in groups.values():
            users = torch.as_tensor(users, device=dev)
            served = [torch.as_tensor(s, dtype=torch.int64, device=dev) for s in served]
            if any(s.shape[0] != users.shape[0] for s in served):
                return float("inf")
            for lo in range(0, users.shape[0], block):
                u = users[lo:lo + block]
                s = allowed(score(u), graph, u, keys)
                for ans in served:
                    worst = max(worst, widest_gap(s, ans[lo:lo + block], k))
    return worst
