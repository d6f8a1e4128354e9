"""The reference's on-demand answer: full-graph embeddings, cosine scores
of a user against the whole catalog, already-bought items removed, and a
judge of served top-k lists against them."""

from __future__ import annotations

from typing import Dict, Sequence

import torch

from portbench.reference import model as ref

BUYS = ("user", "buys", "item")


def embeddings(P, graph: ref.Graph, feats, n_conv: int, q=ref.identity) -> Dict[str, torch.Tensor]:
    with torch.no_grad():
        return ref.Model(P, graph, feats, q).full_graph(n_conv)


def allowed_scores(h: Dict[str, torch.Tensor], graph: ref.Graph, users: torch.Tensor,
                   bought_keys: torch.Tensor, q=ref.identity) -> torch.Tensor:
    """[U, I] cosine scores, -inf at each user's bought items."""
    nu = ref.cosine_normalize(h["user"][users])
    ni = ref.cosine_normalize(h["item"])
    scores = q(nu @ ni.T)
    n_items = ni.shape[0]
    bought = ref.contains(bought_keys, users[:, None],
                          torch.arange(n_items, device=users.device)[None, :], n_items)
    return scores.masked_fill(bought, float("-inf"))


def top_k(scores: torch.Tensor, k: int) -> torch.Tensor:
    return torch.topk(scores, k, dim=1).indices


def widest_gap(scores: torch.Tensor, served: torch.Tensor, k: int) -> float:
    """How far below each user's k-th best allowed score its served items
    lie, at the worst: 0 where every served item is among the best k (ties
    included); inf where a list is short, repeats an item, or serves an item
    outside the catalog or already bought."""
    if served.shape != (scores.shape[0], k):
        return float("inf")
    n_items = scores.shape[1]
    if bool(((served < 0) | (served >= n_items)).any()):
        return float("inf")
    srt = torch.sort(served, dim=1).values
    if bool((srt[:, 1:] == srt[:, :-1]).any()):
        return float("inf")
    kth = torch.topk(scores, k, dim=1).values[:, -1:]
    got = scores.gather(1, served)
    if not bool(torch.isfinite(got).all()):
        return float("inf")
    return float((kth - got).clamp(min=0).max())


def judge(h, graph: ref.Graph, requests: Sequence[Sequence[int]],
          answers: Sequence[torch.Tensor], k: int, block: int = 4096) -> float:
    """The widest gap over every request's served lists."""
    dev = h["user"].device
    keys = ref.pair_keys(graph.src[BUYS], graph.dst[BUYS], graph.num_nodes["item"])
    worst = 0.0
    for users, served in zip(requests, answers):
        users = torch.as_tensor(users, dtype=torch.int64, device=dev)
        served = torch.as_tensor(served, dtype=torch.int64, device=dev)
        for lo in range(0, users.shape[0], block):
            s = allowed_scores(h, graph, users[lo:lo + block], keys)
            worst = max(worst, widest_gap(s, served[lo:lo + block], k))
    return worst
