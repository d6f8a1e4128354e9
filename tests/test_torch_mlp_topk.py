"""Ranking by the MLP head (``pred='nn'``) in one kernel: ``mlp_topk``'s
contract on its plain version (CPU tensors), and ``get_recs``'s routes.

``get_recs(..., backend="cuda")`` on CPU tensors takes the kernel route with
the wrapper's plain version, so its lists are held against the torch route
(user chunks through the score function's tile loop), the route every
``pred='nn'`` ranking took before the kernel.  The card's side:
``tests/test_torch_cuda_kernels.py`` (``-m cuda``) and ``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

from gnn_recsys_tpu_torch.ops.cuda import topk_mips as tm
from gnn_recsys_tpu_torch.ops.membership import build_padded_pair_set
from gnn_recsys_tpu_torch.retrieval import recs

D = 16  # embedding width
TOL = 1e-6  # the head's f32 score against its f64 value, near-tied slots


@pytest.fixture(autouse=True)
def fresh_counters(monkeypatch):
    for owner, attr in ((recs.make_mlp_score_fn, "pairs"), (tm.mlp_topk, "pairs"),
                        (tm.mlp_topk, "launches")):
        monkeypatch.setattr(owner, attr, 0)


def head_params(seed=0):
    """A pred='nn' head's state_dict at a trained head's scales."""
    g = torch.Generator().manual_seed(seed)

    def randn(*shape, scale):
        return scale * torch.randn(*shape, generator=g)

    return {"pred_layer.hidden_1.weight": randn(128, 2 * D, scale=0.3),
            "pred_layer.hidden_1.bias": randn(128, scale=0.1),
            "pred_layer.hidden_2.weight": randn(32, 128, scale=0.2),
            "pred_layer.hidden_2.bias": randn(32, scale=0.1),
            "pred_layer.output.weight": randn(1, 32, scale=0.3),
            "pred_layer.output.bias": randn(1, scale=0.1)}


def embeddings(users, items, seed=1):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(users, D, generator=g), torch.randn(items, D, generator=g)


def exact_scores(sd, ue, ie):
    """The head's score of every pair in f64: [U, I]."""
    p = {k: v.double() for k, v in sd.items()}
    x = torch.cat(torch.broadcast_tensors(ue.double()[:, None], ie.double()[None]), dim=-1)
    h = torch.relu(x @ p["pred_layer.hidden_1.weight"].T + p["pred_layer.hidden_1.bias"])
    h = torch.relu(h @ p["pred_layer.hidden_2.weight"].T + p["pred_layer.hidden_2.bias"])
    return torch.sigmoid(h @ p["pred_layer.output.weight"].T + p["pred_layer.output.bias"])[..., 0]


def assert_same_lists(got, want, exact):
    """Equal lists, except at near-tied slots, where both items score within
    TOL of each other (exactly, in f64); empty slots (-1) where the other
    has them."""
    assert got.shape == want.shape
    assert torch.equal(got < 0, want < 0)
    for r, c in zip(*torch.nonzero(got != want, as_tuple=True)):
        a, b = exact[r, got[r, c]], exact[r, want[r, c]]
        assert abs(float(a - b)) <= TOL, (int(r), int(c))


def bought_table(users, items, per_user, seed=2):
    rng = np.random.default_rng(seed)
    bi = np.concatenate([rng.choice(items, per_user, replace=False) for _ in range(users)])
    return build_padded_pair_set(np.repeat(np.arange(users), per_user), bi, num_src=users)


@pytest.mark.parametrize("users,items,k,bought", [
    (300, 700, 10, 5),  # U not a multiple of 128, I of 64 or 512; fetch 15 (shared lists)
    (130, 600, 40, 5),  # fetch 45 > 32 (lists in device memory on the card)
    (64, 40, 10, 35),   # 5 unbought items a user: trailing -1
    (17, 1030, 1, 0),   # nothing bought: no over-fetch
])
def test_kernel_route_gives_the_torch_routes_lists(users, items, k, bought):
    sd = head_params()
    ue, ie = embeddings(users, items)
    ids = torch.arange(users)
    ps = bought_table(users, items, bought) if bought else None
    fn = recs.make_mlp_score_fn(sd)
    want = recs.get_recs(ue, ie, ids, k, already_bought=ps, score_fn=fn, backend="torch")
    assert recs.make_mlp_score_fn.pairs == users * items and tm.mlp_topk.pairs == 0
    got = recs.get_recs(ue, ie, ids, k, already_bought=ps, score_fn=fn, backend="cuda")
    assert recs.make_mlp_score_fn.pairs == 2 * users * items
    assert tm.mlp_topk.pairs == users * items and tm.mlp_topk.launches == 0
    assert_same_lists(got, want, exact_scores(sd, ue, ie))
    if bought > items - k:
        assert (got[:, items - bought:] == -1).all() and (got[:, :items - bought] >= 0).all()


@pytest.mark.parametrize("users,items,k", [(300, 700, 15), (130, 600, 45), (5, 64, 64)])
def test_mlp_topk_plain_version_is_the_tile_loop(users, items, k):
    """On CPU tensors ``mlp_topk`` is the score function's tile loop, each
    user's scores sorted stably: the same values, and its lists."""
    sd = head_params(3)
    ue, ie = embeddings(users, items, seed=4)
    w1, b1, w2, b2, w3, b3 = recs.make_mlp_score_fn(sd).head(torch.device("cpu"))
    with tm.full_f32_matmul():
        a_u, a_i = recs.head_layer1(w1, b1, ue, ie)
    vals, idx = tm.mlp_topk(a_u, a_i, w2, b2, w3, b3, k)
    scores = recs.make_mlp_score_fn(sd)(ue, ie)
    want_vals, want_idx = tm.stable_topk(scores, k)
    assert vals.dtype == torch.float32 and idx.dtype == torch.int64
    torch.testing.assert_close(vals, want_vals, rtol=0, atol=TOL)
    assert_same_lists(idx, want_idx, exact_scores(sd, ue, ie))
    assert tm.mlp_topk.launches == 0 and tm.mlp_topk.pairs == users * items


def test_mlp_topk_ties_go_to_the_lowest_index():
    sd = head_params(5)
    w1, b1, w2, b2, w3, b3 = recs.make_mlp_score_fn(sd).head(torch.device("cpu"))
    ue, ie = embeddings(7, 1, seed=6)
    a_u, a_i = recs.head_layer1(w1, b1, ue, ie.expand(90, D))
    _, idx = tm.mlp_topk(a_u, a_i, w2, b2, w3, b3, 20)
    assert torch.equal(idx, torch.arange(20).expand(7, 20))


def _head_args():
    w1, b1, w2, b2, w3, b3 = recs.make_mlp_score_fn(head_params()).head(torch.device("cpu"))
    ue, ie = embeddings(6, 50)
    return [*recs.head_layer1(w1, b1, ue, ie), w2, b2, w3, b3]


@pytest.mark.parametrize("which,bad,k,match", [
    (0, lambda t: t.double(), 5, "a_u must be float32"),
    (1, lambda t: t.half(), 5, "a_i must be float32"),
    (0, lambda t: t[:, :64], 5, r"\[\*, 128\]"),
    (1, lambda t: t[None], 5, r"\[\*, 128\]"),
    (2, lambda t: t.T.contiguous(), 5, "the head must be"),
    (5, lambda t: torch.zeros(2), 5, "the head must be"),
    (None, None, 0, "must be in"),
    (None, None, 51, "must be in"),
])
def test_mlp_topk_refuses_what_the_kernel_cannot_rank(which, bad, k, match):
    args = _head_args()
    if which is not None:
        args[which] = bad(args[which])
    with pytest.raises(ValueError, match=match):
        tm.mlp_topk(*args, k)
    assert tm.mlp_topk.pairs == 0


def _plain_score_fn(u, items):
    return u @ items.T


CUDA, CPU = torch.device("cuda"), torch.device("cpu")


@pytest.mark.parametrize("backend,dev,fn,boosted,hub,mlp,route", [
    ("auto", CUDA, "head", False, False, True, "mlp"),
    ("cuda", CPU, "head", False, False, True, "mlp"),
    ("auto", CUDA, "head", True, False, True, "torch"),   # the popularity boost
    ("auto", CUDA, "head", False, True, True, "torch"),   # hub rows
    ("cuda", CUDA, "head", False, True, True, "torch"),
    ("auto", CPU, "head", False, False, True, "torch"),   # CPU tensors
    ("torch", CUDA, "head", False, False, True, "torch"),
    ("auto", CUDA, None, False, False, True, "mips"),
    ("auto", CUDA, None, True, False, True, "mips"),
    ("auto", CUDA, "plain", False, False, True, "torch"),  # a score function without a head
    # A caller without an mlp route (get_recs_sharded): the head on torch.
    ("auto", CUDA, "head", False, False, False, "torch"),
    ("auto", CUDA, None, False, False, False, "mips"),
    ("cuda", CPU, None, True, False, False, "mips"),
])
def test_ranking_route(backend, dev, fn, boosted, hub, mlp, route):
    score_fn = {"head": recs.make_mlp_score_fn(head_params()), "plain": _plain_score_fn,
                None: None}[fn]
    assert recs.ranking_route(backend, dev, score_fn, boosted, hub, mlp=mlp) == route


@pytest.mark.parametrize("fn,boosted,mlp,says", [
    ("plain", False, True, "cosine, or by the MLP head"),
    ("head", True, True, "cosine, or by the MLP head"),
    ("head", False, False, "cosine only"),
])
def test_cuda_backend_refuses_what_no_kernel_scores(fn, boosted, mlp, says):
    score_fn = recs.make_mlp_score_fn(head_params()) if fn == "head" else _plain_score_fn
    with pytest.raises(ValueError, match=f"the cuda backend scores by {says}"):
        recs.ranking_route("cuda", CUDA, score_fn, boosted, False, mlp=mlp)


def test_hub_rows_and_the_boost_take_the_torch_route():
    """Hub rows (wider than OVERFETCH_MAX_ROW) mask-then-rank on the torch
    route even on the cuda backend; a boosted nn ranking on CPU tensors takes
    the torch route: ``mlp_topk`` scores no pair."""
    sd = head_params(7)
    users, items = 9, 400
    ue, ie = embeddings(users, items, seed=8)
    ids = torch.arange(users)
    fn = recs.make_mlp_score_fn(sd)
    hubs = bought_table(users, items, recs.OVERFETCH_MAX_ROW + 1)
    got = recs.get_recs(ue, ie, ids, 5, already_bought=hubs, score_fn=fn, backend="cuda")
    want = recs.get_recs(ue, ie, ids, 5, already_bought=hubs, score_fn=fn, backend="torch")
    assert torch.equal(got, want)
    pop = torch.rand(items, generator=torch.Generator().manual_seed(9))
    recs.get_recs(ue, ie, ids, 5, score_fn=fn, popularity=pop, weight_popularity=0.1)
    assert tm.mlp_topk.pairs == 0 and recs.make_mlp_score_fn.pairs == 3 * users * items
