"""The CUDA kernels against their plain versions, on the card.

Marked ``cuda``; without a card every test skips (the decision is made in a
fixture).  On a CUDA host, without JAX installed::

    python -m pytest --noconftest -p no:cacheprovider -q -m cuda \
        tests/test_torch_cuda_kernels.py
"""

import numpy as np
import pytest
import torch

from gnn_recsys_tpu_torch.ops.cuda import leaf_agg as la
from gnn_recsys_tpu_torch.ops.cuda import pool_mask as pm
from gnn_recsys_tpu_torch.ops.cuda import topk_mips as tm

pytestmark = pytest.mark.cuda

TOL = 1e-5  # f32 FMAs in another order than the library product
# dW / db: sums over K*P terms in another order, relative to the largest
# entry; bf16 outputs: one bf16 ulp.
GRAD_REL = 1e-5
BF16_RTOL = 2.0**-7


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _emb(rng, n, d, dev, shift=0.0):
    return torch.tensor(rng.normal(size=(n, d)).astype(np.float32) + shift,
                        device=dev)


def assert_topk_close(vals, idx, rvals, ridx, exact_scores):
    """Values within TOL; indices equal except at near-tied slots, where the
    kernel's item must score within TOL of the slot's plain value."""
    vals, idx = vals.cpu().numpy(), idx.cpu().numpy()
    rvals, ridx = rvals.cpu().numpy(), ridx.cpu().numpy()
    np.testing.assert_allclose(vals, rvals, rtol=0, atol=TOL)
    for r, c in zip(*np.nonzero(idx != ridx)):
        assert abs(exact_scores[r, idx[r, c]] - rvals[r, c]) <= TOL, (r, c)
    for row in idx:
        assert len(set(row.tolist())) == len(row)


def _scores(ue, ie, bf16=False):
    u, i = tm._as_compute(ue, bf16).double(), tm._as_compute(ie, bf16).double()
    return (u @ i.T).cpu().numpy()


@pytest.mark.parametrize("u,i,d,k", [
    (17, 100, 16, 5), (128, 1000, 32, 10), (300, 30000, 128, 26),
    (70, 30000, 128, 266), (30000, 2000, 32, 10),
])
def test_mips_topk_matches_plain(dev, u, i, d, k):
    rng = np.random.default_rng(0)
    ue, ie = _emb(rng, u, d, dev), _emb(rng, i, d, dev)
    n0 = tm.mips_topk.launches
    vals, idx = tm.mips_topk(ue, ie, k)
    torch.cuda.synchronize()
    assert tm.mips_topk.launches == n0 + 1
    rvals, ridx = tm.mips_topk_reference(ue, ie, k)
    assert_topk_close(vals, idx, rvals, ridx, _scores(ue, ie))


def test_mips_topk_duplicates_lowest_index(dev):
    ue = torch.ones((4, 8), device=dev)
    ie = torch.ones((300, 8), device=dev)
    vals, idx = tm.mips_topk(ue, ie, 6)
    assert (vals.cpu() == 8.0).all()
    assert (idx.cpu() == torch.arange(6)).all()


def test_mips_topk_catalog_padding(dev):
    rng = np.random.default_rng(1)
    ue, ie = _emb(rng, 5, 8, dev), _emb(rng, 37, 8, dev, shift=-10.0)
    vals, idx = tm.mips_topk(ue, ie, 4)
    assert (idx.cpu() < 37).all() and torch.isfinite(vals).all()
    rvals, ridx = tm.mips_topk_reference(ue, ie, 4)
    assert_topk_close(vals, idx, rvals, ridx, _scores(ue, ie))


def test_mips_topk_bf16(dev):
    rng = np.random.default_rng(4)
    ue, ie = _emb(rng, 200, 128, dev), _emb(rng, 3000, 128, dev)
    vals, idx = tm.mips_topk(ue, ie, 26, bf16=True)
    rvals, ridx = tm.mips_topk_reference(ue, ie, 26, bf16=True)
    assert_topk_close(vals, idx, rvals, ridx, _scores(ue, ie, bf16=True))


@pytest.mark.parametrize("u,i,d,k,w", [(13, 333, 16, 6, 2.5), (300, 30000, 128, 26, 1.0)])
def test_mips_topk_boosted_matches_plain(dev, u, i, d, k, w):
    rng = np.random.default_rng(5)
    ue, ie = _emb(rng, u, d, dev), _emb(rng, i, d, dev)
    ue = ue / ue.norm(dim=1, keepdim=True)
    ie = ie / ie.norm(dim=1, keepdim=True)
    pop = torch.tensor(rng.uniform(0, 0.05, i).astype(np.float32), device=dev)
    m, s = tm.mips_lse(ue, ie)
    rm, rs = tm.mips_lse_reference(ue, ie)
    torch.testing.assert_close(m, rm, rtol=0, atol=TOL)
    torch.testing.assert_close(s, rs, rtol=TOL, atol=0)
    vals, idx = tm.mips_boost(ue, ie, pop, rm, rs, k, weight=w)
    rvals, ridx = tm.mips_boost_reference(ue, ie, pop, rm, rs, k, weight=w)
    sc = _scores(ue, ie)
    e = np.exp(sc - rm.double().cpu().numpy()[:, None])
    boosted = e / rs.double().cpu().numpy()[:, None] + w * pop.double().cpu().numpy()
    assert_topk_close(vals, idx, rvals, ridx, boosted)
    n0 = tm.mips_topk_boosted.launches
    v2, i2 = tm.mips_topk_boosted(ue, ie, pop, k, weight=w)
    assert tm.mips_topk_boosted.launches == n0 + 1
    assert_topk_close(v2, i2, rvals, ridx, boosted)


def test_cpu_tensors_take_the_plain_version(dev):
    rng = np.random.default_rng(7)
    ue, ie = _emb(rng, 9, 8, "cpu"), _emb(rng, 50, 8, "cpu")
    n0 = tm.mips_topk.launches
    tm.mips_topk(ue, ie, 3)
    assert tm.mips_topk.launches == n0
    with pytest.raises(ValueError):
        tm.mips_topk(ue.to(dev), ie, 3)


def _leaf_case(dev, k, p, f, h, seed=0, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    x = torch.tensor(rng.normal(size=(k, p, f)).astype(np.float32), device=dev)
    mask = torch.tensor((rng.random((p, k)) < 0.7).astype(np.float32), device=dev)
    mask[p // 2] = 0.0  # an all-masked row
    ms = mask / mask.sum(dim=1, keepdim=True).clamp(min=1.0)
    w = torch.tensor((rng.normal(size=(f, h)) * 0.3).astype(np.float32), device=dev)
    b = torch.tensor((rng.normal(size=(h,)) * 0.1).astype(np.float32), device=dev)
    g = torch.tensor(rng.normal(size=(p, h)).astype(np.float32), device=dev)
    return x.to(dtype), ms, w.to(dtype), b.to(dtype), g.to(dtype)


@pytest.mark.parametrize("k,p,f,h", [(8, 18432, 8, 256), (8, 2047, 8, 256), (4, 37, 5, 33),
                                     (16, 300, 128, 130), (1, 1, 1, 1)])
def test_leaf_mean_nn_matches_plain(dev, k, p, f, h):
    x, ms, w, b, g = _leaf_case(dev, k, p, f, h)
    n_fwd, n_bwd = la.leaf_mean_nn_fwd.launches, la.leaf_mean_nn_bwd.launches
    out = la.leaf_mean_nn_fwd(x, ms, w, b)
    dw, db = la.leaf_mean_nn_bwd(x, ms, w, b, g)
    torch.cuda.synchronize()
    assert (la.leaf_mean_nn_fwd.launches, la.leaf_mean_nn_bwd.launches) == (n_fwd + 1, n_bwd + 1)
    torch.testing.assert_close(out, la.leaf_mean_nn_reference(x, ms, w, b), rtol=0, atol=TOL)
    assert (out[p // 2] == 0).all()
    rdw, rdb = la.leaf_mean_nn_bwd_reference(x, ms, w, b, g)
    for got, want in ((dw, rdw), (db, rdb)):
        assert float((got - want).abs().max()) <= GRAD_REL * max(1.0, float(want.abs().max()))
    # No atomics: a second run gives bit-identical gradients.
    dw2, db2 = la.leaf_mean_nn_bwd(x, ms, w, b, g)
    assert torch.equal(dw, dw2) and torch.equal(db, db2)


def test_leaf_mean_nn_bf16_and_autograd(dev):
    x, ms, w, b, g = _leaf_case(dev, 8, 4608, 8, 256, seed=1, dtype=torch.bfloat16)
    out = la.leaf_mean_nn_fwd(x, ms, w, b)
    assert out.dtype == torch.bfloat16
    torch.testing.assert_close(out.float(), la.leaf_mean_nn_reference(x, ms, w, b).float(),
                               rtol=BF16_RTOL, atol=1e-6)
    x, ms, w, b, g = _leaf_case(dev, 8, 1000, 8, 64, seed=2)
    wk, bk = w.clone().requires_grad_(), b.clone().requires_grad_()
    (la.leaf_mean_nn(x, ms, wk, bk) * g).sum().backward()
    wr, br = w.clone().requires_grad_(), b.clone().requires_grad_()
    (la.leaf_mean_nn_reference(x, ms, wr, br) * g).sum().backward()
    torch.testing.assert_close(wk.grad, wr.grad, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(bk.grad, br.grad, rtol=1e-4, atol=1e-4)


def test_train_minibatch_runs_the_kernels_on_the_card(dev):
    """The trainer entry point on the card: both kernels launch, the loss is
    finite, and a seed gives the same parameters wherever they are drawn."""
    from gnn_recsys_tpu_torch.models.conv_model import ConvModel
    from gnn_recsys_tpu_torch.train.full_batch import init_model
    from gnn_recsys_tpu_torch.train.minibatch import MinibatchConfig, train_minibatch
    from gnn_recsys_tpu_torch.utils.synthetic import make_synthetic_data

    data = make_synthetic_data(num_users=200, num_items=80, seed=0)
    g = data.graph
    model = ConvModel(g.canonical_etypes, (("user", 8), ("item", 8), ("hidden", 32), ("out", 16)),
                      aggregator_type="mean_nn", leaf_kernel=True).to(dev)
    on_cpu = init_model(ConvModel(g.canonical_etypes, model.dims, aggregator_type="mean_nn"), 11)
    cfg = MinibatchConfig(edge_batch_size=256, fanouts=(4, 4), neg_mode="dense_pool",
                          neg_pool_size=64, pool_mask_kernel=True, num_epochs=2, metrics_every=0)
    on_dev = init_model(model, 11)
    assert all(torch.equal(v, on_dev[k].cpu()) for k, v in on_cpu.items())
    n_fwd, n_bwd = la.leaf_mean_nn_fwd.launches, la.leaf_mean_nn_bwd.launches
    n_pool = pm.pool_membership_mask.launches
    feats = {nt: g.ndata[nt]["features"] for nt in g.ntypes}
    _, hist = train_minibatch(model, g, g, feats,
                              {et: np.arange(g.num_edges(et)) for et in data.train_pairs},
                              None, cfg)
    assert np.isfinite(hist["train_loss"]).all()
    assert la.leaf_mean_nn_fwd.launches > n_fwd and la.leaf_mean_nn_bwd.launches > n_bwd
    assert pm.pool_membership_mask.launches > n_pool


@pytest.mark.parametrize("b,k,p", [(1024, 32, 2560), (1000, 24, 2500), (3, 128, 7)])
def test_pool_membership_mask_matches_plain(dev, b, k, p):
    rng = np.random.default_rng(3)
    rows = rng.integers(0, 3000, (b, k)).astype(np.int32)
    valid = rng.integers(0, k + 1, b)
    valid[0] = k
    rows[np.arange(k)[None, :] >= valid[:, None]] = -1
    pool = rng.integers(0, 3000, p).astype(np.int32)
    n = min(p, k)
    pool[:n] = rows[0, :n]  # make sure some pairs hit
    pool[-1] = -1  # never matches, though rows are -1 padded
    rows_t, pool_t = torch.tensor(rows, device=dev), torch.tensor(pool, device=dev)
    n0 = pm.pool_membership_mask.launches
    out = pm.pool_membership_mask(rows_t, pool_t)
    torch.cuda.synchronize()
    assert pm.pool_membership_mask.launches == n0 + 1
    assert torch.equal(out, pm.pool_membership_mask_reference(rows_t, pool_t))
    assert float(out.sum()) > 0 and (out[:, -1] == 0).all()
    with pytest.raises(ValueError):
        pm.pool_membership_mask(torch.zeros((2, 129), dtype=torch.int32, device=dev), pool_t)


def _gather_case(dev, b, k, n, d, seed=0):
    """Random table, ids with -1 and >= n among the valid slots (clipped), and
    an all-masked row."""
    rng = np.random.default_rng(seed)
    h = torch.tensor(rng.normal(size=(n, d)).astype(np.float32), device=dev)
    nbr = rng.integers(0, n, (b, k)).astype(np.int32)
    mask = rng.random((b, k)) < 0.8
    mask[b // 2] = False
    nbr[0, 0], nbr[-1, -1] = -1, n + 3
    mask[0, 0] = mask[-1, -1] = True
    g = torch.tensor(rng.normal(size=(b, d)).astype(np.float32), device=dev)
    return h, torch.tensor(nbr, device=dev), torch.tensor(mask, device=dev), g


@pytest.mark.parametrize("b,k,n,d", [(38912, 8, 30000, 256), (2048, 4, 20992, 256),
                                     (13, 8, 50, 16), (7, 40, 20, 33), (5, 3, 10, 6)])
def test_gather_mean_matches_plain(dev, b, k, n, d):
    """Forward and backward at the dedup step's shapes, with K > 32 and a D
    that is not a multiple of 4 (the scalar path).  The backward adds with
    atomics: its sums come in another order than the plain version's, and
    in another order on every run."""
    from gnn_recsys_tpu_torch.ops.cuda import gather_mean as gm

    h, nbr, mask, g = _gather_case(dev, b, k, n, d)
    n_fwd, n_bwd = gm.gather_mean_fwd.launches, gm.gather_mean_bwd.launches
    out = gm.gather_mean_fwd(h, nbr, mask)
    dh = gm.gather_mean_bwd(g, nbr.long(), mask, n)
    torch.cuda.synchronize()
    assert (gm.gather_mean_fwd.launches, gm.gather_mean_bwd.launches) == (n_fwd + 1, n_bwd + 1)
    want = gm.gather_mean_reference(h, nbr, mask)
    assert float((out - want).abs().max()) <= TOL * max(1.0, float(want.abs().max()))
    assert (out[b // 2] == 0).all()
    want_dh = gm.gather_mean_bwd_reference(g, nbr, mask, n)
    assert float((dh - want_dh).abs().max()) <= GRAD_REL * max(1.0, float(want_dh.abs().max()))


def test_gather_mean_autograd_and_refusals(dev):
    from gnn_recsys_tpu_torch.ops.cuda import gather_mean as gm

    h, nbr, mask, g = _gather_case(dev, 300, 8, 500, 64, seed=1)
    hk, hr = h.clone().requires_grad_(), h.clone().requires_grad_()
    (gm.gather_mean(hk, nbr, mask) * g).sum().backward()
    (gm.gather_mean_reference(hr, nbr, mask) * g).sum().backward()
    torch.testing.assert_close(hk.grad, hr.grad, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError):
        gm.gather_mean_fwd(h.bfloat16(), nbr, mask)
    with pytest.raises(ValueError):
        gm.gather_mean_fwd(h, nbr.cpu(), mask)


def test_dedup_step_launch_counts(dev):
    """One dense-pool step through the dedup'd block forward: 8 gather-mean
    forward and 8 backward launches (2 levels x 2 node types x 2 in-etypes),
    2 pool masks, no leaf kernel."""
    from gnn_recsys_tpu_torch.models.conv_model import ConvModel
    from gnn_recsys_tpu_torch.ops.cuda import gather_mean as gm
    from gnn_recsys_tpu_torch.ops.membership import build_padded_pair_set
    from gnn_recsys_tpu_torch.ops.sampling import Draws
    from gnn_recsys_tpu_torch.train.full_batch import TrainState
    from gnn_recsys_tpu_torch.train.minibatch import (
        EdgeStore,
        MinibatchConfig,
        make_minibatch_step,
    )
    from gnn_recsys_tpu_torch.utils.synthetic import make_synthetic_data

    data = make_synthetic_data(num_users=300, num_items=120, seed=0)
    g = data.graph.to(dev)
    model = ConvModel(g.canonical_etypes, (("user", 8), ("item", 8), ("hidden", 64), ("out", 32)),
                      aggregator_type="mean_nn", leaf_kernel=True).to(dev)
    cfg = MinibatchConfig(edge_batch_size=256, fanouts=(8, 4), neg_mode="dense_pool",
                          neg_pool_size=64, pool_mask_kernel=True, dedup=True)
    etypes = tuple(data.train_pairs)
    tables = {et: build_padded_pair_set(u, i, num_src=300).to(dev)
              for et, (u, i) in data.train_pairs.items()}
    step = make_minibatch_step(model, cfg, etypes, with_update=True, with_exclusion=True,
                               has_reverse={et: True for et in etypes})
    batch = EdgeStore(data.graph, etypes).batch({et: np.arange(128) for et in etypes}, True, dev)
    counters = (gm.gather_mean_fwd, gm.gather_mean_bwd, pm.pool_membership_mask,
                la.leaf_mean_nn_fwd, la.leaf_mean_nn_bwd)
    before = [fn.launches for fn in counters]
    _, loss = step(TrainState.create(model), g, {nt: g.ndata[nt]["features"] for nt in g.ntypes},
                   batch, tables, Draws(torch.Generator(device=dev).manual_seed(0)))
    torch.cuda.synchronize()
    assert torch.isfinite(loss)
    assert [fn.launches - n for fn, n in zip(counters, before)] == [8, 8, 2, 0, 0]
