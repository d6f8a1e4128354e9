"""The CUDA kernels against their plain versions, on the card.

Marked ``cuda``; without a card every test skips (the decision is made in a
fixture).  On a CUDA host, without JAX installed::

    python -m pytest --noconftest -p no:cacheprovider -q -m cuda \
        tests/test_torch_cuda_kernels.py
"""

import ctypes

import numpy as np
import pytest
import torch

from gnn_recsys_tpu_torch.ops.cuda import leaf_agg as la
from gnn_recsys_tpu_torch.ops.cuda import lstm_cell as lc
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


def assert_topk_close(vals, idx, rvals, ridx, exact_scores, tol=TOL):
    """Values within ``tol``; indices equal except at near-tied slots, where
    the kernel's item must score within ``tol`` of the slot's plain value."""
    vals, idx = vals.cpu().numpy(), idx.cpu().numpy()
    rvals, ridx = rvals.cpu().numpy(), ridx.cpu().numpy()
    np.testing.assert_allclose(vals, rvals, rtol=0, atol=tol)
    for r, c in zip(*np.nonzero(idx != ridx)):
        assert abs(exact_scores[r, idx[r, c]] - rvals[r, c]) <= tol, (r, c)
    for row in idx:
        assert len(set(row.tolist())) == len(row)


def _scores(ue, ie, bf16=False):
    u, i = tm._as_compute(ue, bf16).double(), tm._as_compute(ie, bf16).double()
    return (u @ i.T).cpu().numpy()


@pytest.mark.parametrize("u,i,d,k", [
    (17, 100, 16, 5), (128, 1000, 32, 10), (300, 30000, 128, 26),
    (70, 30000, 128, 266), (30000, 2000, 32, 10),
    # k = max_k() (0 below); widths that are not a multiple of 4 (zero-padded
    # by the wrapper); k on both sides of the register lists' 32; users
    # streamed through the ring (D = 256 in f32), with k above 32 too.
    (70, 2000, 32, 0), (50, 3000, 6, 10), (300, 5000, 33, 26), (130, 4000, 30, 32),
    (200, 4000, 128, 33), (300, 5000, 256, 26), (70, 3000, 256, 100),
])
def test_mips_topk_matches_plain(dev, u, i, d, k):
    k = k or tm.max_k()
    rng = np.random.default_rng(0)
    ue, ie = _emb(rng, u, d, dev), _emb(rng, i, d, dev)
    n0 = tm.mips_topk.launches
    vals, idx = tm.mips_topk(ue, ie, k)
    torch.cuda.synchronize()
    assert tm.mips_topk.launches == n0 + 1
    rvals, ridx = tm.mips_topk_reference(ue, ie, k)
    assert_topk_close(vals, idx, rvals, ridx, _scores(ue, ie))


@pytest.mark.parametrize("k", [6, 100])
def test_mips_topk_duplicates_lowest_index(dev, k):
    ue = torch.ones((4, 8), device=dev)
    ie = torch.ones((300, 8), device=dev)
    vals, idx = tm.mips_topk(ue, ie, k)
    assert (vals.cpu() == 8.0).all()
    assert (idx.cpu() == torch.arange(k)).all()


def test_mips_topk_catalog_padding(dev):
    rng = np.random.default_rng(1)
    ue, ie = _emb(rng, 5, 8, dev), _emb(rng, 37, 8, dev, shift=-10.0)
    vals, idx = tm.mips_topk(ue, ie, 4)
    assert (idx.cpu() < 37).all() and torch.isfinite(vals).all()
    rvals, ridx = tm.mips_topk_reference(ue, ie, 4)
    assert_topk_close(vals, idx, rvals, ridx, _scores(ue, ie))


@pytest.mark.parametrize("d", [128, 33])
def test_mips_topk_bf16(dev, d):
    rng = np.random.default_rng(4)
    ue, ie = _emb(rng, 200, d, dev), _emb(rng, 3000, d, dev)
    vals, idx = tm.mips_topk(ue, ie, 26, bf16=True)
    rvals, ridx = tm.mips_topk_reference(ue, ie, 26, bf16=True)
    assert_topk_close(vals, idx, rvals, ridx, _scores(ue, ie, bf16=True))


@pytest.mark.parametrize("u,i,d,k,w,bf16", [
    (13, 333, 16, 6, 2.5, False), (300, 30000, 128, 26, 1.0, False),
    (40, 3000, 30, 10, 1.0, False),
    # The cases of mips_topk: bf16 (at D = 33 too), a width zero-padded to
    # 36, k above 32 (partial lists in device memory), k = max_k() (0 below),
    # users streamed through the ring (D = 256 in f32: the LSE pass keeps
    # them resident); catalogs of fewer than 16 items (threads with no item)
    # and user counts that are not a multiple of 128.
    (300, 5000, 128, 26, 1.0, True), (300, 5000, 33, 26, 1.0, True),
    (260, 5000, 33, 26, 1.0, False), (130, 4000, 128, 100, 1.0, False),
    (70, 2000, 32, 0, 1.0, False), (300, 5000, 256, 26, 1.0, False),
    (130, 11, 16, 5, 1.0, False), (129, 7, 8, 7, 2.0, False),
    # serving's widest fetch (k=10 and 256 bought items a user)
    (300, 30000, 128, 266, 1.0, False),
])
def test_mips_topk_boosted_matches_plain(dev, u, i, d, k, w, bf16):
    k = k or tm.max_k()
    rng = np.random.default_rng(5)
    ue, ie = _emb(rng, u, d, dev), _emb(rng, i, d, dev)
    ue = ue / ue.norm(dim=1, keepdim=True)
    ie = ie / ie.norm(dim=1, keepdim=True)
    pop = torch.tensor(rng.uniform(0, 0.05, i).astype(np.float32), device=dev)
    m, s = tm.mips_lse(ue, ie, bf16=bf16)
    rm, rs = tm.mips_lse_reference(ue, ie, bf16=bf16)
    torch.testing.assert_close(m, rm, rtol=0, atol=TOL)
    torch.testing.assert_close(s, rs, rtol=TOL, atol=0)
    vals, idx = tm.mips_boost(ue, ie, pop, rm, rs, k, weight=w, bf16=bf16)
    rvals, ridx = tm.mips_boost_reference(ue, ie, pop, rm, rs, k, weight=w, bf16=bf16)
    sc = _scores(ue, ie, bf16=bf16)
    e = np.exp(sc - rm.double().cpu().numpy()[:, None])
    boosted = e / rs.double().cpu().numpy()[:, None] + w * pop.double().cpu().numpy()
    assert_topk_close(vals, idx, rvals, ridx, boosted)
    n0 = tm.mips_lse.launches, tm.mips_boost.launches
    v2, i2 = tm.mips_topk_boosted(ue, ie, pop, k, weight=w, bf16=bf16)
    assert (tm.mips_lse.launches, tm.mips_boost.launches) == (n0[0] + 1, n0[1] + 1)
    assert_topk_close(v2, i2, rvals, ridx, boosted)


def test_mips_topk_boosted_ties_lowest_index(dev):
    """Identical items and zero popularity: every boosted value has the same
    bits, so the lowest indices win, at k on both sides of 32."""
    ue = torch.ones((130, 8), device=dev)
    ie = torch.ones((700, 8), device=dev)
    for k in (6, 40, 266):
        _, idx = tm.mips_topk_boosted(ue, ie, torch.zeros(700, device=dev), k)
        assert (idx.cpu() == torch.arange(k)).all()


def test_cpu_tensors_take_the_plain_version(dev):
    rng = np.random.default_rng(7)
    ue, ie = _emb(rng, 9, 8, "cpu"), _emb(rng, 50, 8, "cpu")
    n0 = tm.mips_topk.launches
    tm.mips_topk(ue, ie, 3)
    assert tm.mips_topk.launches == n0
    with pytest.raises(ValueError):
        tm.mips_topk(ue.to(dev), ie, 3)


# The MLP head's sigmoid scores lie near 0.5, whose f32 step is 6e-8: the
# kernel's sums in another order than the plain version's products move them
# by a few steps.
MLP_TOL = 1e-6


def _mlp_case(dev, u, i, seed=0):
    """mlp_topk's inputs at a trained head's scales: a_u, a_i, w2, b2, w3, b3."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape, scale):
        return scale * torch.randn(*shape, generator=g, device=dev)

    return [randn(u, 128, scale=0.5), randn(i, 128, scale=0.5), randn(32, 128, scale=0.1),
            randn(32, scale=0.1), randn(1, 32, scale=0.3), randn(1, scale=0.1)]


def _mlp_exact(args):
    """The head's f64 score of pairs (rows r, items i), on the card."""
    a_u, a_i, w2, b2, w3, b3 = (t.double() for t in args)

    def score(r, i):
        z = torch.relu(torch.relu(a_u[r] + a_i[i]) @ w2.T + b2)
        return torch.sigmoid(z @ w3.reshape(-1) + b3)
    return score


@pytest.mark.parametrize("u,i,k", [
    (4096, 30000, 20), (4093, 3001, 42), (300, 30000, 266), (130, 1001, 5), (130, 11, 11),
    (1, 70, 3), (257, 5000, 1024)])
def test_mlp_topk_matches_plain(dev, u, i, k):
    """Lists of k <= 32 in shared memory and larger in device memory, catalog
    splits (few user blocks), ragged user blocks and tiles, k = max_k().
    Values within MLP_TOL of the plain version's; indices equal except at
    near-tied slots, where the kernel's item scores (in f64) within MLP_TOL
    of the slot's plain value."""
    args = _mlp_case(dev, u, i, seed=u + i + k)
    n0 = tm.mlp_topk.launches
    vals, idx = tm.mlp_topk(*args, k)
    torch.cuda.synchronize()
    assert tm.mlp_topk.launches == n0 + 1
    rvals, ridx = tm.mlp_topk_reference(*args, k)
    assert float((vals - rvals).abs().max()) <= MLP_TOL
    rows, cols = torch.nonzero(idx != ridx, as_tuple=True)
    if rows.numel():
        gap = (_mlp_exact(args)(rows, idx[rows, cols]) - rvals[rows, cols].double()).abs()
        assert float(gap.max()) <= MLP_TOL
    srt = idx.sort(dim=1).values
    assert not (srt[:, 1:] == srt[:, :-1]).any()


@pytest.mark.parametrize("k", [6, 40])
def test_mlp_topk_ties_lowest_index(dev, k):
    a_u, a_i, *head = _mlp_case(dev, 300, 1, seed=k)
    _, idx = tm.mlp_topk(a_u, a_i.expand(900, 128), *head, k)
    assert (idx.cpu() == torch.arange(k)).all()


def test_mlp_topk_cpu_tensors_take_the_plain_version(dev):
    args = _mlp_case("cpu", 9, 50)
    n0 = tm.mlp_topk.launches
    tm.mlp_topk(*args, 3)
    assert tm.mlp_topk.launches == n0
    with pytest.raises(ValueError):
        tm.mlp_topk(args[0].to(dev), *args[1:], 3)


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


def _ragged_leaf_shapes():
    """P one short of and one over a tile, H not a multiple of 4, at narrow,
    odd and wide F and at K of 1, 4 and 8 (tiles from the host's pure
    geometry)."""
    shapes = []
    for f in (1, 3, 8, 16, 128):
        tp, _ = la.tile_shape(f)
        for k in (1, 4, 8):
            shapes += [(k, tp - 1, f, 130), (k, tp + 1, f, 33)]
    return shapes


@pytest.mark.parametrize("k,p,f,h", [(8, 18432, 8, 256), (8, 2047, 8, 256), (4, 37, 5, 33),
                                     (16, 300, 128, 130), (1, 1, 1, 1), (40, 100, 8, 64),
                                     *_ragged_leaf_shapes()])
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
    # bf16 backward (widened on load) against the plain version on the same
    # bf16 inputs; an odd F takes the element-wise staging.
    for f in (8, 5):
        x, ms, w, b, g = _leaf_case(dev, 8, 333, f, 40, seed=3, dtype=torch.bfloat16)
        dw, db = la.leaf_mean_nn_bwd(x, ms, w, b, g)
        for got, want in zip((dw, db), la.leaf_mean_nn_bwd_reference(x, ms, w, b, g)):
            assert float((got - want).abs().max()) <= GRAD_REL * max(1.0, float(want.abs().max()))
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


def test_captured_step_keeps_the_tensors_it_reads(dev):
    """A captured step replays correctly after its maker dropped every
    tensor that its graph reads, and their memory was handed out again."""
    from gnn_recsys_tpu_torch.ops.sampling import Draws
    from gnn_recsys_tpu_torch.train.graph_step import CapturedStep

    out = torch.zeros(4096, device=dev)

    def make():
        a = torch.arange(4096, dtype=torch.float32, device=dev)
        b = torch.full((4096,), 0.5, device=dev)

        def body(update, draws):
            out.copy_(a * 2 + b)

        return CapturedStep(body, Draws(torch.Generator(device=dev)), warmup=1)

    step = make()
    junk = [torch.full((4096,), -7.0, device=dev) for _ in range(64)]
    out.zero_()
    step.replay()
    torch.cuda.synchronize()
    want = torch.arange(4096, dtype=torch.float32, device=dev) * 2 + 0.5
    assert torch.equal(out, want) and len(junk) == 64


@pytest.mark.parametrize("dedup", [False, True])
def test_device_epochs_replay_the_eager_body(dev, dedup):
    """The device epochs' CUDA graph at a small size: 4 replays against 4
    eager steps from one state and seed (``chip_smoke.graph_route_check``:
    the first step's draws bit for bit, losses, parameters after Adam,
    the captured launches a step), and one of fewer batches an epoch than
    warm-up steps."""
    import chip_smoke

    from gnn_recsys_tpu_torch.models.conv_model import ConvModel
    from gnn_recsys_tpu_torch.ops.membership import build_padded_pair_set
    from gnn_recsys_tpu_torch.train.minibatch import MinibatchConfig

    data = chip_smoke.bench_data(num_users=400, num_items=150)
    g = data.graph.to(dev)
    feats = {nt: g.ndata[nt]["features"] for nt in g.ntypes}
    kw = chip_smoke.medium_kwargs(g, 32, 16)
    etypes = tuple(data.train_pairs)
    cfg = MinibatchConfig(edge_batch_size=128, fanouts=(8, 4), neg_mode="dense_pool",
                          neg_pool_size=96, pool_mask_kernel=True, dedup=dedup)
    tables = {et: build_padded_pair_set(u, i, num_src=data.num_users).to(dev)
              for et, (u, i) in data.train_pairs.items()}
    per_step = chip_smoke.step_counts(g, ConvModel(**kw), etypes, dedup)
    for edges in (512, 128):  # 4 batches an epoch, then 1
        eids = chip_smoke.edge_slices(g, etypes, edges)
        report, captured = chip_smoke.graph_route_check(dev, g, feats, kw, cfg, eids, tables,
                                                        per_step, steps=4)
        assert report["first_step_draws"]["pool"] == 96
        assert chip_smoke.captured_launches(captured) == {n: c for n, c in per_step.items() if c}


@pytest.mark.parametrize("dedup", [False, True])
def test_bf16_device_epochs_replay_the_eager_body(dev, dedup):
    """The same with ``ConvModel(dtype=bfloat16)``: the bf16 leaf or
    gather-mean kernels inside the graph, held at the bf16 tolerances
    (``chip_smoke.graph_route_check``)."""
    import chip_smoke

    from gnn_recsys_tpu_torch.models.conv_model import ConvModel
    from gnn_recsys_tpu_torch.ops.membership import build_padded_pair_set
    from gnn_recsys_tpu_torch.train.minibatch import MinibatchConfig

    data = chip_smoke.bench_data(num_users=400, num_items=150)
    g = data.graph.to(dev)
    feats = {nt: g.ndata[nt]["features"] for nt in g.ntypes}
    kw = dict(chip_smoke.medium_kwargs(g, 32, 16), dtype=torch.bfloat16)
    etypes = tuple(data.train_pairs)
    cfg = MinibatchConfig(edge_batch_size=128, fanouts=(8, 4), neg_mode="dense_pool",
                          neg_pool_size=96, pool_mask_kernel=True, dedup=dedup)
    tables = {et: build_padded_pair_set(u, i, num_src=data.num_users).to(dev)
              for et, (u, i) in data.train_pairs.items()}
    per_step = chip_smoke.step_counts(g, ConvModel(**kw), etypes, dedup)
    eids = chip_smoke.edge_slices(g, etypes, 512)
    report, captured = chip_smoke.graph_route_check(dev, g, feats, kw, cfg, eids, tables,
                                                    per_step, steps=4)
    assert report["grad_rel_worst"] <= chip_smoke.BF16_ROUTE_GRAD_REL
    assert report["entries_above_gap"] > 0
    assert report["update_gap_over_lr_above_gap"] <= chip_smoke.UPDATE_REL
    assert chip_smoke.captured_launches(captured) == {n: c for n, c in per_step.items() if c}


@pytest.mark.parametrize("b,k,p", [(1024, 32, 2560), (1000, 24, 2500), (3, 128, 7),
                                   (1000, 24, 2557), (1001, 32, 2560), (50, 1, 300),
                                   (17, 128, 4099)])
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


@pytest.mark.parametrize("k", [1, 32, 128])
def test_pool_membership_mask_repeats_and_negatives(dev, k):
    """Ids drawn from a few values, so that pool entries repeat and rows
    repeat an id (a row's set holds it once), with negative pool entries
    and rows of nothing but -1; and ids that all share one home slot, where
    every probe walks the row's whole run."""
    rng = np.random.default_rng(k)
    b, p = 203, 1031
    rows = rng.integers(0, 40, (b, k)).astype(np.int32)
    rows[rng.random((b, k)) < 0.2] = -1
    rows[5] = -1
    pool = rng.integers(-3, 40, p).astype(np.int32)
    # ids that all share one home slot under the kernel's multiplicative hash
    # (csrc/pool_mask.cu, home_slot)
    shift = 32 - pm.set_slots(k).bit_length() + 1
    ids = np.arange(1000, 1 << 20, dtype=np.int64)
    home = ((ids * 0x9E3779B1) & 0xFFFFFFFF) >> shift
    same = ids[home == home[0]][:k].astype(np.int32)
    rows[7], pool[:k] = same, same[::-1]
    for r, q in ((rows, pool), (rows[:, ::-1].copy(), pool[::-1].copy())):
        rows_t, pool_t = torch.tensor(r, device=dev), torch.tensor(q, device=dev)
        out = pm.pool_membership_mask(rows_t, pool_t)
        assert torch.equal(out, pm.pool_membership_mask_reference(rows_t, pool_t))
    assert float(out.sum()) > 0 and (out[5] == 0).all()


def test_host_plans_match_the_c_exports(dev):
    """The wrappers' pure launch plans against the kernels' own exports."""
    lib = tm._lib()
    assert tm.max_k() == 1024
    for d in (4, 32, 36, 128, 132, 256, 1024):
        for bf16 in (False, True):
            for resident in (False, True):
                for epi in tm.EPILOGUES:
                    assert lib.mips_topk_smem_bytes(d, int(bf16), int(resident), epi) == \
                        tm.topk_smem_bytes(d, bf16, resident, epi)
    tile = (ctypes.c_int * 2)()
    assert pm._lib().pool_mask_tile(tile) == 0 and tuple(tile) == pm._TILE
    from gnn_recsys_tpu_torch.ops.cuda import gather_mean as gm

    glib = gm._lib()
    assert glib.gather_mean_bwd_chunk() == gm.CHUNK
    for n, b, k, d in ((3000, 904, 1280, 256), (6000, 20000, 16, 2), (7, 5, 3, 6),
                       (30000, 38912, 8, 256), (1, 9, 4, 256), (50, 300, 1, 33)):
        assert glib.gather_mean_bwd_scratch_bytes(n, b, k, d) == gm.bwd_scratch_bytes(n, b, k, d)


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


def _assert_dh_close(dh, want):
    assert float((dh - want).abs().max()) <= GRAD_REL * max(1.0, float(want.abs().max()))


# The full-fanout gathers of the CLI drill and the search (B, K, N).
WIDE = [(904, 1280, 3000), (904, 216, 3000), (904, 728, 2104), (20000, 16, 6000)]


@pytest.mark.parametrize("b,k,n,d", [(38912, 8, 30000, 256), (20992, 8, 100000, 256),
                                     (2048, 4, 20992, 256), (4608, 4, 38912, 256),
                                     (13, 8, 50, 16), (7, 40, 20, 33), (5, 3, 10, 6),
                                     (9, 4, 1, 256), (300, 1, 50, 33), (1001, 8, 3000, 33),
                                     (1001, 40, 3000, 256), (333, 4, 7, 256)]
                         + [(b, k, n, d) for b, k, n in WIDE for d in (2, 256)])
def test_gather_mean_matches_plain(dev, b, k, n, d):
    """Forward and backward at the dedup step's four shapes, N = 1, K of 1,
    4, 8 and 40, a D that is not a multiple of 4 (the scalar path), a
    ragged B, and the full-fanout shapes at D 2 and 256.  The backward has
    no atomics: it matches both plain versions (the walk of the same
    transpose, and index_add_) within 1e-5 of the largest entry (fused
    multiply-adds in another order), and a second call gives the same
    bits."""
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
    tr = gm.slot_transpose(nbr, mask, n)
    _assert_dh_close(dh, gm.gather_mean_bwd_reference(g, nbr, mask, n))
    _assert_dh_close(dh, gm.gather_mean_bwd_plain(g, mask, n, tr))
    assert torch.equal(dh, gm.gather_mean_bwd(g, nbr, mask, n, tr))


@pytest.mark.parametrize("b,k,n,d", [(38912, 8, 30000, 256), (20992, 8, 100000, 256),
                                     (2048, 4, 20992, 256), (4608, 4, 38912, 256),
                                     (13, 8, 50, 16), (7, 40, 20, 33), (1001, 8, 3000, 36),
                                     (333, 4, 7, 256)]
                         + [(b, k, n, d) for b, k, n in WIDE for d in (2, 256)])
def test_gather_mean_bf16_matches_plain(dev, b, k, n, d):
    """The bf16 instantiations (table, cotangent, out and dh bf16; sums f32)
    at the dedup step's four shapes, K = 40, the full-fanout shapes, and
    widths that are not a multiple of 8 (the scalar path): within one bf16 ulp of the largest
    entry of the plain versions, which round the same f32 sums (summed in
    another order), and the backward's bits twice the same."""
    from gnn_recsys_tpu_torch.ops.cuda import gather_mean as gm

    h, nbr, mask, g = _gather_case(dev, b, k, n, d)
    h, g = h.bfloat16(), g.bfloat16()
    n_fwd, n_bwd = gm.gather_mean_fwd.launches, gm.gather_mean_bwd.launches
    out = gm.gather_mean_fwd(h, nbr, mask)
    tr = gm.slot_transpose(nbr, mask, n)
    dh = gm.gather_mean_bwd(g, nbr, mask, n, tr)
    torch.cuda.synchronize()
    assert (gm.gather_mean_fwd.launches, gm.gather_mean_bwd.launches) == (n_fwd + 1, n_bwd + 1)
    assert out.dtype == dh.dtype == torch.bfloat16 and (out[b // 2] == 0).all()
    for got, wants in ((out, [gm.gather_mean_reference(h, nbr, mask)]),
                       (dh, [gm.gather_mean_bwd_reference(g, nbr, mask, n),
                             gm.gather_mean_bwd_plain(g, mask, n, tr)])):
        for want in wants:
            assert want.dtype == torch.bfloat16
            err = float((got.float() - want.float()).abs().max())
            assert err <= BF16_RTOL * max(1.0, float(want.float().abs().max()))
    assert torch.equal(dh, gm.gather_mean_bwd(g, nbr, mask, n, tr))


def _skewed_case(dev, b, k, n, d, seed=0):
    """A full-fanout gather as the dedup'd plan makes one: 15% of the slots
    valid, their ids from a power law (floor(n u^3): row 0 takes about
    n^(-1/3) of them), every masked slot on row 0 (the plan's row for the
    padding id), an all-masked row, and an id of -1 and one >= n."""
    rng = np.random.default_rng(seed)
    nbr = (n * rng.random((b, k)) ** 3).astype(np.int32)
    mask = rng.random((b, k)) < 0.15
    nbr[~mask] = 0
    mask[b // 2] = False
    nbr[0, 0], nbr[-1, -1] = -1, n + 3
    mask[0, 0] = mask[-1, -1] = True
    h = torch.tensor(rng.normal(size=(n, d)).astype(np.float32), device=dev)
    g = torch.tensor(rng.normal(size=(b, d)).astype(np.float32), device=dev)
    return h, torch.tensor(nbr, device=dev), torch.tensor(mask, device=dev), g


def _every_slot_transpose(nbr, n):
    """The plan's kind of transpose: every slot, masked ones included,
    grouped by its clipped id (ascending within a row)."""
    from gnn_recsys_tpu_torch.ops.cuda import gather_mean as gm

    srt, order = torch.sort(nbr.long().clamp(0, n - 1).reshape(-1), stable=True)
    start = torch.searchsorted(srt, torch.arange(n + 1, device=nbr.device))
    return gm.SlotTranspose(order.to(torch.int32), start.to(torch.int32))


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("d", [2, 256])
@pytest.mark.parametrize("b,k,n", WIDE)
def test_gather_mean_wide_k_skewed_matches_f64(dev, b, k, n, d, bf16):
    """The full-fanout shapes on skewed ids, so that runs pass the chunk
    length: row 0 holds every masked slot (the plan's transpose walks them)
    and the hottest ids.  Forward and backward against the float64 reference
    on the same (rounded) inputs, within TOL / GRAD_REL of the largest entry
    in f32 and BF16_RTOL in bf16; the backward through the plan's kind of
    transpose, through ``slot_transpose`` and through the wrapper's own sort
    (those two the same bits), each twice the same bits."""
    from gnn_recsys_tpu_torch.ops.cuda import gather_mean as gm

    h, nbr, mask, g = _skewed_case(dev, b, k, n, d)
    if bf16:
        h, g = h.bfloat16(), g.bfloat16()
    out = gm.gather_mean_fwd(h, nbr, mask)
    plan_tr, own_tr = _every_slot_transpose(nbr, n), gm.slot_transpose(nbr, mask, n)
    assert int(plan_tr.start[1]) > 10 * gm.CHUNK  # row 0's run is split
    dh = gm.gather_mean_bwd(g, nbr, mask, n, plan_tr)
    dh_own = gm.gather_mean_bwd(g, nbr, mask, n)
    torch.cuda.synchronize()
    rel_fwd, rel_bwd = (BF16_RTOL, BF16_RTOL) if bf16 else (TOL, GRAD_REL)
    for got, want, rel in (
            (out, gm.gather_mean_reference(h.double(), nbr, mask), rel_fwd),
            (dh, gm.gather_mean_bwd_reference(g.double(), nbr, mask, n), rel_bwd),
            (dh_own, gm.gather_mean_bwd_reference(g.double(), nbr, mask, n), rel_bwd)):
        assert got.dtype == h.dtype
        err = float((got.double() - want).abs().max())
        assert err <= rel * max(1.0, float(want.abs().max())), err
    assert (out[b // 2] == 0).all()
    assert torch.equal(dh, gm.gather_mean_bwd(g, nbr, mask, n, plan_tr))
    assert torch.equal(dh_own, gm.gather_mean_bwd(g, nbr, mask, n, own_tr))
    assert torch.equal(out, gm.gather_mean_fwd(h, nbr, mask))


def test_gather_mean_bwd_hot_row_and_masked_rows(dev):
    """Every valid slot on one source row (a run of about 1,150 entries, 36
    chunks of 32) and rows with no valid slot: the hot row sums its slots in
    a fixed order.  Held against the float64 sum: a sum of n f32 terms in
    any order is off by about sqrt(n) ulp of the result (39,200 terms gave
    1.1e-5 of the largest entry, so the run is kept short)."""
    from gnn_recsys_tpu_torch.ops.cuda import gather_mean as gm

    h, nbr, mask, g = _gather_case(dev, 200, 8, 300, 256, seed=2)
    nbr = torch.full_like(nbr, 17)
    mask[:20] = False
    dh = gm.gather_mean_bwd(g, nbr, mask, 300)
    _assert_dh_close(dh, gm.gather_mean_bwd_reference(g.double(), nbr, mask, 300).float())
    assert (dh[:17] == 0).all() and (dh[18:] == 0).all()
    assert torch.equal(dh, gm.gather_mean_bwd(g, nbr, mask, 300))


@pytest.mark.parametrize("hot", [False, True])
def test_gather_mean_bwd_plan_transpose_matches_wrapper_own(dev, hot):
    """A transpose cut from one sort of a frontier that holds other slots
    before and after this gather's (as the dedup plan's), walked up to
    ``rows``: padding rows (zero cotangent) past it, pointing at one hot row
    with ``hot``, so the 32-way search narrows a long run.  Bit-identical to
    the wrapper's own transpose over every slot."""
    from gnn_recsys_tpu_torch.ops.cuda import gather_mean as gm
    from gnn_recsys_tpu_torch.ops.sampling import unique_plan

    rng = np.random.default_rng(6)
    n_ids, b, k, d, rows = 5000, 4096, 8, 256, 3000
    nbr = rng.integers(0, n_ids, (b, k)).astype(np.int32)
    if hot:
        nbr[rows:] = 11
    before, after = rng.integers(0, n_ids, 7000), rng.integers(0, n_ids, 9000)
    flat = torch.tensor(np.concatenate([before, nbr.reshape(-1), after]).astype(np.int32),
                        device=dev)
    cap = 5000
    plan = unique_plan(flat, cap, transpose=True)
    pos = plan.inv[before.size:before.size + b * k].reshape(b, k)
    mask = torch.tensor(rng.random((b, k)) < 0.9, device=dev)
    g = torch.tensor(rng.normal(size=(b, d)).astype(np.float32), device=dev)
    g[rows:] = 0.0
    tr = gm.SlotTranspose(plan.order, plan.start, before.size,
                          torch.tensor([rows], dtype=torch.int32, device=dev))
    dh = gm.gather_mean_bwd(g, pos, mask, cap, tr)
    assert torch.equal(dh, gm.gather_mean_bwd(g, pos, mask, cap))
    _assert_dh_close(dh, gm.gather_mean_bwd_reference(g, pos, mask, cap))
    assert (dh[int(plan.count):] == 0).all()


def test_gather_mean_autograd_and_refusals(dev):
    from gnn_recsys_tpu_torch.ops.cuda import gather_mean as gm

    h, nbr, mask, g = _gather_case(dev, 300, 8, 500, 64, seed=1)
    hk, hr = h.clone().requires_grad_(), h.clone().requires_grad_()
    (gm.gather_mean(hk, nbr, mask) * g).sum().backward()
    (gm.gather_mean_reference(hr, nbr, mask) * g).sum().backward()
    torch.testing.assert_close(hk.grad, hr.grad, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError):
        gm.gather_mean_fwd(h.half(), nbr, mask)
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


def test_dedup_step_gradients_are_bit_identical(dev):
    """Two dedup'd forward + backward passes from the same parameters and
    draws give the same bits: the gather-mean backward has no atomics, and
    PyTorch's deterministic algorithms keep its own index_add_ in order."""
    from gnn_recsys_tpu_torch.models.conv_model import ConvModel
    from gnn_recsys_tpu_torch.ops.sampling import Draws
    from gnn_recsys_tpu_torch.utils.synthetic import make_synthetic_data

    data = make_synthetic_data(num_users=300, num_items=120, seed=0)
    g = data.graph.to(dev)
    model = ConvModel(g.canonical_etypes, (("user", 8), ("item", 8), ("hidden", 64), ("out", 32)),
                      aggregator_type="mean_nn").to(dev)
    feats = {nt: g.ndata[nt]["features"] for nt in g.ntypes}
    seeds = {"user": torch.arange(0, 300, 3, device=dev) % 97,
             "item": torch.arange(0, 120, 2, device=dev) % 41}
    rec = Draws(torch.Generator(device=dev).manual_seed(0), record=True)
    model.sampled_repr(g, feats, seeds, (8, 4), rec, dedup=True)

    def grads():
        model.zero_grad(set_to_none=True)
        out = model.sampled_repr(g, feats, seeds, (8, 4), rec.replay(), dedup=True)
        sum(o.square().sum() for o in out.values()).backward()
        return [p.grad.clone() for p in model.parameters()]

    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        first, second = grads(), grads()
    finally:
        torch.use_deterministic_algorithms(False)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


# The LSTM cell update: the cell's shapes (N up to 2,560 x 8 rows of H =
# 256), a width that is no multiple of the vector (the scalar kernels) and
# an unaligned carry (a view one element into its storage).
LSTM_SHAPES = [(20480, 256), (9033, 256), (37, 5), (1, 8)]
LSTM_TYPES = [(torch.bfloat16, torch.bfloat16), (torch.bfloat16, torch.float32),
              (torch.float32, torch.float32)]


def _lstm_cell_case(dev, n, h, gates, carry, seed=0, offset=0):
    """Pre-activation products as the reducer makes them (rounded to the
    gates' dtype), a carry with h in (-1, 1), a mask with about 10% holes
    (any stride: a column of an [N, 3] mask) and two cotangents."""
    gen = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape, dtype, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=dev) * scale).to(dtype)

    xw, hw = randn(n, 4 * h, dtype=gates, scale=1.5), randn(n, 4 * h, dtype=gates)
    bias = randn(4 * h, dtype=gates, scale=0.3)
    c = randn(n * h + offset, dtype=carry, scale=1.5)[offset:].view(n, h)
    hh = torch.tanh(randn(n, h, dtype=torch.float32)).to(carry)
    mask = torch.rand(n, 3, generator=gen, device=dev)[:, 1] > 0.1
    dh, dc = randn(n, h, dtype=carry), randn(n, h, dtype=carry)
    return xw, hw, bias, c, hh, mask, dh, dc


def _bf16_ulps_apart(a, b) -> torch.Tensor:
    """Per element: bf16 values equal, or neighbours (bit patterns one apart)."""
    bits = (a.view(torch.int16).int() - b.view(torch.int16).int()).abs()
    return (a == b) | (bits <= 1)


def _bf16_ulp(x) -> float:
    """One bf16 ulp at the largest magnitude of ``x``."""
    top = float(x.abs().max())
    return 2.0 ** (np.floor(np.log2(top)) - 7) if top > 0 else 0.0


@pytest.mark.parametrize("gates,carry", LSTM_TYPES, ids=["bf16", "bf16_f32carry", "f32"])
@pytest.mark.parametrize("n,h", LSTM_SHAPES)
def test_lstm_cell_fwd_matches_plain(dev, n, h, gates, carry):
    """One cell update: bf16 within one ulp everywhere and bit-equal on
    99.9% of the elements or more; f32 within 1e-6.  An f32 carry of bf16
    gates: bit-equal on 99.9% and within a bf16 ulp of the gate that feeds
    it (2^-7 relative) elsewhere.  The activations are compared on the
    valid rows (a masked row saves none)."""
    for offset in (0, 1):
        xw, hw, bias, c, hh, mask, _, _ = _lstm_cell_case(dev, n, h, gates, carry, offset=offset)
        n0 = lc.lstm_cell_fwd.launches
        got = lc.lstm_cell_fwd(xw, hw, bias, c, hh, mask)
        torch.cuda.synchronize()
        assert lc.lstm_cell_fwd.launches == n0 + 1
        want = lc.lstm_cell_fwd_reference(xw, hw, bias, c, hh, mask)
        pairs = [(got[0], want[0]), (got[1], want[1]), (got[2][mask], want[2][mask])]
        for k, w in pairs:
            assert k.dtype == w.dtype and k.shape == w.shape
            if k.dtype == torch.bfloat16:
                assert _bf16_ulps_apart(k, w).all()
                assert float((k == w).float().mean()) >= 0.999
            elif gates == torch.bfloat16:
                torch.testing.assert_close(k, w, rtol=2.0**-7, atol=1e-6)
                assert float((k == w).float().mean()) >= 0.999
            else:
                torch.testing.assert_close(k, w, rtol=0, atol=1e-6)
        assert torch.equal(got[0][~mask], c[~mask]) and torch.equal(got[1][~mask], hh[~mask])
        _, _, none = lc.lstm_cell_fwd(xw, hw, bias, c, hh, mask, save=False)
        assert none is None


def _cell_autograd(xw, hw, bias, c, h, mask, dh, dc, dtype=None):
    """The cell as the reducer's slot loop ran it (PyTorch ops, autograd),
    in ``dtype`` where given (upcast inputs): (dz, dc, dh)."""
    ins = [t if dtype is None else t.to(dtype) for t in (xw, hw, bias, c, h)]
    ins = [t.detach().clone().requires_grad_() for t in ins]
    c_out, h_out, _ = lc.lstm_cell_fwd_reference(*ins, mask, save=False)
    torch.autograd.backward((c_out, h_out), (dc.to(c_out.dtype), dh.to(h_out.dtype)))
    return ins[0].grad.float(), ins[3].grad.float(), ins[4].grad.float()


@pytest.mark.parametrize("gates,carry", LSTM_TYPES, ids=["bf16", "bf16_f32carry", "f32"])
@pytest.mark.parametrize("n,h", LSTM_SHAPES)
def test_lstm_cell_bwd_against_f32_autograd(dev, n, h, gates, carry):
    """The backward kernel's gap to f32 autograd of the cell is no larger
    than the plain autograd's in the working dtypes, plus one bf16 ulp of
    the largest value (f32: within 1e-5 of the plain backward)."""
    xw, hw, bias, c, hh, mask, dh, dc = _lstm_cell_case(dev, n, h, gates, carry, seed=1)
    c_new, _, acts = lc.lstm_cell_fwd(xw, hw, bias, c, hh, mask)
    n0 = lc.lstm_cell_bwd.launches
    got = lc.lstm_cell_bwd(acts, c, c_new, mask, dh, dc)
    torch.cuda.synchronize()
    assert lc.lstm_cell_bwd.launches == n0 + 1
    assert (got[0].dtype, got[1].dtype, got[2].dtype) == (gates, carry, carry)
    ref = _cell_autograd(xw, hw, bias, c, hh, mask, dh, dc, torch.float32)
    own = _cell_autograd(xw, hw, bias, c, hh, mask, dh, dc)
    for name, k, r, o in zip(("dz", "dc", "dh"), got, ref, own):
        gap = float((k.float() - r).abs().max())
        slack = _bf16_ulp(r) if gates == torch.bfloat16 else 1e-5
        assert gap <= float((o - r).abs().max()) + slack, (name, gap)
    assert not got[0][~mask].any() and not got[2][mask].any()
    assert torch.equal(got[1][~mask], dc[~mask]) and torch.equal(got[2][~mask], dh[~mask])
    # dc' absent (the last slot's carry takes no gradient): read as zero.
    dz1, dc1, dh1 = lc.lstm_cell_bwd(acts, c, c_new, mask, dh, None)
    want = lc.lstm_cell_bwd(acts, c, c_new, mask, dh, torch.zeros_like(dc))
    assert all(torch.equal(a, b) for a, b in zip((dz1, dc1, dh1), want))


def _lstm_reducer_case(dev, dtype, n=2560, k=8, d=256, seed=0):
    from gnn_recsys_tpu_torch.models.layers import MaskedLSTMReducer

    torch.manual_seed(seed)
    red = MaskedLSTMReducer(d, d, dtype=dtype).to(dev)
    with torch.no_grad():
        red.hh.bias.uniform_(-0.1, 0.1)
    mask = torch.rand(n, k, device=dev) < 0.85
    mask[0] = False
    msgs = (torch.randn(n, k, d, device=dev) * mask[..., None]).to(dtype or torch.float32)
    return red, msgs, mask, torch.randn(n, d, device=dev)


@pytest.mark.parametrize("dtype", [torch.bfloat16, None], ids=["bf16", "f32"])
def test_lstm_reducer_graph_replay_equals_eager_and_counts(dev, dtype):
    """A whole reducer call, forward and backward, captured as a CUDA graph:
    the replay equals the eager call bit for bit, and an eager call launches
    K forward and K backward cell kernels."""
    red, msgs, mask, cot = _lstm_reducer_case(dev, dtype)
    x = msgs.clone().requires_grad_()

    def call():
        red.zero_grad(set_to_none=False)
        x.grad = None
        out = red(x, mask)
        (out.float() * cot).sum().backward()
        return out

    n_fwd, n_bwd = lc.lstm_cell_fwd.launches, lc.lstm_cell_bwd.launches
    eager = call().detach().clone()
    torch.cuda.synchronize()
    k = mask.shape[1]
    assert (lc.lstm_cell_fwd.launches - n_fwd, lc.lstm_cell_bwd.launches - n_bwd) == (k, k)
    grads = [x.grad.clone()] + [p.grad.clone() for p in red.parameters()]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            call()
    torch.cuda.current_stream().wait_stream(side)
    red.zero_grad(set_to_none=True)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = red(x, mask)
        (out.float() * cot).sum().backward()
    for p in red.parameters():
        p.grad.zero_()
    x.grad.zero_()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager)
    for got, want in zip([x.grad] + [p.grad for p in red.parameters()], grads):
        assert torch.equal(got, want)
