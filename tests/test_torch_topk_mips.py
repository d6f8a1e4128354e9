"""The plain versions of the port's MIPS top-k against the JAX Pallas kernels
(interpret mode), on the cases of tests/test_pallas_topk.py.  On CPU tensors
the port's wrappers take the plain versions, so the wrappers are checked
too."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnn_recsys_tpu.ops.pallas.topk_mips import mips_topk as jmips
from gnn_recsys_tpu.ops.pallas.topk_mips import mips_topk_boosted as jmips_boosted
from gnn_recsys_tpu_torch.ops.cuda import topk_mips as tm
from gnn_recsys_tpu_torch.utils import profiling

TOL = 1e-5


@pytest.fixture(autouse=True)
def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False


def _check(vals, idx, jvals, jidx, rtol=0.0):
    np.testing.assert_allclose(vals.numpy(), np.asarray(jvals), rtol=rtol, atol=TOL)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))


def _check_near_ties(vals, idx, jvals, jidx, exact_scores):
    """Values within TOL of JAX's; indices equal except at slots where the
    port's item scores (exactly, in f64) within TOL of JAX's value there;
    no repeated index in a row.  A failure names each side's largest gap to
    the exact f64 top-k values."""
    vals, idx = vals.numpy(), idx.numpy()
    jvals, jidx = np.asarray(jvals), np.asarray(jidx)
    exact = -np.sort(-exact_scores, axis=1)[:, :vals.shape[1]]
    np.testing.assert_allclose(
        vals, jvals, rtol=0, atol=TOL,
        err_msg=f"largest gap to the exact values: port {np.abs(vals - exact).max()}, "
                f"JAX {np.abs(jvals - exact).max()}")
    for r, c in zip(*np.nonzero(idx != jidx)):
        assert abs(exact_scores[r, idx[r, c]] - jvals[r, c]) <= TOL, (r, c)
    for row in idx:
        assert len(set(row.tolist())) == len(row)


@pytest.mark.parametrize("fn", [tm.mips_topk, tm.mips_topk_reference])
@pytest.mark.parametrize("u,i,d,k", [(17, 100, 16, 5), (128, 1000, 32, 10)])
def test_mips_topk_matches_pallas(fn, u, i, d, k):
    rng = np.random.default_rng(0)
    ue = rng.normal(size=(u, d)).astype(np.float32)
    ie = rng.normal(size=(i, d)).astype(np.float32)
    jv, ji = jmips(jnp.asarray(ue), jnp.asarray(ie), k, tile_users=8,
                   tile_items=128, interpret=True)
    vals, idx = fn(torch.from_numpy(ue), torch.from_numpy(ie), k)
    _check(vals, idx, jv, ji)


def test_mips_topk_duplicate_scores_lowest_indices():
    ue, ie = np.ones((4, 8), np.float32), np.ones((40, 8), np.float32)
    jv, ji = jmips(jnp.asarray(ue), jnp.asarray(ie), 6, tile_users=4,
                   tile_items=16, interpret=True)
    vals, idx = tm.mips_topk(torch.from_numpy(ue), torch.from_numpy(ie), 6)
    _check(vals, idx, jv, ji)
    assert (idx == torch.arange(6)).all()


def test_mips_topk_catalog_padding():
    rng = np.random.default_rng(1)
    ue = rng.normal(size=(5, 8)).astype(np.float32)
    ie = rng.normal(size=(37, 8)).astype(np.float32) - 10.0
    jv, ji = jmips(jnp.asarray(ue), jnp.asarray(ie), 4, tile_users=8,
                   tile_items=16, interpret=True)
    vals, idx = tm.mips_topk(torch.from_numpy(ue), torch.from_numpy(ie), 4)
    _check(vals, idx, jv, ji)
    assert (idx < 37).all()


@pytest.mark.parametrize("dup", [False, True])
def test_mips_topk_boosted_matches_pallas(dup):
    rng = np.random.default_rng(5)
    u, i, d, k, w = 13, 333, 16, 6, 2.5
    ue = rng.normal(size=(u, d)).astype(np.float32)
    ie = rng.normal(size=(i, d)).astype(np.float32)
    pop = rng.uniform(0, 0.05, i).astype(np.float32)
    if dup:  # every score and boost tied: the lowest indices win
        ie[:] = ie[0]
        pop[:] = 0.01
    jv, ji = jmips_boosted(jnp.asarray(ue), jnp.asarray(ie), jnp.asarray(pop), k,
                           weight=w, tile_users=8, tile_items=64, interpret=True)
    args = (torch.from_numpy(ue), torch.from_numpy(ie), torch.from_numpy(pop), k)
    # Near-ties (two boosted scores within the f32 softmax's rounding) may
    # come in either order, so indices are held as chip_smoke.check_topk
    # holds them, on the exact f64 boosted scores.
    s64 = ue.astype(np.float64) @ ie.astype(np.float64).T
    e64 = np.exp(s64 - s64.max(axis=1, keepdims=True))
    boosted = e64 / e64.sum(axis=1, keepdims=True) + w * pop.astype(np.float64)
    for fn in (tm.mips_topk_boosted, tm.mips_topk_boosted_reference):
        vals, idx = fn(*args, weight=w)
        _check_near_ties(vals, idx, jv, ji, boosted)
    if dup:
        assert (idx == torch.arange(k)).all()


def test_mips_lse_and_boost_passes_compose():
    rng = np.random.default_rng(8)
    ue = torch.from_numpy(rng.normal(size=(9, 16)).astype(np.float32))
    ie = torch.from_numpy(rng.normal(size=(70, 16)).astype(np.float32))
    pop = torch.from_numpy(rng.uniform(0, 0.1, 70).astype(np.float32))
    m, s = tm.mips_lse(ue, ie)
    scores = (ue.double() @ ie.double().T)
    np.testing.assert_allclose(m.numpy(), scores.max(1).values.numpy(), rtol=0, atol=TOL)
    lse = torch.logsumexp(scores, dim=1)
    np.testing.assert_allclose((m.double() + s.double().log()).numpy(), lse.numpy(),
                               rtol=0, atol=TOL)
    v1, i1 = tm.mips_boost(ue, ie, pop, m, s, 5, weight=2.0)
    v2, i2 = tm.mips_topk_boosted(ue, ie, pop, 5, weight=2.0)
    assert torch.equal(i1, i2) and torch.equal(v1, v2)


def test_mips_topk_bf16_matches_pallas():
    rng = np.random.default_rng(4)
    ue = rng.normal(size=(16, 64)).astype(np.float32)
    ie = rng.normal(size=(300, 64)).astype(np.float32)
    jv, ji = jmips(jnp.asarray(ue), jnp.asarray(ie), 5, tile_users=8,
                   tile_items=128, interpret=True, bf16=True)
    vals, idx = tm.mips_topk(torch.from_numpy(ue), torch.from_numpy(ie), 5, bf16=True)
    _check(vals, idx, jv, ji, rtol=TOL)


def test_cpu_wrappers_count_no_launch():
    rng = np.random.default_rng(9)
    ue = torch.from_numpy(rng.normal(size=(6, 8)).astype(np.float32))
    ie = torch.from_numpy(rng.normal(size=(20, 8)).astype(np.float32))
    profiling.reset_counters()
    tm.mips_topk(ue, ie, 3)
    tm.mips_topk_boosted(ue, ie, torch.zeros(20), 3)
    assert tm.mips_topk.launches == tm.mips_lse.launches == tm.mips_boost.launches == 0


@pytest.mark.parametrize("d", [6, 30])
def test_odd_widths_match_pallas_through_the_padding_helper(d):
    """Widths that are not a multiple of 4: the kernels see both matrices
    zero-padded by ``kernel_inputs`` (here the plain versions on the padded
    CPU tensors), which must rank as JAX ranks the unpadded ones."""
    rng = np.random.default_rng(d)
    u, i, k, w = 11, 150, 5, 2.0
    ue = rng.normal(size=(u, d)).astype(np.float32)
    ie = rng.normal(size=(i, d)).astype(np.float32)
    pop = rng.uniform(0, 0.05, i).astype(np.float32)
    pu, pi = tm.kernel_inputs(torch.from_numpy(ue), torch.from_numpy(ie), False)
    assert pu.shape[1] == pi.shape[1] == d + (-d % 4)
    s64 = ue.astype(np.float64) @ ie.astype(np.float64).T
    jv, ji = jmips(jnp.asarray(ue), jnp.asarray(ie), k, tile_users=8, tile_items=64,
                   interpret=True)
    _check_near_ties(*tm.mips_topk(pu, pi, k), jv, ji, s64)
    e64 = np.exp(s64 - s64.max(axis=1, keepdims=True))
    boosted = e64 / e64.sum(axis=1, keepdims=True) + w * pop.astype(np.float64)
    jv, ji = jmips_boosted(jnp.asarray(ue), jnp.asarray(ie), jnp.asarray(pop), k, weight=w,
                           tile_users=8, tile_items=64, interpret=True)
    _check_near_ties(*tm.mips_topk_boosted(pu, pi, torch.from_numpy(pop), k, weight=w),
                     jv, ji, boosted)


@pytest.mark.parametrize("d,bf16", [(6, False), (33, True), (128, False)])
def test_kernel_inputs_are_aligned_and_pad_with_exact_zeros(d, bf16):
    rng = np.random.default_rng(3)
    base = torch.from_numpy(rng.normal(size=(9 * d + 1,)).astype(np.float32))
    ue = base[1:].reshape(9, d)  # 4 bytes past an aligned start
    ie = torch.from_numpy(rng.normal(size=(d, 20)).astype(np.float32)).T  # not contiguous
    pu, pi = tm.kernel_inputs(ue, ie, bf16)
    for got, src in ((pu, ue), (pi, ie)):
        assert got.dtype == (torch.bfloat16 if bf16 else torch.float32)
        assert got.is_contiguous() and got.data_ptr() % 16 == 0
        assert got.shape == (src.shape[0], d + (-d % 4))
        assert torch.equal(got[:, :d], src.to(got.dtype))
        assert (got[:, d:] == 0).all()


def test_topk_plan_fits_shared_memory():
    """The mips_topk kernel's shared-memory plan: users resident at the
    serving width, streamed through the ring where they do not fit, and
    every plan within a block's 227 KB in 16-byte sections."""
    assert tm.topk_plan(128, False).resident_users and tm.topk_plan(128, True).resident_users
    assert not tm.topk_plan(256, False).resident_users
    assert tm.topk_plan(256, True).resident_users
    for d in range(4, 1025, 4):
        for bf16 in (False, True):
            plan = tm.topk_plan(d, bf16)
            assert plan.smem_bytes <= tm.SMEM_LIMIT and plan.smem_bytes % 16 == 0
            assert plan.smem_bytes == tm.topk_smem_bytes(d, bf16, plan.resident_users)


@pytest.mark.parametrize("epilogue", [tm.EPI_TOPK, tm.EPI_BOOST, tm.EPI_LSE])
def test_layout_mirror_of_each_epilogue(epilogue):
    """The kernel's shared-memory layout by epilogue: the LSE pass holds only
    the ring and the users (no per-user buffers), the boost pass the top-k
    layout and its users' m and s; every plan fits a block in 16-byte
    sections, and the LSE pass keeps the users resident where the top-k
    passes cannot (D = 256 in f32)."""
    lists = 128 * 64 * 8 + 3 * 128 * 4  # buffers and counters of 128 users
    for d in range(4, 1025, 4):
        for bf16 in (False, True):
            for resident in (False, True):
                base = tm.topk_smem_bytes(d, bf16, resident, tm.EPI_LSE)
                got = tm.topk_smem_bytes(d, bf16, resident, epilogue)
                assert got == base + {tm.EPI_TOPK: lists, tm.EPI_BOOST: lists + 2 * 128 * 4,
                                      tm.EPI_LSE: 0}[epilogue]
            plan = tm.topk_plan(d, bf16, epilogue)
            assert plan.smem_bytes <= tm.SMEM_LIMIT and plan.smem_bytes % 16 == 0
            assert plan.smem_bytes == tm.topk_smem_bytes(d, bf16, plan.resident_users, epilogue)
    assert tm.topk_plan(256, False, epilogue).resident_users == (epilogue == tm.EPI_LSE)
    assert tm.topk_plan(d, True) == tm.topk_plan(d, True, tm.EPI_TOPK)


@pytest.mark.parametrize("u,i,d,k,w", [(13, 11, 16, 5, 2.5), (9, 7, 8, 7, 1.0),
                                       (20, 300, 16, 40, 2.0)])
def test_boosted_plain_versions_match_pallas_small_catalog_and_wide_k(u, i, d, k, w):
    """Catalogs of fewer than 16 items (the kernels' threads with no item)
    and k above 32: the plain versions of both passes against JAX's two
    Pallas kernels (interpret mode), near-ties held as chip_smoke holds
    them; mips_lse's pair against the f64 log-sum-exp."""
    rng = np.random.default_rng(11)
    ue = rng.normal(size=(u, d)).astype(np.float32)
    ie = rng.normal(size=(i, d)).astype(np.float32)
    pop = rng.uniform(0, 0.05, i).astype(np.float32)
    jv, ji = jmips_boosted(jnp.asarray(ue), jnp.asarray(ie), jnp.asarray(pop), k,
                           weight=w, tile_users=8, tile_items=64, interpret=True)
    s64 = ue.astype(np.float64) @ ie.astype(np.float64).T
    lse = np.log(np.exp(s64 - s64.max(axis=1, keepdims=True)).sum(axis=1)) + s64.max(axis=1)
    m, s = tm.mips_lse_reference(torch.from_numpy(ue), torch.from_numpy(ie))
    np.testing.assert_allclose(m.numpy(), s64.max(axis=1), rtol=0, atol=TOL)
    np.testing.assert_allclose(m.double().numpy() + np.log(s.double().numpy()), lse,
                               rtol=0, atol=TOL)
    e64 = np.exp(s64 - s64.max(axis=1, keepdims=True))
    boosted = e64 / e64.sum(axis=1, keepdims=True) + w * pop.astype(np.float64)
    args = (torch.from_numpy(ue), torch.from_numpy(ie), torch.from_numpy(pop), k)
    for fn in (tm.mips_topk_boosted, tm.mips_topk_boosted_reference):
        _check_near_ties(*fn(*args, weight=w), jv, ji, boosted)
