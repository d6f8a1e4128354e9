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

TOL = 1e-5


@pytest.fixture(autouse=True)
def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False


def _check(vals, idx, jvals, jidx, rtol=0.0):
    np.testing.assert_allclose(vals.numpy(), np.asarray(jvals), rtol=rtol, atol=TOL)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))


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
    for fn in (tm.mips_topk_boosted, tm.mips_topk_boosted_reference):
        vals, idx = fn(*args, weight=w)
        _check(vals, idx, jv, ji)
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
    tm.reset_launch_counts()
    tm.mips_topk(ue, ie, 3)
    tm.mips_topk_boosted(ue, ie, torch.zeros(20), 3)
    assert tm.mips_topk.launches == tm.mips_topk_boosted.launches == 0
