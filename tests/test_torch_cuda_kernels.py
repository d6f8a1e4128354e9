"""The CUDA MIPS kernels against their plain versions, on the card.

Marked ``cuda``; without a card every test skips (the decision is made in a
fixture).  On a CUDA host, without JAX installed::

    python -m pytest --noconftest -p no:cacheprovider -q -m cuda \
        tests/test_torch_cuda_kernels.py
"""

import numpy as np
import pytest
import torch

from gnn_recsys_tpu_torch.ops.cuda import topk_mips as tm

pytestmark = pytest.mark.cuda

TOL = 1e-5  # f32 FMAs in another order than the library product


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
