"""The gather-mean kernel's plain versions against the JAX package's
``gather_mean_pallas`` (interpret mode) and ``csc_gather_mean``, its gradient
against ``jax.grad``, and ``unique_capped`` against ``jnp.unique``.

Tolerances: rtol 1e-5 / atol 1e-6 for the forward (sums of K terms in another
order, then one division); the same for the gradient, whose entries are sums
of a few scaled cotangent rows (the kernel's atomics add them in an order
that changes from run to run)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnn_recsys_tpu.ops.message import csc_gather_mean as jcsc_gather_mean
from gnn_recsys_tpu.ops.pallas.gather_mean import gather_mean_pallas
from gnn_recsys_tpu_torch.ops import message as tmsg
from gnn_recsys_tpu_torch.ops.cuda import gather_mean as gm
from gnn_recsys_tpu_torch.ops.sampling import unique_capped

RTOL, ATOL = 1e-5, 1e-6


def _case(b, k, n, d, seed=0):
    """The shapes of tests/test_pallas_gather.py plus a zero-degree row, ids
    of -1 and ids >= n (both clipped into range)."""
    rng = np.random.default_rng(seed)
    h = rng.normal(size=(n, d)).astype(np.float32)
    nbr = rng.integers(0, n, (b, k)).astype(np.int32)
    mask = rng.random((b, k)) < 0.7
    mask[0] = False  # a zero-degree row
    nbr[1, 0], nbr[2, 1] = -1, n + 5
    mask[1, 0] = mask[2, 1] = True  # valid slots whose ids get clipped
    nbr[3, :] = -1  # padding where masked
    mask[3, 1:] = False
    return h, nbr, mask


@pytest.mark.parametrize("b,k,n,d", [(13, 8, 50, 16), (32, 16, 200, 32)])
def test_forward_matches_pallas_and_csc_gather_mean(b, k, n, d):
    h, nbr, mask = _case(b, k, n, d)
    pallas = np.asarray(gather_mean_pallas(jnp.asarray(h), jnp.asarray(nbr), jnp.asarray(mask),
                                           tile_rows=4, interpret=True))
    xla = np.asarray(jcsc_gather_mean(jnp.asarray(h), jnp.asarray(nbr), jnp.asarray(mask)))
    th, tn, tm = torch.tensor(h), torch.tensor(nbr), torch.tensor(mask)
    for out in (gm.gather_mean(th, tn, tm), gm.gather_mean_fwd(th, tn.long(), tm),
                tmsg.csc_gather_mean(th, tn, tm)):
        np.testing.assert_allclose(out.numpy(), pallas, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(out.numpy(), xla, rtol=RTOL, atol=ATOL)
        assert (out[0] == 0).all()


@pytest.mark.parametrize("b,k,n,d", [(13, 8, 50, 16), (32, 16, 200, 32)])
def test_gradient_matches_jax_grad(b, k, n, d):
    h, nbr, mask = _case(b, k, n, d, seed=1)
    c = np.random.default_rng(2).normal(size=(b, d)).astype(np.float32)

    def jloss(h_):
        return jnp.sum(jcsc_gather_mean(h_, jnp.asarray(nbr), jnp.asarray(mask)) * c)

    want = np.asarray(jax.grad(jloss)(jnp.asarray(h)))
    th = torch.tensor(h, requires_grad=True)
    (gm.gather_mean(th, torch.tensor(nbr), torch.tensor(mask)) * torch.tensor(c)).sum().backward()
    np.testing.assert_allclose(th.grad.numpy(), want, rtol=RTOL, atol=ATOL)
    # The plain backward (the backward kernel's oracle) gives the same.
    dh = gm.gather_mean_bwd(torch.tensor(c), torch.tensor(nbr), torch.tensor(mask), n)
    np.testing.assert_allclose(dh.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("n,high,cap", [(40, 10, 16), (37, 1000, 40), (64, 64, 64), (5, 3, 8)])
def test_unique_capped_matches_jnp_unique(n, high, cap):
    """Capacities at and above the number of distinct ids (padding with 0)."""
    flat = np.random.default_rng(n).integers(0, high, n).astype(np.int32)
    ju, jinv = jnp.unique(jnp.asarray(flat), return_inverse=True, size=cap, fill_value=0)
    tu, tinv = unique_capped(torch.tensor(flat), cap)
    assert tu.dtype == torch.int32 and tinv.dtype == torch.int32
    np.testing.assert_array_equal(tu.numpy(), np.asarray(ju))
    np.testing.assert_array_equal(tinv.numpy(), np.asarray(jinv).reshape(-1))
    np.testing.assert_array_equal(tu.numpy()[tinv.numpy()], flat)


def test_cpu_tensors_take_the_plain_route():
    h, nbr, mask = _case(9, 4, 20, 8)
    counts = (gm.gather_mean_fwd.launches, gm.gather_mean_bwd.launches)
    th = torch.tensor(h, requires_grad=True)
    out = gm.gather_mean(th, torch.tensor(nbr), torch.tensor(mask))
    out.sum().backward()
    gm.gather_mean_fwd(torch.tensor(h), torch.tensor(nbr), torch.tensor(mask))
    gm.gather_mean_bwd(out.detach(), torch.tensor(nbr), torch.tensor(mask), 20)
    assert (gm.gather_mean_fwd.launches, gm.gather_mean_bwd.launches) == counts
    torch.testing.assert_close(out, gm.gather_mean_reference(torch.tensor(h), torch.tensor(nbr),
                                                             torch.tensor(mask)))
