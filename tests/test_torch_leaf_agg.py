"""The fused leaf aggregation against the JAX package's ``leaf_mean_nn``
(its Pallas kernel in interpret mode, gradients through ``jax.grad``).

Tolerances: f32 forward within 1e-6 (sums of 8 and 8 terms in another
order); dW / db within 1e-5 (sums over K*P terms); bf16 outputs within one
bf16 ulp (2**-7 relative), since the two sides round the same f32 sums after
different summation orders."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnn_recsys_tpu.ops.pallas.leaf_agg import leaf_mean_nn as jleaf
from gnn_recsys_tpu.ops.pallas.leaf_agg import leaf_mean_nn_reference as jleaf_ref
from gnn_recsys_tpu_torch.ops.cuda import leaf_agg as la

F32_TOL = 1e-6
GRAD_TOL = 1e-5
BF16_RTOL = 2.0**-7


def _case(seed=0, k=8, p=48, f=8, h=64, all_masked_row=None):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(k, p, f)).astype(np.float32)
    mask = (rng.random((p, k)) < 0.7).astype(np.float32)
    if all_masked_row is not None:
        mask[all_masked_row] = 0.0
    ms = mask / np.maximum(mask.sum(axis=1, keepdims=True), 1.0)
    w = (rng.normal(size=(f, h)) * 0.3).astype(np.float32)
    b = (rng.normal(size=(h,)) * 0.1).astype(np.float32)
    return x, ms, w, b


def _loss_weights(p, h, seed=9):
    return np.random.default_rng(seed).normal(size=(p, h)).astype(np.float32)


@pytest.mark.parametrize("p,f,h,masked", [(48, 8, 64, None), (40, 8, 256, 3),
                                          (37, 5, 33, 0), (16, 128, 16, None)])
def test_forward_and_gradients_match_jax(p, f, h, masked):
    """Ragged P (not a multiple of the 16-parent blocks), odd F and H, and
    an all-masked row (which must be 0)."""
    x, ms, w, b = _case(p=p, f=f, h=h, all_masked_row=masked)
    c = _loss_weights(p, h)

    def jloss(w_, b_):
        return jnp.sum(jleaf(jnp.asarray(x), jnp.asarray(ms), w_, b_, 16, True) * c)

    jout = np.asarray(jleaf(jnp.asarray(x), jnp.asarray(ms), jnp.asarray(w), jnp.asarray(b),
                            16, True))
    jdw, jdb = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(w), jnp.asarray(b))

    tw = torch.tensor(w, requires_grad=True)
    tb = torch.tensor(b, requires_grad=True)
    out = la.leaf_mean_nn(torch.tensor(x), torch.tensor(ms), tw, tb)
    (out * torch.tensor(c)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), jout, rtol=0, atol=F32_TOL)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jdw), rtol=GRAD_TOL, atol=GRAD_TOL)
    np.testing.assert_allclose(tb.grad.numpy(), np.asarray(jdb), rtol=GRAD_TOL, atol=GRAD_TOL)
    if masked is not None:
        assert (out[masked] == 0).all()
    assert la.leaf_mean_nn_fwd.launches == la.leaf_mean_nn_bwd.launches == 0


def test_backward_matches_autograd_of_the_reference():
    """The plain backward (the kernel's oracle) equals autograd through the
    einsum forward."""
    x, ms, w, b = _case(seed=3, p=29, h=40)
    g = torch.tensor(_loss_weights(29, 40))
    tw, tb = torch.tensor(w, requires_grad=True), torch.tensor(b, requires_grad=True)
    la.leaf_mean_nn_reference(torch.tensor(x), torch.tensor(ms), tw, tb).backward(g)
    dw, db = la.leaf_mean_nn_bwd_reference(torch.tensor(x), torch.tensor(ms), tw.detach(),
                                           tb.detach(), g)
    torch.testing.assert_close(dw, tw.grad, rtol=GRAD_TOL, atol=GRAD_TOL)
    torch.testing.assert_close(db, tb.grad, rtol=GRAD_TOL, atol=GRAD_TOL)


def test_bf16_matches_jax_reference():
    x, ms, w, b = _case(seed=4, p=64, h=128)
    bf = jnp.bfloat16
    jout = jleaf_ref(jnp.asarray(x, bf), jnp.asarray(ms), jnp.asarray(w, bf), jnp.asarray(b, bf))
    xt = torch.tensor(x).bfloat16()
    out = la.leaf_mean_nn(xt, torch.tensor(ms), torch.tensor(w).bfloat16(),
                          torch.tensor(b).bfloat16())
    assert out.dtype == torch.bfloat16
    ref = np.asarray(jout.astype(jnp.float32))
    np.testing.assert_allclose(out.float().numpy(), ref, rtol=BF16_RTOL, atol=1e-6)


def test_kernel_support_bounds():
    assert la.leaf_kernel_supported(1) and la.leaf_kernel_supported(128)
    assert not la.leaf_kernel_supported(0) and not la.leaf_kernel_supported(129)


@pytest.mark.parametrize("h", [1, 33, 256])
@pytest.mark.parametrize("f", [1, 8, 128])
@pytest.mark.parametrize("p", [1, 31, 18432, 18437])
def test_launch_geometry_covers_each_parent_and_column_once(p, f, h):
    """The kernels' grid, walked as they walk it: block x takes tiles x,
    x + grid_x, ... of tile_parents parents, block y columns y *
    block_columns onward (a lane 1-4 of them); every parent and column is
    covered once, every block has a tile, and the backward's partials (one
    a block x) hold every block's slab."""
    geo = la.launch_geometry(p, f, h, sms=132)
    tp, bc = la.tile_shape(f)
    assert (geo.tile_parents, geo.block_columns) == (tp, bc)
    parents = np.zeros(p, np.int64)
    partial_of_tile = {}
    for x in range(geo.grid_x):
        mine = range(x, geo.tiles, geo.grid_x)
        assert len(mine) >= 1  # no block without a tile, so no unwritten partial
        for t in mine:
            parents[t * tp:(t + 1) * tp] += 1
            partial_of_tile[t] = x
    assert (parents == 1).all()
    assert sorted(set(partial_of_tile.values())) == list(range(geo.grid_x))
    columns = np.zeros(h, np.int64)
    for y in range(geo.grid_y):
        columns[y * bc:(y + 1) * bc] += 1
    assert (columns == 1).all() and geo.grid_y * bc < h + bc
    assert geo.grid_x * geo.grid_y <= max(geo.grid_y, 4 * 132)  # about 4 blocks an SM
    # block_p bounds the parents one block walks.
    small = la.launch_geometry(p, f, h, sms=1, block_p=2 * tp)
    assert -(-small.tiles // small.grid_x) <= 2
