"""The dense-pool membership mask against the JAX package: the Pallas
kernel (interpret mode) and ``pair_set_contains_pool`` give exactly the
port's values (a 0/1 mask: tolerance 0), in both routes and for rows wider
than the kernel's 128 slots."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnn_recsys_tpu.ops.membership import build_padded_pair_set as jbuild
from gnn_recsys_tpu.ops.membership import pair_set_contains_pool as jcontains_pool
from gnn_recsys_tpu.ops.pallas.pool_mask import pool_membership_mask as jpool_mask
from gnn_recsys_tpu_torch.ops.cuda import pool_mask as pm
from gnn_recsys_tpu_torch.ops.membership import (
    build_padded_pair_set,
    pair_set_contains,
    pair_set_contains_pool,
)


def _world(seed=0, n_users=50, n_items=40, n_edges=300, b=33, p=70, hub_degree=0):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n_users, n_edges).astype(np.int32)
    dst = rng.integers(0, n_items, n_edges).astype(np.int32)
    if hub_degree:  # user 0 gets a row wider than the kernel takes
        src = np.concatenate([src, np.zeros(hub_degree, np.int32)])
        dst = np.concatenate([dst, rng.integers(0, n_items, hub_degree).astype(np.int32)])
    u = rng.integers(0, n_users, b).astype(np.int32)
    u[0] = 0
    pool = rng.integers(0, n_items, p).astype(np.int32)
    return src, dst, u, pool


@pytest.mark.parametrize("b,p", [(33, 70), (1, 5), (64, 128)])
def test_pool_membership_mask_matches_pallas(b, p):
    src, dst, u, pool = _world(b=b, p=p)
    rows = build_padded_pair_set(src, dst, num_src=50).rows[torch.as_tensor(u).long()]
    pool[::7] = -2  # padded pool columns never match
    want = np.asarray(jpool_mask(jnp.asarray(rows.numpy()), jnp.asarray(pool), block_b=8,
                                 interpret=True))
    got = pm.pool_membership_mask(rows, torch.as_tensor(pool))
    assert got.dtype == torch.float32 and got.shape == (b, p)
    np.testing.assert_array_equal(got.numpy(), want)
    assert pm.pool_membership_mask.launches == 0  # CPU tensors: the plain version


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("hub_degree", [0, 200])
def test_pair_set_contains_pool_matches_jax(use_kernel, hub_degree):
    src, dst, u, pool = _world(seed=1, hub_degree=hub_degree)
    jps, tps = jbuild(src, dst, num_src=50), build_padded_pair_set(src, dst, num_src=50)
    assert (tps.max_row > pm.MAX_ROW) == bool(hub_degree)  # the broadcast route
    want = np.asarray(jcontains_pool(jps, jnp.asarray(u), jnp.asarray(pool),
                                     use_kernel=use_kernel))
    got = pair_set_contains_pool(tps, torch.as_tensor(u), torch.as_tensor(pool),
                                 use_kernel=use_kernel)
    np.testing.assert_array_equal(got.numpy(), want)
    # ... and the general probe of every (u, pool) pair agrees.
    general = pair_set_contains(tps, torch.as_tensor(u),
                                torch.as_tensor(pool)[None, :].expand(len(u), -1))
    np.testing.assert_array_equal(got.numpy(), general.float().numpy())


def test_padding_rows_never_match():
    """Users without edges have all -1 rows; -1 in the pool never matches."""
    src = np.zeros(5, np.int32)
    dst = np.asarray([1, 3, 3, 7, 9], np.int32)
    ps = build_padded_pair_set(src, dst, num_src=4)
    pool = torch.as_tensor([1, -1, 3, 4, 9, -1], dtype=torch.int32)
    got = pair_set_contains_pool(ps, torch.arange(4), pool, use_kernel=True)
    np.testing.assert_array_equal(got.numpy()[0], [1, 0, 1, 0, 1, 0])
    assert got[1:].sum() == 0
