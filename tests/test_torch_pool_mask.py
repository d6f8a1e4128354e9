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


@pytest.mark.parametrize("k", [1, 2, 3, 24, 32, 33, 100, 128])
def test_set_slots_hold_a_row_at_most_a_sixteenth_full(k):
    s = pm.set_slots(k)
    assert s & (s - 1) == 0 and 16 * k <= s < 64 * k and (s <= 2048 or s < 32 * k)


@pytest.mark.parametrize("b,k,p", [(1024, 32, 2560), (1000, 24, 2557), (3, 128, 7), (9, 1, 1),
                                   (1001, 32, 4097)])
def test_launch_geometry_covers_each_row_and_position_once(b, k, p):
    """The kernel's grid, walked as it walks it: block (x, y) takes rows
    y * tile_rows onward and pool positions [x * chunk, (x + 1) * chunk), 4
    a thread of 256; every (row, position) of [B, P] is written once, the
    chunks are whole 16-byte stores and equal but for the last, and the
    block's row sets fit its shared memory."""
    geo = pm.launch_geometry(b, k, p)
    assert geo.slots == pm.set_slots(k) and geo.chunk % 4 == 0 and geo.chunk <= 256 * 4
    assert geo.smem_bytes == 4 * geo.tile_rows * geo.slots <= 48 * 1024
    rows, cols = np.zeros(b, np.int64), np.zeros(p, np.int64)
    for y in range(geo.grid_y):
        rows[y * geo.tile_rows:(y + 1) * geo.tile_rows] += 1
    for x in range(geo.grid_x):
        end = min(p, (x + 1) * geo.chunk)
        for t in range(256):
            p0 = x * geo.chunk + 4 * t
            cols[p0:min(p0 + 4, end)] += 1
    assert (rows == 1).all() and (cols == 1).all()
    assert (geo.grid_y - 1) * geo.tile_rows < b and (geo.grid_x - 1) * geo.chunk < p
    assert geo.grid_x == -(-p // 1024) and p - (geo.grid_x - 1) * geo.chunk > geo.chunk - 4 * geo.grid_x
