"""The port's cuckoo edge hash against the JAX package's: the same answers
for random pairs, every member and an empty set (the two builders may place
pairs differently: the JAX package can build through its C++ core, so the
tables themselves are not compared)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnn_recsys_tpu.ops.edge_hash import _mix as jmix
from gnn_recsys_tpu.ops.edge_hash import build_edge_hash as jbuild
from gnn_recsys_tpu.ops.edge_hash import edge_hash_lookup as jlookup
from gnn_recsys_tpu_torch.ops.edge_hash import _mix, _mix_np, build_edge_hash, edge_hash_lookup


def _pairs(seed, n, hi=300):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, hi, n).astype(np.int32)
    dst = rng.integers(0, hi, n).astype(np.int32)
    return src, dst


def test_mix_matches_jax_uint32():
    """The device hash (int64 masked to 32 bits) equals JAX's uint32 one on
    ids across the whole int32 range, negatives included."""
    rng = np.random.default_rng(0)
    u = rng.integers(-2**31, 2**31, 4096, dtype=np.int64).astype(np.int32)
    v = rng.integers(-2**31, 2**31, 4096, dtype=np.int64).astype(np.int32)
    for a, b in ((0x9E3779B1, 0x68E31DA5), (0xB55A4F09, 0x9E297A2B)):
        want = np.asarray(jmix(jnp.asarray(u), jnp.asarray(v), a, b, jnp)).astype(np.int64)
        got = _mix(torch.from_numpy(u), torch.from_numpy(v), a, b)
        assert got.dtype == torch.int64
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(_mix_np(u, v, a, b).astype(np.int64), want)


@pytest.mark.parametrize("n", [0, 1, 500, 5000])
def test_lookup_matches_jax(n):
    """Random probes (some members), every member (duplicates in the input),
    and the empty set."""
    src, dst = _pairs(n, n)
    if n:
        src, dst = np.concatenate([src, src[:n // 3]]), np.concatenate([dst, dst[:n // 3]])
    table, jtable = build_edge_hash(src, dst), jbuild(src, dst)
    assert table.slot_u.shape == (2, table.capacity) and table.slot_u.dtype == torch.int32
    pu, pv = _pairs(n + 1, 4000)
    for u, v in ((pu, pv), (src, dst)):
        got = edge_hash_lookup(table, torch.from_numpy(u), torch.from_numpy(v))
        want = np.asarray(jlookup(jtable, jnp.asarray(u), jnp.asarray(v)))
        assert got.dtype == torch.bool
        np.testing.assert_array_equal(got.numpy(), want)
    members = edge_hash_lookup(table, torch.from_numpy(src), torch.from_numpy(dst))
    assert bool(members.all())
    exact = set(zip(src.tolist(), dst.tolist()))
    probe = edge_hash_lookup(table, torch.from_numpy(pu), torch.from_numpy(pv)).numpy()
    np.testing.assert_array_equal(probe, [p in exact for p in zip(pu.tolist(), pv.tolist())])


def test_lookup_keeps_shape_and_table_device():
    src, dst = _pairs(3, 200)
    table = build_edge_hash(src, dst).to("cpu")
    u = torch.from_numpy(src[:12].reshape(3, 4)).long()
    v = torch.from_numpy(dst[:12].reshape(3, 4)).long()
    out = edge_hash_lookup(table, u, v)
    assert out.shape == (3, 4) and bool(out.all())
    assert not bool(edge_hash_lookup(table, u, v + 1000).any())
