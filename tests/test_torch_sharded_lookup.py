"""The port's row-sharded lookups and hash layout against the JAX package's
(``gnn_recsys_tpu/parallel/sharded.py``).  JAX runs its functions inside
``shard_map`` on the 8 virtual CPU devices (``tests/conftest.py``); the port
on a mesh of 8 CPU entries, the table and ids cut into the same blocks.
Rows are gathered, not computed: they must be equal (row transforms within
1e-6 relative plus 1e-6 absolute, f32 products in another grouping).  Integer results
(hashes, layouts, drop counts) must be equal."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import Mesh as JMesh, PartitionSpec as P

from gnn_recsys_tpu.parallel import sharded as js
from gnn_recsys_tpu_torch.parallel import sharded as ts

M = 8


def _jmesh():
    return JMesh(np.asarray(jax.devices()[:M]).reshape(M), ("model",))


def _blocks(x: np.ndarray, m: int = M):
    return list(torch.from_numpy(np.ascontiguousarray(x)).chunk(m))


def _jax_a2a(table, ids, **kw):
    @jax.jit
    @functools.partial(shard_map, mesh=_jmesh(), in_specs=(P("model", None), P("model")),
                       out_specs=(P("model"), P(None)), check_vma=False)
    def lookup(t, i):
        out, dropped = js.row_sharded_lookup_a2a(t, i, "model", return_dropped=True, **kw)
        return out, dropped[None]

    out, dropped = lookup(jnp.asarray(table), jnp.asarray(ids))
    return np.asarray(out), int(dropped[0])


def _port_a2a(table, ids, **kw):
    outs, dropped = ts.row_sharded_lookup_a2a(_blocks(table), _blocks(ids), return_dropped=True,
                                              **kw)
    return torch.cat(outs).numpy(), int(dropped)


def test_row_sharded_lookup_matches_jax():
    """Replicated ids against a table split over 8 owners (``:823-847``),
    with and without an owner-side row transform."""
    rng = np.random.default_rng(0)
    table = rng.normal(size=(64, 16)).astype(np.float32)
    ids = np.asarray([0, 5, 63, 17, 33, 8, 8, 40], np.int32)
    w = rng.normal(size=(16, 4)).astype(np.float32)
    for transform in (False, True):
        jt = (lambda r: jax.nn.relu(r @ jnp.asarray(w))) if transform else None
        tt = (lambda r: torch.relu(r @ torch.from_numpy(w))) if transform else None

        @jax.jit
        @functools.partial(shard_map, mesh=_jmesh(), in_specs=(P("model", None), P()),
                           out_specs=P(), check_vma=False)
        def lookup(t, i):
            return js.row_sharded_lookup(t, i, "model", row_transform=jt)

        want = np.asarray(lookup(jnp.asarray(table), jnp.asarray(ids)))
        got = ts.row_sharded_lookup(_blocks(table), torch.from_numpy(ids), row_transform=tt)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
        if not transform:
            np.testing.assert_array_equal(got.numpy(), table[ids])


@pytest.mark.parametrize("case", ["worst_case", "statistical", "overflow", "transform"])
def test_row_sharded_lookup_a2a_matches_jax(case):
    """The worst-case exchange on skewed ids, a statistical capacity whose
    overflow lane keeps it exact, overflow past both budgets (detected, the
    other rows exact), and an owner-side transform under a capacity."""
    rng = np.random.default_rng({"worst_case": 3, "statistical": 7, "overflow": 11,
                                 "transform": 5}[case])
    kw, transform = {}, None
    if case == "worst_case":
        n, d, b = 64, 16, 32
        ids = np.concatenate([rng.integers(0, 8, b // 2), rng.integers(0, n, b - b // 2)])
    elif case == "statistical":
        n, d, b = 512, 16, 256
        ids = rng.integers(0, n, b)
        kw = dict(capacity=8, overflow_capacity=16)
    elif case == "overflow":
        n, d, b = 64, 8, 64
        ids = rng.integers(0, 8, b)  # every id on owner 0
        kw = dict(capacity=2, overflow_capacity=2)
    else:
        n, d, b = 256, 16, 128
        ids = rng.integers(0, n, b)
        kw = dict(capacity=ts.statistical_a2a_capacity(b // M, M, 2.0))
        transform = rng.normal(size=(d, 6)).astype(np.float32), rng.normal(size=6).astype(
            np.float32)
    table = rng.normal(size=(n, d)).astype(np.float32)
    ids = ids.astype(np.int32)
    jkw, tkw = dict(kw), dict(kw)
    if transform is not None:
        w, bias = transform
        jkw["row_transform"] = lambda r: jax.nn.relu(r @ jnp.asarray(w) + jnp.asarray(bias))
        tkw["row_transform"] = lambda r: torch.relu(r @ torch.from_numpy(w)
                                                    + torch.from_numpy(bias))
    want, want_dropped = _jax_a2a(table, ids, **jkw)
    got, dropped = _port_a2a(table, ids, **tkw)
    assert dropped == want_dropped
    if transform is None:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    if case == "overflow":
        # 8 ids a requester, 2 through the buckets, 2 through the lane.
        assert dropped == 8 * 4
        exact = (got == table[ids]).all(axis=1)
        assert ((got == 0).all(axis=1) | exact).all() and int((~exact).sum()) == 8 * 4
    elif case != "transform":
        assert dropped == 0
        np.testing.assert_array_equal(got, table[ids])


def test_hash_mix_is_bijective_and_matches_jax():
    for log in (1, 4, 10, 17, 31):
        ids = np.arange(min(1 << log, 1 << 17), dtype=np.int32)
        if log == 31:  # the top of the domain, where the products pass 2**62
            ids = (np.arange(1 << 12, dtype=np.int64) * 524_287 + (1 << 30)).astype(np.int32)
        want = np.asarray(js.hash_mix_ids(jnp.asarray(ids), log))
        got = ts.hash_mix_ids(torch.from_numpy(ids), log)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
        if log <= 17:
            assert np.unique(want).size == ids.size
            assert want.min() >= 0 and want.max() < (1 << log)


@pytest.mark.parametrize("n,m", [(30, 2), (64, 8), (1000, 8), (3, 8)])
def test_hash_shard_table_matches_jax(n, m):
    table = np.random.default_rng(n).normal(size=(n, 5)).astype(np.float32)
    want, want_log = js.hash_shard_table(jnp.asarray(table), m)
    got, log = ts.hash_shard_table(torch.from_numpy(table), m)
    assert log == want_log
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_statistical_capacity_matches_jax():
    for chunk, m, factor in [(32, 8, 2.0), (4, 2, 2.0), (64, 8, 4.0), (1000, 7, 1.3), (3, 8, 2)]:
        assert ts.statistical_a2a_capacity(chunk, m, factor) == js.statistical_a2a_capacity(
            chunk, m, factor)


def test_hash_sharded_lookup_zipf_zero_drops():
    """A popularity-skewed stream (90% of ids in the first owner's range):
    contiguous rows overflow at a statistical capacity, hash-sharded rows
    do not, and stay exact (JAX ``test_multichip.py:480-532``)."""
    rng = np.random.default_rng(0)
    n, d, b = 1024, 16, 512
    table = rng.normal(size=(n, d)).astype(np.float32)
    hot = rng.integers(0, n // M, int(b * 0.9))
    ids = np.concatenate([hot, rng.integers(0, n, b - hot.shape[0])]).astype(np.int32)
    cap = ts.statistical_a2a_capacity(b // M, M, 2.0)

    _, want_contig = _jax_a2a(table, ids, capacity=cap)
    _, contig = _port_a2a(table, ids, capacity=cap)
    assert contig == want_contig > 0

    hashed, log = ts.hash_shard_table(torch.from_numpy(table), M)
    mixed = ts.hash_mix_ids(torch.from_numpy(ids), log).numpy()
    jhashed, _ = js.hash_shard_table(jnp.asarray(table), M)
    want_rows, want_hash = _jax_a2a(np.asarray(jhashed), mixed, capacity=cap)
    rows, dropped = _port_a2a(hashed.numpy(), mixed, capacity=cap)
    assert dropped == want_hash == 0
    np.testing.assert_array_equal(rows, table[ids])
    np.testing.assert_array_equal(rows, want_rows)


def test_a2a_exchange_bytes_from_bucket_shapes():
    rng = np.random.default_rng(1)
    table = rng.normal(size=(64, 4)).astype(np.float32)
    ids = rng.integers(0, 64, 32).astype(np.int32)
    stats = {}
    ts.row_sharded_lookup_a2a(_blocks(table), _blocks(ids), capacity=2, overflow_capacity=1,
                              stats=stats)
    c, oc = 2, 1
    assert stats == {"request_bytes": M * M * c * 4, "response_bytes": M * M * c * 16,
                     "overflow_bytes": M * oc * (M * 4 + M * 16)}
