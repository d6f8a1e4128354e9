"""Sharded-CSR sampling of the port against the JAX package
(``gnn_recsys_tpu/parallel/sharded.py:621-821``): padding, sharding and
stripping a relation's tables, the shard-local exclusion table, and the
sampler on rows fetched from their owners.  JAX samples with a key; its
uniform draws are ``jax.random.uniform(key, (*ids.shape, fanout))``
(``ops/sampling.py:113``), given to the port as ``u``.  Every result is an
integer or bool array and must be equal."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import Mesh as JMesh, PartitionSpec as P

from gnn_recsys_tpu.ops.sampling import exclusion_table as jexclusion_table
from gnn_recsys_tpu.ops.sampling import sample_neighbors as jsample
from gnn_recsys_tpu.parallel import sharded as js
from gnn_recsys_tpu.utils.synthetic import make_synthetic_data as jmake
from gnn_recsys_tpu_torch.ops.sampling import exclusion_table
from gnn_recsys_tpu_torch.parallel import sharded as ts
from gnn_recsys_tpu_torch.utils.synthetic import make_synthetic_data

ET = ("user", "buys", "item")
WORLD = dict(num_users=64, num_items=32, num_groups=4, interactions_per_user=8,
             with_clicks=True, seed=5)
M = 8


@pytest.fixture(scope="module")
def graphs():
    return jmake(**WORLD).graph, make_synthetic_data(**WORLD).graph


def _jmesh():
    return JMesh(np.asarray(jax.devices()[:M]).reshape(M), ("model",))


def _blocks(t: torch.Tensor, m: int = M):
    return list(t.chunk(m))


@pytest.mark.parametrize("m", [2, 8, 5])
def test_pad_shard_strip_match_jax(graphs, m):
    jg, tg = graphs
    for et in jg.canonical_etypes:
        want = js.pad_adjacency_tables(jg.rels[et], m)
        got = ts.pad_adjacency_tables(tg.rels[et], m)
        assert got[4] == want[4]
        for a, b in zip(got[:4], want[:4]):
            assert a.shape[0] % m == 0
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    adj = ts.shard_adjacency(tg, tg.canonical_etypes, m)
    jadj = js.shard_adjacency(jg, jg.canonical_etypes, m)
    for et in jg.canonical_etypes:
        for name in ("nbr", "eid", "mask", "deg"):
            np.testing.assert_array_equal(adj[et][name].numpy(), np.asarray(jadj[et][name]))
    stripped = ts.strip_adjacency(tg, (ET,))
    jstripped = js.strip_adjacency(jg, (ET,))
    r, jr = stripped.rels[ET], jstripped.rels[ET]
    for name in ("nbr", "nbr_eid", "nbr_mask", "deg", "src", "dst", "eid_pos"):
        a, b = getattr(r, name), getattr(jr, name)
        assert a.dtype == (torch.bool if b.dtype == jnp.bool_ else torch.int32)
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert r.nbr_feat is None
    other = ("user", "clicks", "item")
    assert stripped.rels[other] is tg.rels[other]


def test_exclusion_table_sharded_concatenates_to_replicated(graphs):
    jg, tg = graphs
    rel = tg.rels[ET]
    nbr, _, _, _, n = ts.pad_adjacency_tables(rel, M)
    eids = torch.from_numpy(np.random.default_rng(1).permutation(rel.num_edges)[:40]
                            .astype(np.int32))
    parts = [ts.exclusion_table_sharded(b, rel.eid_pos, eids, k)
             for k, b in enumerate(_blocks(nbr))]
    got = torch.cat(parts)[:n]
    np.testing.assert_array_equal(got.numpy(), exclusion_table(rel, eids).numpy())
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jexclusion_table(jg.rels[ET], jnp.asarray(eids.numpy()))))


def _jax_sharded(jg, ids, fanout, key, mode, excl=None, capacity=None):
    rel = jg.rels[ET]
    nbr, eid, mask, deg, _ = js.pad_adjacency_tables(rel, M)

    @jax.jit
    @functools.partial(shard_map, mesh=_jmesh(),
                       in_specs=(P("model"),) * 4 + (P(), P(), P(), P()),
                       out_specs=(P(), P(), P()), check_vma=False)
    def run(nbr_s, eid_s, mask_s, deg_s, eid_pos, excl_ids, ids, key):
        table = None
        if excl is not None:
            table = js.exclusion_table_sharded(nbr_s, eid_pos, excl_ids)
        return js.sample_neighbors_sharded(nbr_s, eid_s, mask_s, deg_s, ids, fanout, rng=key,
                                           mode=mode, capacity=capacity, nbr_table_shard=table)

    excl_ids = jnp.asarray(excl if excl is not None else np.zeros(1, np.int32))
    return run(nbr, eid, mask, deg, rel.eid_pos, excl_ids, jnp.asarray(ids), key)


def _port_sharded(tg, ids, fanout, u, mode, excl=None, capacity=None):
    rel = tg.rels[ET]
    nbr, eid, mask, deg, _ = ts.pad_adjacency_tables(rel, M)
    table = None
    if excl is not None:
        table = [ts.exclusion_table_sharded(b, rel.eid_pos, torch.from_numpy(excl), k)
                 for k, b in enumerate(_blocks(nbr))]
    return ts.sample_neighbors_sharded(
        _blocks(nbr), _blocks(eid), _blocks(mask), _blocks(deg), torch.from_numpy(ids), fanout,
        u=None if u is None else torch.from_numpy(u), mode=mode, capacity=capacity,
        nbr_table_shards=table, return_dropped=True)


@pytest.mark.parametrize("mode,exclude", [("uniform", False), ("full", False),
                                          ("uniform", True)])
def test_sample_neighbors_sharded_matches_replicated_and_jax(graphs, mode, exclude):
    """The sampler on fetched rows equals the replicated sampler on the same
    draws (JAX ``test_multichip.py:579-670``), and JAX's sharded sampler."""
    jg, tg = graphs
    rng = np.random.default_rng(1 if exclude else 0)
    n = tg.num_nodes("item")
    ids = rng.integers(0, n, 24).astype(np.int32)
    excl = (rng.permutation(tg.rels[ET].num_edges)[:40].astype(np.int32) if exclude else None)
    fanout = 3 if mode == "uniform" else tg.rels[ET].max_fanout
    key = jax.random.PRNGKey(9 if exclude else 4)
    u = np.array(jax.random.uniform(key, (24, fanout))) if mode == "uniform" else None
    got = _port_sharded(tg, ids, fanout, u, mode, excl)
    assert int(got[3]) == 0
    jrel = jg.rels[ET]
    kw = {}
    if exclude:
        kw["nbr_table"] = jexclusion_table(jrel, jnp.asarray(excl))
    replicated = jsample(jrel, jnp.asarray(ids), fanout, rng=key, mode=mode, **kw)
    sharded = _jax_sharded(jg, ids, fanout, key, mode, excl)
    for a, b, c, name in zip(got[:3], replicated, sharded, ("nbr", "eid", "mask")):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=f"{mode}/{name}")
        np.testing.assert_array_equal(a.numpy(), np.asarray(c), err_msg=f"{mode}/{name}")


def test_adjacency_drops_are_counted(graphs):
    """The reference flaw not followed (``ADVICE.md`` item 1,
    ``sharded.py:760``): with an adjacency capacity that overflows, JAX's
    lost rows come back empty and uncounted; the port returns the same rows
    and a drop count above 0."""
    jg, tg = graphs
    n = tg.num_nodes("item")
    ids = np.zeros(64, np.int32)  # every request on owner 0
    ids[::2] = np.arange(32) % n
    key = jax.random.PRNGKey(2)
    u = np.array(jax.random.uniform(key, (64, 3)))
    nbr, eid, mask, dropped = _port_sharded(tg, ids, 3, u, "uniform", capacity=1)
    jnbr, jeid, jmask = _jax_sharded(jg, ids, 3, key, "uniform", capacity=1)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    np.testing.assert_array_equal(nbr.numpy(), np.asarray(jnbr))
    full, _, full_mask, _ = _port_sharded(tg, ids, 3, u, "uniform")
    lost = (full_mask.numpy().any(axis=1)) & ~(mask.numpy().any(axis=1))
    assert lost.sum() > 0  # JAX reads these rows as zero-degree destinations
    assert int(dropped) >= lost.sum() > 0
