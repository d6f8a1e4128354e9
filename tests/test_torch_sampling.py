"""The port's sampler against the JAX package's: the same relation, ids and
uniform draws give exactly the same ``nbr`` / ``eid`` / ``mask`` (integer
outputs: tolerance 0) in every mode, with every form of exclusion."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnn_recsys_tpu.graph.hetero import build_relation as jbuild_relation
from gnn_recsys_tpu.ops import sampling as js
from gnn_recsys_tpu.utils.synthetic import make_synthetic_data as jmake
from gnn_recsys_tpu_torch.graph.hetero import build_relation
from gnn_recsys_tpu_torch.ops import sampling as ts
from gnn_recsys_tpu_torch.ops.sampling import Draws, ReplayDraws
from gnn_recsys_tpu_torch.utils.synthetic import make_synthetic_data

ET = ("item", "bought-by", "user")


def _graphs(max_fanout=None):
    kw = dict(num_users=30, num_items=20, num_groups=3, interactions_per_user=5,
              with_clicks=True, seed=2, max_fanout=max_fanout)
    return jmake(**kw).graph, make_synthetic_data(**kw).graph


def _hub_relations():
    """One destination far wider than ROW_GATHER_KMAX, one of degree 8, the
    rest empty: the wide-row path."""
    rng = np.random.default_rng(7)
    hub = js.ROW_GATHER_KMAX * 2 + 5
    src = np.concatenate([rng.integers(0, 50, hub), rng.integers(0, 50, 8)]).astype(np.int32)
    dst = np.concatenate([np.zeros(hub), np.ones(8)]).astype(np.int32)
    return jbuild_relation(src, dst, num_dst=12), build_relation(src, dst, num_dst=12)


def _exclusion(kind, jrel, trel, eids):
    if kind is None:
        return {}, {}
    if kind == "table":
        return ({"nbr_table": js.exclusion_table(jrel, jnp.asarray(eids))},
                {"nbr_table": ts.exclusion_table(trel, torch.as_tensor(eids))})
    return ({"exclude_flags": js.exclusion_flags(jrel, jnp.asarray(eids))},
            {"exclude_flags": ts.exclusion_flags(trel, torch.as_tensor(eids))})


def _assert_same(jout, tout, with_eids=True):
    jn, je, jm = (np.asarray(a) if a is not None else None for a in jout)
    tn, te, tm_ = tout
    np.testing.assert_array_equal(tn.numpy(), jn)
    np.testing.assert_array_equal(tm_.numpy(), jm)
    if with_eids:
        np.testing.assert_array_equal(te.numpy(), je)


def _run_both(jrel, trel, ids, fanout, mode, excl, eids, key=3):
    jkw, tkw = _exclusion(excl, jrel, trel, eids)
    rng = jax.random.PRNGKey(key) if mode == "uniform" else None
    jout = js.sample_neighbors(jrel, jnp.asarray(ids, jnp.int32), fanout, rng=rng, mode=mode,
                               **jkw)
    u = None
    if mode == "uniform":  # the draws JAX's sampler makes from this key
        u = torch.as_tensor(np.array(jax.random.uniform(rng, (*ids.shape, fanout))))
    tout = ts.sample_neighbors(trel, torch.as_tensor(ids), fanout, u=u, mode=mode, **tkw)
    _assert_same(jout, tout)
    return tout


@pytest.mark.parametrize("excl", [None, "table", "flags"])
@pytest.mark.parametrize("mode", ["full", "uniform"])
def test_row_modes_match_jax(mode, excl):
    jg, tg = _graphs()
    jrel, trel = jg.rels[ET], tg.rels[ET]
    assert trel.max_fanout <= ts.ROW_GATHER_KMAX  # the row-gather path
    ids = np.arange(30, dtype=np.int32).reshape(5, 6)  # N-D frontiers keep their shape
    eids = np.where(np.asarray(jrel.dst) % 3 == 0)[0].astype(np.int32)
    nbr, _, mask = _run_both(jrel, trel, ids, 4, mode, excl, eids)
    assert nbr.shape[:2] == (5, 6) and mask.dtype == torch.bool


@pytest.mark.parametrize("excl", [None, "table", "flags"])
def test_wide_row_uniform_matches_jax(excl):
    jrel, trel = _hub_relations()
    assert trel.max_fanout > ts.ROW_GATHER_KMAX  # the wide-row path
    eids = np.where(np.asarray(jrel.dst) == 0)[0][::2].astype(np.int32)
    nbr, eid, mask = _run_both(jrel, trel, np.arange(12, dtype=np.int32), 16, "uniform",
                               excl, eids)
    assert mask[1].all() and not mask[2:].any()


@pytest.mark.parametrize("max_fanout", [None, 8])
def test_exclusion_tables_match_jax(max_fanout):
    """With a fanout cap some edges have no slot (eid_pos = N*K): the
    scatter drops them, as JAX's ``mode='drop'`` does."""
    jg, tg = _graphs(max_fanout)
    dropped = 0
    for et in tg.canonical_etypes:
        jrel, trel = jg.rels[et], tg.rels[et]
        eids = np.arange(0, trel.num_edges, 3, dtype=np.int32)
        dropped += int((trel.eid_pos.numpy()[eids] >= trel.nbr.numel()).sum())
        np.testing.assert_array_equal(
            ts.exclusion_table(trel, torch.as_tensor(eids)).numpy(),
            np.asarray(js.exclusion_table(jrel, jnp.asarray(eids))))
        np.testing.assert_array_equal(
            ts.exclusion_flags(trel, torch.as_tensor(eids)).numpy(),
            np.asarray(js.exclusion_flags(jrel, jnp.asarray(eids))))
    assert (dropped > 0) == (max_fanout is not None)


@pytest.mark.parametrize("mode", ["uniform", "full"])
def test_zero_degree_nodes_match_jax(mode):
    """Destinations 3 and 7 have no edges: every slot is invalid and carries
    node 0, an in-range id."""
    src = np.asarray([1, 2, 5, 5, 9, 4], np.int32)
    dst = np.asarray([0, 0, 1, 2, 4, 9], np.int32)
    jrel, trel = jbuild_relation(src, dst, num_dst=10), build_relation(src, dst, num_dst=10)
    nbr, _, mask = _run_both(jrel, trel, np.asarray([3, 7, 0], np.int32), 4, mode, None,
                             None)
    assert not mask[:2].any() and (nbr[:2] == 0).all()


def test_relation_max_fanout_is_the_padded_width():
    jg, tg = _graphs(8)
    for et in tg.canonical_etypes:
        assert tg.rels[et].max_fanout == jg.rels[et].max_fanout == tg.rels[et].nbr.shape[1]


def test_draws_record_and_replay():
    d = Draws(torch.Generator().manual_seed(0), record=True)
    a, b = d.uniform((3, 4)), d.randint((5,), 7)
    assert a.dtype == torch.float32 and ((a >= 0) & (a < 1)).all()
    assert b.dtype == torch.int32 and ((b >= 0) & (b < 7)).all()
    r = d.replay()
    assert torch.equal(r.randint((5,), 7), b) and torch.equal(r.uniform((3, 4)), a)
    assert r.exhausted
    with pytest.raises(ValueError):
        ReplayDraws([np.zeros((2, 2))]).uniform((2, 3))
