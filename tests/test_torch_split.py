"""The port's hard synthetic data, ``remove_edges``, ``etypes_into`` /
``etypes_from`` and ``train_valid_split`` against the JAX package on a micro
world: every array equal, bit for bit (both are numpy from one seed)."""

import dataclasses

import numpy as np
import pytest
import torch
from test_torch_graph import assert_graphs_equal

from gnn_recsys_tpu.config import FixedParams as JFixedParams
from gnn_recsys_tpu.data.split import train_valid_split as jsplit
from gnn_recsys_tpu.graph.hetero import remove_edges as jremove_edges
from gnn_recsys_tpu.utils.synthetic import make_hard_synthetic_data as jmake_hard
from gnn_recsys_tpu_torch.config import FixedParams
from gnn_recsys_tpu_torch.data.split import train_valid_split
from gnn_recsys_tpu_torch.graph.hetero import remove_edges
from gnn_recsys_tpu_torch.utils.synthetic import make_hard_synthetic_data

HARD_KW = dict(num_users=300, num_items=100, seed=3, user_chunk=128)
BUYS = ("user", "buys", "item")
CLICKS = ("user", "clicks", "item")


@pytest.fixture(scope="module")
def worlds():
    """The micro hard world of each package, capped and uncapped."""
    return {cap: (jmake_hard(**HARD_KW, max_fanout=cap), make_hard_synthetic_data(
        **HARD_KW, max_fanout=cap)) for cap in (None, 16)}


def _assert_arrays_equal(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, what
    if a.size:
        assert a.dtype == b.dtype, what
    np.testing.assert_array_equal(a, b, err_msg=what)


@pytest.mark.parametrize("cap", [None, 16])
def test_hard_synthetic_data_equal(worlds, cap):
    jd, td = worlds[cap]
    assert_graphs_equal(jd.graph, td.graph)
    assert td.train_graph is td.graph
    for name in ("user_latent", "item_latent", "item_logpop", "user_group", "item_group"):
        a, b = getattr(jd, name), getattr(td, name)
        assert (a is None) == (b is None), name
        if a is not None:
            _assert_arrays_equal(a, b, name)
    for a, b in zip(jd.test_ground_truth, td.test_ground_truth):
        _assert_arrays_equal(a, b, "test_ground_truth")
    assert list(jd.train_pairs) == list(td.train_pairs)
    for et in jd.train_pairs:
        for a, b in zip(jd.train_pairs[et], td.train_pairs[et]):
            _assert_arrays_equal(a, b, f"train_pairs {et}")
    assert (jd.num_users, jd.num_items, jd.num_groups) == (td.num_users, td.num_items,
                                                           td.num_groups)
    if cap is None:  # hub items: the uncapped rows are wider than the cap
        assert td.graph.rels[BUYS].max_fanout > 16


def test_etypes_into_and_from(worlds):
    jg, tg = worlds[None][0].graph, worlds[None][1].graph
    for nt in ("user", "item"):
        assert tg.etypes_into(nt) == jg.etypes_into(nt)
        assert tg.etypes_from(nt) == jg.etypes_from(nt)
    assert tg.etypes_into("item") == (BUYS, CLICKS)
    assert tg.etypes_from("item") == (("item", "bought-by", "user"),
                                      ("item", "clicked-by", "user"))


@pytest.mark.parametrize("cap,max_fanout", [(None, None), (16, None), (16, 8), (None, 24)])
def test_remove_edges_matches_jax(worlds, cap, max_fanout):
    """Every relation rebuilt, the removed etypes and the others, with and
    without a cap; the uncapped rebuild of a capped graph widens its rows
    (the split's default, ROADMAP.md queue 3)."""
    jd, td = worlds[cap]
    rng = np.random.default_rng(4)
    removals = {et: rng.choice(jd.graph.num_edges(et), 200, replace=False)
                for et in (BUYS, ("item", "bought-by", "user"), CLICKS)}
    jg = jremove_edges(jd.graph, removals, max_fanout=max_fanout)
    tg = remove_edges(td.graph, {et: torch.as_tensor(v).numpy() for et, v in removals.items()},
                      max_fanout=max_fanout)
    assert_graphs_equal(jg, tg)
    for et in td.graph.canonical_etypes:
        assert tg.num_edges(et) == td.graph.num_edges(et) - len(removals.get(et, ()))
    if cap is not None and max_fanout is None:
        assert tg.rels[BUYS].max_fanout > cap


@pytest.mark.parametrize("fixed_kw,samples,max_fanout", [
    ({}, (1.0, 1.0), None),
    ({}, (0.3, 0.5), None),
    ({"valid_size": 0.2, "subtrain_size": 0.3}, (1.0, 0.5), 16),
])
def test_train_valid_split_matches_jax(worlds, fixed_kw, samples, max_fanout):
    """Every field of ``TrainValSplit`` equal: the train graph, eids, user
    sets and ground truths (the subtrain users come from the global numpy
    generator in both packages)."""
    jd, td = worlds[16]
    clicks, purchases = samples
    kw = dict(clicks_sample=clicks, purchases_sample=purchases, max_fanout=max_fanout)
    js = jsplit(jd.graph, jd.test_ground_truth, JFixedParams(**fixed_kw), **kw)
    ts = train_valid_split(td.graph, td.test_ground_truth, FixedParams(**fixed_kw), **kw)
    assert_graphs_equal(js.train_graph, ts.train_graph)
    for field in dataclasses.fields(js):
        name = field.name
        a, b = getattr(js, name), getattr(ts, name)
        if name == "train_graph":
            continue
        if isinstance(a, dict):
            assert list(a) == list(b), name
            for et in a:
                _assert_arrays_equal(a[et], b[et], f"{name} {et}")
        elif isinstance(a, tuple):
            for x, y in zip(a, b):
                _assert_arrays_equal(x, y, name)
        else:
            _assert_arrays_equal(a, b, name)
    assert len(ts.subtrain_uids) > 0 and len(ts.ground_truth_valid[0]) > 0


@pytest.mark.parametrize("samples", [(1.0, 1.0), (0.6, 0.8)])
def test_remove_train_eids_fails_in_both_packages(worlds, samples):
    """``remove_train_eids=True`` removes the training edges from the train
    graph, whose training eids then point past its edges: both packages
    raise the same IndexError (a flaw of the JAX package that the port
    follows; ROADMAP.md queue 3)."""
    jd, td = worlds[16]
    kw = dict(clicks_sample=samples[0], purchases_sample=samples[1])
    with pytest.raises(IndexError) as jerr:
        jsplit(jd.graph, jd.test_ground_truth, JFixedParams(remove_train_eids=True), **kw)
    with pytest.raises(IndexError) as terr:
        train_valid_split(td.graph, td.test_ground_truth, FixedParams(remove_train_eids=True),
                          **kw)
    assert str(terr.value) == str(jerr.value)
