"""The port's graph container, synthetic data and npz format against the
JAX package: the same seed gives the same arrays, and files cross over."""

import os

import numpy as np
import pytest
import torch

from gnn_recsys_tpu.graph import hetero as jhetero
from gnn_recsys_tpu.graph.serialize import load_graph as jload_graph
from gnn_recsys_tpu.graph.serialize import save_graph as jsave_graph
from gnn_recsys_tpu.ops.membership import build_padded_pair_set as jbuild_pairs
from gnn_recsys_tpu.utils.synthetic import make_synthetic_data as jmake
from gnn_recsys_tpu_torch.graph import hetero as thetero
from gnn_recsys_tpu_torch.graph.serialize import load_graph, save_graph
from gnn_recsys_tpu_torch.ops.membership import build_padded_pair_set
from gnn_recsys_tpu_torch.utils.synthetic import make_synthetic_data

REL_ARRAYS = ("src", "dst", "nbr", "nbr_eid", "nbr_mask", "deg", "eid_pos")


def assert_graphs_equal(jg, tg):
    assert tuple(jg.canonical_etypes) == tuple(tg.canonical_etypes)
    assert tuple(jg.num_nodes_tuple) == tuple(tg.num_nodes_tuple)
    for et in jg.canonical_etypes:
        jr, tr = jg.rels[et], tg.rels[et]
        for name in REL_ARRAYS:
            np.testing.assert_array_equal(
                np.asarray(getattr(jr, name)), getattr(tr, name).numpy(), err_msg=f"{et} {name}"
            )
        assert sorted(jr.edata) == sorted(tr.edata)
        for name in jr.edata:
            np.testing.assert_array_equal(np.asarray(jr.edata[name]), tr.edata[name].numpy())
    assert sorted(jg.ndata) == sorted(tg.ndata)
    for nt in jg.ndata:
        assert sorted(jg.ndata[nt]) == sorted(tg.ndata[nt])
        for name in jg.ndata[nt]:
            np.testing.assert_array_equal(np.asarray(jg.ndata[nt][name]), tg.ndata[nt][name].numpy())


@pytest.mark.parametrize("seed,max_fanout,with_sports", [
    (0, None, False), (1, 8, False), (2, 16, True),
])
def test_synthetic_data_equal(seed, max_fanout, with_sports):
    kw = dict(num_users=60, num_items=40, seed=seed, max_fanout=max_fanout,
              with_sports=with_sports)
    jd, td = jmake(**kw), make_synthetic_data(**kw)
    assert_graphs_equal(jd.graph, td.graph)
    for a, b in zip(jd.test_ground_truth, td.test_ground_truth):
        np.testing.assert_array_equal(a, b)
    for et in jd.train_pairs:
        for a, b in zip(jd.train_pairs[et], td.train_pairs[et]):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("max_fanout", [None, 3, 5])
def test_coo_to_padded_csc_matches_packer(max_fanout):
    rng = np.random.default_rng(3)
    src = rng.integers(0, 50, 400).astype(np.int32)
    dst = rng.integers(0, 30, 400).astype(np.int32)
    dst[dst == 7] = 8  # a zero-degree row
    for a, b in zip(jhetero.coo_to_padded_csc(src, dst, 30, max_fanout=max_fanout),
                    thetero.coo_to_padded_csc(src, dst, 30, max_fanout=max_fanout)):
        np.testing.assert_array_equal(a, b)


def test_jax_graph_file_loads_in_port_and_back(tmp_path):
    jg = jmake(num_users=30, num_items=20, seed=4, with_sports=True).graph
    jpath = os.path.join(tmp_path, "jax.npz")
    jsave_graph(jg, jpath)
    tg = load_graph(jpath)
    assert_graphs_equal(jg, tg)
    tpath = os.path.join(tmp_path, "port.npz")
    save_graph(tg, tpath)
    assert_graphs_equal(jload_graph(tpath), tg)


def test_graph_to_device_keeps_arrays():
    tg = make_synthetic_data(num_users=10, num_items=30, seed=5).graph
    moved = tg.to("cpu")
    for et in tg.canonical_etypes:
        assert torch.equal(moved.rels[et].nbr, tg.rels[et].nbr)
    assert moved.num_nodes_dict == tg.num_nodes_dict


@pytest.mark.parametrize("cap", [None, 4])
def test_padded_pair_set_rows_equal(cap):
    rng = np.random.default_rng(6)
    u = rng.integers(0, 25, 300).astype(np.int32)
    i = rng.integers(0, 60, 300).astype(np.int32)
    jp = jbuild_pairs(u, i, num_src=30, cap=cap)
    tp = build_padded_pair_set(u, i, num_src=30, cap=cap)
    np.testing.assert_array_equal(np.asarray(jp.rows), tp.rows.numpy())
    assert jp.max_row == tp.max_row
