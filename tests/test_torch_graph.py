"""The port's graph container, synthetic data and npz format against the
JAX package: the same seed gives the same arrays, and files cross over."""

import os
import warnings
import zipfile

import numpy as np
import pytest
import torch

from gnn_recsys_tpu.graph import hetero as jhetero
from gnn_recsys_tpu.graph.serialize import load_graph as jload_graph
from gnn_recsys_tpu.graph.serialize import save_graph as jsave_graph
from gnn_recsys_tpu.ops.membership import build_padded_pair_set as jbuild_pairs
from gnn_recsys_tpu.utils.synthetic import make_synthetic_data as jmake
from gnn_recsys_tpu_torch.graph import hetero as thetero
from gnn_recsys_tpu_torch.graph.serialize import _read_npz, load_graph, save_graph
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


def _members(path):
    with zipfile.ZipFile(path) as zf:
        return zf.infolist()


def _load_counted(path, monkeypatch):
    """``load_graph(path)`` with its counters reset and every warning an
    error; returns the graph and the counters."""
    monkeypatch.setattr(load_graph, "stored_bytes", 0)
    monkeypatch.setattr(load_graph, "inflated_bytes", 0)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        g = load_graph(path)
    return g, load_graph.stored_bytes, load_graph.inflated_bytes


def _assert_writable(g):
    for rel in g.rels.values():
        for name in REL_ARRAYS:
            assert getattr(rel, name).numpy().flags.writeable, name
        assert all(t.numpy().flags.writeable for t in rel.edata.values())
    assert all(t.numpy().flags.writeable for f in g.ndata.values() for t in f.values())


def test_port_graph_file_is_stored_and_loads_in_both(tmp_path, monkeypatch):
    tg = make_synthetic_data(num_users=40, num_items=25, seed=7, with_sports=True).graph
    path = os.path.join(tmp_path, "graph.npz")
    save_graph(tg, path)
    members = _members(path)
    assert {m.compress_type for m in members} == {zipfile.ZIP_STORED}
    assert_graphs_equal(jload_graph(path), tg)
    loaded, stored, inflated = _load_counted(path, monkeypatch)
    assert_graphs_equal(tg, loaded)
    assert (stored, inflated) == (sum(m.file_size for m in members), 0)
    _assert_writable(loaded)


def _old_port_file(graph, path):
    """The graph as old port writers left it: deflated, ``nbr`` padded with
    0, no ``eid_pos``."""
    save_graph(graph, path)
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files if not k.endswith("\x1feid_pos")}
    for k in [k for k in arrays if k.endswith("\x1fnbr")]:
        arrays[k] = np.where(arrays[k[:-3] + "nbr_mask"], arrays[k], 0).astype(np.int32)
    np.savez_compressed(path, **arrays)


@pytest.mark.parametrize("writer", ["jax", "old_port"])
def test_deflated_graph_file_loads_through_inflating_path(writer, tmp_path, monkeypatch):
    kw = dict(num_users=40, num_items=25, seed=8, with_sports=True)
    path = os.path.join(tmp_path, "graph.npz")
    if writer == "jax":
        expected = jmake(**kw).graph
        jsave_graph(expected, path)
    else:
        expected = make_synthetic_data(**kw).graph
        _old_port_file(expected, path)
        assert any((expected.rels[et].nbr != -1).any() for et in expected.rels)
    members = _members(path)
    assert zipfile.ZIP_DEFLATED in {m.compress_type for m in members}
    loaded, stored, inflated = _load_counted(path, monkeypatch)
    assert_graphs_equal(expected, loaded)
    assert stored + inflated == sum(m.file_size for m in members)
    assert inflated == sum(m.file_size for m in members
                           if m.compress_type == zipfile.ZIP_DEFLATED)
    _assert_writable(loaded)


@pytest.mark.parametrize("save", [np.savez, np.savez_compressed])
def test_read_npz_members_equal_np_load(save, tmp_path):
    rng = np.random.default_rng(9)
    arrays = {
        "i32": rng.integers(-5, 5, (7, 3)).astype(np.int32),
        "i64": rng.integers(-5, 5, 11).astype(np.int64),
        "f16": rng.standard_normal((2, 3, 4)).astype(np.float16),
        "mask": rng.random((5, 4)) < 0.5,
        "fortran": np.asfortranarray(rng.standard_normal((4, 6)).astype(np.float32)),
        "scalar": np.float64(2.5),
        "empty": np.zeros((0, 3), np.int32),
        "odd": np.arange(3, dtype=np.uint8),  # the next member starts unaligned
    }
    path = os.path.join(tmp_path, "a.npz")
    save(path, **arrays)
    got = _read_npz(path)
    assert sorted(got) == sorted(arrays)
    for k, a in arrays.items():
        assert got[k].dtype == a.dtype and got[k].flags.writeable, k
        np.testing.assert_array_equal(got[k], a, err_msg=k)


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
