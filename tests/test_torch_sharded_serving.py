"""Catalog-sharded retrieval and mesh embedding inference of the port against
the JAX package.

The port's mesh is 8 CPU entries, ``('data'=2, 'model'=4)``, JAX's the 8
virtual CPU devices of ``tests/conftest.py``.  The port's ``get_recs_sharded``
on both routes (``cuda``: the MIPS kernels' plain versions on CPU tensors,
``torch``) must equal JAX's single-device ``get_recs`` exactly, and JAX's
``get_recs_sharded`` where that is exact; the boosted ``cuda`` route combines
the shards' softmax statistics in another order, so it is held by the
near-tie rule.  JAX's Pallas route ranks a zero padding row before it masks
it; the port's ``cuda`` route ranks real rows only (the padding case).
"""

import contextlib
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_minibatch import one_torch_thread  # noqa: F401 (autouse)

from gnn_recsys_tpu.models.conv_model import ConvModel as JConvModel
from gnn_recsys_tpu.ops.membership import build_padded_pair_set as jpairs
from gnn_recsys_tpu.parallel.mesh import make_mesh as jmake_mesh
from gnn_recsys_tpu.parallel.mesh import shard_batch as jshard_batch
from gnn_recsys_tpu.retrieval.metrics import get_metrics_at_k as jmetrics
from gnn_recsys_tpu.retrieval.recs import get_recs as jget_recs
from gnn_recsys_tpu.retrieval.recs import model_score_fn as jmodel_score_fn
from gnn_recsys_tpu.retrieval.sharded import get_recs_sharded as jget_recs_sharded
from gnn_recsys_tpu.train.full_batch import init_model
from gnn_recsys_tpu.train.minibatch import infer_embeddings as jinfer
from gnn_recsys_tpu.utils.synthetic import make_synthetic_data as jmake
from gnn_recsys_tpu_torch.cli import main_inference
from gnn_recsys_tpu_torch.config import HyperParams
from gnn_recsys_tpu_torch.inference import inference_ondemand
from gnn_recsys_tpu_torch.models.conv_model import ConvModel
from gnn_recsys_tpu_torch.models.convert import params_from_jax
from gnn_recsys_tpu_torch.ops.membership import build_padded_pair_set
from gnn_recsys_tpu_torch.parallel import make_mesh, replicate, shard_batch
from gnn_recsys_tpu_torch.retrieval.metrics import get_metrics_at_k
from gnn_recsys_tpu_torch.retrieval.recs import get_recs, make_mlp_score_fn
from gnn_recsys_tpu_torch.retrieval.sharded import (
    get_recs_sharded,
    infer_embeddings_sharded,
    shard_catalog,
)
from gnn_recsys_tpu_torch.train.checkpoint import save_run
from gnn_recsys_tpu_torch.train.minibatch import infer_embeddings
from gnn_recsys_tpu_torch.utils.synthetic import make_synthetic_data

K = 10
TOL = 1e-5  # near-tie rule: the scores of two differing lists agree within TOL
CPU8 = ["cpu"] * 8


@pytest.fixture(autouse=True)
def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False


@pytest.fixture(scope="module")
def meshes():
    """(JAX mesh, port mesh), both ('data'=2, 'model'=4)."""
    return jmake_mesh(n_devices=8, data_axis=2), make_mesh(8, data_axis=2, devices=CPU8)


def _embs():
    """JAX's fixture (``tests/test_sharded_serving.py:33-49``): 201 items,
    not divisible by 8."""
    rng = np.random.default_rng(7)
    user_emb = rng.standard_normal((96, 16)).astype(np.float32)
    item_emb = rng.standard_normal((201, 16)).astype(np.float32)
    user_ids = rng.permutation(96)[:40].astype(np.int32)
    bu = rng.integers(0, 96, size=400).astype(np.int32)
    bi = rng.integers(0, 201, size=400).astype(np.int32)
    pop = (rng.random(201).astype(np.float32) / 201.0)
    return user_emb, item_emb, user_ids, (bu, bi, 96), pop


def _hub():
    """JAX's hub case (``tests/test_sharded_serving.py:87-109``): one user
    bought 600 of 640 items."""
    rng = np.random.default_rng(3)
    user_emb = rng.standard_normal((8, 8)).astype(np.float32)
    item_emb = rng.standard_normal((640, 8)).astype(np.float32)
    bu = np.concatenate([np.zeros(600, np.int32), rng.integers(1, 8, 50).astype(np.int32)])
    bi = np.concatenate([rng.permutation(640)[:600].astype(np.int32),
                         rng.integers(0, 640, 50).astype(np.int32)])
    return user_emb, item_emb, np.arange(8, dtype=np.int32), (bu, bi, 8), None


def _mlp_params(d: int, seed: int = 11):
    rng = np.random.default_rng(seed)

    def dense(i, o):
        return {"kernel": rng.standard_normal((i, o)).astype(np.float32) * 0.1,
                "bias": np.zeros(o, np.float32)}

    return {"params": {"pred_layer": {"hidden_1": dense(2 * d, 128),
                                      "hidden_2": dense(128, 32), "output": dense(32, 1)}}}


# case -> (data, bought, boosted, mlp head, axis)
CASES = {
    "plain": (_embs, False, False, False, "model"),
    "already_bought": (_embs, True, False, False, "model"),
    "boosted": (_embs, True, True, False, "model"),
    "hub": (_hub, True, False, False, "model"),
    "mlp": (_embs, False, False, True, "model"),
    "both_axes": (_embs, True, True, False, ("data", "model")),
    "201_items_over_8": (_embs, True, False, False, ("data", "model")),
}


def _both(case):
    """(JAX keyword arguments, port keyword arguments, data) of one case."""
    make, bought, boosted, mlp, axis = CASES[case]
    ue, ie, uids, (bu, bi, n_src), pop = make()
    jkw, tkw = dict(axis=axis), dict(axis=axis)
    if bought:
        jkw["already_bought"] = jpairs(bu, bi, num_src=n_src)
        tkw["already_bought"] = build_padded_pair_set(bu, bi, num_src=n_src)
    if boosted:
        jkw.update(popularity=jnp.asarray(pop), weight_popularity=0.1)
        tkw.update(popularity=torch.from_numpy(pop), weight_popularity=0.1)
    if mlp:
        params = _mlp_params(ue.shape[1])
        jkw["score_fn"] = jmodel_score_fn("nn", params)
        tkw["score_fn"] = make_mlp_score_fn(params_from_jax(params))
    return jkw, tkw, (ue, ie, uids)


def _boosted_scores(ue, ie, pop, w):
    """f64 boosted scores [U_all, I] of the reference formula."""
    u = ue / np.linalg.norm(ue, axis=1, keepdims=True)
    it = ie / np.linalg.norm(ie, axis=1, keepdims=True)
    s = u.astype(np.float64) @ it.astype(np.float64).T
    e = np.exp(s - s.max(axis=1, keepdims=True))
    return e / e.sum(axis=1, keepdims=True) + w * pop.astype(np.float64)


def _assert_near_ties(out, ref, uids, scores):
    """Rows may differ only where the two lists' scores agree within TOL."""
    for r in np.nonzero((out != ref).any(axis=1))[0]:
        a, b = (np.sort(scores[uids[r], row[row >= 0]]) for row in (out[r], ref[r]))
        assert np.abs(a - b).max() <= TOL, f"row {r}: {out[r]} against {ref[r]}"


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_equals_single_device_jax(meshes, case):
    jmesh, mesh = meshes
    jkw, tkw, (ue, ie, uids) = _both(case)
    axis = jkw.pop("axis")
    ref = np.asarray(jget_recs(jnp.asarray(ue), jnp.asarray(ie), jnp.asarray(uids), K, **jkw))
    jsh = np.asarray(jget_recs_sharded(jmesh, jnp.asarray(ue), jnp.asarray(ie),
                                       jnp.asarray(uids), K, axis=axis, **jkw))
    np.testing.assert_array_equal(jsh, ref)
    backends = ["torch"] if "score_fn" in tkw else ["torch", "cuda", "auto"]
    for backend in backends:
        out = get_recs_sharded(mesh, ue, ie, uids, K, backend=backend, **tkw)
        assert out.dtype == torch.int64 and out.device == mesh.first_device
        if backend == "cuda" and "popularity" in tkw:
            scores = _boosted_scores(ue, ie, tkw["popularity"].numpy(), 0.1)
            _assert_near_ties(out.numpy(), ref, uids, scores)
        else:
            np.testing.assert_array_equal(out.numpy(), ref, err_msg=backend)
    if case == "hub":
        assert tkw["already_bought"].max_row > 256


def test_padding_row_never_outranks_a_real_item(meshes):
    """One user ``[1, 0]``, nine items, k = 3, the catalog over the 2-entry
    'data' axis: the last shard holds items 5-8 (negative scores) and one
    zero padding row.  JAX's Pallas route lets the padding row's 0 push item
    7 out of that shard's top 3; the port's ``cuda`` route ranks real rows
    only."""
    jmesh, mesh = meshes
    u = np.array([[1.0, 0.0]], np.float32)
    items = np.array([[-0.9, 0.43]] * 5 + [[-0.1, 0.99], [-0.2, 0.98], [-0.3, 0.95],
                                          [-0.4, 0.92]], np.float32)
    ids = np.array([0], np.int32)
    single = np.asarray(jget_recs(jnp.asarray(u), jnp.asarray(items), jnp.asarray(ids), 3))
    np.testing.assert_array_equal(single, [[5, 6, 7]])
    jargs = (jmesh, jnp.asarray(u), jnp.asarray(items), jnp.asarray(ids), 3)
    np.testing.assert_array_equal(np.asarray(jget_recs_sharded(*jargs, axis="data")), single)
    jpallas = np.asarray(jget_recs_sharded(*jargs, axis="data", backend="pallas"))
    np.testing.assert_array_equal(jpallas, [[5, 6, 0]])
    assert not np.array_equal(jpallas, single)
    for backend in ("cuda", "torch"):
        out = get_recs_sharded(mesh, u, items, ids, 3, axis="data", backend=backend)
        np.testing.assert_array_equal(out.numpy(), single, err_msg=backend)


def test_shards_with_fewer_rows_than_the_fetch(meshes):
    """Nine items over 8 shards (per 2): the last shards hold one real row or
    none; their ``-inf`` fillers rank last."""
    _, mesh = meshes
    rng = np.random.default_rng(5)
    ue = rng.standard_normal((6, 4)).astype(np.float32)
    ie = rng.standard_normal((9, 4)).astype(np.float32)
    pop = rng.random(9).astype(np.float32)
    ids = np.arange(6, dtype=np.int32)
    for boost in (None, torch.from_numpy(pop)):
        ref = get_recs(ue, ie, ids, 7, popularity=boost, device="cpu")
        assert (ref >= 0).all()
        for backend in ("cuda", "torch"):
            out = get_recs_sharded(mesh, ue, ie, ids, 7, popularity=boost, backend=backend,
                                   axis=("data", "model"))
            np.testing.assert_array_equal(out.numpy(), ref.numpy(), err_msg=backend)


def test_shard_catalog_placement(meshes):
    _, mesh = meshes
    ue, ie, uids, _, pop = _embs()
    blocks, pop_blocks, n = shard_catalog(mesh, ie, pop)
    assert n == 201 and len(blocks) == len(pop_blocks) == 4  # 'model' axis = 4
    assert [b.shape for b in blocks] == [(51, 16)] * 4
    assert [p.shape for p in pop_blocks] == [(51,)] * 4
    assert [b.device for b in blocks] == mesh.shard_devices("model")
    whole = torch.cat(blocks)
    np.testing.assert_array_equal(whole[:201].numpy(), ie)
    assert not whole[201:].any() and not torch.cat(pop_blocks)[201:].any()
    ref = np.asarray(jget_recs(jnp.asarray(ue), jnp.asarray(ie), jnp.asarray(uids), K))
    for backend in ("cuda", "torch"):
        out = get_recs_sharded(mesh, ue, blocks, uids, K, num_items=n, backend=backend)
        np.testing.assert_array_equal(out.numpy(), ref)


def test_routes_refuse_what_they_cannot_do(meshes):
    _, mesh = meshes
    ue, ie, uids, _, _ = _embs()
    sfn = make_mlp_score_fn(params_from_jax(_mlp_params(16)))
    with pytest.raises(ValueError, match="cosine only"):
        get_recs_sharded(mesh, ue, ie, uids, K, score_fn=sfn, backend="cuda")
    with pytest.raises(ValueError, match="unknown backend"):
        get_recs_sharded(mesh, ue, ie, uids, K, backend="pallas")
    with pytest.raises(ValueError, match="catalog blocks"):
        get_recs_sharded(mesh, ue, [torch.from_numpy(ie)], uids, K)


@pytest.mark.parametrize("leaf_kernel", [False, True])
def test_infer_embeddings_sharded_matches_jax(meshes, leaf_kernel):
    """The sharded tree pass against JAX's ``infer_embeddings`` (the full
    graph), JAX's weights carried by ``params_from_jax``, within JAX's
    tolerance (``tests/test_sharded_serving.py:196-198``)."""
    _, mesh = meshes
    kw = dict(num_users=60, num_items=28, num_groups=4, interactions_per_user=6,
              with_clicks=True, seed=9)
    jd, td = jmake(**kw), make_synthetic_data(**kw)
    mkw = dict(canonical_etypes=jd.graph.canonical_etypes,
               dims=(("user", 8), ("item", 8), ("hidden", 16), ("out", 8)),
               n_layers=3, aggregator_type="mean_nn", pred="cos")
    jm = JConvModel(**mkw)
    jfeats = {nt: jd.graph.ndata[nt]["features"] for nt in jd.graph.ntypes}
    params = init_model(jm, jd.graph, jfeats, seed=0)
    ref = jinfer(jm, params, jd.graph, jfeats)
    model = ConvModel(**mkw, leaf_kernel=leaf_kernel)
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    model.train()
    feats = {nt: td.graph.ndata[nt]["features"] for nt in td.graph.ntypes}
    outs = [infer_embeddings_sharded(model, td.graph, feats, mesh, node_chunk=16),
            infer_embeddings(model, td.graph, feats, mode="full_graph", node_batch_size=16,
                             mesh=mesh)]
    for out in outs:
        for nt in ("user", "item"):
            assert out[nt].shape == (td.graph.num_nodes(nt), 8)
            np.testing.assert_allclose(out[nt].numpy(), np.asarray(ref[nt]), rtol=2e-5,
                                       atol=2e-6)
    assert model.training  # the caller's mode comes back


def test_capped_rows_are_read_whole():
    """On a graph whose padded rows a ``max_fanout`` cap of 8 cut, JAX's
    sharded pass reads the capped rows and misses its own
    single-device embeddings by far; the port's reads every in-edge and
    meets them within JAX's tolerance."""
    kw = dict(num_users=60, num_items=28, num_groups=4, interactions_per_user=6,
              with_clicks=True, seed=9, max_fanout=8)
    jd, td = jmake(**kw), make_synthetic_data(**kw)
    assert any(int(rel.deg.sum()) < rel.num_edges for rel in td.graph.rels.values())
    mkw = dict(canonical_etypes=jd.graph.canonical_etypes,
               dims=(("user", 8), ("item", 8), ("hidden", 16), ("out", 8)),
               n_layers=3, aggregator_type="mean_nn", pred="cos")
    jm = JConvModel(**mkw)
    jfeats = {nt: jd.graph.ndata[nt]["features"] for nt in jd.graph.ntypes}
    params = init_model(jm, jd.graph, jfeats, seed=0)
    ref = jinfer(jm, params, jd.graph, jfeats)
    jsh = jinfer(jm, params, jd.graph, jfeats, mesh=jmake_mesh(8, data_axis=2))
    assert max(float(np.abs(np.asarray(jsh[nt]) - np.asarray(ref[nt])).max())
               for nt in ("user", "item")) > 0.1
    model = ConvModel(**mkw)
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    feats = {nt: td.graph.ndata[nt]["features"] for nt in td.graph.ntypes}
    out = infer_embeddings_sharded(model, td.graph, feats, make_mesh(8, devices=CPU8),
                                   node_chunk=16)
    for nt in ("user", "item"):
        np.testing.assert_allclose(out[nt].numpy(), np.asarray(ref[nt]), rtol=2e-5, atol=2e-6)


@pytest.mark.parametrize("boost", [False, True])
def test_get_metrics_at_k_mesh_equals_single(meshes, boost):
    _, mesh = meshes
    ue, ie, _, _, pop = _embs()
    rng = np.random.default_rng(13)
    gt = (rng.integers(0, 96, 50).astype(np.int32), rng.integers(0, 201, 50).astype(np.int32))
    bought = (rng.integers(0, 96, 200).astype(np.int32),
              rng.integers(0, 201, 200).astype(np.int32))
    kw = dict(popularity=pop if boost else None, weight_popularity=0.1)
    ref = jmetrics(jnp.asarray(ue), jnp.asarray(ie), gt, bought, K, backend="xla",
                   **{**kw, "popularity": jnp.asarray(pop) if boost else None})
    single = get_metrics_at_k(ue, ie, gt, bought, K, device="cpu", **kw)
    assert single == pytest.approx(ref, rel=1e-6)
    for backend in ("auto", "cuda", "torch"):
        assert get_metrics_at_k(ue, ie, gt, bought, K, mesh=mesh, backend=backend,
                                **kw) == single


@pytest.fixture(scope="module")
def port_run(tmp_path_factory):
    """A saved port run: 200 users, 100 items, popularity, seeded weights."""
    data = make_synthetic_data(num_users=200, num_items=100, seed=7)
    g = data.graph
    pop = np.random.default_rng(7).uniform(0, 0.05, 100).astype(np.float32)
    g.ndata["item"]["popularity"] = torch.from_numpy(pop)[:, None]
    kw = dict(canonical_etypes=g.canonical_etypes,
              dims=(("user", 8), ("item", 8), ("hidden", 32), ("out", 16)), n_layers=3,
              aggregator_type="mean_nn", pred="cos")
    model = ConvModel(**kw, generator=torch.Generator().manual_seed(3))
    run_dir = str(tmp_path_factory.mktemp("port_run"))
    save_run(run_dir, model.state_dict(),
             dict(kw, canonical_etypes=[list(e) for e in kw["canonical_etypes"]],
                  dims=[list(d) for d in kw["dims"]], norm=True, dropout=0.0),
             hyper_params=HyperParams(), graph=g)
    return run_dir


@pytest.mark.parametrize("use_popularity", [False, True])
def test_inference_ondemand_mesh_equals_single_device(meshes, port_run, use_popularity):
    _, mesh = meshes
    kw = dict(k=7, use_popularity=use_popularity, device="cpu")
    ref = inference_ondemand(port_run, "all", **kw)
    assert inference_ondemand(port_run, "all", mesh=mesh, **kw) == ref
    with pytest.raises(ValueError, match="mesh's devices"):
        inference_ondemand(port_run, [0], mesh=mesh, device="cuda")


def test_main_inference_mesh_flag(port_run):
    def run(*extra):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            recs = main_inference.main(["--run-dir", port_run, "--user-ids", "3",
                                        "--user-ids", "17", "--all", "--device", "cpu", *extra])
        return recs, buf.getvalue()

    single = run()
    assert run("--mesh", "2") == single and run("--mesh", "0") == single
    assert len(single[0]) == 200


def test_make_mesh_axes_match_jax():
    for n in (1, 2, 3, 4, 8):
        want = dict(jmake_mesh(n).shape)
        assert dict(make_mesh(n, devices=CPU8).shape) == want, n
        assert dict(make_mesh(n, axis_names=("data",), devices=CPU8).shape) == dict(
            jmake_mesh(n, axis_names=("data",)).shape)
    assert dict(make_mesh(8, data_axis=2, devices=CPU8).shape) == {"data": 2, "model": 4}
    with pytest.raises(ValueError, match="does not divide"):
        make_mesh(8, data_axis=3, devices=CPU8)


def test_make_mesh_refuses_more_devices_than_exist(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    mesh = make_mesh(2)
    assert [str(d) for d in mesh.devices.flat] == ["cuda:0", "cuda:1"]
    assert dict(mesh.shape) == {"data": 1, "model": 2}
    with pytest.raises(ValueError, match="3 devices, but there are 2"):
        make_mesh(3)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(ValueError, match="visible CUDA devices"):
        make_mesh()
    with pytest.raises(ValueError, match="devices given"):
        make_mesh(9, devices=CPU8)


def test_shard_batch_and_replicate_match_jax_placement(meshes):
    """Each mesh entry holds the block JAX's ``shard_batch`` puts on the
    device at the same place in its mesh."""
    jmesh, mesh = meshes
    x = np.arange(48, dtype=np.float32).reshape(8, 6)
    for axis in ("data", "model", ("data", "model")):
        jx = jshard_batch(jmesh, {"x": jnp.asarray(x)}, axis=axis)["x"]
        by_device = {s.device: np.asarray(s.data) for s in jx.addressable_shards}
        want = [by_device[d] for d in jmesh.devices.flat]
        got = shard_batch(mesh, {"x": torch.from_numpy(x)}, axis=axis)
        assert len(got) == 8
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g["x"].numpy(), w)
    reps = replicate(mesh, [torch.from_numpy(x)])
    assert len(reps) == 8 and all(r[0] is reps[0][0] for r in reps)
    with pytest.raises(ValueError, match="does not split"):
        shard_batch(mesh, torch.zeros(3, 2), axis="model")
