"""The port's tensor-parallel leaf, kernel flags, GSPMD step and
``train_minibatch(mesh=...)`` against the JAX package (the world, draws and
tolerances of ``tests/test_torch_sharded_train.py``): the kernel flags through
the dp step, the GSPMD step, and ``train_minibatch(mesh=...)``."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from gnn_recsys_tpu.parallel import sharded as js
from gnn_recsys_tpu.parallel.mesh import make_mesh as jmake_mesh
from gnn_recsys_tpu.train import minibatch as jmb
from gnn_recsys_tpu_torch.models.conv_model import ConvModel
from gnn_recsys_tpu_torch.ops.sampling import ReplayDraws
from gnn_recsys_tpu_torch.parallel import sharded as ts
from gnn_recsys_tpu_torch.train import minibatch as tmb
from test_torch_bf16 import _recording
from test_torch_minibatch import one_torch_thread  # noqa: F401 (autouse)
from test_torch_sharded_train import (
    DATA,
    ET,
    ETC,
    ETYPES,
    GSPMD_TOL,
    KERNEL_TOL,
    LR,
    World,
    _assert_same_step,
    _assert_step,
    _cfg,
    _replays,
    _tmesh,
)


@pytest.fixture(scope="module")
def world():
    return World()


def test_shardmap_kernel_flags_match_plain_and_jax():
    """test_multichip.py:409-455: the leaf and pool-mask kernels (their plain
    versions on CPU tensors) through the dp step equal the step without
    them, and JAX's step; the dense pool, mean_nn."""
    w = World(agg="mean_nn")
    cfg = _cfg(neg_mode="dense_pool", neg_sample_size=16)
    recorded = w.shard_draws(cfg, jax.random.PRNGKey(0))
    runs = []
    for kern in (False, True):
        tm, state = w.port(leaf_kernel=kern)
        step = ts.make_shardmap_dp_step(tm, tmb.MinibatchConfig(**cfg, pool_mask_kernel=kern),
                                        ETYPES, _tmesh())
        _, loss = step(state, w.tg, w.tfeats, w.tbatch, w.ttables, _replays(recorded))
        runs.append((loss, tm))
    _assert_same_step(runs[1], runs[0], KERNEL_TOL)
    jstep = js.make_shardmap_dp_step(w.jm, jmb.MinibatchConfig(**cfg), ETYPES,
                                     jmake_mesh(8, data_axis=DATA))
    jst, jloss = jstep(w.jstate(), w.jg, w.jfeats, w.jbatch, w.jtables, jax.random.PRNGKey(0))
    _assert_step(runs[1][0], runs[1][1], jloss, jst.params, KERNEL_TOL)


def test_gspmd_step_matches_single_device_jax(world):
    """The single-device step over the (4, 2) mesh, the item table split by
    rows over 'model': JAX's un-jitted single-device step from the same
    parameters and draws (JAX's slow test ties that step to its GSPMD form)."""
    cfg = _cfg()
    has_reverse = {et: True for et in ETYPES}
    uniforms, randints, patch = _recording()
    with patch:
        jstep = jmb.make_minibatch_step(world.jm, jmb.MinibatchConfig(**cfg), ETYPES,
                                        with_update=True, with_exclusion=True,
                                        has_reverse=has_reverse)
        jst, jloss = jstep(world.jstate(), world.jg, world.jfeats, world.jbatch, world.jtables,
                           jax.random.PRNGKey(7))
        jax.effects_barrier()
    mesh = _tmesh()
    for rows in (("item",), ()):
        tm, state = world.port()
        step = ts.make_gspmd_minibatch_step(tm, tmb.MinibatchConfig(**cfg), ETYPES, mesh)
        _, graph, feats, tables = ts.shard_inputs(mesh, state, world.tg, world.tfeats,
                                                  world.ttables, row_shard_ntypes=rows)
        assert isinstance(feats["item"], ts.RowBlocks) == bool(rows)
        draws = ReplayDraws(uniforms, randints)
        _, loss = step(state, graph, feats, world.tbatch, tables, draws)
        assert draws.exhausted
        _assert_step(loss, tm, jloss, jst.params, GSPMD_TOL)


def test_hooks_refuse_dedup(world):
    tm, _ = world.port()

    def lookup(nt, ids):
        return world.tfeats[nt][ids.long()]

    seeds = {"user": torch.arange(4)}
    with pytest.raises(ValueError, match="tree path only"):
        tm.sampled_repr(world.tg, world.tfeats, seeds, (4, 4), ReplayDraws([]), dedup=True,
                        feature_lookup=lookup)


def _aligned_batch_size(counts, extent):
    """An edge batch size whose per-etype slices already divide ``extent``,
    so that the mesh run and the run without a mesh take the same batches."""
    for bs in range(64, 200):
        per, _ = tmb._per_etype_batch_sizes(counts, bs)
        if all(n % extent == 0 for n in per.values()):
            return bs
    raise AssertionError("no aligned batch size")


@pytest.fixture(scope="module")
def mesh_runs(world):
    g, feats = world.tg, world.tfeats
    train_eids = {et: np.arange(g.num_edges(et)) for et in ETYPES}
    bs = _aligned_batch_size({et: len(v) for et, v in train_eids.items()}, DATA)
    cfg = tmb.MinibatchConfig(**{**_cfg(), "edge_batch_size": bs}, num_epochs=3,
                              metrics_every=0, patience=100, lr=LR)
    runs = {}
    for name, mesh, rows in (("none", None, ()), ("replicated", _tmesh(), ()),
                             ("row_sharded", _tmesh(), ("item",))):
        tm, _ = world.port()
        state, hist = tmb.train_minibatch(tm, g, g, feats, train_eids, None, cfg, device="cpu",
                                          mesh=mesh, row_shard_ntypes=rows)
        runs[name] = (hist, tm, state)
    return runs


@pytest.mark.parametrize("name", ["replicated", "row_sharded"])
def test_train_minibatch_mesh_equals_single_device(mesh_runs, name):
    """Device epochs over the (4, 2) mesh, the item table replicated or split
    by rows, equal the run without a mesh at the same batch sizes and draws."""
    hist, tm, state = mesh_runs[name]
    ref_hist, ref_tm, ref_state = mesh_runs["none"]
    assert state.step == ref_state.step > 0
    assert np.isfinite(hist["train_loss"]).all()
    assert hist["train_loss"][-1] < hist["train_loss"][0] * 1.5
    np.testing.assert_allclose(hist["train_loss"], ref_hist["train_loss"], rtol=1e-4, atol=1e-6)
    for (n, p), q in zip(tm.named_parameters(), ref_tm.parameters()):
        np.testing.assert_allclose(p.detach().numpy(), q.detach().numpy(), rtol=2e-4,
                                   atol=2e-5, err_msg=n)
    other = mesh_runs["row_sharded" if name == "replicated" else "replicated"]
    np.testing.assert_allclose(hist["train_loss"], other[0]["train_loss"], rtol=1e-4, atol=1e-6)


def test_train_minibatch_mesh_rounds_batches_and_refuses_kernels(world):
    g, feats = world.tg, world.tfeats
    eids = {et: np.arange(32) for et in ETYPES}
    cfg = tmb.MinibatchConfig(**_cfg(), num_epochs=1)
    tm = ConvModel(**{**world.kw, "aggregator_type": "mean_nn"}, leaf_kernel=True)
    with pytest.raises(ValueError, match="opaque to the auto-partitioner"):
        tmb.train_minibatch(tm, g, g, feats, eids, None, cfg, device="cpu", mesh=_tmesh())
    tm, _ = world.port()
    with pytest.raises(ValueError, match="opaque to the auto-partitioner"):
        tmb.train_minibatch(tm, g, g, feats, eids, None,
                            dataclasses.replace(cfg, pool_mask_kernel=True), device="cpu",
                            mesh=_tmesh())
    # 37 / 27 edges an etype at batch 64 round up to 40 / 28 on 4 data shards.
    counts = {ET: 300, ETC: 219}
    per, _ = tmb._per_etype_batch_sizes(counts, 64, round_to=DATA)
    want, _ = jmb._per_etype_batch_sizes(counts, 64, round_to=DATA)
    assert per == want and all(n % DATA == 0 for n in per.values())
