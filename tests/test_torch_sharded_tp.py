"""The port's ('data', 'model') step with sharded adjacency and with the
tensor-parallel leaf, against the JAX package (the world, draws and
tolerances of ``tests/test_torch_sharded_train.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnn_recsys_tpu.parallel import sharded as js
from gnn_recsys_tpu.parallel.mesh import make_mesh as jmake_mesh
from gnn_recsys_tpu.train import minibatch as jmb
from gnn_recsys_tpu_torch.ops.sampling import ReplayDraws
from gnn_recsys_tpu_torch.parallel import sharded as ts
from gnn_recsys_tpu_torch.train import minibatch as tmb
from test_torch_minibatch import _record_draws, one_torch_thread  # noqa: F401 (autouse)
from test_torch_sharded_train import (
    DATA,
    ETYPES,
    STEP_TOL,
    World,
    _assert_step,
    _cfg,
    _replays,
    _tmesh,
    check_tp_case,
)


@pytest.fixture(scope="module")
def world():
    return World()


@pytest.fixture(scope="module")
def recorded(world):
    """The draws depend on the graph, the batch and the key, not the model:
    the wide world below samples the same trees."""
    return world.shard_draws(_cfg(), jax.random.PRNGKey(3))


@pytest.fixture(scope="module")
def port_dp(world, recorded):
    tm, state = world.port()
    step = ts.make_shardmap_dp_step(tm, tmb.MinibatchConfig(**_cfg()), ETYPES, _tmesh())
    _, loss = step(state, world.tg, world.tfeats, world.tbatch, world.ttables,
                   _replays(recorded))
    return loss, tm


@pytest.mark.parametrize("case", ["graph_sharded", "graph_sharded_capacity"])
def test_graph_sharded_tp_dp_step_matches_dp_step_and_jax(monkeypatch, world, recorded, port_dp,
                                                          case):
    """Every relation's adjacency split over 'model' (the graph stripped),
    without and with a bucket capacity: the dp step on the same draws, and
    JAX's step; no id lost in either exchange.  The port builds each
    etype's shard-local exclusion table once a forward, where JAX builds
    one at every expansion (``ADVICE.md`` item 4, ``sharded.py:368-376``)."""
    builds = {"port": 0, "jax": 0}

    def counted(fn, key):
        def wrapper(*a, **k):
            builds[key] += 1
            return fn(*a, **k)
        return wrapper

    monkeypatch.setattr(ts, "exclusion_table_sharded", counted(ts.exclusion_table_sharded, "port"))
    monkeypatch.setattr(js, "exclusion_table_sharded", counted(js.exclusion_table_sharded, "jax"))
    check_tp_case(world, recorded, port_dp, case)
    # One table a (data shard, model shard, excluded etype): the two training
    # etypes and their reverses; JAX traces its shard program once, one build
    # an expansion (16 a device here).
    assert builds["port"] == DATA * 2 * 4
    assert builds["jax"] > 4


def test_lookup_transform_is_declared_not_inferred(monkeypatch):
    """``ADVICE.md`` item 2 (JAX ``conv_model.py:53-68``): JAX hands a
    ``feature_lookup`` that takes three arguments the leaf's row map and uses
    what it returns, so a hook that ignores the map silently skips the leaf's
    embed when the feature width equals the hidden width.  The port passes
    the map only for the node types the hook declares (``transform_ntypes``):
    the same hook leaves the forward unchanged."""
    dims = (("user", 16), ("item", 16), ("hidden", 16), ("out", 8))
    w = World(agg="mean_nn", dims=dims, feat_dim=16)
    seeds = {"user": np.arange(8, dtype=np.int32), "item": np.arange(8, dtype=np.int32)}
    key = jax.random.PRNGKey(1)

    def jhook(nt, ids, row_transform=None):  # takes the map and ignores it
        return jnp.take(w.jfeats[nt], ids, axis=0)

    with monkeypatch.context() as mp:
        uniforms, _ = _record_draws(mp)
        plain = w.jm.apply(w.params, w.jg, w.jfeats, {k: jnp.asarray(v) for k, v in seeds.items()},
                           (4, 4), key, method=w.jm.sampled_repr)
    hooked = w.jm.apply(w.params, w.jg, w.jfeats, {k: jnp.asarray(v) for k, v in seeds.items()},
                        (4, 4), key, feature_lookup=jhook, method=w.jm.sampled_repr)
    jgap = max(float(np.abs(np.asarray(hooked[nt]) - np.asarray(plain[nt])).max()) for nt in seeds)
    assert jgap > 1e-2

    def thook(nt, ids, row_transform=None):
        return w.tfeats[nt][ids.long()]

    tm, _ = w.port()
    tm.eval()
    tseeds = {k: torch.from_numpy(v) for k, v in seeds.items()}
    tplain = tm.sampled_repr(w.tg, w.tfeats, tseeds, (4, 4), ReplayDraws(uniforms))
    thooked = tm.sampled_repr(w.tg, w.tfeats, tseeds, (4, 4), ReplayDraws(uniforms),
                              feature_lookup=thook)
    for nt in seeds:
        np.testing.assert_array_equal(thooked[nt].detach().numpy(), tplain[nt].detach().numpy())
        np.testing.assert_allclose(tplain[nt].detach().numpy(), np.asarray(plain[nt]), rtol=0,
                                   atol=1e-5)


@pytest.fixture(scope="module")
def wide():
    """test_multichip.py:695-756: feat_dim 64, hidden 8, mean_nn."""
    return World(agg="mean_nn", dims=(("user", 64), ("item", 64), ("hidden", 8), ("out", 8)),
                 feat_dim=64)


@pytest.mark.parametrize("tp_transform", [True, False])
def test_tp_transform_matches_jax_and_narrows_the_exchange(wide, recorded, tp_transform):
    """The leaf's per-row map applied by the lookup for the row-sharded items
    (at the requester, before the reassembly), or by the model after it: the
    same step as JAX's, and the reassembly rides at hidden width (8) instead
    of the feature width (64) with the transform on."""
    tm, state = wide.port()
    step = ts.make_shardmap_tp_dp_step(tm, tmb.MinibatchConfig(**_cfg()), ETYPES, _tmesh(),
                                       row_shard_ntypes=("item",), tp_transform=tp_transform)
    _, loss = step(state, wide.tg, wide.tfeats, wide.tbatch, wide.ttables, _replays(recorded))
    jstep = js.make_shardmap_tp_dp_step(wide.jm, jmb.MinibatchConfig(**_cfg()), ETYPES,
                                        jmake_mesh(8, data_axis=DATA),
                                        row_shard_ntypes=("item",), tp_transform=tp_transform)
    jst, jloss = jstep(wide.jstate(), wide.jg, wide.jfeats, wide.jbatch, wide.jtables,
                       jax.random.PRNGKey(3))
    _assert_step(loss, tm, jloss, jst.params, STEP_TOL)
    width = step.exchange_bytes["reassembly_bytes"]
    tm2, state2 = wide.port()
    other = ts.make_shardmap_tp_dp_step(tm2, tmb.MinibatchConfig(**_cfg()), ETYPES, _tmesh(),
                                        row_shard_ntypes=("item",),
                                        tp_transform=not tp_transform)
    other(state2, wide.tg, wide.tfeats, wide.tbatch, wide.ttables, _replays(recorded))
    on, off = (width, other.exchange_bytes["reassembly_bytes"])[::1 if tp_transform else -1]
    assert on < off and on <= 0.5 * off


