"""The port's multi-device training steps against the JAX package's
(``gnn_recsys_tpu/parallel/sharded.py``, ``train/minibatch.py``).

The world is JAX's ``tests/test_multichip.py:40-79``: 64 users, 32 items,
dims 8/8/16/8, fanouts (4, 4), 32 edges an etype.  JAX runs on its 8
virtual CPU devices, the port on a mesh of 8 CPU entries.  A shard-map
step's draws are tracers, so each data shard ``i``'s draws are recorded
from JAX's un-jitted eval step (built as ``sharded.py:140-144`` builds it)
run on the shard's slice with ``jax.random.fold_in(key, i)``, and replayed
into the port's shard ``i``; the port is compared with JAX's jitted
``shard_map`` step.  Parameters cross through ``params_from_jax``.

Tolerances are JAX's at each site: the dp and tp-dp steps
(``test_multichip.py:345-375``) loss rtol 1e-6 / atol 1e-7, parameters
rtol 1e-5 / atol 1e-6; the kernel step (``:449-455``) loss rtol 1e-5 /
atol 1e-6, parameters rtol 2e-4 / atol 2e-5; the GSPMD step against the
single-device step (``:104-109``) loss rtol 1e-5, parameters rtol 2e-5 /
atol 2e-6; the mesh runs of ``train_minibatch`` (``:314-320``) losses rtol
1e-4 / atol 1e-6, parameters rtol 2e-4 / atol 2e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gnn_recsys_tpu.models.conv_model import ConvModel as JConvModel
from gnn_recsys_tpu.ops.membership import build_padded_pair_set as jbuild_pairs
from gnn_recsys_tpu.parallel import sharded as js
from gnn_recsys_tpu.parallel.mesh import make_mesh as jmake_mesh
from gnn_recsys_tpu.train import full_batch as jfb
from gnn_recsys_tpu.train import minibatch as jmb
from gnn_recsys_tpu.utils.synthetic import make_synthetic_data as jmake
from gnn_recsys_tpu_torch.models.conv_model import ConvModel
from gnn_recsys_tpu_torch.models.convert import params_from_jax
from gnn_recsys_tpu_torch.ops.membership import build_padded_pair_set
from gnn_recsys_tpu_torch.ops.sampling import ReplayDraws
from gnn_recsys_tpu_torch.parallel import sharded as ts
from gnn_recsys_tpu_torch.parallel.mesh import make_mesh
from gnn_recsys_tpu_torch.train import minibatch as tmb
from gnn_recsys_tpu_torch.train.full_batch import TrainState
from gnn_recsys_tpu_torch.utils.synthetic import make_synthetic_data
from test_torch_bf16 import _recording
from test_torch_minibatch import one_torch_thread  # noqa: F401 (autouse)

ET = ("user", "buys", "item")
ETC = ("user", "clicks", "item")
ETYPES = (ET, ETC)
WORLD = dict(num_users=64, num_items=32, num_groups=4, interactions_per_user=8,
             with_clicks=True, seed=5)
DIMS = (("user", 8), ("item", 8), ("hidden", 16), ("out", 8))
LR = 1e-2
DATA = 4  # the (4, 2) data x model mesh
STEP_TOL = dict(loss=(1e-6, 1e-7), params=(1e-5, 1e-6))
KERNEL_TOL = dict(loss=(1e-5, 1e-6), params=(2e-4, 2e-5))
GSPMD_TOL = dict(loss=(1e-5, 0.0), params=(2e-5, 2e-6))


def _cfg(**kw):
    base = dict(edge_batch_size=64, fanouts=(4, 4), neg_sample_size=8, neg_mode="shared_pool",
                neg_pool_size=16)
    base.update(kw)
    return base


class World:
    def __init__(self, agg="mean", dims=DIMS, feat_dim=None):
        self.jd, self.td = jmake(**WORLD), make_synthetic_data(**WORLD)
        jg, tg = self.jd.graph, self.td.graph
        self.jg, self.tg = jg, tg
        kw = dict(canonical_etypes=jg.canonical_etypes, dims=dims, n_layers=3,
                  aggregator_type=agg, pred="cos")
        self.jm = JConvModel(**kw)
        self.kw = kw
        if feat_dim is None:
            self.jfeats = {nt: jg.ndata[nt]["features"] for nt in jg.ntypes}
        else:  # the wide-feature world of test_multichip.py:695-729
            rng = np.random.default_rng(7)
            self.jfeats = {nt: jnp.asarray(rng.normal(size=(jg.num_nodes(nt), feat_dim)),
                                           jnp.float32) for nt in jg.ntypes}
        self.tfeats = {nt: torch.from_numpy(np.array(x)) for nt, x in self.jfeats.items()}
        self.params = jfb.init_model(self.jm, jg, self.jfeats, seed=0)
        self.jbatch, self.tbatch = {}, {}
        for et in ETYPES:
            src, dst = np.asarray(jg.rels[et].src)[:32], np.asarray(jg.rels[et].dst)[:32]
            self.jbatch[et] = {"u": jnp.asarray(src, jnp.int32), "i": jnp.asarray(dst, jnp.int32),
                               "recency": jnp.ones((32,), jnp.float32),
                               "eids": jnp.arange(32, dtype=jnp.int32)}
            self.tbatch[et] = {"u": torch.from_numpy(src.astype(np.int64)),
                               "i": torch.from_numpy(dst.astype(np.int64)),
                               "recency": torch.ones(32), "eids": torch.arange(32)}
        self.jtables = {et: jbuild_pairs(np.asarray(jg.rels[et].src), np.asarray(jg.rels[et].dst),
                                         num_src=jg.num_nodes("user")) for et in ETYPES}
        self.ttables = {et: build_padded_pair_set(tg.rels[et].src.numpy(),
                                                  tg.rels[et].dst.numpy(),
                                                  num_src=tg.num_nodes("user")) for et in ETYPES}

    def jstate(self):
        return jfb.TrainState.create(apply_fn=self.jm.apply,
                                     params=jax.tree.map(jnp.copy, self.params),
                                     tx=optax.adam(LR))

    def port(self, **kw):
        """The port's model with JAX's parameters, and its state."""
        tm = ConvModel(**{**self.kw, **kw})
        tm.load_state_dict(params_from_jax(jax.tree.map(np.asarray, self.params)))
        return tm, TrainState.create(tm, lr=LR)

    def shard_draws(self, cfg, key, shards=DATA):
        """Data shard ``i``'s draws: JAX's eval step on the shard's slice with
        ``fold_in(key, i)``, jitted once with its draws recorded in program
        order (``test_torch_bf16._recording``)."""
        uniforms, randints, patch = _recording()
        out = []
        with patch:
            step = jmb.make_minibatch_step(self.jm, jmb.MinibatchConfig(**cfg), ETYPES,
                                           with_update=False, with_exclusion=True,
                                           has_reverse={et: True for et in ETYPES})
            for i in range(shards):
                n = 32 // shards
                part = {et: {k: v[i * n:(i + 1) * n] for k, v in d.items()}
                        for et, d in self.jbatch.items()}
                step(self.jstate(), self.jg, self.jfeats, part, self.jtables,
                     jax.random.fold_in(key, i))[1].block_until_ready()
                jax.effects_barrier()
                out.append((list(uniforms), list(randints)))
                uniforms.clear()
                randints.clear()
        return out


def _replays(recorded):
    return [ReplayDraws(u, r) for u, r in recorded]


def _assert_step(tloss, tmodel, jloss, jparams, tol):
    """The port's step against JAX's: the loss, and the parameters after
    Adam's update within ``tol`` where the port's gradient exceeds 1e-5.  An
    element whose gradient is near zero moves by about lr * g / (|g| + eps)
    in each package, which two f32 programs that sum in other orders can
    put anywhere in [-lr, lr]: there within 2 * lr
    (``tests/test_torch_minibatch.py``)."""
    (lr_, la), (pr, pa) = tol["loss"], tol["params"]
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=lr_, atol=la)
    want = params_from_jax(jax.tree.map(np.asarray, jparams))
    for name, p in tmodel.named_parameters():
        got, ref = p.detach().numpy(), want[name].numpy()
        big = np.abs(p.grad.numpy()) > 1e-5
        np.testing.assert_allclose(got[big], ref[big], rtol=pr, atol=pa, err_msg=name)
        assert np.abs(got - ref).max(initial=0.0) <= 2 * LR, name


def _assert_same_step(a, b, tol):
    (loss_a, model_a), (loss_b, model_b) = a, b
    (lr_, la), (pr, pa) = tol["loss"], tol["params"]
    np.testing.assert_allclose(float(loss_a), float(loss_b), rtol=lr_, atol=la)
    for (name, p), q in zip(model_a.named_parameters(), model_b.parameters()):
        np.testing.assert_allclose(p.detach().numpy(), q.detach().numpy(), rtol=pr, atol=pa,
                                   err_msg=name)


def _tmesh():
    return make_mesh(8, data_axis=DATA, devices=["cpu"] * 8)


@pytest.fixture(scope="module")
def world():
    return World()


@pytest.fixture(scope="module")
def recorded(world):
    return world.shard_draws(_cfg(), jax.random.PRNGKey(3))


@pytest.fixture(scope="module")
def port_dp(world, recorded):
    """The port's dp step on the (4, 2) mesh: (loss, model after the update)."""
    tm, state = world.port()
    step = ts.make_shardmap_dp_step(tm, tmb.MinibatchConfig(**_cfg()), ETYPES, _tmesh())
    _, loss = step(state, world.tg, world.tfeats, world.tbatch, world.ttables,
                   _replays(recorded))
    assert state.step == 1
    return loss, tm


def test_dp_step_matches_jax(world, port_dp):
    jmesh = jmake_mesh(8, data_axis=DATA)
    jstep = js.make_shardmap_dp_step(world.jm, jmb.MinibatchConfig(**_cfg()), ETYPES, jmesh,
                                     axis="data")
    jst, jloss = jstep(world.jstate(), world.jg, world.jfeats, world.jbatch, world.jtables,
                       jax.random.PRNGKey(3))
    _assert_step(port_dp[0], port_dp[1], jloss, jst.params, STEP_TOL)


TP_CASES = {
    "contiguous": dict(),
    "capacity": dict(a2a_capacity_factor=2.0),
    "hash": dict(a2a_capacity_factor=4.0, hash=True),
    "graph_sharded": dict(graph_shard=True),
    "graph_sharded_capacity": dict(graph_shard=True, adj_capacity=64, a2a_capacity_factor=2.0),
}


def _tp_run(world, recorded, case, port: bool):
    kw = dict(TP_CASES[case])
    hashed = kw.pop("hash", False)
    graph_shard = kw.pop("graph_shard", False)
    adj_cap = kw.pop("adj_capacity", None)
    cfg = _cfg()
    if port:
        tm, state = world.port()
        feats, graph = dict(world.tfeats), world.tg
        if hashed:
            feats["item"], log = ts.hash_shard_table(feats["item"], 2)
            kw["hash_mix_logs"] = {"item": log}
        extra = ()
        if graph_shard:
            all_ets = graph.canonical_etypes
            extra = (ts.shard_adjacency(graph, all_ets, 2),)
            graph = ts.strip_adjacency(graph, all_ets)
            kw.update(graph_shard_etypes=all_ets, adj_capacity=adj_cap)
        step = ts.make_shardmap_tp_dp_step(tm, tmb.MinibatchConfig(**cfg), ETYPES, _tmesh(),
                                           row_shard_ntypes=("item",), **kw)
        out = step(state, graph, feats, world.tbatch, world.ttables, *extra, _replays(recorded))
        return out, tm, step
    feats, graph = dict(world.jfeats), world.jg
    if hashed:
        feats["item"], log = js.hash_shard_table(feats["item"], 2)
        kw["hash_mix_logs"] = {"item": log}
    extra = ()
    if graph_shard:
        all_ets = graph.canonical_etypes
        extra = (js.shard_adjacency(graph, all_ets, 2),)
        graph = js.strip_adjacency(graph, all_ets)
        kw.update(graph_shard_etypes=all_ets, adj_capacity=adj_cap)
    step = js.make_shardmap_tp_dp_step(world.jm, jmb.MinibatchConfig(**cfg), ETYPES,
                                       jmake_mesh(8, data_axis=DATA), row_shard_ntypes=("item",),
                                       **kw)
    return step(world.jstate(), graph, feats, world.jbatch, world.jtables, *extra,
                jax.random.PRNGKey(3))


@pytest.mark.parametrize("case", ["contiguous", "capacity", "hash"])
def test_tp_dp_step_matches_dp_step_and_jax(world, recorded, port_dp, case):
    """The ('data', 'model') step with the item table split over 'model'
    (contiguous, statistical capacity, hash-sharded) equals the dp step on
    the same draws, and JAX's tp-dp step."""
    check_tp_case(world, recorded, port_dp, case)


def check_tp_case(world, recorded, port_dp, case):
    out, tm, step = _tp_run(world, recorded, case, port=True)
    with_drops = "a2a_capacity_factor" in TP_CASES[case] or "adj_capacity" in TP_CASES[case]
    assert len(out) == (3 if with_drops else 2)
    if with_drops:
        assert int(out[2]) == 0
        assert int(step.drops["features"]) == int(step.drops["adjacency"]) == 0
    assert step.exchange_bytes["request_bytes"] > 0
    if "graph_shard" in TP_CASES[case]:
        assert step.exchange_bytes.get("response_bytes", 0) > 0
    _assert_same_step((out[1], tm), port_dp, STEP_TOL)
    jout = _tp_run(world, recorded, case, port=False)
    if len(jout) == 3 and "adj_capacity" not in TP_CASES[case]:
        assert int(jout[2]) == 0
    _assert_step(out[1], tm, jout[1], jout[0].params, STEP_TOL)
