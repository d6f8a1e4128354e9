"""The port's device epochs (``train/minibatch.py:make_epoch_fns``) against
the JAX package's ``make_epoch_fns`` and against the port's own host loop,
and the launch accounting of a captured step.

JAX's epoch runs under ``jax.disable_jit()``, where ``lax.scan`` calls its
body in Python on concrete values, so the draw recorder of
``tests/test_torch_minibatch.py`` sees every step's ``uniform`` / ``randint``
draws; JAX's permutation and those draws go into the port's ``chunk_fn`` on
the CPU, where the same body runs eagerly that a CUDA graph captures on the
card.  Each step's loss must agree within ``LOSS_RTOL`` and its gradients
within the step tests' tolerances; the parameters after the last update
within the Adam tolerance of one step summed over the steps (an element moves
by about lr * sign(g) where its gradient is near zero, so two f32 runs can
part by up to 2 * lr there at each update)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from test_torch_minibatch import (  # noqa: F401 (one_torch_thread: autouse)
    GRAD_ATOL,
    GRAD_RTOL,
    LOSS_RTOL,
    LR,
    _pair,
    _record_draws,
    one_torch_thread,
)

from gnn_recsys_tpu.ops.membership import build_padded_pair_set as jbuild_pairs
from gnn_recsys_tpu.train import full_batch as jfb
from gnn_recsys_tpu.train import minibatch as jmb
from gnn_recsys_tpu_torch.models.conv_model import ConvModel
from gnn_recsys_tpu_torch.models.convert import params_from_jax
from gnn_recsys_tpu_torch.models.layers import MaskedLSTMReducer
from gnn_recsys_tpu_torch.ops.cuda import build
from gnn_recsys_tpu_torch.ops.cuda import gather_mean as gm
from gnn_recsys_tpu_torch.ops.cuda import leaf_agg as la
from gnn_recsys_tpu_torch.ops.cuda import lstm_cell as lc
from gnn_recsys_tpu_torch.ops.cuda import pool_mask as pm
from gnn_recsys_tpu_torch.ops.cuda import pred_tower as pt
from gnn_recsys_tpu_torch.ops.cuda import topk_mips as tm
from gnn_recsys_tpu_torch.ops.membership import PaddedPairSet, build_padded_pair_set
from gnn_recsys_tpu_torch.ops.sampling import Draws, ReplayDraws
from gnn_recsys_tpu_torch.train import full_batch as tfb
from gnn_recsys_tpu_torch.train import graph_step
from gnn_recsys_tpu_torch.train import minibatch as tmb
from gnn_recsys_tpu_torch.utils import profiling
from gnn_recsys_tpu_torch.utils.synthetic import make_synthetic_data

ET_BUYS = ("user", "buys", "item")
ET_CLICKS = ("user", "clicks", "item")
STEPS = 2


def epoch_cfg(neg_mode, loss="max_margin", use_recency=False, dedup=False) -> dict:
    """A tiny bench-like config: 48 edges a batch, fanouts (4, 3), a pool of 24."""
    return dict(edge_batch_size=48, fanouts=(4, 3), neg_mode=neg_mode, neg_pool_size=24,
                neg_sample_size=24 if neg_mode == "dense_pool" else 4, loss=loss,
                use_recency=use_recency, dedup=dedup, lr=LR)


def check_epoch_body_against_jax(monkeypatch, cfg_kw, with_exclusion=True):
    """``STEPS`` steps of one epoch chunk from the same parameters,
    permutation and draws (batch slicing, negatives, exclusion, the
    false-negative mask, the loss, Adam): JAX's ``make_epoch_fns`` under
    ``disable_jit`` against the port's eager body.  Each step's loss within
    ``LOSS_RTOL``; the first step's gradients (both from the same
    parameters) within ``GRAD_RTOL`` / ``GRAD_ATOL``; the parameters after
    each update within the summed Adam tolerance."""
    jd, td, jm, tm, jfeats, tfeats, params = _pair("mean_nn")
    etypes = tuple(jd.train_pairs)
    has_reverse = {et: True for et in etypes}
    counts = {et: jd.graph.num_edges(et) for et in etypes}
    jstore = {et: (jd.graph.rels[et].src, jd.graph.rels[et].dst,
                   jd.graph.rels[et].edata["recency"]) for et in etypes}
    jtables = {et: jbuild_pairs(u, i, num_src=40) for et, (u, i) in jd.train_pairs.items()}
    ttables = {et: build_padded_pair_set(u, i, num_src=40)
               for et, (u, i) in td.train_pairs.items()}

    jsteps = []  # per update: (gradients, parameters after it)
    orig_apply = jfb.TrainState.apply_gradients

    def apply_gradients(self, **kw):
        new = orig_apply(self, **kw)
        jsteps.append(tuple(params_from_jax(jax.tree.map(np.asarray, t))
                            for t in (kw["grads"], new.params)))
        return new

    monkeypatch.setattr(jfb.TrainState, "apply_gradients", apply_gradients)
    jstate = jfb.TrainState.create(apply_fn=jm.apply, params=params, tx=optax.adam(LR))
    with jax.disable_jit():
        perm_fn, chunk_fn = jmb.make_epoch_fns(jm, jmb.MinibatchConfig(**cfg_kw), etypes, True,
                                               with_exclusion, has_reverse, counts)
        jperms = perm_fn({et: jnp.arange(counts[et], dtype=jnp.int32) for et in etypes},
                         jax.random.PRNGKey(3))
        uniforms, randints = _record_draws(monkeypatch)
        _, jlosses = chunk_fn(jstate, jd.graph, jfeats, jtables, jstore, jperms, jnp.int32(0),
                              jax.random.PRNGKey(4), n_steps=STEPS)
    assert len(jsteps) == STEPS

    state = tfb.TrainState.create(tm, lr=LR)
    _, tchunk_fn = tmb.make_epoch_fns(tm, tmb.MinibatchConfig(**cfg_kw), etypes, True,
                                      with_exclusion, has_reverse, counts)
    store = tmb.device_edge_store(td.graph, etypes, "cpu")
    perms = {et: torch.from_numpy(np.array(jperms[et])).long() for et in etypes}
    draws = ReplayDraws(uniforms, randints)
    slack = {n: 0.0 for n, _ in tm.named_parameters()}
    for t, (jgrads, jparams) in enumerate(jsteps):  # one step a chunk
        _, tloss = tchunk_fn(state, td.graph, tfeats, ttables, store, perms, t, draws, n_steps=1)
        assert float(tloss[0]) == pytest.approx(float(jlosses[t]), rel=LOSS_RTOL), t
        for n, p in tm.named_parameters():
            jg = jgrads[n].numpy()
            if t == 0:
                g = p.grad.numpy() if p.grad is not None else np.zeros_like(jg)
                np.testing.assert_allclose(g, jg, rtol=GRAD_RTOL, atol=GRAD_ATOL, err_msg=n)
            slack[n] = slack[n] + np.where(np.abs(jg) > 1e-5, 2e-6, 2 * LR)
            gap = np.abs(p.detach().numpy() - jparams[n].numpy())
            assert (gap <= slack[n]).all(), (t, n, float((gap - slack[n]).max()))
    assert draws.exhausted and state.step == STEPS and tchunk_fn.captured is None


@pytest.mark.parametrize("neg_mode", ["dense_pool", "shared_pool"])
@pytest.mark.parametrize("dedup", [False, True])
def test_epoch_body_matches_jax(monkeypatch, neg_mode, dedup):
    check_epoch_body_against_jax(monkeypatch, epoch_cfg(neg_mode, dedup=dedup))


def _world():
    data = make_synthetic_data(num_users=40, num_items=30, num_groups=4,
                               interactions_per_user=5, test_per_user=1, feat_dim=8,
                               with_clicks=True, seed=2)
    g = data.graph
    model = ConvModel(g.canonical_etypes, (("user", 8), ("item", 8), ("hidden", 16), ("out", 8)),
                      n_layers=3, aggregator_type="mean_nn")
    return data, g, model, {nt: g.ndata[nt]["features"] for nt in g.ntypes}


@pytest.mark.parametrize("dedup,with_update", [(False, True), (True, True), (False, False)])
def test_epoch_body_matches_host_loop(dedup, with_update):
    """Given the host loop's own permutation and the same draws, the device
    epochs' body gives the host loop's losses and parameters bit for bit,
    in chunks of 2 and 1 steps."""
    data, g, model, feats = _world()
    etypes = tuple(data.train_pairs)
    eids = {et: np.arange(g.num_edges(et)) for et in etypes}
    cfg = tmb.MinibatchConfig(edge_batch_size=48, fanouts=(4, 3), neg_sample_size=5,
                              neg_pool_size=24, dedup=dedup, lr=3e-3)
    has_reverse = {et: True for et in etypes}
    tables = {et: build_padded_pair_set(u, i, num_src=g.num_nodes("user"))
              for et, (u, i) in data.train_pairs.items()}
    init = {k: v.clone() for k, v in model.state_dict().items()}

    batches = list(tmb.iter_edge_batches(np.random.default_rng(7), eids, cfg.edge_batch_size))
    host = tmb.EdgeStore(g, etypes)
    state = tfb.TrainState.create(model, lr=cfg.lr)
    step = tmb.make_minibatch_step(model, cfg, etypes, with_update, True, has_reverse)
    draws = Draws(torch.Generator().manual_seed(5))
    want = torch.stack([step(state, g, feats, host.batch(b, True, "cpu"), tables, draws)[1]
                        for b in batches[:3]])
    want_params = {k: v.clone() for k, v in model.state_dict().items()}

    model.load_state_dict(init)
    state = tfb.TrainState.create(model, lr=cfg.lr)
    rng = np.random.default_rng(7)
    perms = {et: torch.as_tensor(rng.permutation(eids[et])) for et in etypes}
    _, chunk_fn = tmb.make_epoch_fns(model, cfg, etypes, with_update, True, has_reverse,
                                     {et: len(v) for et, v in eids.items()})
    store = tmb.device_edge_store(g, etypes, "cpu")
    draws = Draws(torch.Generator().manual_seed(5))
    got = torch.cat([chunk_fn(state, g, feats, tables, store, perms, t0, draws, n_steps=n)[1]
                     for t0, n in ((0, 2), (2, 1))])
    assert torch.equal(got, want)
    for k, v in model.state_dict().items():
        assert torch.equal(v, want_params[k]), k
    assert state.step == (3 if with_update else 0)


def test_run_device_epoch_chunks_visit_one_permutation():
    """Chunks of any length visit the batches of one unchunked epoch: the
    permutation is drawn once, then the steps draw in order."""
    data, g, model, feats = _world()
    etypes = tuple(data.train_pairs)
    eids = {et: torch.arange(g.num_edges(et)) for et in etypes}
    cfg = tmb.MinibatchConfig(edge_batch_size=48, fanouts=(4, 3), neg_sample_size=5,
                              neg_pool_size=24)
    tables = {et: build_padded_pair_set(u, i, num_src=g.num_nodes("user"))
              for et, (u, i) in data.train_pairs.items()}
    store = tmb.device_edge_store(g, etypes, "cpu")
    counts = {et: len(v) for et, v in eids.items()}
    fns = tmb.make_epoch_fns(model, cfg, etypes, False, True, {et: True for et in etypes}, counts)
    out = [tmb.run_device_epoch(*fns, None, g, feats, tables, store, eids, torch.Generator(),
                                seed=9, n_batches=5, chunk_steps=chunk)[1]
           for chunk in (16, 2, 1)]
    assert out[0].shape == (5,)
    assert torch.equal(out[0], out[1]) and torch.equal(out[0], out[2])


def test_device_epoch_matches_host_loop_learning():
    """The port of ``tests/test_minibatch.py:205-231``: both routes learn (the
    last epoch's loss under 0.9 of the first training epoch's) and land at
    comparable losses (other permutations and draws, the same regime)."""
    data = make_synthetic_data(num_users=100, num_items=50, num_groups=4,
                               interactions_per_user=8, test_per_user=3, feat_dim=8,
                               with_clicks=True, seed=0)
    g = data.graph
    feats = {nt: g.ndata[nt]["features"] for nt in g.ntypes}
    train_eids = {et: np.arange(g.num_edges(et)) for et in (ET_BUYS, ET_CLICKS)}
    finals = {}
    for dev_epoch in (True, False):
        model = ConvModel(g.canonical_etypes,
                          (("user", 8), ("item", 8), ("hidden", 32), ("out", 16)),
                          n_layers=3, aggregator_type="mean")
        cfg = tmb.MinibatchConfig(edge_batch_size=64, fanouts=(4, 3), neg_sample_size=8,
                                  neg_mode="shared_pool", neg_pool_size=32, lr=5e-3,
                                  num_epochs=6, metrics_every=0, patience=100,
                                  device_epoch=dev_epoch, epoch_chunk_steps=4)
        _, hist = tmb.train_minibatch(model, g, g, feats, train_eids, None, cfg, device="cpu")
        losses = hist["train_loss"]
        assert losses[-1] < losses[1] * 0.9, (dev_epoch, losses)
        finals[dev_epoch] = losses[-1]
    assert abs(finals[True] - finals[False]) < 0.5 * max(abs(finals[False]), 0.05)


class _Graph:
    """A CUDA graph's stand-in: counts its replays."""

    replays = 0

    def replay(self):
        self.replays += 1


def stub_step(**attrs) -> graph_step.CapturedStep:
    """A :class:`~gnn_recsys_tpu_torch.train.graph_step.CapturedStep` as a
    capture leaves it, with a stand-in graph and no training state."""
    step = graph_step.CapturedStep.__new__(graph_step.CapturedStep)
    step.graph, step.state = _Graph(), None
    for name, value in attrs.items():
        setattr(step, name, value)
    return step


def test_capture_launch_accounting(monkeypatch):
    """What a capture counted comes off every declared counter (it launched
    nothing) and each replay adds it back: a stand-in counter of neither a
    kernel nor the LSTM, a kernel wrapper's launches and the LSTM reducer's
    row slots alike, and no other counter moves."""
    monkeypatch.setattr(profiling, "DECLARED", dict(profiling.DECLARED))

    def stand_in():
        pass

    profiling.counter(stand_in, "calls")
    monkeypatch.setattr(gm.gather_mean_fwd, "launches", 5)
    monkeypatch.setattr(MaskedLSTMReducer, "row_slots", 3)
    stand_in.calls = 1
    before = profiling.counter_values()
    stand_in.calls += 4  # what the capture's Python calls counted
    gm.gather_mean_fwd.launches += 12
    MaskedLSTMReducer.row_slots += 1011712
    took = graph_step.take_counts(before)
    assert took == {f"{stand_in.__qualname__}.calls": 4, "gather_mean_fwd.launches": 12,
                    "MaskedLSTMReducer.row_slots": 1011712}
    assert profiling.counter_values() == before

    step = stub_step(counts=took)
    for _ in range(7):
        step.replay()
    assert step.graph.replays == 7
    after = profiling.counter_values()
    assert (stand_in.calls, gm.gather_mean_fwd.launches, MaskedLSTMReducer.row_slots) == (
        1 + 7 * 4, 5 + 7 * 12, 3 + 7 * 1011712)
    assert {n: v for n, v in after.items() if n not in took} == {
        n: v for n, v in before.items() if n not in took}


def test_capture_guards_hold_a_replay_to_its_capture():
    """A call must pass the objects and the generator that the capture read
    (each raises its message otherwise); a fresh fed tensor is copied into
    its buffer, which stays the graph's, and a buffer passed back as itself
    is left alone."""
    held, gen = (object(), {"features": 1}), torch.Generator()
    buffers = {"a": torch.zeros(3), "b": {"c": torch.zeros(2)}}
    a, c = buffers["a"], buffers["b"]["c"]
    step = stub_step(held=held, fed=buffers, generator=gen)
    with pytest.raises(ValueError, match="a captured step replays on the inputs it was "
                                         "captured with"):
        step.check((held[0], {"features": 1}), gen, buffers)
    with pytest.raises(ValueError, match="a captured step replays with the generator it was "
                                         "captured with"):
        step.check(held, torch.Generator(), buffers)
    fresh = torch.arange(3.0)
    step.check(held, gen, {"a": fresh, "b": {"c": c}})
    fresh.add_(1)
    assert step.fed["a"] is a and torch.equal(a, torch.arange(3.0))
    assert step.fed["b"]["c"] is c and torch.equal(c, torch.zeros(2))


def test_launch_counters_name_the_ten_wrappers(monkeypatch):
    """``build.launch_counters()`` reads the registry and names exactly the
    kernel wrappers of the package (thirteen, with the head's tower's two and
    its ranking's): a ``launches`` counter declared elsewhere is not one of
    them."""
    monkeypatch.setattr(profiling, "DECLARED", dict(profiling.DECLARED))

    def stand_in():
        pass

    profiling.counter(stand_in, "launches")
    fns = (la.leaf_mean_nn_fwd, la.leaf_mean_nn_bwd, pm.pool_membership_mask,
           gm.gather_mean_fwd, gm.gather_mean_bwd, tm.mips_topk, tm.mips_lse, tm.mips_boost,
           lc.lstm_cell_fwd, lc.lstm_cell_bwd, pt.pred_tower_fwd, pt.pred_tower_bwd,
           tm.mlp_topk)
    assert build.launch_counters() == {fn.__name__: fn for fn in fns}
    assert all(profiling.DECLARED[f"{fn.__name__}.launches"] == (fn, "launches") for fn in fns)


def test_warmup_restore_gives_a_first_update():
    """The parameters and Adam state after a capture's warm-up are put back:
    the next update is the one a fresh state makes, bit for bit."""
    torch.manual_seed(0)
    model = torch.nn.Linear(4, 3)
    init = {k: v.clone() for k, v in model.state_dict().items()}
    x = torch.randn(8, 4)

    def update(state):
        state.tx.zero_grad(set_to_none=True)
        model(x).square().sum().backward()
        state.apply_gradients()

    fresh = tfb.TrainState(model=model, tx=torch.optim.Adam(model.parameters(), lr=1e-2))
    update(fresh)
    want = {k: v.clone() for k, v in model.state_dict().items()}

    model.load_state_dict(init)
    state = tfb.TrainState(model=model, tx=torch.optim.Adam(model.parameters(), lr=1e-2))
    held = graph_step._snapshot(state)
    for _ in range(3):  # the warm-up
        update(state)
    graph_step._restore(state, held)
    assert all(torch.equal(v, init[k]) for k, v in model.state_dict().items())
    update(state)
    assert all(torch.equal(v, want[k]) for k, v in model.state_dict().items())


def test_captured_route_refuses_what_it_cannot_replay():
    """``capture=True`` draws from a generator on a CUDA device: replayed
    draws and CPU generators raise instead of falling back."""
    data, g, model, feats = _world()
    etypes = tuple(data.train_pairs)
    counts = {et: g.num_edges(et) for et in etypes}
    cfg = tmb.MinibatchConfig(edge_batch_size=48, fanouts=(4, 3), neg_pool_size=24)
    _, chunk_fn = tmb.make_epoch_fns(model, cfg, etypes, True, True, {et: True for et in etypes},
                                     counts, capture=True)
    tables = {et: PaddedPairSet(torch.full((g.num_nodes("user"), 1), -1, dtype=torch.int32),
                                g.num_nodes("user")) for et in etypes}
    store = tmb.device_edge_store(g, etypes, "cpu")
    perms = {et: torch.arange(n) for et, n in counts.items()}
    state = tfb.TrainState.create(model)
    with pytest.raises(ValueError, match="Draws"):
        chunk_fn(state, g, feats, tables, store, perms, 0, ReplayDraws([]), n_steps=1)
    with pytest.raises(ValueError, match="CUDA generator"):
        chunk_fn(state, g, feats, tables, store, perms, 0, Draws(torch.Generator()), n_steps=1)


def test_epoch_fns_are_freed_without_the_cycle_collector():
    """The epoch functions hold no reference cycle, so a captured step's
    graph and memory pool go as soon as the trainer drops them (a search
    trains model after model; the cycle collector may not run in between)."""
    import gc
    import weakref

    et = ("user", "buys", "item")
    model = ConvModel([et, ("item", "bought-by", "user")],
                      (("user", 8), ("item", 8), ("hidden", 16), ("out", 8)))
    enabled = gc.isenabled()
    gc.disable()
    try:
        perm_fn, chunk_fn = tmb.make_epoch_fns(model, tmb.MinibatchConfig(), (et,), True, True,
                                               {et: True}, {et: 100})
        refs = [weakref.ref(perm_fn), weakref.ref(chunk_fn)]
        del perm_fn, chunk_fn
        assert all(r() is None for r in refs)
    finally:
        if enabled:
            gc.enable()
