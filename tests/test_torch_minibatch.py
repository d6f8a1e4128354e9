"""The port's sampled-tree forward, losses and training step against the JAX
package.  JAX's random draws are recorded (``jax.random.uniform`` and
``randint`` patched while an un-jitted step runs) and replayed into the port
through :class:`ReplayDraws`; parameters go through ``params_from_jax``.

Tolerances: representations within 1e-5 (f32, sums in another order); the
loss within 1e-5 relative; gradients within 1e-4 relative + 1e-6 absolute.
After one Adam step an element whose gradient is near zero moves by about
lr * sign(g), so two f32 implementations can differ there by up to 2 * lr
(``tests/test_pool_mask.py:106-111``): updated parameters are compared
within 2e-6 where |g| > 1e-5, and within 2 * lr elsewhere."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gnn_recsys_tpu.models.conv_model import ConvModel as JConvModel
from gnn_recsys_tpu.models.loss import max_margin_loss as jmax_margin
from gnn_recsys_tpu.models.loss import sampled_softmax_loss as jsoftmax
from gnn_recsys_tpu.ops.membership import build_padded_pair_set as jbuild_pairs
from gnn_recsys_tpu.train import full_batch as jfb
from gnn_recsys_tpu.train import minibatch as jmb
from gnn_recsys_tpu.utils.synthetic import make_synthetic_data as jmake
from gnn_recsys_tpu_torch.models.conv_model import ConvModel
from gnn_recsys_tpu_torch.models.convert import params_from_jax
from gnn_recsys_tpu_torch.models.loss import max_margin_loss, sampled_softmax_loss
from gnn_recsys_tpu_torch.ops.membership import build_padded_pair_set
from gnn_recsys_tpu_torch.ops.sampling import Draws, ReplayDraws
from gnn_recsys_tpu_torch.retrieval.metrics import recs_to_metrics
from gnn_recsys_tpu_torch.retrieval.recs import get_recs
from gnn_recsys_tpu_torch.train import minibatch as tmb
from gnn_recsys_tpu_torch.train.full_batch import TrainState, compute_embeddings
from gnn_recsys_tpu_torch.utils.synthetic import make_synthetic_data

REPR_TOL = 1e-5
LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6
LR = 1e-3
ET_BUYS = ("user", "buys", "item")
ET_CLICKS = ("user", "clicks", "item")
DATA_KW = dict(num_users=40, num_items=30, num_groups=4, interactions_per_user=5,
               test_per_user=1, feat_dim=8, with_clicks=True, seed=2)


def _pair(agg, leaf_kernel=False):
    """The same graph, model and parameters in both packages."""
    jd, td = jmake(**DATA_KW), make_synthetic_data(**DATA_KW)
    kw = dict(canonical_etypes=jd.graph.canonical_etypes,
              dims=(("user", 8), ("item", 8), ("hidden", 16), ("out", 8)),
              n_layers=3, aggregator_type=agg, leaf_kernel=leaf_kernel)
    jm, tm = JConvModel(**kw), ConvModel(**kw)
    jfeats = {nt: jd.graph.ndata[nt]["features"] for nt in jd.graph.ntypes}
    tfeats = {nt: td.graph.ndata[nt]["features"] for nt in td.graph.ntypes}
    params = jfb.init_model(jm, jd.graph, jfeats, seed=0)
    tm.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    return jd, td, jm, tm, jfeats, tfeats, params


def _record_draws(monkeypatch):
    """Record every concrete jax.random.uniform / randint result from now on
    (flax's shape checks trace parameter initialisers: those are skipped)."""
    uniforms, randints = [], []
    orig_u, orig_r = jax.random.uniform, jax.random.randint

    def recorder(orig, into):
        def draw(*a, **k):
            out = orig(*a, **k)
            if not isinstance(out, jax.core.Tracer):
                into.append(np.array(out))
            return out
        return draw

    uniform, randint = recorder(orig_u, uniforms), recorder(orig_r, randints)

    monkeypatch.setattr(jax.random, "uniform", uniform)
    monkeypatch.setattr(jax.random, "randint", randint)
    return uniforms, randints


@pytest.mark.parametrize("agg,leaf_kernel,fanouts", [
    ("mean_nn", True, (4, 3)),
    ("mean_nn", False, (4, 3)),
    ("mean_nn", True, (-1, 3)),
    ("mean", False, (3, 2)),
    ("pool_nn_edge", False, (2, 3)),
    ("mean_edge", False, (3, -1)),
])
def test_sampled_repr_matches_jax(monkeypatch, agg, leaf_kernel, fanouts):
    jd, td, jm, tm, jfeats, tfeats, params = _pair(agg, leaf_kernel)
    seeds = {"user": np.arange(12, dtype=np.int32),
             "item": np.arange(10, dtype=np.int32).reshape(5, 2)}
    excl = {ET_BUYS: np.arange(6, dtype=np.int32),
            ("item", "bought-by", "user"): np.arange(6, dtype=np.int32)}
    uniforms, _ = _record_draws(monkeypatch)
    jout = jm.apply(params, jd.graph, jfeats, {k: jnp.asarray(v) for k, v in seeds.items()},
                    fanouts, jax.random.PRNGKey(7),
                    exclude_eids={k: jnp.asarray(v) for k, v in excl.items()},
                    method=jm.sampled_repr)
    assert len(uniforms) > 0 or -1 in fanouts
    tm.eval()
    draws = ReplayDraws(uniforms)
    tout = tm.sampled_repr(td.graph, tfeats, {k: torch.as_tensor(v) for k, v in seeds.items()},
                           fanouts, draws,
                           exclude_eids={k: torch.as_tensor(v) for k, v in excl.items()})
    assert draws.exhausted
    for nt in seeds:
        assert tuple(tout[nt].shape) == jout[nt].shape
        np.testing.assert_allclose(tout[nt].detach().numpy(), np.asarray(jout[nt]),
                                   rtol=0, atol=REPR_TOL)


def _scores(seed=0, b=6, s=5):
    rng = np.random.default_rng(seed)
    pos = {et: rng.uniform(-1, 1, b).astype(np.float32) for et in (ET_BUYS, ET_CLICKS)}
    neg = {et: rng.uniform(-1, 1, (b, s)).astype(np.float32) for et in pos}
    mask = {et: (rng.random((b, s)) < 0.2).astype(np.float32) for et in pos}
    rec = {et: rng.integers(1, 30, b).astype(np.float32) for et in pos}
    valid = {et: rng.random(b) < 0.8 for et in pos}
    return pos, neg, mask, rec, valid


@pytest.mark.parametrize("loss", ["max_margin", "sampled_softmax"])
@pytest.mark.parametrize("options", [(), ("mask",), ("mask", "recency", "pair_mask")])
def test_losses_match_jax(loss, options):
    pos, neg, mask, rec, valid = _scores()
    kw = {}
    if "mask" in options:
        kw["negative_mask"] = mask
    if "recency" in options:
        kw["recency_scores"] = rec
    if "pair_mask" in options:
        kw["pair_mask"] = valid

    def both(tree_fn):
        return {name: {et: tree_fn(a) for et, a in d.items()} for name, d in kw.items()}

    jkw, tkw = both(jnp.asarray), both(torch.as_tensor)
    jpos, jneg = ({et: jnp.asarray(a) for et, a in d.items()} for d in (pos, neg))
    tpos, tneg = ({et: torch.as_tensor(a) for et, a in d.items()} for d in (pos, neg))
    if loss == "max_margin":
        want = float(jmax_margin(jpos, jneg, delta=0.266, **jkw))
        got = float(max_margin_loss(tpos, tneg, delta=0.266, **tkw))
    else:
        want = float(jsoftmax(jpos, jneg, tau=0.1, **jkw))
        got = float(sampled_softmax_loss(tpos, tneg, tau=0.1, **tkw))
    assert got == pytest.approx(want, rel=LOSS_RTOL)


def _batch(train_pairs, n=16):
    jbatch, tbatch = {}, {}
    for et, (u, i) in train_pairs.items():
        jbatch[et] = {"u": jnp.asarray(u[:n], jnp.int32), "i": jnp.asarray(i[:n], jnp.int32),
                      "recency": jnp.ones((n,), jnp.float32),
                      "eids": jnp.arange(n, dtype=jnp.int32)}
        tbatch[et] = {"u": torch.as_tensor(u[:n]).long(), "i": torch.as_tensor(i[:n]).long(),
                      "recency": torch.ones(n), "eids": torch.arange(n)}
    return jbatch, tbatch


@pytest.mark.parametrize("kernels", [False, True])
def test_dense_pool_step_matches_jax(monkeypatch, kernels):
    """One full training step (dense pool, batch-edge exclusion, false-negative
    mask, max-margin loss, Adam) from the same parameters, pool and draws."""
    jd, td, jm, tm, jfeats, tfeats, params = _pair("mean_nn", leaf_kernel=kernels)
    etypes = tuple(jd.train_pairs)
    has_reverse = {et: True for et in etypes}
    cfg_kw = dict(edge_batch_size=32, fanouts=(3, 3), neg_mode="dense_pool",
                  neg_pool_size=24, neg_sample_size=24, pool_mask_kernel=kernels)
    jbatch, tbatch = _batch(jd.train_pairs)
    jtables = {et: jbuild_pairs(u, i, num_src=40) for et, (u, i) in jd.train_pairs.items()}
    ttables = {et: build_padded_pair_set(u, i, num_src=40)
               for et, (u, i) in td.train_pairs.items()}

    captured = {}
    orig_apply = jfb.TrainState.apply_gradients

    def apply_gradients(self, *, grads, **kw):
        captured["grads"] = grads
        return orig_apply(self, grads=grads, **kw)

    monkeypatch.setattr(jfb.TrainState, "apply_gradients", apply_gradients)
    jstate = jfb.TrainState.create(apply_fn=jm.apply, params=params, tx=optax.adam(LR))
    jstep = jmb.make_minibatch_step(jm, jmb.MinibatchConfig(**cfg_kw), etypes, with_update=True,
                                    with_exclusion=True, has_reverse=has_reverse, jit=False)
    uniforms, randints = _record_draws(monkeypatch)
    jstate, jloss = jstep(jstate, jd.graph, jfeats, jbatch, jtables, jax.random.PRNGKey(5))

    state = TrainState.create(tm, lr=LR)
    tstep = tmb.make_minibatch_step(tm, tmb.MinibatchConfig(**cfg_kw), etypes, with_update=True,
                                    with_exclusion=True, has_reverse=has_reverse)
    draws = ReplayDraws(uniforms, randints)
    state, tloss = tstep(state, td.graph, tfeats, tbatch, ttables, draws)
    assert draws.exhausted and state.step == 1
    assert float(tloss) == pytest.approx(float(jloss), rel=LOSS_RTOL)

    jgrads = params_from_jax(jax.tree.map(np.asarray, captured["grads"]))
    jnew = params_from_jax(jax.tree.map(np.asarray, jstate.params))
    for name, p in tm.named_parameters():
        g = p.grad.numpy() if p.grad is not None else np.zeros(tuple(p.shape), np.float32)
        np.testing.assert_allclose(g, jgrads[name].numpy(), rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=name)
        big = np.abs(jgrads[name].numpy()) > 1e-5
        gap = np.abs(p.detach().numpy() - jnew[name].numpy())
        assert gap[big].max(initial=0.0) <= 2e-6, name
        assert gap.max(initial=0.0) <= 2 * LR, name


def test_cosine_schedule_matches_optax():
    tm = ConvModel([ET_BUYS, ("item", "bought-by", "user")],
                   (("user", 8), ("item", 8), ("hidden", 16), ("out", 8)))
    state = TrainState.create(tm, lr=3e-3, decay_steps=20)
    sched = optax.cosine_decay_schedule(3e-3, 20)
    for step in range(20):
        assert state.tx.param_groups[0]["lr"] == pytest.approx(float(sched(step)), rel=1e-5,
                                                               abs=1e-12)
        state.apply_gradients()


def test_iter_edge_batches_match_jax():
    eids = {ET_BUYS: np.arange(100), ET_CLICKS: np.arange(50)}
    jb = list(jmb.iter_edge_batches(np.random.default_rng(0), eids, batch_size=60, round_to=4))
    tb = list(tmb.iter_edge_batches(np.random.default_rng(0), eids, batch_size=60, round_to=4))
    assert len(jb) == len(tb) == 3
    for a, b in zip(jb, tb):
        for et in eids:
            np.testing.assert_array_equal(a[et], b[et])


def _small_world(num_users=100, num_items=50):
    data = make_synthetic_data(num_users=num_users, num_items=num_items, num_groups=4,
                               interactions_per_user=8, test_per_user=3, feat_dim=8,
                               with_clicks=True, seed=0)
    g = data.graph
    model = ConvModel(g.canonical_etypes, (("user", 8), ("item", 8), ("hidden", 32), ("out", 16)),
                      n_layers=3, aggregator_type="mean")
    return data, g, model, {nt: g.ndata[nt]["features"] for nt in g.ntypes}


def test_train_minibatch_learns():
    """The JAX package's learning gate (``tests/test_minibatch.py:51-78``)."""
    data, g, model, feats = _small_world()
    cfg = tmb.MinibatchConfig(edge_batch_size=256, fanouts=(-1, -1), neg_sample_size=10,
                              neg_mode="shared_pool", neg_pool_size=64, lr=3e-3, num_epochs=12,
                              metrics_every=0, patience=100)
    train_eids = {et: np.arange(g.num_edges(et)) for et in (ET_BUYS, ET_CLICKS)}
    state, hist = tmb.train_minibatch(model, g, g, feats, train_eids, None, cfg, device="cpu")
    assert state.step == 11 * 7  # epoch 0 takes no step; 7 batches an epoch
    assert hist["train_loss"][-1] < hist["train_loss"][0] * 0.7
    h = tmb.compute_embeddings_minibatch(model, g, feats, ntypes=("user", "item"))
    gt_u, gt_i = data.test_ground_truth
    user_ids = np.unique(gt_u)
    recs = get_recs(h["user"], h["item"], torch.as_tensor(user_ids), 10, device="cpu")
    _, recall, _ = recs_to_metrics(recs, user_ids, gt_u, gt_i, data.num_items)
    assert recall > 0.2, f"recall {recall}"


def test_dense_pool_training_with_validation_and_metrics():
    """Dense pool with kernels (their plain versions here), a held-out split
    with validation loss, and the metrics cadence."""
    data, g, model, feats = _small_world(60, 30)
    model = ConvModel(g.canonical_etypes, model.dims, n_layers=3, aggregator_type="mean_nn",
                      leaf_kernel=True)
    n = g.num_edges(ET_BUYS)
    cfg = tmb.MinibatchConfig(edge_batch_size=128, fanouts=(4, 4), neg_mode="dense_pool",
                              neg_pool_size=48, pool_mask_kernel=True, lr=3e-3, num_epochs=4,
                              metrics_every=2, patience=100, lr_schedule="cosine")
    state, hist = tmb.train_minibatch(
        model, g, g, feats, {ET_BUYS: np.arange(n - 50)}, {ET_BUYS: np.arange(n - 50, n)}, cfg,
        test_ground_truth=data.test_ground_truth, already_bought=data.train_pairs[ET_BUYS],
        device="cpu")
    assert len(hist["valid_loss"]) == len(hist["train_loss"]) == 4
    assert np.isfinite(hist["valid_loss"]).all() and len(hist["recall"]) == 2
    assert 0.0 <= hist["recall"][-1] <= 1.0


def test_node_batches_inference_matches_full_graph():
    data, g, model, feats = _small_world(40, 25)
    h_fg = tmb.infer_embeddings(model, g, feats, mode="full_graph", device="cpu")
    h_nb = tmb.infer_embeddings(model, g, feats, mode="node_batches", node_batch_size=16,
                                ntypes=("user", "item"), device="cpu")
    for nt in ("user", "item"):
        np.testing.assert_allclose(h_nb[nt].numpy(), h_fg[nt].numpy(), rtol=2e-4, atol=2e-5)
    with pytest.raises(ValueError):
        tmb.infer_embeddings(model, g, feats, mode="bogus", device="cpu")
    assert torch.equal(compute_embeddings(model, g, feats)["user"], h_fg["user"])


@pytest.mark.parametrize("leaf_kernel", [False, True])
def test_composed_leaf_weights_once_per_walk(leaf_kernel):
    """The folded leaf's composed weights are probed once per (layer, etype)
    of a walk, however many leaf branches use them, and not kept after it."""
    data, g, model, feats = _small_world(20, 10)
    model = ConvModel(g.canonical_etypes, model.dims, n_layers=3, aggregator_type="mean_nn",
                      leaf_kernel=leaf_kernel)
    calls = {}
    for name, mod in model.named_modules():
        if name.startswith("layer0_") and name.endswith(".fc_preagg"):
            mod.register_forward_hook(
                lambda m, i, o, name=name: calls.__setitem__(name, calls.get(name, 0) + 1))
    draws = Draws(torch.Generator().manual_seed(0))
    model.eval()
    model.sampled_repr(g, feats, {"user": torch.arange(4), "item": torch.arange(3)}, (2, 2),
                       draws)
    assert calls and set(calls.values()) == {1}, calls
    assert model._leaf_weights is None


def test_unported_options_raise():
    data, g, model, feats = _small_world(20, 10)
    seeds = {"user": torch.arange(3)}
    draws = Draws(torch.Generator().manual_seed(0))
    with pytest.raises(NotImplementedError):
        model.sampled_repr(g, feats, seeds, (2, 2), draws, feature_lookup=lambda *a: None)
    with pytest.raises(NotImplementedError):
        ConvModel(g.canonical_etypes, model.dims, remat_levels=True)
    with pytest.raises(ValueError):
        model.sampled_repr(g, feats, seeds, (2,), draws)
    with pytest.raises(KeyError):
        tmb.make_minibatch_loss(model, tmb.MinibatchConfig(neg_mode="bogus"), (ET_BUYS,), False,
                                {ET_BUYS: True})
