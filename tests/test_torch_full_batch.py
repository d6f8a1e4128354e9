"""The port's full-batch trainer (BASELINE config[0]) against the JAX
package: ``uniform_negative_dst``, one ``make_full_batch_step`` and a few
epochs of ``train_full_batch`` from the same parameters and negatives, and
the port's own copies of the JAX package's full-batch gates
(``tests/test_e2e_fullbatch.py``).

JAX's negatives come from its own keys, split as its step splits them; the
port replays those ints through ``ReplayDraws``.  Dropout draws cannot agree
across frameworks, so the equality tests run with dropout 0, as the gates
do; one test checks that a step with dropout trains.  JAX runs at the
highest matmul precision (``tests/conftest.py``), the port without TF32.

Tolerances: the loss within 1e-5 relative; gradients within 1e-4 relative +
1e-6 absolute; the parameters after an update within 2e-6 where |g| > 1e-5
and 2 * lr elsewhere, per update (the step tests' tolerances,
``tests/test_torch_minibatch.py``)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from test_e2e_fullbatch import popularity_baseline_recall
from test_torch_minibatch import (  # noqa: F401 (one_torch_thread: autouse)
    GRAD_ATOL,
    GRAD_RTOL,
    LOSS_RTOL,
    LR,
    one_torch_thread,
)

from gnn_recsys_tpu.models.conv_model import ConvModel as JConvModel
from gnn_recsys_tpu.ops.membership import build_padded_pair_set as jpairs
from gnn_recsys_tpu.ops.negative import uniform_negative_dst as juniform_negative_dst
from gnn_recsys_tpu.train import full_batch as jfb
from gnn_recsys_tpu.utils.synthetic import make_synthetic_data as jmake
from gnn_recsys_tpu_torch.models.conv_model import ConvModel
from gnn_recsys_tpu_torch.models.convert import params_from_jax
from gnn_recsys_tpu_torch.ops.membership import pair_set_contains
from gnn_recsys_tpu_torch.ops.negative import uniform_negative_dst
from gnn_recsys_tpu_torch.ops.sampling import Draws, ReplayDraws
from gnn_recsys_tpu_torch.train import full_batch as tfb
from gnn_recsys_tpu_torch.utils.synthetic import make_synthetic_data

DIMS = (("user", 8), ("item", 8), ("hidden", 16), ("out", 8))
DATA_KW = dict(num_users=70, num_items=30, num_groups=4, interactions_per_user=6,
               test_per_user=2, feat_dim=8, with_clicks=True, seed=3)
NEG = 7


@pytest.fixture(autouse=True)
def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False


@functools.lru_cache(maxsize=None)
def _jax_params(pred, agg, seed):
    """JAX's initial parameters (as numpy) of :func:`_pair`'s model, drawn
    once a module for each (pred, agg, seed): the init is jitted anew for
    every model object."""
    jd = jmake(**DATA_KW)
    jm = JConvModel(canonical_etypes=jd.graph.canonical_etypes, dims=DIMS, n_layers=3,
                    aggregator_type=agg, pred=pred, dropout=0.0)
    jfeats = {nt: jd.graph.ndata[nt]["features"] for nt in jd.graph.ntypes}
    return jax.tree.map(np.asarray, jfb.init_model(jm, jd.graph, jfeats, seed=seed))


def _pair(pred, agg="mean", seed=0):
    """The same graph, model and (JAX-initialised) parameters in both packages."""
    jd, td = jmake(**DATA_KW), make_synthetic_data(**DATA_KW)
    kw = dict(canonical_etypes=jd.graph.canonical_etypes, dims=DIMS, n_layers=3,
              aggregator_type=agg, pred=pred, dropout=0.0)
    jm, tm = JConvModel(**kw), ConvModel(**kw)
    jfeats = {nt: jd.graph.ndata[nt]["features"] for nt in jd.graph.ntypes}
    tfeats = {nt: td.graph.ndata[nt]["features"] for nt in td.graph.ntypes}
    params = _jax_params(pred, agg, seed)
    tm.load_state_dict(params_from_jax(params))
    return jd, td, jm, tm, jfeats, tfeats, jax.tree.map(jnp.asarray, params)


def jax_negatives(key, pos_src, num_items, neg_sample_size):
    """Each etype's negative destinations as JAX's step draws them from
    ``key``: split into one key per etype plus the dropout key."""
    keys = jax.random.split(key, len(pos_src) + 1)
    return [np.array(juniform_negative_dst(keys[i], jnp.asarray(u), num_items,
                                           neg_sample_size)[1])
            for i, u in enumerate(pos_src)]


def test_uniform_negative_dst_matches_jax():
    """JAX's ints, replayed; the sources broadcast; a fresh draw in range."""
    rng = np.random.default_rng(0)
    pos = [rng.integers(0, 50, n).astype(np.int32) for n in (13, 6)]
    keys = jax.random.split(jax.random.PRNGKey(4), len(pos) + 1)
    want = [juniform_negative_dst(keys[i], jnp.asarray(u), 30, 5) for i, u in enumerate(pos)]
    draws = ReplayDraws([], [np.array(w[1]) for w in want])
    for u, (jsrc, jdst) in zip(pos, want):
        src, dst = uniform_negative_dst(draws, torch.from_numpy(u), 30, 5)
        np.testing.assert_array_equal(src.numpy(), np.asarray(jsrc))
        np.testing.assert_array_equal(dst.numpy(), np.asarray(jdst))
        assert src.shape == dst.shape == (len(u), 5) and dst.dtype == torch.int32
    assert draws.exhausted
    src, dst = uniform_negative_dst(Draws(torch.Generator().manual_seed(0)),
                                    torch.arange(400), 30, 5)
    assert dst.min() >= 0 and dst.max() < 30 and len(torch.unique(dst)) == 30
    assert torch.equal(src, torch.arange(400)[:, None].expand(400, 5))


def _jax_inputs(jd, etypes):
    """Positive pairs, the full edge set's tables and the recency divisors."""
    return ({et: tuple(jnp.asarray(a, jnp.int32) for a in jd.train_pairs[et]) for et in etypes},
            {et: jpairs(np.asarray(jd.graph.rels[et].src), np.asarray(jd.graph.rels[et].dst),
                        num_src=DATA_KW["num_users"]) for et in etypes},
            {et: jd.graph.rels[et].edata["recency"] for et in etypes})


def _port_inputs(td):
    """The same as :func:`_jax_inputs`, for the port."""
    return tfb.full_batch_inputs(td.graph, td.graph, {}, td.train_pairs, "cpu")[2:]


def _check_update(tm, jgrads, jnew):
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), jgrads[name].numpy(), rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg=name)
        big = np.abs(jgrads[name].numpy()) > 1e-5
        gap = np.abs(p.detach().numpy() - jnew[name].numpy())
        assert gap[big].max(initial=0.0) <= 2e-6, name
        assert gap.max(initial=0.0) <= 2 * LR, name


@pytest.mark.parametrize("pred", ["cos", "nn"])
@pytest.mark.parametrize("remove_false_negative", [True, False])
@pytest.mark.parametrize("use_recency", [False, True])
def test_full_batch_step_matches_jax(monkeypatch, pred, remove_false_negative, use_recency):
    """One step from the same parameters and negatives: the false-negative
    mask against the full edge set, the full pass, the max-margin loss
    (optionally recency-weighted) and Adam."""
    agg = "mean_nn" if pred == "nn" else "mean"
    jd, td, jm, tm, jfeats, tfeats, params = _pair(pred, agg)
    etypes = tuple(jd.train_pairs)
    cfg_kw = dict(neg_sample_size=NEG, lr=LR, remove_false_negative=remove_false_negative,
                  use_recency=use_recency)
    jpos, jtab, jrec = _jax_inputs(jd, etypes)
    tpos, ttab, trec = _port_inputs(td)
    key = jax.random.PRNGKey(9)
    negs = jax_negatives(key, [jd.train_pairs[et][0] for et in etypes], DATA_KW["num_items"], NEG)
    # The mask has work to do: some negatives are edges of the graph.
    assert all(pair_set_contains(ttab[et], tpos[et][0], torch.from_numpy(n)).any()
               for et, n in zip(etypes, negs))

    orig_apply = jfb.TrainState.apply_gradients

    def keep_grads(self, *, grads, **kw):  # the jitted step hands back both
        new = orig_apply(self, grads=grads, **kw)
        return new.replace(params={"new": new.params, "grads": grads})

    monkeypatch.setattr(jfb.TrainState, "apply_gradients", keep_grads)
    jstate = jfb.TrainState.create(apply_fn=jm.apply, params=params, tx=optax.adam(LR))
    jstep = jfb.make_full_batch_step(jm, jfb.FullBatchConfig(**cfg_kw), etypes)
    jstate, jloss = jstep(jstate, jd.graph, jfeats, jpos, jtab, jrec, key)

    state = tfb.TrainState.create(tm, lr=LR)
    tstep = tfb.make_full_batch_step(tm, tfb.FullBatchConfig(**cfg_kw), etypes)
    draws = ReplayDraws([], negs)
    state, tloss = tstep(state, td.graph, tfeats, tpos, ttab, trec, draws)
    assert draws.exhausted and state.step == 1 and tm.training
    assert float(tloss) == pytest.approx(float(jloss), rel=LOSS_RTOL)
    _check_update(tm, params_from_jax(jax.tree.map(np.asarray, jstate.params["grads"])),
                  params_from_jax(jax.tree.map(np.asarray, jstate.params["new"])))


@pytest.mark.parametrize("pred", ["cos", "nn"])
def test_train_full_batch_matches_jax(pred):
    """Three epochs of the trainer, evaluating each, with every epoch's
    negatives replayed from JAX's keys (``rng, sub = split(rng)`` an
    epoch): the loss and metric histories agree."""
    cfg = dict(neg_sample_size=NEG, lr=3e-3, num_epochs=3, eval_every=1, k=5, seed=2)
    jd, td, jm, tm, jfeats, tfeats, _ = _pair(pred, seed=cfg["seed"])  # JAX's own init
    etypes = tuple(jd.train_pairs)
    negs, rng = [], jax.random.PRNGKey(cfg["seed"])
    for _ in range(cfg["num_epochs"]):
        rng, sub = jax.random.split(rng)
        negs += jax_negatives(sub, [jd.train_pairs[et][0] for et in etypes],
                              DATA_KW["num_items"], NEG)
    bought = jd.train_pairs[("user", "buys", "item")]
    _, jhist = jfb.train_full_batch(jm, jd.graph, jd.graph, jfeats, jd.train_pairs,
                                    jd.test_ground_truth, jfb.FullBatchConfig(**cfg),
                                    already_bought=bought)
    draws = ReplayDraws([], negs)
    state, thist = tfb.train_full_batch(tm, td.graph, td.graph, tfeats, td.train_pairs,
                                        td.test_ground_truth, tfb.FullBatchConfig(**cfg),
                                        already_bought=bought,
                                        state=tfb.TrainState.create(tm, lr=cfg["lr"]),
                                        draws=draws, device="cpu")
    assert draws.exhausted and state.step == 3
    assert set(thist) == set(jhist) and len(thist["epoch_time"]) == 3
    np.testing.assert_allclose(thist["loss"], jhist["loss"], rtol=LOSS_RTOL)
    for name in ("recall", "precision", "coverage"):
        assert len(thist[name]) == 3
        np.testing.assert_allclose(thist[name], jhist[name], rtol=1e-6, err_msg=name)


def _gate_run(pred, seed, num_users, num_items, num_epochs):
    """The JAX package's gate setup (``tests/test_e2e_fullbatch.py``) on the
    port, on the CPU."""
    data = make_synthetic_data(num_users=num_users, num_items=num_items, num_groups=4,
                               interactions_per_user=10, test_per_user=3, feat_dim=8,
                               with_clicks=True, seed=seed)
    g = data.graph
    model = ConvModel(g.canonical_etypes, (("user", 8), ("item", 8), ("hidden", 32), ("out", 16)),
                      n_layers=3, aggregator_type="mean", pred=pred, aggregator_hetero="sum",
                      dropout=0.0)
    feats = {nt: g.ndata[nt]["features"] for nt in g.ntypes}
    cfg = tfb.FullBatchConfig(delta=0.266, neg_sample_size=20, lr=3e-3, num_epochs=num_epochs,
                              eval_every=20, k=10)
    _, history = tfb.train_full_batch(model, data.train_graph, g, feats, data.train_pairs,
                                      data.test_ground_truth, cfg,
                                      already_bought=data.train_pairs[("user", "buys", "item")],
                                      device="cpu")
    return data, history


def test_full_batch_beats_popularity():
    """BASELINE config[0]'s gate: the cosine model beats recommending the
    popular items by more than 0.05 recall@10, and the loss falls."""
    data, history = _gate_run("cos", seed=0, num_users=120, num_items=60, num_epochs=60)
    pop_recall = popularity_baseline_recall(data, k=10)
    assert max(history["recall"]) > pop_recall + 0.05, (history["recall"], pop_recall)
    assert history["loss"][-1] < history["loss"][0]


def test_full_batch_nn_predictor_end_to_end():
    """The MLP head trains and ranks with itself: the loss falls and recall
    beats popularity."""
    data, history = _gate_run("nn", seed=2, num_users=100, num_items=50, num_epochs=40)
    assert history["loss"][-1] < history["loss"][0]
    assert max(history["recall"]) > popularity_baseline_recall(data, k=10), history["recall"]


def test_eval_cadence_and_patience():
    """``eval_every=0`` evaluates only at the last epoch; with patience, an
    evaluation that does not improve on the best for ``patience *
    eval_every`` epochs stops the run."""
    data = make_synthetic_data(**DATA_KW)
    g = data.graph
    feats = {nt: g.ndata[nt]["features"] for nt in g.ntypes}

    def run(**kw):
        model = ConvModel(g.canonical_etypes, DIMS, aggregator_type="mean")
        cfg = tfb.FullBatchConfig(neg_sample_size=NEG, k=5, **kw)
        return tfb.train_full_batch(model, g, g, feats, data.train_pairs,
                                    data.test_ground_truth, cfg, device="cpu")[1]

    hist = run(num_epochs=4, eval_every=0)
    assert len(hist["loss"]) == 4 and len(hist["recall"]) == 1
    hist = run(num_epochs=50, eval_every=1, patience=1, lr=0.0)  # recall never improves
    assert len(hist["loss"]) == 2 and len(hist["recall"]) == 2


def test_dropout_step_trains():
    """With dropout the masks come from torch's generator: two train-mode
    passes differ, eval-mode passes do not, and steps give finite losses."""
    data = make_synthetic_data(**DATA_KW)
    g = data.graph
    feats = {nt: g.ndata[nt]["features"] for nt in g.ntypes}
    torch.manual_seed(0)
    model = ConvModel(g.canonical_etypes, DIMS, aggregator_type="mean_nn", dropout=0.5)
    model.train()
    a, b = model(g, feats)["user"], model(g, feats)["user"]
    model.eval()
    c, d = model(g, feats)["user"], model(g, feats)["user"]
    assert not torch.equal(a, b) and torch.equal(c, d) and not torch.equal(a, c)
    etypes = tuple(data.train_pairs)
    pos, tables, rec = _port_inputs(data)
    state = tfb.TrainState.create(model, lr=LR)
    step = tfb.make_full_batch_step(model, tfb.FullBatchConfig(neg_sample_size=NEG), etypes)
    draws = Draws(torch.Generator().manual_seed(1))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    losses = [float(step(state, g, feats, pos, tables, rec, draws)[1]) for _ in range(3)]
    assert np.isfinite(losses).all() and state.step == 3 and model.training
    assert all(not torch.equal(before[k], v) for k, v in model.state_dict().items()
               if k.startswith("layer"))
