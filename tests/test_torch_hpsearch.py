"""The port's hyperparameter search and a trial's model and config against the JAX
package: ``gp_opt`` (the space's encoding, the GP, expected improvement),
``run_search`` (trials and JSON checkpoints, resumed across packages),
``trial.build_model`` and ``trial.minibatch_config`` for the first three
trials of the search, one training step of each from the same parameters
with JAX's draws replayed, and each trial's evaluation; and the port's
``trial.run_trial_on_graph``, which runs those parts in order.

Tolerances: the GP's predictions within 1e-10 (the same numpy code);
embeddings within 1e-5; the step's as in ``test_torch_minibatch.py`` (loss
1e-5 relative, gradients 1e-4 relative + 1e-6 absolute, parameters after
Adam within 2e-6 where |g| > 1e-5, else 2 * lr).  The steps run at dropout 0:
dropout draws from each framework's own generator, which cannot be replayed
across frameworks.  Recommendations may differ only at near-ties, held as
``test_torch_topk_mips._check_near_ties`` holds them."""

import dataclasses
import json
import shutil
import unittest.mock

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from test_torch_bf16 import _recording
from test_torch_minibatch import (
    GRAD_ATOL,
    GRAD_RTOL,
    LOSS_RTOL,
    one_torch_thread,  # noqa: F401 (autouse)
)

from gnn_recsys_tpu import gp_opt as jgp
from gnn_recsys_tpu import hpsearch as jhp
from gnn_recsys_tpu import trial as jtrial
from gnn_recsys_tpu.config import FixedParams as JFixedParams
from gnn_recsys_tpu.config import HyperParams as JHyperParams
from gnn_recsys_tpu.data.split import train_valid_split as jsplit
from gnn_recsys_tpu.ops.membership import build_padded_pair_set as jbuild_pairs
from gnn_recsys_tpu.retrieval.metrics import get_metrics_at_k as jget_metrics
from gnn_recsys_tpu.retrieval.recs import get_recs as jget_recs
from gnn_recsys_tpu.train import full_batch as jfb
from gnn_recsys_tpu.train import minibatch as jmb
from gnn_recsys_tpu.utils.synthetic import make_hard_synthetic_data as jmake_hard
from gnn_recsys_tpu_torch import gp_opt as tgp
from gnn_recsys_tpu_torch import hpsearch as thp
from gnn_recsys_tpu_torch import trial as ttrial
from gnn_recsys_tpu_torch.config import FixedParams, HyperParams
from gnn_recsys_tpu_torch.data.split import train_valid_split
from gnn_recsys_tpu_torch.models.convert import params_from_jax
from gnn_recsys_tpu_torch.ops.membership import build_padded_pair_set
from gnn_recsys_tpu_torch.ops.sampling import ReplayDraws
from gnn_recsys_tpu_torch.retrieval.metrics import get_metrics_at_k, recs_to_metrics
from gnn_recsys_tpu_torch.retrieval.recs import get_recs
from gnn_recsys_tpu_torch.train import minibatch as tmb
from gnn_recsys_tpu_torch.train.checkpoint import load_run
from gnn_recsys_tpu_torch.utils.synthetic import make_hard_synthetic_data

BUYS = ("user", "buys", "item")
HARD_KW = dict(num_users=300, num_items=100, seed=0, max_fanout=16, user_chunk=128)
FIXED_KW = dict(max_fanout=16, edge_batch_size=64)
NEAR_TIE = 1e-5

# The first three points of GPOptimizer(Space(SEARCH_SPACE), x0=[defaults],
# seed=46): the defaults, then random asks (they do not depend on the
# objectives).  (aggregator_type, aggregator_hetero, embed_dim, n_layers,
# embedding_layer, popularity_importance, use_recency, neg_sample_size)
TRIALS = [
    ("mean_nn", "mean", "medium", 3, False, "no", True, 2500),
    ("pool_nn", "sum", "large", 4, True, "medium", False, 2484),
    ("mean_nn", "max", "small", 3, True, "small", True, 1597),
]


def _fitness(h) -> float:
    """A closed-form 'recall' of one trial."""
    return 0.01 * h.n_layers + h.delta


# ----------------------------------------------------------------------
# gp_opt
# ----------------------------------------------------------------------

SPEC = {
    "x": ("float", -2.0, 2.0, False),
    "lr": ("float", 1e-4, 1e-1, True),
    "depth": ("int", 2, 6),
    "agg": ("cat", ["mean", "max", "sum"]),
    "norm": ("cat", [True, False]),
}


def test_space_encode_decode_sample_perturb_match_jax():
    jspace, tspace = jgp.Space(SPEC), tgp.Space(SPEC)
    assert tspace.encoded_width == jspace.encoded_width
    jrng, trng = np.random.default_rng(0), np.random.default_rng(0)
    for _ in range(30):
        enc = tspace.sample(trng)[0]
        np.testing.assert_array_equal(enc, jspace.sample(jrng)[0])
        params = tspace.decode(enc)
        assert params == jspace.decode(enc)
        np.testing.assert_array_equal(tspace.encode(params), jspace.encode(params))
        round_trip = tspace.decode(tspace.encode(params))
        assert round_trip["agg"] == params["agg"] and round_trip["depth"] == params["depth"]
        assert round_trip["lr"] == pytest.approx(params["lr"], rel=1e-12)
        np.testing.assert_array_equal(tspace.perturb(enc, trng), jspace.perturb(enc, jrng))
    # The search's own space: the defaults encode and decode to themselves.
    space = tgp.Space(thp.SEARCH_SPACE)
    defaults = dataclasses.asdict(HyperParams())
    back = space.decode(space.encode(defaults))
    for name in thp.SEARCH_SPACE:
        assert back[name] == pytest.approx(defaults[name], rel=1e-12), name
    assert thp.SEARCH_SPACE == jhp.SEARCH_SPACE


def test_gp_predict_and_expected_improvement_match_jax():
    space = tgp.Space(SPEC)
    rng = np.random.default_rng(1)
    xs = space.sample(rng, 25)
    ys = np.sin(3.0 * xs[:, 0]) + xs[:, 2]
    xq = space.sample(rng, 40)
    tmu, tsig = tgp._GP(xs, ys).predict(xq)
    jmu, jsig = jgp._GP(xs, ys).predict(xq)
    np.testing.assert_allclose(tmu, jmu, rtol=0, atol=1e-10)
    np.testing.assert_allclose(tsig, jsig, rtol=0, atol=1e-10)
    np.testing.assert_array_equal(tgp._matern52(xs, xq, 0.7, 1.3),
                                  jgp._matern52(xs, xq, 0.7, 1.3))
    for z in (np.linspace(-6, 6, 101),):
        for a, b in zip(tgp._phi_Phi(z), jgp._phi_Phi(z)):
            np.testing.assert_array_equal(a, b)
    best = float(ys.min())
    np.testing.assert_array_equal(tgp.expected_improvement(tmu, tsig, best),
                                  jgp.expected_improvement(jmu, jsig, best))
    sig0 = np.where(np.arange(40) % 3 == 0, 0.0, tsig)
    np.testing.assert_array_equal(tgp.expected_improvement(tmu, sig0, best, xi=0.05),
                                  jgp.expected_improvement(tmu, sig0, best, xi=0.05))


# ----------------------------------------------------------------------
# run_search
# ----------------------------------------------------------------------

def _trials(state):
    return [(dataclasses.asdict(t.hyper), t.objective) for t in state.trials]


def _latest(logdir):
    with open(thp.latest_checkpoint(logdir)) as f:
        return json.load(f)


@pytest.mark.parametrize("optimizer", ["gp", "random"])
def test_run_search_matches_jax(tmp_path, optimizer):
    """14 calls, so that the GP-EI branch runs past its 10 initial points:
    the same trials and the same checkpoint in both packages."""
    kw = dict(n_calls=14, optimizer=optimizer, seed=46)
    for name in ("jax", "port"):  # run_search lists its logdir first
        (tmp_path / name).mkdir()
    jstate = jhp.run_search(_fitness, logdir=str(tmp_path / "jax"), **kw)
    tstate = thp.run_search(_fitness, logdir=str(tmp_path / "port"), **kw)
    assert _trials(tstate) == _trials(jstate)
    assert _latest(tmp_path / "port") == _latest(tmp_path / "jax")
    assert len({json.dumps(h, sort_keys=True) for h, _ in _trials(tstate)}) > 10
    assert tstate.best.objective == jstate.best.objective


@pytest.mark.parametrize("optimizer", ["gp", "random"])
@pytest.mark.parametrize("first", ["jax", "port"])
def test_resume_across_packages(tmp_path, optimizer, first):
    """A search stopped after 6 trials by one package resumes in the other
    with the proposals of the first package's own resume.  A resumed GP
    search asks its first random point again (ROADMAP.md queue 3): both
    packages do."""
    kw = dict(optimizer=optimizer, seed=46)
    writer, other = (jhp, thp) if first == "jax" else (thp, jhp)
    (tmp_path / "a").mkdir()
    writer.run_search(_fitness, n_calls=6, logdir=str(tmp_path / "a"), **kw)
    shutil.copytree(tmp_path / "a", tmp_path / "b")
    same = writer.run_search(_fitness, n_calls=14, logdir=str(tmp_path / "a"), **kw)
    cross = other.run_search(_fitness, n_calls=14, logdir=str(tmp_path / "b"), **kw)
    assert _trials(cross) == _trials(same)
    assert _latest(tmp_path / "b") == _latest(tmp_path / "a")
    called = []
    again = thp.run_search(lambda h: called.append(h) or 0.0, n_calls=14,
                           logdir=str(tmp_path / "b"), **kw)
    assert not called and _trials(again) == _trials(same)
    if optimizer == "gp":  # the repeated proposal after a resume
        hypers = [json.dumps(h, sort_keys=True) for h, _ in _trials(cross)]
        assert hypers[6] == hypers[1]


def test_pkl_checkpoint_is_refused(tmp_path):
    (tmp_path / "checkpoint20240101_000000.pkl").write_bytes(b"not read")
    assert thp.latest_checkpoint(str(tmp_path)).endswith(".pkl")
    with pytest.raises(ValueError, match="pkl"):
        thp.run_search(_fitness, n_calls=2, logdir=str(tmp_path))
    state = thp.run_search(_fitness, n_calls=2, logdir=str(tmp_path), from_beginning=True)
    assert len(state.trials) == 2


def test_first_three_trials(tmp_path):
    state = thp.run_search(lambda h: 0.0, n_calls=3, logdir=str(tmp_path), seed=46)
    got = [(h.aggregator_type, h.aggregator_hetero, h.embed_dim, h.n_layers,
            h.embedding_layer, h.popularity_importance, h.use_recency, h.neg_sample_size)
           for h in (t.hyper for t in state.trials)]
    assert got == TRIALS
    assert state.trials[0].hyper == HyperParams()


# ----------------------------------------------------------------------
# A trial's model and config, one step and the evaluation
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def search_trials(tmp_path_factory):
    """The first three trials of the search, as each package's HyperParams."""
    state = thp.run_search(lambda h: 0.0, n_calls=3, seed=46,
                           logdir=str(tmp_path_factory.mktemp("search")))
    return [(t.hyper, JHyperParams(**dataclasses.asdict(t.hyper))) for t in state.trials]


@pytest.fixture(scope="module")
def hard_world():
    return jmake_hard(**HARD_KW), make_hard_synthetic_data(**HARD_KW)


_INITIAL = {}  # JAX's initial parameters, drawn once a trial


def _model_pair(world, index, hyper, jhyper, fixed_kw=FIXED_KW):
    """Each package's model of trial ``index`` and JAX's initial parameters."""
    jd, td = world
    jfixed, fixed = JFixedParams(**fixed_kw), FixedParams(**fixed_kw)
    jm, tm = jtrial.build_model(jd, jfixed, jhyper), ttrial.build_model(td, fixed, hyper)
    if index not in _INITIAL:
        jfeats = {nt: jd.graph.ndata[nt]["features"] for nt in jd.graph.ntypes}
        _INITIAL[index] = jfb.init_model(jm, jd.graph, jfeats, seed=0)
    return jm, tm, _INITIAL[index], jfixed, fixed


@pytest.mark.parametrize("index", [0, 1, 2])
@pytest.mark.parametrize("bucket", [False, True])
def test_build_model_and_minibatch_config_match_jax(hard_world, search_trials, index, bucket):
    """The same parameter tree and shapes, model options and config fields
    (the full-graph embeddings of the same parameters are held in
    ``test_trial_step_and_evaluation_match_jax``)."""
    hyper, jhyper = search_trials[index]
    fixed_kw = dict(FIXED_KW, bucket_shapes=bucket)
    jm, tm, params, jfixed, fixed = _model_pair(hard_world, index, hyper, jhyper, fixed_kw)
    converted = params_from_jax(jax.tree.map(np.asarray, params))
    state = tm.state_dict()
    assert sorted(converted) == sorted(state)
    for name, p in state.items():
        assert tuple(p.shape) == tuple(converted[name].shape), name
    assert tm.num_conv_layers == jm.num_conv_layers
    for attr in ("dims", "n_layers", "norm", "dropout", "aggregator_type", "pred",
                 "aggregator_hetero", "embedding_layer"):
        assert getattr(tm, attr) == getattr(jm, attr), attr
    tcfg = ttrial.minibatch_config(fixed, hyper, tm, neg_pool_size=100)
    jcfg = jtrial.minibatch_config(jfixed, jhyper, jm, neg_pool_size=100)
    assert dataclasses.asdict(tcfg) == {f.name: getattr(jcfg, f.name)
                                        for f in dataclasses.fields(tcfg)}
    assert tcfg.dedup == (index < 2)
    if bucket:
        assert tcfg.neg_sample_size % 128 == 0


def _split_pair(world, fixed, jfixed, hyper):
    jd, td = world
    kw = dict(clicks_sample=hyper.clicks_sample, purchases_sample=hyper.purchases_sample,
              max_fanout=fixed.max_fanout)
    return (jsplit(jd.graph, jd.test_ground_truth, jfixed, **kw),
            train_valid_split(td.graph, td.test_ground_truth, fixed, **kw))


def _batches(split, n=32):
    """The first ``n`` training edges of each etype of the split's train
    graph, as each package's batch."""
    g = split.train_graph
    jbatch, tbatch = {}, {}
    for et, eids in split.train_eids.items():
        e = np.asarray(eids[:n])
        rel = g.rels[et]
        u, i = np.asarray(rel.src)[e], np.asarray(rel.dst)[e]
        rec = np.asarray(rel.edata["recency"])[e]
        jbatch[et] = {"u": jnp.asarray(u, jnp.int32), "i": jnp.asarray(i, jnp.int32),
                      "recency": jnp.asarray(rec), "eids": jnp.asarray(e, jnp.int32)}
        tbatch[et] = {"u": torch.as_tensor(u).long(), "i": torch.as_tensor(i).long(),
                      "recency": torch.as_tensor(rec), "eids": torch.as_tensor(e)}
    return jbatch, tbatch


def _check_recs(trecs, jrecs, scores):
    """Indices equal except at near-ties of the exact f64 ``scores``."""
    trecs, jrecs = trecs.numpy(), np.asarray(jrecs)
    differ = 0
    for r, c in zip(*np.nonzero(trecs != jrecs)):
        assert abs(scores[r, trecs[r, c]] - scores[r, jrecs[r, c]]) <= NEAR_TIE, (r, c)
        differ += 1
    return differ


@pytest.mark.parametrize("index", [0, 1, 2])
def test_trial_step_and_evaluation_match_jax(hard_world, search_trials, index):
    """The trial at dropout 0: its split, one training step of its config
    from JAX's initial parameters with JAX's draws replayed (loss, gradients,
    update), then the evaluation of the updated parameters on the full
    graph: embeddings, recommendations (with the popularity boost where the
    trial serves with it) and recall@10."""
    hyper, jhyper = (dataclasses.replace(h, dropout=0.0) for h in search_trials[index])
    jm, tm, params, jfixed, fixed = _model_pair(hard_world, index, hyper, jhyper)
    jd, td = hard_world
    js, ts = _split_pair(hard_world, fixed, jfixed, hyper)
    cfg_kw = dataclasses.asdict(ttrial.minibatch_config(fixed, hyper, tm, neg_pool_size=100))
    etypes = tuple(ts.train_eids)
    has_reverse = {et: True for et in etypes}
    jbatch, tbatch = _batches(js)
    num_users = jd.graph.num_nodes("user")
    full = {et: (np.asarray(jd.graph.rels[et].src), np.asarray(jd.graph.rels[et].dst))
            for et in etypes}
    jtables = {et: jbuild_pairs(u, i, num_src=num_users) for et, (u, i) in full.items()}
    ttables = {et: build_padded_pair_set(u, i, num_src=num_users) for et, (u, i) in full.items()}
    jfeats = {nt: js.train_graph.ndata[nt]["features"] for nt in js.train_graph.ntypes}
    tfeats = {nt: ts.train_graph.ndata[nt]["features"] for nt in ts.train_graph.ntypes}

    tm.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))

    orig = jfb.TrainState.apply_gradients

    def grads_and_params(self, *, grads, **kw):  # the step returns both
        new = orig(self, grads=grads, **kw)
        return new.replace(params={"new": new.params, "grads": grads})

    uniforms, randints, patch = _recording()
    with patch, unittest.mock.patch.object(jfb.TrainState, "apply_gradients",
                                           grads_and_params):
        jstep = jmb.make_minibatch_step(jm, jmb.MinibatchConfig(**cfg_kw), etypes,
                                        with_update=True, with_exclusion=True,
                                        has_reverse=has_reverse, jit=False)
        jstate = jfb.TrainState.create(apply_fn=jm.apply, params=params,
                                       tx=optax.adam(hyper.lr))
        jout, jloss = jax.jit(jstep)(jstate, js.train_graph, jfeats, jbatch, jtables,
                                     jax.random.PRNGKey(5))
        jax.effects_barrier()

    state = tmb.TrainState.create(tm, lr=hyper.lr)
    tstep = tmb.make_minibatch_step(tm, tmb.MinibatchConfig(**cfg_kw), etypes, with_update=True,
                                    with_exclusion=True, has_reverse=has_reverse)
    draws = ReplayDraws(uniforms, randints)
    state, tloss = tstep(state, ts.train_graph, tfeats, tbatch, ttables, draws)
    assert draws.exhausted and state.step == 1
    assert float(tloss) == pytest.approx(float(jloss), rel=LOSS_RTOL)
    jgrads = params_from_jax(jax.tree.map(np.asarray, jout.params["grads"]))
    jnew_tree = jax.tree.map(np.asarray, jout.params["new"])
    jnew = params_from_jax(jnew_tree)
    for name, p in tm.named_parameters():
        g = p.grad.numpy() if p.grad is not None else np.zeros(tuple(p.shape), np.float32)
        np.testing.assert_allclose(g, jgrads[name].numpy(), rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=name)
        big = np.abs(jgrads[name].numpy()) > 1e-5
        gap = np.abs(p.detach().numpy() - jnew[name].numpy())
        assert gap[big].max(initial=0.0) <= 2e-6, name
        assert gap.max(initial=0.0) <= 2 * hyper.lr, name

    # The evaluation of JAX's updated parameters, on the full graph.
    tm.load_state_dict(jnew)
    jfull = {nt: jd.graph.ndata[nt]["features"] for nt in jd.graph.ntypes}
    tfull = {nt: td.graph.ndata[nt]["features"] for nt in td.graph.ntypes}
    jh = jmb.infer_embeddings(jm, jnew_tree, jd.graph, jfull, ntypes=("user", "item"))
    th = tmb.infer_embeddings(tm, td.graph, tfull, device="cpu")
    for nt in ("user", "item"):
        np.testing.assert_allclose(th[nt].numpy(), np.asarray(jh[nt]), rtol=0, atol=1e-5)
    bought = td.train_pairs[BUYS]
    deg = np.bincount(bought[1], minlength=td.num_items).astype(np.float32)
    popularity = deg / deg.sum()
    boost = hyper.serve_with_popularity_boost
    assert boost == (index > 0)
    users = np.unique(td.test_ground_truth[0])
    k = fixed.k
    jtable = jbuild_pairs(bought[0], bought[1], num_src=num_users)
    ttable = build_padded_pair_set(bought[0], bought[1], num_src=num_users)
    pop_kw = dict(weight_popularity=hyper.weight_popularity)
    jrecs = jget_recs(jh["user"], jh["item"], jnp.asarray(users, jnp.int32), k,
                      already_bought=jtable, popularity=jnp.asarray(popularity) if boost else None,
                      **pop_kw)
    trecs = get_recs(th["user"], th["item"], torch.as_tensor(users), k, already_bought=ttable,
                     popularity=torch.as_tensor(popularity) if boost else None, device="cpu",
                     **pop_kw)
    u64 = th["user"].double().numpy()[users]
    i64 = th["item"].double().numpy()
    s = (u64 / np.linalg.norm(u64, axis=1, keepdims=True)) @ (
        i64 / np.linalg.norm(i64, axis=1, keepdims=True)).T
    if boost:
        e = np.exp(s - s.max(axis=1, keepdims=True))
        s = e / e.sum(axis=1, keepdims=True) + hyper.weight_popularity * popularity
    differ = _check_recs(trecs, jrecs, s)
    gt_u, gt_i = td.test_ground_truth
    _, trecall, _ = recs_to_metrics(trecs, torch.as_tensor(users), gt_u, gt_i, td.num_items)
    _, jrecall, _ = recs_to_metrics(torch.from_numpy(np.array(jrecs)).long(),
                                    torch.as_tensor(users), gt_u, gt_i, td.num_items)
    assert abs(trecall - jrecall) <= differ / len(gt_u)
    assert 0.0 < trecall < 1.0
    # The trial's own call: get_metrics_at_k in each package (JAX's recall is
    # an f32 ratio, hence 1e-6).
    _, tmetric, _ = get_metrics_at_k(th["user"], th["item"], td.test_ground_truth, bought, k,
                                     popularity=torch.as_tensor(popularity) if boost else None,
                                     device="cpu", **pop_kw)
    _, jmetric, _ = jget_metrics(jh["user"], jh["item"], jd.test_ground_truth,
                                 jd.train_pairs[BUYS], k,
                                 popularity=jnp.asarray(popularity) if boost else None, **pop_kw)
    assert tmetric == trecall and abs(tmetric - jmetric) <= differ / len(gt_u) + 1e-6


def test_run_trial_on_graph(hard_world, tmp_path):
    """The trial on a built graph, two epochs of a small model (epoch 0 takes
    no step): its stages in
    order; its recall that of the trained model's full-graph embeddings
    ranked by ``trial_metrics``; without ``max_fanout`` the train graph's
    rows uncapped, wider than the full graph's cap, as ``run_trial`` builds
    it (the reference flaw); a recall above the save threshold saved, so
    that ``load_run`` gives back the trained weights."""
    _, td = hard_world
    fixed = FixedParams(**dict(FIXED_KW, edge_batch_size=2048, num_epochs=2))
    hyper = dataclasses.replace(HyperParams(), embed_dim="small")
    stages, runs = [], []

    def on_stage(stage, run):
        stages.append(stage)
        runs.append(run)

    result = ttrial.run_trial_on_graph(td, td.test_ground_truth, td.train_pairs[BUYS], fixed,
                                       hyper, save_dir=str(tmp_path), save_threshold=-1.0,
                                       device="cpu", on_stage=on_stage)
    assert stages == ["split", "built", "trained", "evaluated"]
    run = runs[-1]
    assert isinstance(result, ttrial.TrialResult) and result.saved_to == str(tmp_path)
    assert len(result.history["train_loss"]) == 2 and run.state.step > 0
    again = ttrial.trial_metrics(ttrial.trial_embeddings(run.model, td.graph, run.features, fixed,
                                                         "cpu"),
                                 run.model, td.test_ground_truth, td.train_pairs[BUYS], fixed,
                                 hyper, device="cpu")
    assert (result.precision, result.recall, result.coverage) == again
    assert result.recall_purchase == 0.0
    widths = {et: rel.max_fanout for et, rel in run.split.train_graph.rels.items()}
    assert max(widths.values()) > fixed.max_fanout
    saved = load_run(str(tmp_path))["params"]
    for name, p in run.model.state_dict().items():
        assert torch.equal(saved[name], p), name
    assert ttrial.SAVE_THRESHOLDS[fixed.item_id_type] == 0.08
