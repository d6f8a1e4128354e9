"""The MLP scoring head (``pred='nn'``) of the port against the JAX package:
``PredictingLayer``, ``score_emb_pairs``, ``score_pairs`` and the full pass,
the factorised retrieval score function, recs and metrics with it, and
serving an nn run (its minibatch step: ``tests/test_torch_minibatch.py``).
Weights are JAX's, carried by ``params_from_jax``; JAX runs at the highest
matmul precision (``tests/conftest.py``) and the port without TF32.

Tolerances: scores and embeddings within 1e-5 relative (f32 sums in
another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_minibatch import one_torch_thread  # noqa: F401 (autouse)

from gnn_recsys_tpu.models.conv_model import ConvModel as JConvModel
from gnn_recsys_tpu.models.layers import PredictingLayer as JPredictingLayer
from gnn_recsys_tpu.ops.membership import build_padded_pair_set as jpairs
from gnn_recsys_tpu.retrieval import recs as jrecs
from gnn_recsys_tpu.retrieval.metrics import get_metrics_at_k as j_metrics
from gnn_recsys_tpu.train import full_batch as jfb
from gnn_recsys_tpu.utils.synthetic import make_synthetic_data as jmake
from gnn_recsys_tpu_torch.inference import inference_ondemand
from gnn_recsys_tpu_torch.models.conv_model import ConvModel
from gnn_recsys_tpu_torch.models.convert import params_from_jax, params_to_jax
from gnn_recsys_tpu_torch.models.layers import PredictingLayer
from gnn_recsys_tpu_torch.ops.membership import build_padded_pair_set
from gnn_recsys_tpu_torch.retrieval import recs as trecs
from gnn_recsys_tpu_torch.retrieval.metrics import get_metrics_at_k
from gnn_recsys_tpu_torch.train.checkpoint import save_run
from gnn_recsys_tpu_torch.utils.synthetic import make_synthetic_data

RTOL = 1e-5
DIMS = (("user", 8), ("item", 8), ("hidden", 16), ("out", 8))
DATA_KW = dict(num_users=60, num_items=37, num_groups=4, interactions_per_user=5,
               test_per_user=2, feat_dim=8, with_clicks=True, seed=4)
ET_BUYS = ("user", "buys", "item")


@pytest.fixture(autouse=True)
def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False


def _close(got, want, what=""):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * float(np.abs(want).max()),
                               err_msg=what)


def _pair(pred="nn", agg="mean", **model_kw):
    """The same graph, model and (JAX-initialised) parameters in both packages."""
    jd, td = jmake(**DATA_KW), make_synthetic_data(**DATA_KW)
    kw = dict(canonical_etypes=jd.graph.canonical_etypes, dims=DIMS, n_layers=3,
              aggregator_type=agg, pred=pred, **model_kw)
    jm, tm = JConvModel(**kw), ConvModel(**kw)
    jfeats = {nt: jd.graph.ndata[nt]["features"] for nt in jd.graph.ntypes}
    tfeats = {nt: td.graph.ndata[nt]["features"] for nt in td.graph.ntypes}
    params = jfb.init_model(jm, jd.graph, jfeats, seed=1)
    tm.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    tm.eval()
    return jd, td, jm, tm, jfeats, tfeats, params


def _pairs(rng, num_users, num_items, shape):
    u = rng.integers(0, num_users, shape).astype(np.int32)
    i = rng.integers(0, num_items, shape).astype(np.int32)
    return u, i


def test_predicting_layer_matches_jax():
    """Dense 128 -> 32 -> 1 with sigmoid, on inputs of rank 2 and 3."""
    x = np.random.default_rng(0).normal(size=(5, 7, 16)).astype(np.float32)
    jl = JPredictingLayer()
    variables = jl.init(jax.random.PRNGKey(2), jnp.asarray(x))
    tl = PredictingLayer(16)
    tl.load_state_dict({k.split(".", 1)[1]: v for k, v in params_from_jax(
        {"pred_layer": jax.tree.map(np.asarray, variables["params"])}).items()})
    for xin in (x, x[0]):
        _close(tl(torch.from_numpy(xin)), jl.apply(variables, jnp.asarray(xin)))


def test_nn_params_round_trip():
    *_, params = _pair("nn", "mean_nn")
    tree = jax.tree.map(np.asarray, params)
    back = params_to_jax(params_from_jax(tree))
    assert "pred_layer" in back["params"]
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("pred", ["cos", "nn"])
@pytest.mark.parametrize("agg", ["mean", "mean_nn", "pool_nn"])
def test_scores_and_full_pass_match_jax(pred, agg):
    """``score_emb_pairs`` (broadcast shapes), ``score_pairs`` (ids of rank 1
    and 2) and the full pass (JAX ``__call__``): embeddings and scores."""
    jd, td, jm, tm, jfeats, tfeats, params = _pair(pred, agg)
    rng = np.random.default_rng(5)
    eu = rng.normal(size=(6, 1, 8)).astype(np.float32)
    ev = rng.normal(size=(1, 4, 8)).astype(np.float32)
    want = jm.apply(params, jnp.asarray(eu), jnp.asarray(ev), method=jm.score_emb_pairs)
    _close(tm.score_emb_pairs(torch.from_numpy(eu), torch.from_numpy(ev)), want,
           "score_emb_pairs")

    n_u, n_i = DATA_KW["num_users"], DATA_KW["num_items"]
    pos = {et: _pairs(rng, n_u, n_i, (9,)) for et in jd.train_pairs}
    neg = {et: _pairs(rng, n_u, n_i, (9, 5)) for et in jd.train_pairs}

    def as_j(d):
        return {et: tuple(jnp.asarray(a) for a in p) for et, p in d.items()}

    def as_t(d):
        return {et: tuple(torch.from_numpy(a) for a in p) for et, p in d.items()}

    jh, jpos, jneg = jm.apply(params, jd.graph, jfeats, as_j(pos), as_j(neg))
    with torch.no_grad():
        th, tpos, tneg = tm.full_pass(td.graph, tfeats, as_t(pos), as_t(neg))
        direct = tm.score_pairs(th, as_t(neg))
    for nt in jh:
        _close(th[nt], jh[nt], nt)
    for et in jd.train_pairs:
        assert tpos[et].dtype == tneg[et].dtype == torch.float32
        _close(tpos[et], jpos[et], f"pos {et}")
        _close(tneg[et], jneg[et], f"neg {et}")
        assert torch.equal(direct[et], tneg[et])


def _mlp_params(seed=0, d=8):
    """A ``pred_layer`` tree of random (not initialiser-shaped) weights."""
    rng = np.random.default_rng(seed)
    shapes = {"hidden_1": (2 * d, 128), "hidden_2": (128, 32), "output": (32, 1)}
    return {"params": {"pred_layer": {
        lin: {"kernel": (rng.normal(size=s) / np.sqrt(s[0])).astype(np.float32),
              "bias": rng.normal(scale=0.1, size=s[1]).astype(np.float32)}
        for lin, s in shapes.items()}}}


@pytest.mark.parametrize("num_items,item_tile", [(37, 16), (64, 16), (37, 512)])
def test_mlp_score_fn_matches_jax(num_items, item_tile):
    """The factorised head over a catalog that is, and is not, a multiple of
    the item tile; also against the unfactorised head on the concat."""
    params = _mlp_params()
    rng = np.random.default_rng(1)
    u = rng.normal(size=(11, 8)).astype(np.float32)
    items = rng.normal(size=(num_items, 8)).astype(np.float32)
    want = jrecs.make_mlp_score_fn(params, item_tile=item_tile)(jnp.asarray(u),
                                                                jnp.asarray(items))
    sd = params_from_jax(params)
    got = trecs.make_mlp_score_fn(sd, item_tile=item_tile)(torch.from_numpy(u),
                                                           torch.from_numpy(items))
    assert got.shape == (11, num_items) and got.dtype == torch.float32
    _close(got, want)
    head = PredictingLayer(16)
    head.load_state_dict({k.split(".", 1)[1]: v for k, v in sd.items()})
    with torch.no_grad():
        x = torch.cat(torch.broadcast_tensors(torch.from_numpy(u)[:, None, :],
                                              torch.from_numpy(items)[None, :, :]), dim=-1)
        _close(got, head(x)[..., 0].numpy())
    assert trecs.model_score_fn("cos", sd) is None


@pytest.mark.parametrize("remove_bought", [True, False])
def test_nn_recs_and_metrics_match_jax(remove_bought):
    """``get_recs`` and ``get_metrics_at_k`` with the MLP head of an nn model:
    the same ids and metrics as JAX's (the XLA route there, torch here)."""
    jd, td, jm, tm, jfeats, tfeats, params = _pair("nn")
    jh = jfb.compute_embeddings(jm, params, jd.graph, jfeats)
    with torch.no_grad():
        th = tm(td.graph, tfeats)
    buys_u, buys_i = jd.train_pairs[ET_BUYS]
    n_u = DATA_KW["num_users"]
    users = np.arange(0, n_u, 3, dtype=np.int32)
    jfn = jrecs.model_score_fn("nn", params)
    tfn = trecs.model_score_fn("nn", tm)
    want = jrecs.get_recs(jh["user"], jh["item"], jnp.asarray(users), 6,
                          already_bought=jpairs(buys_u, buys_i, num_src=n_u),
                          remove_already_bought=remove_bought, score_fn=jfn, chunk_size=8)
    got = trecs.get_recs(th["user"], th["item"], torch.from_numpy(users), 6,
                         already_bought=build_padded_pair_set(buys_u, buys_i, num_src=n_u),
                         remove_already_bought=remove_bought, score_fn=tfn, chunk_size=8,
                         device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    jm_ = j_metrics(jh["user"], jh["item"], jd.test_ground_truth, jd.train_pairs[ET_BUYS], 5,
                    remove_already_bought=remove_bought, score_fn=jfn)
    tm_ = get_metrics_at_k(th["user"], th["item"], td.test_ground_truth,
                           td.train_pairs[ET_BUYS], 5, remove_already_bought=remove_bought,
                           score_fn=tfn, device="cpu")
    assert tm_ == pytest.approx(jm_, rel=1e-6)  # JAX divides in f32


def test_serving_an_nn_run_matches_jax(tmp_path):
    """``save_run`` an nn model, then ``inference_ondemand`` on the CPU: the
    recs of JAX's ``get_recs`` with the same parameters and the MLP head."""
    jd, td, jm, tm, jfeats, tfeats, params = _pair("nn", "mean_nn")
    model_kwargs = dict(canonical_etypes=[list(e) for e in td.graph.canonical_etypes],
                        dims=[list(d) for d in DIMS], n_layers=3, norm=True, dropout=0.0,
                        aggregator_type="mean_nn", pred="nn", aggregator_hetero="sum",
                        embedding_layer=True)
    save_run(str(tmp_path), tm.state_dict(), model_kwargs, graph=td.graph)
    users = [0, 7, 13, 59, 30]
    got = inference_ondemand(str(tmp_path), users, k=5, use_popularity=False, device="cpu")
    jh = jfb.compute_embeddings(jm, params, jd.graph, jfeats)
    buys_u, buys_i = jd.train_pairs[ET_BUYS]
    want = jrecs.get_recs(jh["user"], jh["item"], jnp.asarray(users, jnp.int32), 5,
                          already_bought=jpairs(buys_u, buys_i, num_src=DATA_KW["num_users"]),
                          score_fn=jrecs.make_mlp_score_fn(params))
    assert got == {u: list(map(int, row)) for u, row in zip(users, np.asarray(want))}
