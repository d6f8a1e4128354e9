"""The port's ConvModel against the JAX one: JAX-initialised parameters go
through ``params_from_jax``, and the full-graph embeddings must agree."""

import jax
import numpy as np
import pytest
import torch

from gnn_recsys_tpu.models.conv_model import ConvModel as JConvModel
from gnn_recsys_tpu.train.full_batch import compute_embeddings as jcompute
from gnn_recsys_tpu.train.full_batch import init_model
from gnn_recsys_tpu.utils.synthetic import make_synthetic_data as jmake
from gnn_recsys_tpu_torch.models.conv_model import ConvModel
from gnn_recsys_tpu_torch.models.convert import params_from_jax, params_to_jax
from gnn_recsys_tpu_torch.train.full_batch import compute_embeddings
from gnn_recsys_tpu_torch.utils.synthetic import make_synthetic_data

ATOL = 1e-5
DIMS = (("user", 8), ("item", 8), ("hidden", 32), ("out", 16))


@pytest.fixture(autouse=True)
def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False


def _pair(agg, hetero, n_layers, emb, seed=0, pred="cos"):
    jd = jmake(num_users=50, num_items=30, seed=seed)
    td = make_synthetic_data(num_users=50, num_items=30, seed=seed)
    kw = dict(canonical_etypes=jd.graph.canonical_etypes, dims=DIMS, n_layers=n_layers,
              aggregator_type=agg, aggregator_hetero=hetero, embedding_layer=emb, pred=pred)
    jm, tm = JConvModel(**kw), ConvModel(**kw)
    jfeats = {nt: jd.graph.ndata[nt]["features"] for nt in jd.graph.ntypes}
    params = init_model(jm, jd.graph, jfeats, seed=seed)
    return jd, td, jm, tm, jfeats, params


@pytest.mark.parametrize("agg,hetero,n_layers,emb", [
    ("mean_nn", "sum", 3, True),
    ("mean", "mean", 2, True),
    ("pool_nn_edge", "max", 3, False),
    ("mean_nn", "max", 2, False),
    ("mean", "sum", 3, False),
    ("pool_nn_edge", "mean", 2, True),
    ("lstm", "sum", 3, True),
    ("lstm_edge", "mean", 2, False),
])
def test_embeddings_match_jax(agg, hetero, n_layers, emb):
    jd, td, jm, tm, jfeats, params = _pair(agg, hetero, n_layers, emb)
    tm.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    ref = jcompute(jm, params, jd.graph, jfeats)
    feats = {nt: td.graph.ndata[nt]["features"] for nt in td.graph.ntypes}
    out = compute_embeddings(tm, td.graph, feats, device="cpu")
    assert sorted(out) == sorted(ref)
    for nt in ref:
        np.testing.assert_allclose(out[nt].numpy(), np.asarray(ref[nt]), rtol=0, atol=ATOL)
    assert tm.num_conv_layers == jm.num_conv_layers == len(tm.layers)


def test_params_round_trip():
    *_, params = _pair("mean_nn", "sum", 3, True)
    tree = jax.tree.map(np.asarray, params)
    back = params_to_jax(params_from_jax(tree))
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("agg,emb", [("mean_nn", True), ("pool_nn", False), ("lstm", True),
                                     ("lstm_edge", False)])
def test_own_init_mirrors_jax(agg, emb):
    """Same parameter tree and shapes as JAX; xavier-relu bounds on the conv
    towers; zero embedding bias; the LSTM cell as flax's ``LSTMCell``
    initialises it: input kernels ``lecun_normal`` (truncated at two
    standard deviations), recurrent kernels orthogonal, zero biases."""
    jd, *_, params = _pair(agg, "sum", 3, emb)
    tree = jax.tree.map(np.asarray, params)
    tm = ConvModel(canonical_etypes=jd.graph.canonical_etypes,
                   dims=DIMS, n_layers=3, aggregator_type=agg, embedding_layer=emb,
                   generator=torch.Generator().manual_seed(3))
    mine = params_to_jax(tm.state_dict())
    assert jax.tree.structure(mine) == jax.tree.structure(tree)
    for path, leaf in jax.tree_util.tree_leaves_with_path(mine):
        names = [p.key for p in path]
        ref = tree
        for n in names:
            ref = ref[n]
        assert leaf.shape == ref.shape
        if names[-1] == "bias":
            assert (leaf == 0).all()
        elif names[-4:-2] == ["scan", "cell"] and names[-2].startswith("h"):
            np.testing.assert_allclose(leaf.T @ leaf, np.eye(leaf.shape[0]), atol=1e-5)
        elif names[-4:-2] == ["scan", "cell"]:
            std = np.sqrt(1.0 / leaf.shape[0]) / 0.87962566103423978
            assert np.abs(leaf).max() <= 2 * std and 0.7 * std < leaf.std() < 1.3 * std
        elif names[-2] != "proj_feats":
            fan_in, fan_out = leaf.shape
            assert np.abs(leaf).max() <= np.sqrt(2.0) * np.sqrt(6.0 / (fan_in + fan_out))


def test_pred_layer_mirrors_jax():
    """``ConvModel(pred='nn')`` builds ``pred_layer`` with JAX's tree and
    shapes (concat(u, i) -> 128 -> 32 -> 1): xavier-uniform at gain sqrt(2)
    for the hidden layers and 1 for the output, zero biases."""
    jd, *_, params = _pair("mean", "sum", 3, True, pred="nn")
    tree = jax.tree.map(np.asarray, params)["params"]["pred_layer"]
    tm = ConvModel(jd.graph.canonical_etypes, DIMS, pred="nn",
                   generator=torch.Generator().manual_seed(3))
    mine = params_to_jax(tm.state_dict())["params"]["pred_layer"]
    assert jax.tree.structure(mine) == jax.tree.structure(tree)
    assert mine["hidden_1"]["kernel"].shape == (2 * 16, 128)
    for lin, gain in (("hidden_1", np.sqrt(2.0)), ("hidden_2", np.sqrt(2.0)), ("output", 1.0)):
        for leaf in ("kernel", "bias"):
            assert mine[lin][leaf].shape == tree[lin][leaf].shape, (lin, leaf)
        fan_in, fan_out = mine[lin]["kernel"].shape
        limit = gain * np.sqrt(6.0 / (fan_in + fan_out))
        assert 0.5 * limit < np.abs(mine[lin]["kernel"]).max() <= limit, lin
        assert (mine[lin]["bias"] == 0).all()


def test_unported_options_raise():
    et = (("user", "buys", "item"), ("item", "bought-by", "user"))
    with pytest.raises(KeyError):
        ConvModel(et, DIMS, aggregator_type="bogus")
    with pytest.raises(KeyError):
        ConvModel(et, DIMS, pred="bogus")
