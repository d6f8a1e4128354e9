"""The serving slice end to end on the CPU: the port against the JAX package.

The same synthetic graph and the same (JAX-initialised) weights are saved as
a JAX run and as a port run; ``inference_ondemand`` must return the same
recommendation lists, ``get_recs`` the same ids on every route and
``get_metrics_at_k`` the same metrics.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnn_recsys_tpu.config import HyperParams as JHyperParams
from gnn_recsys_tpu.inference import inference_ondemand as j_inference
from gnn_recsys_tpu.models.conv_model import ConvModel as JConvModel
from gnn_recsys_tpu.ops.membership import build_padded_pair_set as jpairs
from gnn_recsys_tpu.retrieval.metrics import get_metrics_at_k as j_metrics
from gnn_recsys_tpu.retrieval.recs import get_recs as j_get_recs
from gnn_recsys_tpu.train.checkpoint import save_run as j_save_run
from gnn_recsys_tpu.train.full_batch import init_model
from gnn_recsys_tpu.utils.synthetic import make_synthetic_data as jmake
from gnn_recsys_tpu_torch.config import HyperParams
from gnn_recsys_tpu_torch.inference import inference_ondemand
from gnn_recsys_tpu_torch.models.convert import params_from_jax
from gnn_recsys_tpu_torch.ops.membership import build_padded_pair_set
from gnn_recsys_tpu_torch.retrieval.metrics import get_metrics_at_k
from gnn_recsys_tpu_torch.retrieval.recs import get_recs
from gnn_recsys_tpu_torch.train.checkpoint import load_run, save_run
from gnn_recsys_tpu_torch.utils.synthetic import make_synthetic_data

MODEL_KWARGS = {
    "dims": [["user", 8], ["item", 8], ["hidden", 32], ["out", 16]],
    "n_layers": 3, "norm": True, "dropout": 0.0, "aggregator_type": "mean_nn",
    "pred": "cos", "aggregator_hetero": "sum", "embedding_layer": True,
}


@pytest.fixture(autouse=True)
def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(JAX run dir, port run dir) over one 200-user / 100-item graph."""
    kw = dict(num_users=200, num_items=100, seed=7)
    jd, td = jmake(**kw), make_synthetic_data(**kw)
    pop = np.random.default_rng(7).uniform(0, 0.05, 100).astype(np.float32)
    jd.graph.ndata["item"]["popularity"] = jnp.asarray(pop)[:, None]
    td.graph.ndata["item"]["popularity"] = torch.from_numpy(pop)[:, None]
    model_kwargs = dict(MODEL_KWARGS,
                        canonical_etypes=[list(e) for e in jd.graph.canonical_etypes])
    jm = JConvModel(canonical_etypes=jd.graph.canonical_etypes,
                    dims=tuple(tuple(d) for d in MODEL_KWARGS["dims"]),
                    **{k: v for k, v in MODEL_KWARGS.items() if k != "dims"})
    feats = {nt: jd.graph.ndata[nt]["features"] for nt in jd.graph.ntypes}
    params = init_model(jm, jd.graph, feats, seed=3)
    jdir = str(tmp_path_factory.mktemp("jax_run"))
    tdir = str(tmp_path_factory.mktemp("port_run"))
    j_save_run(jdir, params, model_kwargs, hyper_params=JHyperParams(), graph=jd.graph)
    save_run(tdir, params_from_jax(jax.tree.map(np.asarray, params)), model_kwargs,
             hyper_params=HyperParams(), graph=td.graph)
    return jdir, tdir


@pytest.mark.parametrize("users", [[0, 5, 17, 199], "all"])
@pytest.mark.parametrize("remove_bought", [True, False])
@pytest.mark.parametrize("use_popularity", [None, False, True])
def test_inference_ondemand_same_lists(runs, users, remove_bought, use_popularity):
    jdir, tdir = runs
    kw = dict(k=7, remove_already_bought=remove_bought, use_popularity=use_popularity)
    ref = j_inference(jdir, users, **kw)
    out = inference_ondemand(tdir, users, device="cpu", **kw)
    assert out == ref


def test_port_run_round_trip_and_orbax_refusal(runs):
    jdir, tdir = runs
    run = load_run(tdir)
    assert run["hyper_params"]["popularity_importance"] == "no"
    assert "layer0_user__buys__item.fc_preagg.weight" in run["params"]
    assert os.path.exists(os.path.join(tdir, "params.npz"))
    with pytest.raises(ValueError, match="orbax"):
        load_run(jdir)


def test_entry_point_defaults_to_the_card(runs):
    if torch.cuda.is_available():
        pytest.skip("checks the default device on a host without a card")
    with pytest.raises((RuntimeError, AssertionError)):
        inference_ondemand(runs[1], [0, 1])


def _recs_case(case):
    """(user emb, item emb, bought users, bought items, k) for one case."""
    rng = np.random.default_rng(11)
    n_items = {"overfetch": 90, "overfetch_short": 40, "hub": 400}[case]
    ue = rng.normal(size=(30, 16)).astype(np.float32)
    ie = rng.normal(size=(n_items, 16)).astype(np.float32)
    ab_u = rng.integers(0, 30, 60).astype(np.int32)
    ab_i = rng.integers(0, n_items, 60).astype(np.int32)
    if case != "overfetch":
        # user 0 bought all but 3 items: fewer than k unbought (-1 slots);
        # in the hub case user 1's row is also wider than 256.
        keep = n_items - 3
        ab_u = np.concatenate([ab_u, np.zeros(keep, np.int32)])
        ab_i = np.concatenate([ab_i, rng.permutation(n_items)[:keep].astype(np.int32)])
        if case == "hub":
            ab_u = np.concatenate([ab_u, np.ones(300, np.int32)])
            ab_i = np.concatenate([ab_i, rng.permutation(n_items)[:300].astype(np.int32)])
    return ue, ie, ab_u, ab_i, 7


@pytest.mark.parametrize("case", ["overfetch", "overfetch_short", "hub"])
@pytest.mark.parametrize("boost", [False, True])
def test_get_recs_routes_match_jax(case, boost):
    ue, ie, ab_u, ab_i, k = _recs_case(case)
    pop = np.random.default_rng(12).uniform(0, 0.1, ie.shape[0]).astype(np.float32)
    uids = np.arange(30, dtype=np.int32)
    jps, tps = jpairs(ab_u, ab_i, num_src=30), build_padded_pair_set(ab_u, ab_i, num_src=30)
    assert (case == "hub") == (tps.max_row > 256)
    jkw = dict(already_bought=jps, popularity=jnp.asarray(pop) if boost else None,
               weight_popularity=3.0)
    tkw = dict(already_bought=tps, popularity=torch.from_numpy(pop) if boost else None,
               weight_popularity=3.0)
    for jb, tb in (("xla", "torch"), ("pallas", "cuda")):
        ref = np.asarray(j_get_recs(jnp.asarray(ue), jnp.asarray(ie), jnp.asarray(uids), k,
                                    backend=jb, **jkw))
        out = get_recs(torch.from_numpy(ue), torch.from_numpy(ie), torch.from_numpy(uids),
                       k, backend=tb, **tkw)
        np.testing.assert_array_equal(out.numpy(), ref, err_msg=f"{jb} vs {tb}")
    if case != "overfetch":
        assert (out[0] == -1).sum() == k - 3
    banned = set(zip(ab_u.tolist(), ab_i.tolist()))
    assert not any((u, i) in banned for u, row in enumerate(out.tolist()) for i in row)


@pytest.mark.parametrize("backend", ["auto", "cuda"])
@pytest.mark.parametrize("boost", [False, True])
def test_get_metrics_at_k_matches_jax(backend, boost):
    data = make_synthetic_data(num_users=200, num_items=100, seed=9)
    rng = np.random.default_rng(9)
    ue = rng.normal(size=(200, 16)).astype(np.float32)
    ie = rng.normal(size=(100, 16)).astype(np.float32)
    pop = rng.uniform(0, 0.1, 100).astype(np.float32)
    bought = data.train_pairs[("user", "buys", "item")]
    ref = j_metrics(jnp.asarray(ue), jnp.asarray(ie), data.test_ground_truth, bought, 10,
                    popularity=jnp.asarray(pop) if boost else None)
    out = get_metrics_at_k(torch.from_numpy(ue), torch.from_numpy(ie),
                           data.test_ground_truth, bought, 10, backend=backend,
                           popularity=torch.from_numpy(pop) if boost else None)
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6)
    assert out[1] > 0
