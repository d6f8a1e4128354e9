"""The dedup'd block forward (``sampled_repr(dedup=True)``) and a dense-pool
training step through it, against the JAX package with JAX's draws replayed
(recorded as in ``test_torch_minibatch.py``).

Tolerances as in ``test_torch_minibatch.py``: representations within 1e-5
(f32, sums in another order); the loss within 1e-5 relative; gradients within
1e-4 relative + 1e-6 absolute; updated parameters within 2e-6 where
|g| > 1e-5 and within 2 * lr elsewhere."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from test_torch_minibatch import (
    DATA_KW,
    ET_BUYS,
    GRAD_ATOL,
    GRAD_RTOL,
    LOSS_RTOL,
    LR,
    REPR_TOL,
    _batch,
    _record_draws,
)

from gnn_recsys_tpu.models.conv_model import ConvModel as JConvModel
from gnn_recsys_tpu.ops.membership import build_padded_pair_set as jbuild_pairs
from gnn_recsys_tpu.train import full_batch as jfb
from gnn_recsys_tpu.train import minibatch as jmb
from gnn_recsys_tpu.utils.synthetic import make_synthetic_data as jmake
from gnn_recsys_tpu_torch.models.conv_model import ConvModel
from gnn_recsys_tpu_torch.models.convert import params_from_jax
from gnn_recsys_tpu_torch.ops.membership import build_padded_pair_set
from gnn_recsys_tpu_torch.ops.sampling import Draws, ReplayDraws
from gnn_recsys_tpu_torch.train import minibatch as tmb
from gnn_recsys_tpu_torch.utils.synthetic import make_synthetic_data

REVERSE_BUYS = ("item", "bought-by", "user")


def _pair(agg, sports=False):
    """The same graph, model and parameters in both packages; ``sports``
    adds a third node type and its two etypes."""
    data_kw = dict(DATA_KW, with_sports=sports)
    jd, td = jmake(**data_kw), make_synthetic_data(**data_kw)
    dims = (("user", 8), ("item", 8)) + ((("sport", 8),) if sports else ())
    kw = dict(canonical_etypes=jd.graph.canonical_etypes,
              dims=dims + (("hidden", 16), ("out", 8)), n_layers=3, aggregator_type=agg)
    jm, tm = JConvModel(**kw), ConvModel(**kw)
    jfeats = {nt: jd.graph.ndata[nt]["features"] for nt in jd.graph.ntypes}
    tfeats = {nt: td.graph.ndata[nt]["features"] for nt in td.graph.ntypes}
    params = jfb.init_model(jm, jd.graph, jfeats, seed=0)
    tm.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    return jd, td, jm, tm, jfeats, tfeats, params


@pytest.mark.parametrize("agg,fanouts,sports", [
    ("mean_nn", (4, 3), False),
    ("mean_nn", (-1, 3), False),
    ("mean", (3, 2), True),
    ("pool_nn_edge", (2, 3), False),
    ("mean_edge", (3, -1), False),
])
def test_dedup_sampled_repr_matches_jax(monkeypatch, agg, fanouts, sports):
    jd, td, jm, tm, jfeats, tfeats, params = _pair(agg, sports)
    # Duplicate seeds and a frontier that exceeds the graph (capacity capped
    # by the node count, then rounded up to 8).
    seeds = {"user": np.array([0, 3, 3, 7, 1, 0, 11, 39, 3, 5], dtype=np.int32),
             "item": np.arange(24, dtype=np.int32).reshape(6, 4) % 17}
    excl = {ET_BUYS: np.arange(6, dtype=np.int32), REVERSE_BUYS: np.arange(6, dtype=np.int32)}
    uniforms, _ = _record_draws(monkeypatch)
    jout = jm.apply(params, jd.graph, jfeats, {k: jnp.asarray(v) for k, v in seeds.items()},
                    fanouts, jax.random.PRNGKey(7),
                    exclude_eids={k: jnp.asarray(v) for k, v in excl.items()}, dedup=True,
                    method=jm.sampled_repr)
    assert len(uniforms) > 0
    tm.eval()
    draws = ReplayDraws(uniforms)
    tout = tm.sampled_repr(td.graph, tfeats, {k: torch.as_tensor(v) for k, v in seeds.items()},
                           fanouts, draws, dedup=True,
                           exclude_eids={k: torch.as_tensor(v) for k, v in excl.items()})
    assert draws.exhausted
    for nt in seeds:
        assert tuple(tout[nt].shape) == jout[nt].shape
        np.testing.assert_allclose(tout[nt].detach().numpy(), np.asarray(jout[nt]),
                                   rtol=0, atol=REPR_TOL)


def test_dedup_duplicate_seeds_identical_rows():
    """Each unique node is computed once: duplicated seeds give bit-identical
    rows (``tests/test_sampling.py:157-178``); the tree samples each
    occurrence on its own."""
    _, td, _, tm, _, tfeats, _ = _pair("mean")
    tm.eval()
    seeds = {"user": torch.tensor([5, 9, 5, 5, 9])}
    h = tm.sampled_repr(td.graph, tfeats, seeds, (3, 3), Draws(torch.Generator().manual_seed(7)),
                        dedup=True)["user"].detach()
    assert torch.equal(h[0], h[2]) and torch.equal(h[0], h[3]) and torch.equal(h[1], h[4])
    assert not torch.equal(h[0], h[1])
    tree = tm.sampled_repr(td.graph, tfeats, seeds, (3, 3),
                           Draws(torch.Generator().manual_seed(7)))["user"].detach()
    assert not torch.equal(tree[0], tree[2])


@pytest.mark.parametrize("agg", ["mean_nn", "pool_nn", "mean_edge"])
def test_dedup_matches_tree_at_full_fanout(agg):
    """With fanout -1 both paths aggregate the same full rows
    (``tests/test_sampling.py:181``)."""
    _, td, _, tm, _, tfeats, _ = _pair(agg, sports=True)
    tm.eval()
    seeds = {"user": torch.tensor([0, 1, 2, 2]), "item": torch.tensor([3, 3, 4])}
    draws = Draws(torch.Generator().manual_seed(1))
    h_d = tm.sampled_repr(td.graph, tfeats, seeds, (-1, -1), draws, dedup=True)
    h_t = tm.sampled_repr(td.graph, tfeats, seeds, (-1, -1), draws)
    for nt in seeds:
        torch.testing.assert_close(h_d[nt], h_t[nt], rtol=0, atol=REPR_TOL)


def test_dedup_dense_pool_step_matches_jax(monkeypatch):
    """One training step through the dedup'd block forward (dense pool,
    batch-edge exclusion, false-negative mask, max-margin, Adam) from the same
    parameters, pool and draws."""
    jd, td, jm, tm, jfeats, tfeats, params = _pair("mean_nn")
    etypes = tuple(jd.train_pairs)
    has_reverse = {et: True for et in etypes}
    cfg_kw = dict(edge_batch_size=32, fanouts=(3, 3), neg_mode="dense_pool",
                  neg_pool_size=24, neg_sample_size=24, dedup=True)
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

    state = tmb.TrainState.create(tm, lr=LR)
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
