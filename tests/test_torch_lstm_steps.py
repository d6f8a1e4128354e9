"""One minibatch training step of an LSTM model, the port against the JAX
package, on the sampled tree (this file) and the dedup'd block forward
(``tests/test_torch_lstm_dedup.py``): the same parameters, batch, pool and
draws, the loss and every gradient.

JAX's step is compiled once (an un-jitted step dispatches the LSTM's scan
op by op, about 40 s a case here); its draws are recorded inside the
program (``tests/test_torch_bf16.py:_recording``) and its gradients come
back as the state's parameters.  Tolerances: the loss within ``LOSS_RTOL``
relative, gradients within ``GRAD_RTOL`` relative + ``GRAD_ATOL``
(``tests/test_torch_minibatch.py``).  The graph has purchases only, which
halves JAX's compile (clicks add two etypes to every level)."""

import unittest.mock

import jax
import numpy as np
import optax
import pytest
import torch
from test_torch_bf16 import _recording
from test_torch_minibatch import (  # noqa: F401 (one_torch_thread: autouse)
    DATA_KW,
    GRAD_ATOL,
    GRAD_RTOL,
    LOSS_RTOL,
    _batch,
    one_torch_thread,
)

from gnn_recsys_tpu.models.conv_model import ConvModel as JConvModel
from gnn_recsys_tpu.ops.membership import build_padded_pair_set as jbuild_pairs
from gnn_recsys_tpu.train import full_batch as jfb
from gnn_recsys_tpu.train import minibatch as jmb
from gnn_recsys_tpu.utils.synthetic import make_synthetic_data as jmake
from gnn_recsys_tpu_torch.models.conv_model import ConvModel
from gnn_recsys_tpu_torch.models.convert import params_from_jax
from gnn_recsys_tpu_torch.ops.membership import build_padded_pair_set
from gnn_recsys_tpu_torch.ops.sampling import ReplayDraws
from gnn_recsys_tpu_torch.train import minibatch as tmb
from gnn_recsys_tpu_torch.utils.synthetic import make_synthetic_data

BUYS_ONLY = dict(DATA_KW, with_clicks=False)
DIMS = (("user", 8), ("item", 8), ("hidden", 16), ("out", 8))


def lstm_pair(agg, remat=False):
    """The same graph and JAX-initialised parameters in both packages; the
    JAX model with ``remat_levels`` where asked."""
    jd, td = jmake(**BUYS_ONLY), make_synthetic_data(**BUYS_ONLY)
    kw = dict(canonical_etypes=jd.graph.canonical_etypes, dims=DIMS, n_layers=3,
              aggregator_type=agg)
    jm = JConvModel(**kw, remat_levels=remat)
    jfeats = {nt: jd.graph.ndata[nt]["features"] for nt in jd.graph.ntypes}
    params = jfb.init_model(JConvModel(**kw), jd.graph, jfeats, seed=0)
    return jd, td, jm, kw, jfeats, params


def step_config(fanouts, dedup):
    return dict(edge_batch_size=32, fanouts=fanouts, neg_mode="dense_pool", neg_pool_size=24,
                neg_sample_size=24, dedup=dedup)


def jax_step(jd, jm, jfeats, params, cfg_kw):
    """JAX's compiled step: (loss, gradients as a port state dict, the
    recorded uniforms, randints)."""
    etypes = tuple(jd.train_pairs)
    jbatch, _ = _batch(jd.train_pairs)
    jtables = {et: jbuild_pairs(u, i, num_src=DATA_KW["num_users"])
               for et, (u, i) in jd.train_pairs.items()}

    def grads_as_params(self, *, grads, **kw):
        return self.replace(params=grads)

    uniforms, randints, patch = _recording()
    with patch, unittest.mock.patch.object(jfb.TrainState, "apply_gradients", grads_as_params):
        step = jmb.make_minibatch_step(jm, jmb.MinibatchConfig(**cfg_kw), etypes,
                                       with_update=True, with_exclusion=True,
                                       has_reverse={et: True for et in etypes}, jit=False)
        state = jfb.TrainState.create(apply_fn=jm.apply, params=params, tx=optax.adam(1e-3))
        grads, loss = jax.jit(step)(state, jd.graph, jfeats, jbatch, jtables,
                                    jax.random.PRNGKey(5))
        jax.effects_barrier()
    jgrads = params_from_jax(jax.tree.map(np.asarray, grads.params))
    return float(loss), jgrads, uniforms, randints


def port_step(td, kw, params, cfg_kw, draws, **model_kw):
    """The port's step from JAX's parameters: (loss, {name: gradient})."""
    model = ConvModel(**kw, **model_kw)
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    etypes = tuple(td.train_pairs)
    _, tbatch = _batch(td.train_pairs)
    tables = {et: build_padded_pair_set(u, i, num_src=DATA_KW["num_users"])
              for et, (u, i) in td.train_pairs.items()}
    step = tmb.make_minibatch_step(model, tmb.MinibatchConfig(**cfg_kw), etypes,
                                   with_update=True, with_exclusion=True,
                                   has_reverse={et: True for et in etypes})
    feats = {nt: td.graph.ndata[nt]["features"] for nt in td.graph.ntypes}
    _, loss = step(tmb.TrainState.create(model, lr=1e-3), td.graph, feats, tbatch, tables, draws)
    return float(loss), {n: (p.grad if p.grad is not None else torch.zeros_like(p))
                         for n, p in model.named_parameters()}


def assert_step_matches(loss, grads, jloss, jgrads):
    assert loss == pytest.approx(jloss, rel=LOSS_RTOL)
    assert sorted(grads) == sorted(jgrads)
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), jgrads[name].numpy(), rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg=name)


def check_lstm_step(agg, fanouts, dedup):
    jd, td, jm, kw, jfeats, params = lstm_pair(agg)
    cfg_kw = step_config(fanouts, dedup)
    jloss, jgrads, uniforms, randints = jax_step(jd, jm, jfeats, params, cfg_kw)
    draws = ReplayDraws(uniforms, randints)
    loss, grads = port_step(td, kw, params, cfg_kw, draws)
    assert draws.exhausted
    assert any(n.endswith(".lstm.hh.weight") and g.abs().max() > 0 for n, g in grads.items())
    assert_step_matches(loss, grads, jloss, jgrads)


@pytest.mark.parametrize("agg,fanouts", [("lstm", (3, 2)), ("lstm_edge", (2, -1))])
def test_tree_step_matches_jax(agg, fanouts):
    """The tree step: batch-edge exclusion leaves holes in the masks, which
    the LSTM skips; ``lstm_edge`` weights its messages by occurrence."""
    check_lstm_step(agg, fanouts, dedup=False)
