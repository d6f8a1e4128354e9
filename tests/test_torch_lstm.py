"""The LSTM aggregators (``lstm``, ``lstm_edge``) of the port against the JAX
package: the masked reducer alone, in f32 and bf16, with its gradients; the
layer's reduction on every forward route; and a saved and reloaded LSTM
run (``train_full_batch``: ``tests/test_torch_lstm_full_batch.py``; the
training steps: ``tests/test_torch_lstm_steps.py``).  JAX's parameters
cross through ``params_from_jax``.

Tolerances: f32 outputs within ``ATOL`` (1e-5, ``tests/test_torch_model.py``),
losses within ``LOSS_RTOL`` and gradients within ``GRAD_RTOL`` relative +
``GRAD_ATOL`` (``tests/test_torch_minibatch.py``); bf16 as
``tests/test_torch_bf16.py`` holds a forward (``e <= E_OVER_G * g``: the gap
to JAX's bf16 output at most half the gap between JAX's bf16 and f32
outputs) and a gradient (within ``GRAD_REL`` of its largest entry)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_bf16 import E_OVER_G, _compiled
from test_torch_bf16 import GRAD_REL as BF16_GRAD_REL
from test_torch_minibatch import (  # noqa: F401 (one_torch_thread: autouse)
    GRAD_ATOL,
    GRAD_RTOL,
    one_torch_thread,
)
from test_torch_model import ATOL, DIMS

from gnn_recsys_tpu.models.conv_model import ConvModel as JConvModel
from gnn_recsys_tpu.models.layers import MaskedLSTMReducer as JReducer
from gnn_recsys_tpu.train import full_batch as jfb
from gnn_recsys_tpu.utils.synthetic import make_synthetic_data as jmake
from gnn_recsys_tpu_torch.inference import inference_ondemand
from gnn_recsys_tpu_torch.models import conv_model
from gnn_recsys_tpu_torch.models.conv_model import ConvModel
from gnn_recsys_tpu_torch.models.convert import params_from_jax, params_to_jax
from gnn_recsys_tpu_torch.models.layers import ConvLayer, MaskedLSTMReducer
from gnn_recsys_tpu_torch.ops.sampling import Draws
from gnn_recsys_tpu_torch.train.checkpoint import load_run, model_kwargs_to_config, save_run
from gnn_recsys_tpu_torch.utils.synthetic import make_synthetic_data

IN_FEATS, FEATURES = 6, 5  # a non-square cell: the packing's two widths differ


def _masks(n, k, seed):
    """Random masks with holes (the sampled tree's exclusion makes them),
    one all-masked row and one full row."""
    mask = np.random.default_rng(seed).random((n, k)) < 0.6
    mask[0] = False
    mask[1] = True
    return mask


def _reducer_case(n, k, seed, dtype):
    rng = np.random.default_rng(seed)
    msgs = rng.normal(size=(n, k, IN_FEATS)).astype(np.float32)
    mask = _masks(n, k, seed)
    msgs[~mask] = 0.0  # the model zeroes masked messages before the reducer
    cot = rng.normal(size=(n, FEATURES)).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else None
    jred = JReducer(FEATURES, dtype=jdt)
    params = jred.init(jax.random.PRNGKey(seed), jnp.asarray(msgs), jnp.asarray(mask))
    tred = MaskedLSTMReducer(IN_FEATS, FEATURES, dtype=dtype)
    tred.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    return msgs, mask, cot, jred, params, tred


def _jax_out_and_grads(jred, params, msgs, mask, cot, in_dtype, compiled):
    m = jnp.asarray(msgs, in_dtype)

    def loss(p, x):
        return jnp.sum(jred.apply(p, x, jnp.asarray(mask)).astype(jnp.float32) * cot)

    run = _compiled if compiled else (lambda f, *a: jax.jit(f)(*a))
    out = run(lambda p, x: jred.apply(p, x, jnp.asarray(mask)), params, m)
    gp, gx = run(jax.grad(loss, argnums=(0, 1)), params, m)
    return (np.asarray(out, np.float32), np.asarray(gx, np.float32),
            params_from_jax(jax.tree.map(np.asarray, gp)))


def _port_out_and_grads(tred, msgs, mask, cot, dtype):
    x = torch.tensor(msgs).to(dtype or torch.float32).requires_grad_()
    out = tred(x, torch.as_tensor(mask))
    (out.float() * torch.as_tensor(cot)).sum().backward()
    return out, x.grad.float(), {n: p.grad for n, p in tred.named_parameters()}


@pytest.mark.parametrize("n,k", [(7, 4), (5, 1)])
def test_reducer_matches_flax_f32(n, k):
    """Output and the gradients with respect to the messages and every gate
    weight, on masks with holes, an all-masked row (its state stays 0) and
    K = 1."""
    msgs, mask, cot, jred, params, tred = _reducer_case(n, k, seed=n * 10 + k, dtype=None)
    jout, jgx, jgp = _jax_out_and_grads(jred, params, msgs, mask, cot, jnp.float32, False)
    out, gx, gp = _port_out_and_grads(tred, msgs, mask, cot, None)
    assert out.shape == (n, FEATURES) and not out[0].any()
    np.testing.assert_allclose(out.detach().numpy(), jout, rtol=0, atol=ATOL)
    np.testing.assert_allclose(gx.numpy(), jgx, rtol=GRAD_RTOL, atol=GRAD_ATOL)
    assert set(gp) == set(jgp) == {"ih.weight", "hh.weight", "hh.bias"}
    for name, g in gp.items():
        np.testing.assert_allclose(g.numpy(), jgp[name].numpy(), rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=name)


def test_reducer_matches_flax_bf16():
    """bf16: rounded where flax's ``Dense(dtype=bfloat16)`` cell rounds (JAX
    compiled without excess precision), the carry in the messages' dtype;
    gradients within ``GRAD_REL`` of each one's largest entry."""
    msgs, mask, cot, jred, params, tred = _reducer_case(9, 4, seed=3, dtype=torch.bfloat16)
    jout, jgx, jgp = _jax_out_and_grads(jred, params, msgs, mask, cot, jnp.bfloat16, True)
    j32 = JReducer(FEATURES)
    ref = np.asarray(jax.jit(j32.apply)(params, jnp.asarray(msgs), jnp.asarray(mask)))
    out, gx, gp = _port_out_and_grads(tred, msgs, mask, cot, torch.bfloat16)
    assert out.dtype == torch.bfloat16
    e = float(np.abs(out.detach().float().numpy() - jout).max())
    g = float(np.abs(ref - jout).max())
    assert g > 0 and e <= E_OVER_G * g, (e, g)
    for got, want, name in [(gx, torch.as_tensor(jgx), "msgs")] + [
            (gp[n].float(), jgp[n], n) for n in gp]:
        scale = max(float(want.abs().max()), 1e-30)
        assert float((got - want).abs().max()) <= BF16_GRAD_REL * scale, name


def test_layer_reduces_with_the_lstm():
    """``ConvLayer('lstm').reducer`` is 'lstm', and the LSTM's width is the
    neighbour width, as in JAX (``layers.py:170-177``)."""
    for agg in ("lstm", "lstm_edge"):
        layer = ConvLayer(12, 7, 9, aggregator_type=agg)
        assert layer.reducer == "lstm" and layer.edge_weighted == agg.endswith("_edge")
        assert layer.lstm.ih.weight.shape == (4 * 12, 12)
        assert layer.lstm.hh.weight.shape == (4 * 12, 12)
    assert ConvLayer(4, 4, 4, aggregator_type="pool_nn").reducer == "max"
    assert ConvLayer(4, 4, 4, aggregator_type="mean_nn").reducer == "mean"


@pytest.mark.parametrize("agg", ["lstm", "lstm_edge"])
def test_no_lstm_route_runs_a_mean_or_max(monkeypatch, agg):
    """The full graph, the tree and the dedup'd block forward of an LSTM
    model reduce with the LSTM alone: the segment means and maxes, the
    gather-mean and the fused leaf are never called."""
    def refuse(*a, **k):
        raise AssertionError("an LSTM model ran a mean or a max")

    for name in ("coo_segment_mean", "coo_segment_max", "gather_mean", "leaf_mean_nn"):
        monkeypatch.setattr(conv_model, name, refuse)
    data = make_synthetic_data(num_users=30, num_items=20, seed=1)
    g = data.graph
    feats = {nt: g.ndata[nt]["features"] for nt in g.ntypes}
    model = ConvModel(g.canonical_etypes, DIMS, aggregator_type=agg, leaf_kernel=True)
    calls = []
    for mod in model.modules():
        if isinstance(mod, MaskedLSTMReducer):
            mod.register_forward_hook(lambda *a: calls.append(1))
    model.eval()
    with torch.no_grad():
        h = model(g, feats)
        seeds = {"user": torch.arange(5), "item": torch.arange(4)}
        trees = [model.sampled_repr(g, feats, seeds, (3, 2),
                                    Draws(torch.Generator().manual_seed(0)), dedup=d)
                 for d in (False, True)]
    assert calls
    for out in [h] + trees:
        assert all(torch.isfinite(x).all() for x in out.values())


def test_lstm_run_saves_under_flax_paths_and_serves(tmp_path):
    """``save_run`` writes an LSTM model's ``params.npz`` under JAX's own
    flax paths (``.../lstm/scan/cell/hi/kernel``), ``load_run`` gives the
    state dict back bit for bit, and the run serves on the CPU with the
    JAX-initialised weights."""
    jd = jmake(num_users=40, num_items=25, seed=4)
    td = make_synthetic_data(num_users=40, num_items=25, seed=4)
    kw = dict(canonical_etypes=jd.graph.canonical_etypes, dims=DIMS, n_layers=3,
              aggregator_type="lstm_edge")
    jm = JConvModel(**kw)
    jfeats = {nt: jd.graph.ndata[nt]["features"] for nt in jd.graph.ntypes}
    params = jax.tree.map(np.asarray, jfb.init_model(jm, jd.graph, jfeats, seed=0))
    tm = ConvModel(**kw)
    tm.load_state_dict(params_from_jax(params))
    run_kw = dict(kw, canonical_etypes=[list(e) for e in kw["canonical_etypes"]],
                  dims=[list(d) for d in DIMS])
    save_run(str(tmp_path), tm.state_dict(), run_kw, graph=td.graph)
    with np.load(os.path.join(tmp_path, "params.npz")) as z:
        keys = set(z.files)
    want = {"/".join(str(p.key) for p in path)
            for path, _ in jax.tree_util.tree_leaves_with_path(params)}
    assert keys == want
    assert "params/layer0_user__buys__item/lstm/scan/cell/hi/kernel" in keys
    run = load_run(str(tmp_path))
    assert sorted(run["params"]) == sorted(tm.state_dict())
    for name, t in tm.state_dict().items():
        assert torch.equal(run["params"][name], t), name
    back = ConvModel(**model_kwargs_to_config(run["model_kwargs"]))
    back.load_state_dict(run["params"])
    assert jax.tree.structure(params_to_jax(back.state_dict())) == jax.tree.structure(params)
    recs = inference_ondemand(str(tmp_path), [0, 3, 7], k=5, device="cpu")
    assert sorted(recs) == [0, 3, 7] and all(len(r) == 5 for r in recs.values())
