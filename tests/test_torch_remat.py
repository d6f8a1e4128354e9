"""``remat_levels``: the port's rematerialised tree step against its plain
step and against the JAX package's remat step (``tests/test_minibatch.py``'s
``test_remat_levels_identical_loss_and_grads``, mirrored), on an LSTM model,
whose per-slot gate activations are what remat stops keeping.

JAX's remat step draws its neighbours again in the backward, from the same
keys: the recorder sees the forward's draws, then the recomputes' copies,
and the port's steps take the forward's.  The port's remat step replays its
own draws (and dropout masks) in the recompute, so it equals its plain step
bit for bit, at dropout 0 and above; against JAX, the tolerances of ``tests/test_torch_minibatch.py``."""

import numpy as np
import pytest
import torch
from test_torch_lstm_steps import (
    assert_step_matches,
    jax_step,
    lstm_pair,
    port_step,
    step_config,
)
from test_torch_minibatch import _small_world, one_torch_thread  # noqa: F401 (autouse)

from gnn_recsys_tpu_torch.models import conv_model, layers
from gnn_recsys_tpu_torch.models.conv_model import ConvModel
from gnn_recsys_tpu_torch.ops.sampling import Draws, ReplayDraws


def test_remat_step_matches_plain_and_jax(monkeypatch):
    jd, td, jm, kw, jfeats, params = lstm_pair("lstm", remat=True)
    cfg_kw = step_config((3, 2), dedup=False)
    jloss, jgrads, uniforms, randints = jax_step(jd, jm, jfeats, params, cfg_kw)
    plain_draws = ReplayDraws(uniforms, randints)
    plain = port_step(td, kw, params, cfg_kw, plain_draws)
    n = len(uniforms) - len(plain_draws._uniforms)  # the forward's draws
    # JAX's recompute drew copies of its forward's numbers.
    assert len(uniforms) > n and all(any(np.array_equal(u, f) for f in uniforms[:n])
                                     for u in uniforms[n:])
    calls = []
    orig = conv_model.checkpoint
    monkeypatch.setattr(conv_model, "checkpoint",
                        lambda fn, *a, **k: calls.append(1) or orig(fn, *a, **k))
    draws = ReplayDraws(uniforms[:n], randints)
    remat = port_step(td, kw, params, cfg_kw, draws, remat_levels=True)
    assert draws.exhausted and calls
    assert remat[0] == plain[0]
    for name, g in remat[1].items():
        assert torch.equal(g, plain[1][name]), name
    assert_step_matches(*remat, jloss, jgrads)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dropout_scales_the_kept_entries(dtype):
    """``layers.dropout``: each kept entry of the output and of the gradient
    is the f32 product with 1 / (1 - p), rounded once to the dtype; the
    rest are 0; about 1 - p of the entries are kept."""
    p = 0.4
    torch.manual_seed(0)
    x = torch.randn(20_000).to(dtype).requires_grad_()
    grad = torch.randn(20_000).to(dtype)
    keep = layers.dropout_keep_mask(x, p)
    out = layers.dropout(x, p, lambda like, q: keep)
    out.backward(grad)
    assert keep.dtype == torch.bool and abs(keep.float().mean().item() - (1 - p)) < 0.02
    for got, src in ((out, x), (x.grad, grad)):
        want = torch.where(keep, src.detach().float() * (1.0 / (1.0 - p)), 0.0).to(dtype)
        assert got.dtype == dtype and torch.equal(got, want)


def test_remat_step_matches_plain_step_with_dropout():
    """At dropout 0.4 both steps draw their keep masks through the one
    dropout of the layers, from the default generator in the same order:
    under one ``torch.manual_seed`` and the same draws, the remat step's loss
    and every gradient equal the plain step's bit for bit."""
    _, td, _, kw, _, params = lstm_pair("lstm")
    cfg_kw = step_config((3, 2), dedup=False)

    def step(remat_levels):
        torch.manual_seed(5)
        return port_step(td, kw, params, cfg_kw, Draws(torch.Generator().manual_seed(0)),
                         dropout=0.4, remat_levels=remat_levels)

    plain, remat = step(False), step(True)
    assert remat[0] == plain[0]
    assert sorted(remat[1]) == sorted(plain[1])
    for name, g in remat[1].items():
        assert torch.equal(g, plain[1][name]), name
    torch.manual_seed(6)
    other = port_step(td, kw, params, cfg_kw, Draws(torch.Generator().manual_seed(0)),
                      dropout=0.4)
    assert other[0] != plain[0]  # the masks did change the step


def test_remat_replays_dropout_masks(monkeypatch):
    """With dropout, the recompute reuses the forward's keep masks: the
    remat step's gradients equal those of the same walk run without a
    checkpoint (same draws, same default-generator seed); without the
    replay the recompute would draw new masks.  No remat under no_grad."""
    data, g, _, feats = _small_world(30, 20)
    kw = dict(canonical_etypes=g.canonical_etypes,
              dims=(("user", 8), ("item", 8), ("hidden", 16), ("out", 8)), n_layers=3,
              aggregator_type="lstm", dropout=0.4, remat_levels=True)
    seeds = {"user": torch.arange(6), "item": torch.arange(5)}

    def grads(**patch):
        for name, fn in patch.items():
            monkeypatch.setattr(conv_model, name, fn)
        model = ConvModel(**kw, generator=torch.Generator().manual_seed(1))
        model.train()
        torch.manual_seed(3)
        out = model.sampled_repr(g, feats, seeds, (3, 2), Draws(torch.Generator().manual_seed(0)))
        sum(x.square().sum() for x in out.values()).backward()
        return {n: p.grad.clone() for n, p in model.named_parameters()}

    calls = []
    orig = conv_model.checkpoint
    remat = grads(checkpoint=lambda fn, *a, **k: calls.append(1) or orig(fn, *a, **k))
    direct = grads(checkpoint=lambda fn, *a, **k: fn(*a))
    assert calls
    for name, gr in remat.items():
        assert torch.equal(gr, direct[name]), name
    model = ConvModel(**kw)
    with torch.no_grad():
        calls.clear()
        model.sampled_repr(g, feats, seeds, (3, 2), Draws(torch.Generator().manual_seed(0)))
    assert not calls
