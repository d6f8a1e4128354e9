"""The MLP head's cross form (``PredictingLayer.score_cross``, the plain
version of ``ops/cuda/pred_tower.py``) against the unfactorised head on the
broadcast concat, on the CPU.  The kernels' own tests, on a card:
``tests/test_torch_cuda_pred_tower.py``.

Tolerances.  f64: the same sums in another order, 1e-10 of each tensor's
largest entry.  f32: against the unfactorised head in f64, 1e-5 of the
largest entry for the scores and 1e-4 for the gradients (sums of up to
163,840 per-pair terms of either sign: 2.2e-5 measured on W2's), on a head
whose biases keep every pre-activation of layers 1
and 2 at least 0.2 from zero: a ReLU that switches between f32 and f64 is a
discrete change, not a rounding (with free biases, such switches put the
f32 gradients up to 2e-3 off in either form).
bf16: the two forms round at different places (the unfactorised head rounds
layer 1's product, its bias sum, z2, h2, z3 and s to bf16; the cross form
rounds h1 only), so each is held to the f64 head on the same bf16 inputs,
and the cross form must be no farther from it than the unfactorised head,
by the relative norm of each difference, with a margin of 25% and 1e-3:
measured, the cross form is 0.7 to 1.1 times the unfactorised head's
distance (0.0007 to 0.062 against 0.0022 to 0.083).
"""

import pytest
import torch

from gnn_recsys_tpu_torch.models.layers import PredictingLayer
from gnn_recsys_tpu_torch.ops.cuda import pred_tower as pt

SHAPES = [(1, 1), (37, 1001), (64, 2560)]
D = 16  # the embedding's width: the head's input is the 32-wide concat


def _layer(dtype, seed, wide=None) -> PredictingLayer:
    """A head with nonzero biases; with ``dtype`` bf16, its parameters hold
    bf16 values, so that the f64 head computes on the same numbers."""
    layer = PredictingLayer(2 * D, dtype=dtype)
    layer.reset_parameters(torch.Generator().manual_seed(seed))
    with torch.no_grad():
        for lin in (layer.hidden_1, layer.hidden_2, layer.output):
            lin.bias.uniform_(-0.3, 0.3, generator=torch.Generator().manual_seed(seed + 1))
            if dtype is not None:
                for p in (lin.weight, lin.bias):
                    p.copy_(p.to(dtype).float())
    return layer.to(wide) if wide is not None else layer


def _as_f64(layer: PredictingLayer) -> PredictingLayer:
    out = PredictingLayer(2 * D).double()
    out.load_state_dict({k: v.double() for k, v in layer.state_dict().items()})
    return out


def _rows(b, p, dtype, seed):
    gen = torch.Generator().manual_seed(seed)
    u = torch.randn(b, D, generator=gen, dtype=torch.float64).to(dtype)
    items = torch.randn(p, D, generator=gen, dtype=torch.float64).to(dtype)
    return u.requires_grad_(), items.requires_grad_()


def _cross(layer, u, items):
    return layer.score_cross(u, items)


def _concat(layer, u, items):
    x = torch.cat(torch.broadcast_tensors(u[:, None, :], items[None, :, :]), dim=-1)
    return layer(x)[..., 0].float() if layer.dtype is not None else layer(x)[..., 0]


def _scores_and_grads(fn, layer, u, items, ds):
    """The scores and the gradients of u, items and the head's six
    parameters for the scores' gradient ``ds``."""
    s = fn(layer, u, items)
    grads = torch.autograd.grad(s, [u, items, *layer.parameters()], ds.to(s.dtype))
    return [s.detach()] + [g.detach() for g in grads]


def _gap(got, want, norm=False) -> float:
    d, w = got.double() - want.double(), want.double()
    if norm:
        return float(d.norm() / w.norm().clamp_min(1e-300))
    return float(d.abs().max() / w.abs().max().clamp_min(1e-300))


@pytest.mark.parametrize("b,p", SHAPES)
def test_cross_form_is_the_concat_head_in_f64(b, p):
    """The algebra: the same scores and gradients in f64."""
    layer = _layer(None, seed=b, wide=torch.float64)
    u, items = _rows(b, p, torch.float64, seed=p)
    ds = torch.randn(b, p, generator=torch.Generator().manual_seed(7), dtype=torch.float64)
    got = _scores_and_grads(_cross, layer, u, items, ds)
    want = _scores_and_grads(_concat, layer, u, items, ds)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == w.dtype and g.shape == w.shape, i
        assert _gap(g, w) <= 1e-10, i


def _far_from_zero(layer: PredictingLayer, seed: int) -> PredictingLayer:
    """Small products under biases of +-0.5, b2 set against layer 2's
    product of h1 at relu(b1): no pre-activation of layers 1 and 2 comes
    near zero."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        layer.hidden_1.weight.mul_(0.02)
        layer.hidden_1.bias.copy_(0.5 * torch.randn(pt.H1, generator=gen).sign())
        layer.hidden_2.weight.mul_(0.1)
        centre = layer.hidden_2.weight @ torch.relu(layer.hidden_1.bias)
        layer.hidden_2.bias.copy_(0.5 * torch.randn(pt.H2, generator=gen).sign() - centre)
    return layer


@pytest.mark.parametrize("b,p", SHAPES)
def test_cross_form_f32(b, p):
    """f32 scores and gradients within float tolerance of the f64 head."""
    layer = _far_from_zero(_layer(None, seed=b), seed=b)
    u, items = _rows(b, p, torch.float32, seed=p)
    with torch.no_grad():
        l64 = _as_f64(layer)
        w1 = l64.hidden_1.weight
        z1 = ((u.double() @ w1[:, :D].T + l64.hidden_1.bias)[:, None, :]
              + (items.double() @ w1[:, D:].T)[None, :, :])
        z2 = torch.relu(z1) @ l64.hidden_2.weight.T + l64.hidden_2.bias
        assert float(z1.abs().min()) > 0.2 and float(z2.abs().min()) > 0.2
    ds = torch.randn(b, p, generator=torch.Generator().manual_seed(7))
    got = _scores_and_grads(_cross, layer, u, items, ds)
    want = _scores_and_grads(_concat, _as_f64(layer), *(t.detach().double().requires_grad_()
                                                        for t in (u, items)), ds)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == torch.float32 and g.shape == w.shape, i
        assert _gap(g, w) <= (1e-5 if i == 0 else 1e-4), i


@pytest.mark.parametrize("b,p", SHAPES[1:])
def test_cross_form_bf16_no_farther_than_the_concat_head(b, p):
    """bf16: f32 scores; the gradients of the bf16 rows in bf16 and of the
    parameters in f32; each within the unfactorised bf16 head's distance
    (times 1.25, plus 1e-3) of the f64 head on the same inputs."""
    layer = _layer(torch.bfloat16, seed=b)
    u, items = _rows(b, p, torch.bfloat16, seed=p)
    ds = torch.randn(b, p, generator=torch.Generator().manual_seed(7))
    got = _scores_and_grads(_cross, layer, u, items, ds)
    old = _scores_and_grads(_concat, layer, u, items, ds)
    exact = _scores_and_grads(_concat, _as_f64(layer), *(t.detach().double().requires_grad_()
                                                         for t in (u, items)), ds)
    assert got[0].dtype == torch.float32
    assert got[1].dtype == got[2].dtype == torch.bfloat16
    for i, (g, o, e) in enumerate(zip(got, old, exact)):
        assert g.dtype == o.dtype and g.shape == e.shape, i
        assert _gap(g, e, norm=True) <= 1.25 * _gap(o, e, norm=True) + 1e-3, i


def test_pair_counters():
    """``PredictingLayer.pairs`` counts every scored pair on both forms;
    ``pred_tower.pairs`` the cross form's alone."""
    layer = _layer(torch.bfloat16, seed=3)
    u, items = _rows(37, 1001, torch.bfloat16, seed=4)
    head, tower = PredictingLayer.pairs, pt.pred_tower.pairs
    layer.score_cross(u, items)
    assert (PredictingLayer.pairs - head, pt.pred_tower.pairs - tower) == (37 * 1001,) * 2
    _concat(layer, u, items[:5])
    assert PredictingLayer.pairs - head == 37 * 1001 + 37 * 5
    assert pt.pred_tower.pairs - tower == 37 * 1001


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tower_function_is_the_plain_autograd(dtype):
    """On CPU tensors ``pred_tower`` runs its autograd Function over the
    plain forward and backward: the same bits as autograd through
    ``pred_tower_reference``; with no gradient wanted, the forward alone."""
    gen = torch.Generator().manual_seed(0)
    a_u = torch.randn(9, pt.H1, generator=gen).requires_grad_()
    a_i = torch.randn(13, pt.H1, generator=gen).requires_grad_()
    shapes = ((pt.H1,), (pt.H2, pt.H1), (pt.H2,), (pt.H2,), (1,))
    params = [(0.3 * torch.randn(s, generator=gen)).to(dtype).requires_grad_() for s in shapes]
    ds = torch.randn(9, 13, generator=gen)
    s = pt.pred_tower(a_u, a_i, *params)
    got = torch.autograd.grad(s, [a_u, a_i, *params], ds)
    want_s = pt.pred_tower_reference(a_u, a_i, *params)
    want = torch.autograd.grad(want_s, [a_u, a_i, *params], ds)
    assert torch.equal(s, want_s) and s.dtype == torch.float32
    for g, w, x in zip(got, want, [a_u, a_i, *params]):
        assert g.dtype == x.dtype and torch.equal(g, w)
    with torch.no_grad():
        assert torch.equal(pt.pred_tower(a_u, a_i, *params), want_s)
