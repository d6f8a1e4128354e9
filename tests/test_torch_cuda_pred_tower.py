"""The MLP head's tower kernels (``ops/cuda/pred_tower.py``) against their
plain version, on the card.

Marked ``cuda``; without a card every test skips (the decision is made in a
fixture).  On a CUDA host, without JAX installed::

    python -m pytest --noconftest -p no:cacheprovider -q -m cuda \
        tests/test_torch_cuda_pred_tower.py

Tolerances.  Scores, both types: 1e-5 (the kernels and the plain version
round h1 alike and sum layer 2 in f32 in another order).  Gradients in f32:
1e-4 of each tensor's largest entry (sums of up to 2.6M per-pair terms of
either sign in another order), on inputs whose biases keep every
pre-activation of layers 1 and 2 at least 0.2 from zero: a ReLU that the two
orders of a sum switch is a discrete change, not a rounding (on free
inputs one such switch put dA_u 0.0086 of its largest entry off).
Gradients in bf16, on free inputs: 1e-2 of each tensor's
norm, by the norm of the difference: the kernels round dz2 to bf16 as the
tensor cores' operand, the plain version rounds dz2 W2 to bf16, about 2^-9
of each per-pair term either way.
"""

import pytest
import torch

from gnn_recsys_tpu_torch.models.layers import PredictingLayer
from gnn_recsys_tpu_torch.ops.cuda import build
from gnn_recsys_tpu_torch.ops.cuda import pred_tower as pt

pytestmark = pytest.mark.cuda

SHAPES = [(1, 1), (37, 1001), (64, 2560), (1024, 2560)]
DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _case(dev, b, p, dtype, seed=0, margin=False):
    """a_u, a_i (f32), the head's parameters in ``dtype`` (leaves that take
    a gradient), and the scores' gradient: the scales of a trained head.
    With ``margin``, small products under biases of +-0.5, b2 set against
    layer 2's product at relu(b1): no pre-activation of layers 1 and 2
    comes near zero."""
    gen = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape, scale=1.0):
        return scale * torch.randn(*shape, generator=gen, device=dev)

    scale = 0.02 if margin else 0.7
    a_u, a_i = randn(b, pt.H1, scale=scale), randn(p, pt.H1, scale=scale)
    b1, w2 = randn(pt.H1, scale=0.3), randn(pt.H2, pt.H1, scale=0.17)
    b2, w3, b3 = randn(pt.H2, scale=0.3), randn(pt.H2, scale=0.4), randn(1, scale=0.3)
    if margin:
        b1 = 0.5 * b1.sign()
        b2 = 0.5 * b2.sign() - w2.to(dtype).float() @ torch.relu(b1)
    params = [t.to(dtype) for t in (b1, w2, b2, w3, b3)]
    ds = torch.randn(b, p, generator=gen, device=dev)
    return [t.requires_grad_() for t in (a_u, a_i, *params)], ds


def _gap(got, want, norm: bool) -> float:
    d, w = got.double() - want.double(), want.double()
    if norm:
        return float(d.norm() / w.norm().clamp_min(1e-300))
    return float(d.abs().max() / w.abs().max().clamp_min(1e-300))


@pytest.mark.parametrize("b,p", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_kernels_match_the_plain_version(dev, dtype, b, p):
    args, ds = _case(dev, b, p, dtype, seed=b + p, margin=dtype == torch.float32)
    s = pt.pred_tower_fwd(*args)
    want = pt.pred_tower_reference(*args).detach()
    assert s.dtype == torch.float32 and s.shape == (b, p)
    assert float((s - want).abs().max()) <= 1e-5
    got = pt.pred_tower_bwd(ds, s, *args)
    ref = pt.pred_tower_bwd_reference(ds, *args)
    for i, (g, r, x) in enumerate(zip(got, ref, args)):
        assert g.dtype == x.dtype and g.shape == x.shape, i
        if dtype == torch.float32:
            assert _gap(g, r, norm=False) <= 1e-4, i
        else:
            assert _gap(g, r, norm=True) <= 1e-2, i


@pytest.mark.parametrize("dtype", DTYPES)
def test_two_runs_give_the_same_bits(dev, dtype):
    args, ds = _case(dev, 300, 2100, dtype, seed=5)
    s1, s2 = pt.pred_tower_fwd(*args), pt.pred_tower_fwd(*args)
    assert torch.equal(s1, s2)
    for g1, g2 in zip(pt.pred_tower_bwd(ds, s1, *args), pt.pred_tower_bwd(ds, s1, *args)):
        assert torch.equal(g1, g2)


@pytest.mark.parametrize("dtype", DTYPES)
def test_kernels_run_on_every_card(dev, dtype):
    """One process launches on each card in turn, the first card current
    throughout (each card's context needs the kernels' shared-memory limit):
    every card's scores and gradients equal the first card's, bit for bit."""
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs two CUDA devices")
    args, ds = _case(dev, 300, 2100, dtype, seed=11)
    s = pt.pred_tower_fwd(*args)
    grads = pt.pred_tower_bwd(ds, s, *args)
    for i in range(1, n):
        there = torch.device("cuda", i)
        on = [t.detach().to(there) for t in args]
        s_i = pt.pred_tower_fwd(*on)
        assert s_i.device == there and torch.equal(s_i.cpu(), s.cpu()), i
        for g_i, g in zip(pt.pred_tower_bwd(ds.to(there), s_i, *on), grads):
            assert g_i.device == there and torch.equal(g_i.cpu(), g.cpu()), i


def test_counters_and_the_route(dev):
    """Each wrapper counts one launch a call; ``score_cross`` on the card runs
    the kernels and counts its pairs in both counters; the launch counters
    are in the registry."""
    counters = build.launch_counters()
    assert counters["pred_tower_fwd"] is pt.pred_tower_fwd
    assert counters["pred_tower_bwd"] is pt.pred_tower_bwd
    layer = PredictingLayer(256, dtype=torch.bfloat16).to(dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    u = torch.randn(40, 128, generator=gen, device=dev).bfloat16().requires_grad_()
    items = torch.randn(700, 128, generator=gen, device=dev).bfloat16().requires_grad_()
    before = (pt.pred_tower_fwd.launches, pt.pred_tower_bwd.launches, pt.pred_tower.pairs,
              PredictingLayer.pairs)
    s = layer.score_cross(u, items)
    s.sum().backward()
    torch.cuda.synchronize()
    after = (pt.pred_tower_fwd.launches, pt.pred_tower_bwd.launches, pt.pred_tower.pairs,
             PredictingLayer.pairs)
    assert [a - b for a, b in zip(after, before)] == [1, 1, 40 * 700, 40 * 700]
    assert u.grad.dtype == torch.bfloat16 and torch.isfinite(u.grad.float()).all()
    with torch.no_grad():
        want = layer(torch.cat(torch.broadcast_tensors(u[:, None], items[None]), -1))[..., 0]
    assert float((s.detach() - want.float()).abs().max()) <= 0.02  # bf16's rounding of s


def test_wrapper_raises_on_what_the_kernels_do_not_take(dev):
    args, ds = _case(dev, 8, 8, torch.bfloat16)
    narrow = [args[0][:, :64].detach(), args[1][:, :64].detach(), *args[2:]]
    with pytest.raises(ValueError):
        pt.pred_tower_fwd(*narrow)
    mixed = [*args[:3], args[3].detach().float(), *args[4:]]
    with pytest.raises(ValueError):
        pt.pred_tower_fwd(*mixed)
    with pytest.raises(ValueError):
        pt.pred_tower_fwd(args[0].detach().bfloat16(), *args[1:])


@pytest.mark.parametrize("dtype", DTYPES)
def test_graph_replay_equals_the_eager_call(dev, dtype):
    """Forward and backward captured as a CUDA graph: the replay equals the
    eager call bit for bit and adds no launch to the counters."""
    args, ds = _case(dev, 1024, 2560, dtype, seed=3)

    def call():
        for t in args:
            t.grad = None
        s = pt.pred_tower(*args)
        (s * ds).sum().backward()
        return s

    eager = call().detach().clone()
    grads = [t.grad.clone() for t in args]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            call()
    torch.cuda.current_stream().wait_stream(side)
    for t in args:
        t.grad = None
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = pt.pred_tower(*args)
        (out * ds).sum().backward()
    launched = pt.pred_tower_fwd.launches, pt.pred_tower_bwd.launches
    for t in args:
        t.grad.zero_()
    graph.replay()
    torch.cuda.synchronize()
    assert (pt.pred_tower_fwd.launches, pt.pred_tower_bwd.launches) == launched
    assert torch.equal(out, eager)
    for t, want in zip(args, grads):
        assert torch.equal(t.grad, want)
