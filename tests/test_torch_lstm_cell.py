"""The masked LSTM's cell update (``ops/cuda/lstm_cell.py``) on the CPU: the
module's plain version, its forward and its hand-written backward, against
autograd of the reducer's slot loop as PyTorch ops (the loop the fused cell
replaced, written out here); the reducer's route through the cell; the
benchmark's count and reader of the kernels' roofline share.  The card
holds the kernels against the plain version (``tests/test_torch_cuda_kernels.py``);
the JAX parity stays with ``tests/test_torch_lstm*.py``.

Tolerances: f32 within ``F32_TOL``, other orders of f32 sums (the bias
added after the recurrent product in place of inside it, the backward's
hand-written chain); f64 by ``torch.autograd.gradcheck``; bf16 forwards bit
for bit, and gradients no further from the f32 ones than the slot loop's
bf16 autograd, plus one bf16 ulp of the largest."""

from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from gnn_recsys_tpu_torch.models import layers
from gnn_recsys_tpu_torch.models.layers import MaskedLSTMReducer
from gnn_recsys_tpu_torch.ops.cuda import build
from gnn_recsys_tpu_torch.ops.cuda import lstm_cell as lc
from portbench.counts import lstm_cell as clc
from portbench.harness import core
from portbench.harness.trace import Trace

F32_TOL = 1e-6
IN_FEATS, FEATURES = 6, 5
METRIC = Path(__file__).resolve().parents[1] / "portbench" / "metrics" / "lstm_cell_roofline.py"


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sigmoid(x):
    """flax's gate sigmoid: bf16 as XLA expands it, each op rounded."""
    return 1.0 / (1.0 + torch.exp(-x)) if x.dtype == torch.bfloat16 else torch.sigmoid(x)


def _dense(lin, x, dtype):
    if dtype is None:
        return lin(x)
    y = F.linear(x.to(dtype), lin.weight.to(dtype))
    return y if lin.bias is None else y + lin.bias.to(dtype)


def slot_loop(red: MaskedLSTMReducer, msgs, mask):
    """The reducer's K steps as the port ran them before the fused cell:
    each product through ``dense``, the gate math and the freeze as PyTorch
    ops, differentiated by autograd."""
    n = msgs.shape[0]
    c = msgs.new_zeros((n, red.features))
    h = msgs.new_zeros((n, red.features))
    for x, m in zip(msgs.unbind(1), mask.unbind(1)):
        gates = _dense(red.ih, x, red.dtype) + _dense(red.hh, h, red.dtype)
        i, f, g, o = gates.chunk(4, dim=-1)
        c_new = _sigmoid(f) * c + _sigmoid(i) * torch.tanh(g)
        h_new = _sigmoid(o) * torch.tanh(c_new)
        m = m[:, None]
        c, h = torch.where(m, c_new, c), torch.where(m, h_new, h)
    return h


def make_mask(kind: str, n: int, k: int, seed: int) -> np.ndarray:
    """``holes``: random, one all-masked and one full row; ``last_only``:
    every other row valid at its last slot alone; ``all_masked``: no valid
    slot; ``k1``: one slot, random."""
    rng = np.random.default_rng(seed)
    mask = rng.random((n, k)) < 0.6
    if kind == "holes":
        mask[0], mask[1] = False, True
    elif kind == "last_only":
        mask[::2] = False
        mask[::2, -1] = True
    elif kind == "all_masked":
        mask[:] = False
    else:
        mask[0] = False
    return mask


MASKS = [("holes", 7, 4), ("last_only", 6, 5), ("all_masked", 4, 3), ("k1", 5, 1)]


def reducer_case(kind, n, k, dtype, msgs_dtype, seed=0):
    """A reducer with random weights (the bias too), its messages (zero
    where masked, as the model passes them), mask and output cotangent."""
    torch.manual_seed(seed)
    red = MaskedLSTMReducer(IN_FEATS, FEATURES, dtype=dtype)
    with torch.no_grad():
        for p in red.parameters():
            p.uniform_(-0.8, 0.8)
    mask = torch.as_tensor(make_mask(kind, n, k, seed))
    msgs = torch.randn(n, k, IN_FEATS) * mask[..., None]
    cot = torch.randn(n, FEATURES)
    return red, msgs.to(msgs_dtype), mask, cot


def out_and_grads(run, red, msgs, mask, cot):
    red.zero_grad()
    x = msgs.clone().requires_grad_()
    out = run(red, x, mask)
    (out.float() * cot).sum().backward()
    grads = {"msgs": x.grad.float()}
    grads.update({n: p.grad.float() for n, p in red.named_parameters()})
    return out.detach(), grads


@pytest.mark.parametrize("kind,n,k", MASKS)
def test_f32_reducer_equals_the_slot_loop(kind, n, k):
    red, msgs, mask, cot = reducer_case(kind, n, k, None, torch.float32)
    out, grads = out_and_grads(MaskedLSTMReducer.forward, red, msgs, mask, cot)
    want, wgrads = out_and_grads(slot_loop, red, msgs, mask, cot)
    torch.testing.assert_close(out, want, rtol=F32_TOL, atol=F32_TOL)
    for name, g in grads.items():
        torch.testing.assert_close(g, wgrads[name], rtol=F32_TOL, atol=F32_TOL, msg=name)
    if kind == "all_masked":
        assert not out.any() and all(not g.any() for g in grads.values())


def _ulp(x: torch.Tensor) -> float:
    """One bf16 ulp at ``x``'s largest magnitude."""
    top = float(x.abs().max())
    return 2.0 ** (np.floor(np.log2(top)) - 7) if top > 0 else 0.0


@pytest.mark.parametrize("msgs_dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32_msgs"])
@pytest.mark.parametrize("kind,n,k", MASKS)
def test_bf16_reducer_forward_bit_equal_gradients_no_worse(kind, n, k, msgs_dtype):
    """bf16 products; the carry in the messages' dtype (bf16, or f32 where
    the messages are f32: the mixed cell).  The reference gradients are
    the slot loop's in f32 on the same (rounded) messages and weights."""
    red, msgs, mask, cot = reducer_case(kind, n, k, torch.bfloat16, msgs_dtype, seed=1)
    out, grads = out_and_grads(MaskedLSTMReducer.forward, red, msgs, mask, cot)
    want, wgrads = out_and_grads(slot_loop, red, msgs, mask, cot)
    assert out.dtype == msgs_dtype and torch.equal(out, want)
    red32 = MaskedLSTMReducer(IN_FEATS, FEATURES)
    red32.load_state_dict({n_: p.to(torch.bfloat16).float() for n_, p in red.state_dict().items()})
    _, f32 = out_and_grads(slot_loop, red32, msgs.float(), mask, cot)
    for name, g in grads.items():
        gap = float((g - f32[name]).abs().max())
        own = float((wgrads[name] - f32[name]).abs().max())
        assert gap <= own + _ulp(f32[name]), (name, gap, own)


def cell_inputs(kind, n, h, dtype, seed=2):
    gen = torch.Generator().manual_seed(seed)
    xw, hw = (torch.randn(n, 4 * h, generator=gen, dtype=dtype) for _ in range(2))
    bias = torch.randn(4 * h, generator=gen, dtype=dtype)
    c, hh = (torch.randn(n, h, generator=gen, dtype=dtype) for _ in range(2))
    mask = torch.as_tensor(make_mask(kind, n, 3, seed))[:, -1]
    return xw, hw, bias, c, hh, mask


@pytest.mark.parametrize("kind,n,k", MASKS)
def test_cell_gradcheck_f64(kind, n, k):
    """The plain version's hand-written backward is the forward's
    derivative, through every input (both outputs used)."""
    xw, hw, bias, c, h, mask = cell_inputs(kind, n, 3, torch.float64)
    args = [t.requires_grad_() for t in (xw, hw, bias, c, h)]
    assert torch.autograd.gradcheck(lambda *a: lc.lstm_cell(*a, mask), args)


@pytest.mark.parametrize("kind,n,k", MASKS)
def test_reducer_gradcheck_f64(kind, n, k):
    red, msgs, mask, _ = reducer_case(kind, n, k, None, torch.float32, seed=3)
    red = red.double()
    x = msgs.double().requires_grad_()
    assert torch.autograd.gradcheck(lambda m: red(m, mask), [x])
    assert torch.autograd.gradcheck(
        lambda w_ih, w_hh, b: torch.func.functional_call(
            red, {"ih.weight": w_ih, "hh.weight": w_hh, "hh.bias": b}, (x.detach(), mask)),
        [p.detach().clone().requires_grad_() for p in red.parameters()])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_one_output_used_and_no_grad(dtype):
    """Where only h' takes a gradient (the last slot), the backward reads
    dc' as zero; without grad the forward saves nothing and gives the same
    carry."""
    xw, hw, bias, c, h, mask = cell_inputs("holes", 6, 4, dtype)
    args = [t.clone().requires_grad_() for t in (xw, hw, bias, c, h)]
    c_new, h_new = lc.lstm_cell(*args, mask)
    h_new.float().sum().backward()
    plain = [t.clone().requires_grad_() for t in (xw, hw, bias, c, h)]
    _, h_ref, _ = lc.lstm_cell_fwd_reference(*plain, mask)
    h_ref.float().sum().backward()
    assert torch.equal(h_new, h_ref)
    for got, want in zip(args, plain):
        torch.testing.assert_close(got.grad, want.grad, rtol=F32_TOL, atol=F32_TOL)
    with torch.no_grad():
        c2, h2 = lc.lstm_cell(xw, hw, bias, c, h, mask)
    assert c2.grad_fn is None
    assert torch.equal(c2, c_new.detach()) and torch.equal(h2, h_new.detach())


def test_every_slot_goes_through_the_cell(monkeypatch):
    """The reducer runs one cell update a slot, with the bias cast to the
    computation dtype once a call (every slot reads one copy)."""
    calls = []
    real_cell = layers.lstm_cell

    def cell(xw, hw, b, c, h, m):
        calls.append((xw.dtype, b.data_ptr()))
        return real_cell(xw, hw, b, c, h, m)

    monkeypatch.setattr(layers, "lstm_cell", cell)
    red, msgs, mask, _ = reducer_case("holes", 7, 4, torch.bfloat16, torch.bfloat16)
    red(msgs, mask)
    assert len(calls) == 4 and {d for d, _ in calls} == {torch.bfloat16}
    assert len({p for _, p in calls}) == 1


def slot_loop_cast_a_slot(red: MaskedLSTMReducer, msgs, mask):
    """The reducer's K steps through the same cell, with the weights and the
    bias cast a slot as ``dense`` casts them: autograd takes each slot's
    gradient back to f32 before it sums the slots."""
    dt, n = red.dtype, msgs.shape[0]
    c = msgs.new_zeros((n, red.features))
    h = msgs.new_zeros((n, red.features))
    for x, m in zip(msgs.unbind(1), mask.unbind(1)):
        xw = F.linear(x.to(dt), red.ih.weight.to(dt))
        hw = F.linear(h.to(dt), red.hh.weight.to(dt))
        c, h = lc.lstm_cell(xw, hw, red.hh.bias.to(dt), c, h, m)
    return h


@pytest.mark.parametrize("msgs_dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32_msgs"])
@pytest.mark.parametrize("kind", ["holes", "last_only"])
def test_bf16_parameter_gradients_sum_the_slots_in_f32(kind, msgs_dtype):
    """K = 8 in bf16: the f32 parameters' gradients are within one f32 ulp
    of the same cell's with the weights cast a slot, whose K slot
    gradients autograd sums in f32 (a sum in bf16 before one cast back is
    off by bf16 ulps)."""
    red, msgs, mask, cot = reducer_case(kind, 64, 8, torch.bfloat16, msgs_dtype, seed=4)
    _, grads = out_and_grads(MaskedLSTMReducer.forward, red, msgs, mask, cot)
    _, want = out_and_grads(slot_loop_cast_a_slot, red, msgs, mask, cot)
    for name, p in red.named_parameters():
        assert p.grad.dtype == torch.float32
        gap = (grads[name] - want[name]).abs()
        assert (gap <= want[name].abs() * 2.0**-23).all(), (name, float(gap.max()))


def test_cpu_wrappers_take_the_plain_version_and_counters_are_registered():
    counters = build.launch_counters()
    assert counters["lstm_cell_fwd"] is lc.lstm_cell_fwd
    assert counters["lstm_cell_bwd"] is lc.lstm_cell_bwd
    before = lc.lstm_cell_fwd.launches, lc.lstm_cell_bwd.launches
    xw, hw, bias, c, h, mask = cell_inputs("holes", 5, 4, torch.float32)
    args = [t.requires_grad_() for t in (xw, hw, bias, c, h)]
    c_new, h_new = lc.lstm_cell(*args, mask)
    (c_new.sum() + h_new.sum()).backward()
    assert (lc.lstm_cell_fwd.launches, lc.lstm_cell_bwd.launches) == before


@pytest.mark.parametrize("gates,carry", [(torch.bfloat16, torch.bfloat16),
                                         (torch.bfloat16, torch.float32),
                                         (torch.float32, torch.float32)])
def test_plain_backward_dtypes(gates, carry):
    xw, hw, bias, c, h, mask = cell_inputs("holes", 5, 4, torch.float32)
    c_new, _, acts = lc.lstm_cell_fwd_reference(xw.to(gates), hw.to(gates), bias.to(gates),
                                                c.to(carry), h.to(carry), mask)
    assert c_new.dtype == carry and acts.dtype == gates and acts.shape == (5, 16)
    dz, dc, dh = lc.lstm_cell_bwd_reference(acts, c.to(carry), c_new, mask, h.to(carry), None)
    assert (dz.dtype, dc.dtype, dh.dtype) == (gates, carry, carry)
    assert not dz[~mask].any() and not dh[mask].any()
    assert torch.equal(dh[~mask], h.to(carry)[~mask])


def roofline_ctx(**over):
    ctx = {"kind": "train", "steps": 4, "hidden": 256, "elem": 2,
           "lstm": {"row_slots_per_step": 1_011_712.0, "spans_per_step": 16.0},
           "trace": Trace(window_s=1.0, device=[
               (0.0, 0.008, "void lstm_cell_fwd_kernel<__nv_bfloat16, __nv_bfloat16, 8>"),
               (0.009, 0.021, "void lstm_cell_bwd_kernel<__nv_bfloat16, __nv_bfloat16, 8>"),
               (0.021, 0.5, "nvjet_tst_128x64")])}
    ctx.update(over)
    return ctx


def test_roofline_reader_and_count():
    read = core.load_module(METRIC, "portbench_metric_lstm_cell_roofline").read
    least = 1_011_712 * 21 * 256 * 2 / 3.35e12
    assert clc.step_bound_s(1_011_712, 256, 2) == pytest.approx(least)
    assert read(roofline_ctx()) == pytest.approx(100.0 * least * 4 / 0.020)
    assert 0 < read(roofline_ctx()) < 100


@pytest.mark.parametrize("over", [
    {"trace": Trace(window_s=1.0, device=[(0.0, 0.5, "nvjet_tst_128x64")])},
    {"lstm": {}}, {"lstm": {"row_slots_per_step": None}}, {"kind": "serve"}],
    ids=["no kernel", "untraced", "no counter", "serving"])
def test_roofline_reader_gives_nothing_without_kernel_or_counter(over):
    read = core.load_module(METRIC, "portbench_metric_lstm_cell_roofline").read
    assert read(roofline_ctx(**over)) is None
