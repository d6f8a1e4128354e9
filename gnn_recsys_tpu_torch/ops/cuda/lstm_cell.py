"""The masked LSTM reducer's cell update: CUDA kernels, their plain
versions, the wrappers.

One slot of ``models/layers.py:MaskedLSTMReducer`` after its two products
(``xw = x W_ih^T`` and ``hw = h W_hh^T``, each in the gates' dtype)::

    z = xw + (hw + b);  i, f, g, o = sigma(z_i), sigma(z_f), tanh(z_g), sigma(z_o)
    c' = f c + i g;     h' = o tanh(c')
    (c_out, h_out) = (c', h') where mask, else (c, h)

with ``sigma`` as :func:`gate_sigmoid` computes it.  It replaces no Pallas
kernel: the JAX package's reducer is a plain ``nn.scan``
(``gnn_recsys_tpu/models/layers.py:79-109``).  :func:`lstm_cell` is a
``torch.autograd.Function`` whose forward and backward are the kernels of
``gnn_recsys_tpu_torch/csrc/lstm_cell.cu`` (its header says what bounds
them); gradients flow to ``xw``, ``hw``, ``b``, ``c`` and ``h``, and the
products' backward is autograd's.  The forward saves the four activations
``(i, f, g, o)`` ``[N, 4H]`` for the backward, which computes in f32 and
rounds only its outputs.  Each wrapper takes its plain version only for CPU
tensors; for CUDA tensors it launches its kernel or raises, and counts its
launches in ``.launches``.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from gnn_recsys_tpu_torch.ops.cuda import build
from gnn_recsys_tpu_torch.utils.profiling import counter

_LIB = "lstm_cell"
_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_DTYPES = (torch.float32, torch.bfloat16)


def _bind(lib: ctypes.CDLL) -> None:
    lib.lstm_cell_fwd_launch.argtypes = [_P, _P, _P, _P, _P, _P, _L, _I, _I, _I, _I,
                                         _P, _P, _P, _P]
    lib.lstm_cell_fwd_launch.restype = _I
    lib.lstm_cell_bwd_launch.argtypes = [_P, _P, _P, _P, _L, _P, _P, _I, _I, _I, _I,
                                         _P, _P, _P, _P]
    lib.lstm_cell_bwd_launch.restype = _I


def _lib() -> ctypes.CDLL:
    return build.load(_LIB, _bind)


def gate_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """An LSTM gate's sigmoid as flax computes it (``lax.logistic``): in bf16
    as XLA expands it, ``1 / (1 + exp(-x))`` with every op rounded to bf16
    (``torch.sigmoid`` rounds once, and differs in about a third of the
    values); ``torch.sigmoid`` otherwise."""
    if x.dtype == torch.bfloat16:
        return 1.0 / (1.0 + torch.exp(-x))
    return torch.sigmoid(x)


# ----------------------------------------------------------------------
# Plain versions
# ----------------------------------------------------------------------

def lstm_cell_fwd_reference(xw, hw, bias, c, h, mask, save: bool = True):
    """Plain version of the forward: ``(c_out, h_out, acts)``, every op
    rounded in its operands' promoted dtype; ``acts`` [N, 4H] (``i, f, g,
    o``) is None unless ``save``."""
    i, f, g, o = (xw + (hw + bias)).chunk(4, dim=-1)
    i, f, g, o = gate_sigmoid(i), gate_sigmoid(f), torch.tanh(g), gate_sigmoid(o)
    c_new = f * c + i * g
    h_new = o * torch.tanh(c_new)
    m = mask[:, None]
    acts = torch.cat((i, f, g, o), dim=-1) if save else None
    return torch.where(m, c_new, c), torch.where(m, h_new, h), acts


def lstm_cell_bwd_reference(acts, c, c_new, mask, dh_new, dc_new):
    """Plain version of the backward: ``(dz [N, 4H] in the gates' dtype, dc,
    dh)`` for the outputs' gradients ``dh_new`` and ``dc_new`` (None: a
    zero), computed in f32 (f64 stays f64) from the saved activations."""
    wide = torch.promote_types(acts.dtype, torch.float32)
    i, f, g, o = acts.to(wide).chunk(4, dim=-1)
    cw, tc = c.to(wide), torch.tanh(c_new.to(wide))
    zero = torch.zeros_like(cw)
    dh = zero if dh_new is None else dh_new.to(wide)
    dc = zero if dc_new is None else dc_new.to(wide)
    dct = dc + dh * o * (1 - tc * tc)
    dz = torch.cat((dct * g * i * (1 - i), dct * cw * f * (1 - f), dct * i * (1 - g * g),
                    dh * tc * o * (1 - o)), dim=-1)
    m = mask[:, None]
    dz = torch.where(m, dz, torch.zeros_like(dz)).to(acts.dtype)
    return dz, torch.where(m, dct * f, dc).to(c.dtype), torch.where(m, zero, dh).to(c.dtype)


# ----------------------------------------------------------------------
# Wrappers
# ----------------------------------------------------------------------

def _types(gates: torch.Tensor, carry: torch.Tensor) -> Tuple[int, int]:
    """(gate_bf16, carry_bf16) for the kernels; raises on what they do not
    take: f32 or bf16 gates and a carry of the gates' dtype or f32."""
    if gates.dtype not in _DTYPES or carry.dtype not in (gates.dtype, torch.float32):
        raise ValueError(f"the kernels take f32 or bf16 gates with a carry of their dtype or "
                         f"f32, got {gates.dtype} gates and a {carry.dtype} carry")
    return int(gates.dtype == torch.bfloat16), int(carry.dtype == torch.bfloat16)


def _check_mask(mask: torch.Tensor, n: int) -> None:
    if mask.dtype != torch.bool or mask.dim() != 1 or mask.shape[0] != n:
        raise ValueError(f"mask must be [{n}] bool, got {tuple(mask.shape)} {mask.dtype}")


def lstm_cell_fwd(xw, hw, bias, c, h, mask, save: bool = True):
    """Forward: ``(c_out, h_out, acts)``.  xw, hw: [N, 4H]; bias: [4H], all
    in the gates' dtype; c, h: [N, H] in the carry's; mask: [N] bool (any
    stride).  ``acts`` is None unless ``save``."""
    if build.on_cpu(xw, hw, bias, c, h, mask):
        return lstm_cell_fwd_reference(xw, hw, bias, c, h, mask, save)
    gate_bf16, carry_bf16 = _types(xw, c)
    n, hd = c.shape if c.dim() == 2 else (-1, -1)
    if (n < 0 or tuple(h.shape) != (n, hd) or tuple(xw.shape) != (n, 4 * hd)
            or tuple(hw.shape) != (n, 4 * hd) or tuple(bias.shape) != (4 * hd,)):
        raise ValueError(f"shapes disagree: xw {tuple(xw.shape)}, hw {tuple(hw.shape)}, "
                         f"bias {tuple(bias.shape)}, c {tuple(c.shape)}, h {tuple(h.shape)}")
    if hw.dtype != xw.dtype or bias.dtype != xw.dtype or h.dtype != c.dtype:
        raise ValueError(f"dtypes disagree: xw {xw.dtype}, hw {hw.dtype}, bias {bias.dtype}, "
                         f"c {c.dtype}, h {h.dtype}")
    _check_mask(mask, n)
    xw, hw, bias, c, h = (t.contiguous() for t in (xw, hw, bias, c, h))
    dev = c.device
    c_out, h_out = torch.empty_like(c), torch.empty_like(h)
    acts = torch.empty_like(xw) if save else None
    if n and hd:
        lib = _lib()
        with torch.cuda.device(dev):
            err = lib.lstm_cell_fwd_launch(
                xw.data_ptr(), hw.data_ptr(), bias.data_ptr(), c.data_ptr(), h.data_ptr(),
                mask.data_ptr(), mask.stride(0), n, hd, gate_bf16, carry_bf16,
                c_out.data_ptr(), h_out.data_ptr(), acts.data_ptr() if save else None,
                build.stream(dev))
        build.check(lib, err, "lstm_cell_fwd")
        lstm_cell_fwd.launches += 1
    return c_out, h_out, acts


counter(lstm_cell_fwd, "launches")


def lstm_cell_bwd(acts, c, c_new, mask, dh_new: Optional[torch.Tensor],
                  dc_new: Optional[torch.Tensor]):
    """Backward: ``(dz [N, 4H] in the gates' dtype, dc, dh)`` in the carry's
    dtype; ``dh`` is the masked rows' pass-through only (the recurrent
    product's part is autograd's).  ``dh_new`` or ``dc_new`` may be None (a
    zero)."""
    given = [t for t in (dh_new, dc_new) if t is not None]
    if build.on_cpu(acts, c, c_new, mask, *given):
        return lstm_cell_bwd_reference(acts, c, c_new, mask, dh_new, dc_new)
    gate_bf16, carry_bf16 = _types(acts, c)
    n, hd = c.shape if c.dim() == 2 else (-1, -1)
    if (n < 0 or tuple(acts.shape) != (n, 4 * hd) or tuple(c_new.shape) != (n, hd)
            or any(tuple(t.shape) != (n, hd) for t in given)):
        raise ValueError(f"shapes disagree: acts {tuple(acts.shape)}, c {tuple(c.shape)}, "
                         f"c_new {tuple(c_new.shape)}")
    _check_mask(mask, n)
    acts, c, c_new = acts.contiguous(), c.contiguous(), c_new.to(c.dtype).contiguous()
    dh_new, dc_new = (None if t is None else t.to(c.dtype).contiguous() for t in (dh_new, dc_new))
    dev = c.device
    dz, dc, dh = torch.empty_like(acts), torch.empty_like(c), torch.empty_like(c)
    if n and hd:
        lib = _lib()
        with torch.cuda.device(dev):
            err = lib.lstm_cell_bwd_launch(
                acts.data_ptr(), c.data_ptr(), c_new.data_ptr(), mask.data_ptr(), mask.stride(0),
                None if dh_new is None else dh_new.data_ptr(),
                None if dc_new is None else dc_new.data_ptr(), n, hd, gate_bf16, carry_bf16,
                dz.data_ptr(), dc.data_ptr(), dh.data_ptr(), build.stream(dev))
        build.check(lib, err, "lstm_cell_bwd")
        lstm_cell_bwd.launches += 1
    return dz, dc, dh


counter(lstm_cell_bwd, "launches")


class _LSTMCell(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xw, hw, bias, c, h, mask):
        c_new, h_new, acts = lstm_cell_fwd(xw, hw, bias, c, h, mask, save=True)
        ctx.save_for_backward(acts, c, c_new, mask)
        ctx.set_materialize_grads(False)
        return c_new, h_new

    @staticmethod
    def backward(ctx, dc_new, dh_new):
        acts, c, c_new, mask = ctx.saved_tensors
        dz, dc, dh = lstm_cell_bwd(acts, c, c_new, mask, dh_new, dc_new)
        need = ctx.needs_input_grad
        return (dz if need[0] else None, dz if need[1] else None,
                dz.sum(dim=0) if need[2] else None, dc, dh, None)


def lstm_cell(xw, hw, bias, c, h, mask) -> Tuple[torch.Tensor, torch.Tensor]:
    """One cell update of the masked LSTM: ``(c_out, h_out)``.

    xw, hw: [N, 4H] the slot's input and recurrent products; bias: [4H] the
    recurrent bias, all in the gates' dtype; c, h: [N, H] the carry (the
    gates' dtype or f32); mask: [N] bool, False where the carry stays.
    Through the autograd Function where a gradient will be taken, else the
    forward alone, which saves nothing."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (xw, hw, bias, c, h)):
        return _LSTMCell.apply(xw, hw, bias, c, h, mask)
    c_new, h_new, _ = lstm_cell_fwd(xw, hw, bias, c, h, mask, save=False)
    return c_new, h_new
