"""The MLP head's tower over a cross product of rows: CUDA kernels, their
plain versions, the wrappers.

``PredictingLayer.score_cross`` (``models/layers.py``) scores every pair of
B user rows and P pool rows with the head, layer 1 factorised: the caller
forms ``a_u = u W1_u^T`` [B, 128] and ``a_i = pool W1_i^T`` [P, 128] in f32,
and :func:`pred_tower` does the rest for each pair (b, p)::

    z1 = (a_u[b] + b1) + a_i[p];   h1 = T(relu(z1))
    z2 = h1 W2^T + b2;             s = sigmoid(relu(z2) . w3 + b3)

with the head's parameters in its type T (bf16 or f32), everything else f32,
``s`` [B, P] f32.  It replaces no Pallas kernel: the JAX package runs the
head in XLA (``gnn_recsys_tpu/models/layers.py:PredictingLayer``).  The
kernels (``gnn_recsys_tpu_torch/csrc/pred_tower.cu``, whose header says what
bounds them) write no per-pair tensor but ``s``; the backward takes the
scores' gradient and ``s`` and gives ``a_u``'s, ``a_i``'s and the five
parameters' gradients.  Each wrapper takes its plain version only for CPU
tensors; for CUDA tensors it launches its kernels or raises, and counts its
calls in ``.launches``.  :func:`pred_tower` counts the pairs it scores in
``pred_tower.pairs``.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from gnn_recsys_tpu_torch.ops.cuda import build
from gnn_recsys_tpu_torch.utils.profiling import counter

_LIB = "pred_tower"
_P = ctypes.c_void_p
_I = ctypes.c_int
_DTYPES = (torch.float32, torch.bfloat16)
H1, H2 = 128, 32  # the head's widths: the kernels' fixed tile shapes


def _bind(lib: ctypes.CDLL) -> None:
    lib.pred_tower_scratch_floats.argtypes = [_I, _I]
    lib.pred_tower_scratch_floats.restype = ctypes.c_longlong
    lib.pred_tower_widths.argtypes = [_I]
    lib.pred_tower_widths.restype = _I
    lib.pred_tower_fwd_launch.argtypes = [_P] * 7 + [_I, _I, _I, _P, _P]
    lib.pred_tower_fwd_launch.restype = _I
    lib.pred_tower_bwd_launch.argtypes = [_P] * 8 + [_I, _I, _I] + [_P] * 6
    lib.pred_tower_bwd_launch.restype = _I
    if (lib.pred_tower_widths(0), lib.pred_tower_widths(1)) != (H1, H2):
        raise RuntimeError("csrc/pred_tower.cu and its wrapper disagree on the head's widths")


def _lib() -> ctypes.CDLL:
    return build.load(_LIB, _bind)


# ----------------------------------------------------------------------
# Plain versions
# ----------------------------------------------------------------------

def pred_tower_reference(a_u, a_i, b1, w2, b2, w3, b3) -> torch.Tensor:
    """Plain version of the forward: ``s`` [B, P] in ``a_u``'s dtype (f32;
    f64 stays f64), through PyTorch operations that autograd differentiates
    (it forms the [B, P, 128] activations the kernels never write)."""
    wide = a_u.dtype
    z1 = (a_u + b1.to(wide))[:, None, :] + a_i[None, :, :]
    h1 = torch.relu(z1).to(w2.dtype).to(wide)
    h2 = torch.relu(torch.matmul(h1, w2.to(wide).T) + b2.to(wide))
    return torch.sigmoid(torch.matmul(h2, w3.to(wide)) + b3.to(wide))


def pred_tower_bwd_reference(ds, a_u, a_i, b1, w2, b2, w3, b3) -> Tuple[torch.Tensor, ...]:
    """Plain version of the backward: the gradients of ``a_u``, ``a_i`` and
    ``b1, w2, b2, w3, b3`` (in their dtypes) for the scores' gradient
    ``ds``, by autograd through :func:`pred_tower_reference`."""
    with torch.enable_grad():
        inputs = [t.detach().requires_grad_(True) for t in (a_u, a_i, b1, w2, b2, w3, b3)]
        s = pred_tower_reference(*inputs)
        return torch.autograd.grad(s, inputs, ds)


# ----------------------------------------------------------------------
# Wrappers
# ----------------------------------------------------------------------

def _check(a_u, a_i, b1, w2, b2, w3, b3) -> None:
    """Raise on what the kernels do not take: f32 ``a_u`` [B, 128] and
    ``a_i`` [P, 128], B and P at least 1, and the parameters in one type,
    f32 or bf16, at the head's widths."""
    if a_u.dtype != torch.float32 or a_i.dtype != torch.float32:
        raise ValueError(f"the kernels take f32 products, got {a_u.dtype} and {a_i.dtype}")
    if a_u.dim() != 2 or a_i.dim() != 2 or a_u.shape[1] != H1 or a_i.shape[1] != H1 \
            or not a_u.shape[0] or not a_i.shape[0]:
        raise ValueError(f"the kernels take a_u [B, {H1}] and a_i [P, {H1}], B and P at least "
                         f"1, got {tuple(a_u.shape)} and {tuple(a_i.shape)}")
    params = (b1, w2, b2, w3, b3)
    shapes = ((H1,), (H2, H1), (H2,), (H2,), (1,))
    if any(tuple(t.shape) != s for t, s in zip(params, shapes)):
        raise ValueError(f"the head's parameters must be {shapes}, got "
                         f"{[tuple(t.shape) for t in params]}")
    if w2.dtype not in _DTYPES or any(t.dtype != w2.dtype for t in params):
        raise ValueError(f"the parameters must share one type, f32 or bf16, got "
                         f"{[t.dtype for t in params]}")


def _aligned(*tensors) -> list:
    """Contiguous, each data pointer on 16 bytes (a copy where it is not)."""
    out = []
    for t in tensors:
        t = t.contiguous()
        out.append(t if t.data_ptr() % 16 == 0 else t.clone())
    return out


def pred_tower_fwd(a_u, a_i, b1, w2, b2, w3, b3) -> torch.Tensor:
    """Forward: the scores ``s`` [B, P] f32 of every (a_u row, a_i row)
    pair."""
    if build.on_cpu(a_u, a_i, b1, w2, b2, w3, b3):
        with torch.no_grad():
            return pred_tower_reference(a_u, a_i, b1, w2, b2, w3, b3)
    _check(a_u, a_i, b1, w2, b2, w3, b3)
    a_u, a_i, b1, w2, b2, w3, b3 = _aligned(a_u, a_i, b1, w2, b2, w3, b3)
    dev = a_u.device
    n_u, n_i = a_u.shape[0], a_i.shape[0]
    s = torch.empty(n_u, n_i, dtype=torch.float32, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        err = lib.pred_tower_fwd_launch(
            a_u.data_ptr(), a_i.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
            w3.data_ptr(), b3.data_ptr(), n_u, n_i, int(w2.dtype == torch.bfloat16),
            s.data_ptr(), build.stream(dev))
    build.check(lib, err, "pred_tower_fwd")
    pred_tower_fwd.launches += 1
    return s


counter(pred_tower_fwd, "launches")


def pred_tower_bwd(ds, s, a_u, a_i, b1, w2, b2, w3, b3) -> Tuple[torch.Tensor, ...]:
    """Backward: the gradients of ``a_u`` [B, 128] and ``a_i`` [P, 128]
    (f32) and of ``b1, w2, b2, w3, b3`` (in their type) for the scores'
    gradient ``ds`` [B, P] and the forward's scores ``s``."""
    if build.on_cpu(ds, s, a_u, a_i, b1, w2, b2, w3, b3):
        return pred_tower_bwd_reference(ds, a_u, a_i, b1, w2, b2, w3, b3)
    _check(a_u, a_i, b1, w2, b2, w3, b3)
    n_u, n_i = a_u.shape[0], a_i.shape[0]
    if tuple(ds.shape) != (n_u, n_i) or tuple(s.shape) != (n_u, n_i):
        raise ValueError(f"ds and s must be [{n_u}, {n_i}], got {tuple(ds.shape)} and "
                         f"{tuple(s.shape)}")
    ds, s, a_u, a_i, b1, w2, b2, w3 = _aligned(ds.float(), s.float(), a_u, a_i, b1, w2, b2, w3)
    dev = a_u.device
    lib = _lib()
    f32 = dict(dtype=torch.float32, device=dev)
    scratch = torch.empty(lib.pred_tower_scratch_floats(n_u, n_i), **f32)
    da_u, da_i = torch.empty(n_u, H1, **f32), torch.empty(n_i, H1, **f32)
    small, dw2 = torch.empty(H1 + 2 * H2 + 1, **f32), torch.empty(H2, H1, **f32)
    with torch.cuda.device(dev):
        err = lib.pred_tower_bwd_launch(
            ds.data_ptr(), s.data_ptr(), a_u.data_ptr(), a_i.data_ptr(), b1.data_ptr(),
            w2.data_ptr(), b2.data_ptr(), w3.data_ptr(), n_u, n_i,
            int(w2.dtype == torch.bfloat16), scratch.data_ptr(), da_u.data_ptr(),
            da_i.data_ptr(), small.data_ptr(), dw2.data_ptr(), build.stream(dev))
    build.check(lib, err, "pred_tower_bwd")
    pred_tower_bwd.launches += 1
    db1, db2, dw3, db3 = small.split((H1, H2, H2, 1))
    dt = w2.dtype
    return da_u, da_i, db1.to(dt), dw2.to(dt), db2.to(dt), dw3.to(dt), db3.to(dt)


counter(pred_tower_bwd, "launches")


class _PredTower(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a_u, a_i, b1, w2, b2, w3, b3):
        s = pred_tower_fwd(a_u, a_i, b1, w2, b2, w3, b3)
        ctx.save_for_backward(s, a_u, a_i, b1, w2, b2, w3, b3)
        return s

    @staticmethod
    def backward(ctx, ds):
        s, *inputs = ctx.saved_tensors
        grads = pred_tower_bwd(ds, s, *inputs)
        return tuple(g if need else None for g, need in zip(grads, ctx.needs_input_grad))


def pred_tower(a_u, a_i, b1, w2, b2, w3, b3) -> torch.Tensor:
    """The head's tower on every (a_u row, a_i row) pair: ``s`` [B, P] f32.

    a_u [B, 128], a_i [P, 128]: the two halves of layer 1's product, f32;
    b1 [128], w2 [32, 128], b2 [32], w3 [32], b3 [1]: the head's parameters
    in its type (f32, or bf16 with the tensor cores' products)."""
    pred_tower.pairs += a_u.shape[0] * a_i.shape[0]
    return _PredTower.apply(a_u, a_i, b1, w2, b2, w3, b3)


counter(pred_tower, "pairs")
