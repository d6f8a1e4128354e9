"""Neighbour gather + masked mean: CUDA kernels, their plain versions, the wrappers.

Port of ``gnn_recsys_tpu/ops/pallas/gather_mean.py`` (``gather_mean_pallas``),
the ``csc_gather_mean`` contract without edge weights:

    out[b] = sum_k m[b, k] * h[clip(nbr[b, k])] / max(sum_k m[b, k], 1)

with ids clipped into ``[0, N-1]`` and zeros for a row with no valid slot.
:func:`gather_mean` is a ``torch.autograd.Function`` whose forward and
backward are the kernels of ``gnn_recsys_tpu_torch/csrc/gather_mean.cu`` (its
header says what bounds them); the gradient flows to ``h`` only.  The
backward adds with atomics, so its sums come in another order on every run.
Each wrapper takes its plain version only for CPU tensors; for CUDA tensors
it launches its kernel or raises, and counts its launches in ``.launches``.
"""

from __future__ import annotations

import ctypes

import torch

from gnn_recsys_tpu_torch.ops.cuda import build

_LIB = "gather_mean"
_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib() -> ctypes.CDLL:
    lib = build.load(_LIB)
    if not getattr(lib, "_typed", False):
        for fn in (lib.gather_mean_fwd_launch, lib.gather_mean_bwd_launch):
            fn.argtypes = [_P, _P, _P, _I, _I, _I, _I, _I, _P, _P]
            fn.restype = _I
        lib._typed = True
    return lib


# ----------------------------------------------------------------------
# Plain versions
# ----------------------------------------------------------------------

def _clipped(nbr: torch.Tensor, n: int) -> torch.Tensor:
    return nbr.long().clamp(0, max(n - 1, 0))


def gather_mean_reference(h: torch.Tensor, nbr: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Plain version of the forward (``ops/message.py``'s gather and masked
    mean): [B, D]; differentiable by autograd."""
    msgs = h[_clipped(nbr, h.shape[0])]  # [B, K, D]
    m = mask.to(h.dtype)
    return (msgs * m[..., None]).sum(dim=1) / m.sum(dim=1).clamp(min=1.0)[:, None]


def gather_mean_bwd_reference(dout: torch.Tensor, nbr: torch.Tensor, mask: torch.Tensor,
                              n: int) -> torch.Tensor:
    """Plain version of the backward: dh [n, D], the scatter-add of
    ``dout[b] * m[b, k] / max(count_b, 1)`` into the rows ``clip(nbr)``."""
    m = mask.to(dout.dtype)
    w = m / m.sum(dim=1, keepdim=True).clamp(min=1.0)  # [B, K]
    contrib = (w[..., None] * dout[:, None, :]).reshape(-1, dout.shape[1])
    dh = dout.new_zeros((n, dout.shape[1]))
    return dh.index_add_(0, _clipped(nbr, n).reshape(-1), contrib)


# ----------------------------------------------------------------------
# Wrappers
# ----------------------------------------------------------------------

def _checked(x: torch.Tensor, nbr: torch.Tensor, mask: torch.Tensor, what: str):
    """The kernels' view of (table or cotangent, ids, mask); raises on what
    they do not take."""
    if x.dtype != torch.float32:
        raise ValueError(f"{what} must be f32 (bf16 is a later slice), got {x.dtype}")
    if x.dim() != 2 or nbr.dim() != 2 or tuple(mask.shape) != tuple(nbr.shape):
        raise ValueError(f"{what} must be [*, D], nbr and mask [B, K]; got {tuple(x.shape)}, "
                         f"{tuple(nbr.shape)}, {tuple(mask.shape)}")
    if nbr.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"nbr must be int32 or int64, got {nbr.dtype}")
    ids = nbr.to(torch.int32).contiguous()
    m = mask.to(torch.bool).contiguous().view(torch.uint8)
    return x.contiguous(), ids, m


def _vec4(*tensors: torch.Tensor) -> int:
    """Whether the float4 path applies: D % 4 == 0 and 16-byte alignment."""
    return int(tensors[0].shape[1] % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in tensors))


def gather_mean_fwd(h: torch.Tensor, nbr: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Forward: h [N, D] f32, nbr [B, K] int32/int64, mask [B, K] bool -> [B, D]."""
    if build.on_cpu(h, nbr, mask):
        return gather_mean_reference(h, nbr, mask)
    h_, ids, m = _checked(h, nbr, mask, "h")
    (n, d), (b, k) = h_.shape, ids.shape
    if n == 0 and b * k:
        raise ValueError("h has no rows to gather from")
    dev = h_.device
    out = torch.empty((b, d), dtype=torch.float32, device=dev)
    if b and d:
        lib = _lib()
        with torch.cuda.device(dev):
            err = lib.gather_mean_fwd_launch(h_.data_ptr(), ids.data_ptr(), m.data_ptr(),
                                             n, b, k, d, _vec4(h_, out), out.data_ptr(),
                                             build.stream(dev))
        build.check(lib, err, "gather_mean_fwd")
        gather_mean_fwd.launches += 1
    return out


gather_mean_fwd.launches = 0


def gather_mean_bwd(dout: torch.Tensor, nbr: torch.Tensor, mask: torch.Tensor,
                    n: int) -> torch.Tensor:
    """Backward: dh [n, D] f32 for the cotangent ``dout`` [B, D]."""
    if build.on_cpu(dout, nbr, mask):
        return gather_mean_bwd_reference(dout, nbr, mask, n)
    g, ids, m = _checked(dout, nbr, mask, "dout")
    (b, d), k = g.shape, ids.shape[1]
    if ids.shape[0] != b:
        raise ValueError(f"dout has {b} rows, nbr {ids.shape[0]}")
    dev = g.device
    dh = torch.zeros((n, d), dtype=torch.float32, device=dev)  # the kernel adds into it
    if n and b and d:
        lib = _lib()
        with torch.cuda.device(dev):
            err = lib.gather_mean_bwd_launch(g.data_ptr(), ids.data_ptr(), m.data_ptr(),
                                             n, b, k, d, _vec4(g, dh), dh.data_ptr(),
                                             build.stream(dev))
        build.check(lib, err, "gather_mean_bwd")
        gather_mean_bwd.launches += 1
    return dh


gather_mean_bwd.launches = 0


class _GatherMean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, nbr, mask):
        ctx.save_for_backward(nbr, mask)
        ctx.n = h.shape[0]
        return gather_mean_fwd(h, nbr, mask)

    @staticmethod
    def backward(ctx, g):
        nbr, mask = ctx.saved_tensors
        # The ids and the mask (graph structure) take no gradient.
        return gather_mean_bwd(g, nbr, mask, ctx.n), None, None


def gather_mean(h: torch.Tensor, nbr: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """``out[b] = sum_k mask[b,k] h[clip(nbr[b,k])] / max(sum_k mask[b,k], 1)``.

    h: [N, D] f32; nbr: [B, K] int32 or int64 (any value where the mask is
    False); mask: [B, K] bool.  Returns [B, D].  CPU tensors go through the
    plain version (autograd differentiates it); CUDA tensors through the
    kernels, forward and backward."""
    if build.on_cpu(h, nbr, mask):
        return gather_mean_reference(h, nbr, mask)
    # Converted once here, so that neither kernel's wrapper copies them again.
    return _GatherMean.apply(h, nbr.to(torch.int32).contiguous(),
                             mask.to(torch.bool).contiguous())
