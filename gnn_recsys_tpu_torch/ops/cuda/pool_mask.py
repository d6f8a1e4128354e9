"""Dense-pool membership mask: CUDA kernel, its plain version, the wrapper.

Port of ``gnn_recsys_tpu/ops/pallas/pool_mask.py`` (``pool_membership_mask``):
``out[b, p] = 1.0`` where ``pool[p]`` is among ``rows[b]``.  Rows are the
padded already-seen rows of a batch's users (-1 padding never matches); the
result is ANDed with ``pool >= 0``.  The kernel is
``gnn_recsys_tpu_torch/csrc/pool_mask.cu`` (its header says what bounds it).
The wrapper takes the plain version only for CPU tensors; for CUDA tensors it
launches the kernel or raises, and counts its launches in ``.launches``.
"""

from __future__ import annotations

import ctypes

import torch

from gnn_recsys_tpu_torch.ops.cuda import build

_LIB = "pool_mask"
_P = ctypes.c_void_p
_I = ctypes.c_int

# Widest row the kernel takes (the JAX routing's cap, membership.py:94).
MAX_ROW = 128


def _lib() -> ctypes.CDLL:
    lib = build.load(_LIB)
    if not getattr(lib, "_typed", False):
        lib.pool_mask_launch.argtypes = [_P, _P, _I, _I, _I, _P, _P]
        lib.pool_mask_launch.restype = _I
        lib._typed = True
    return lib


def pool_membership_mask_reference(rows: torch.Tensor, pool: torch.Tensor) -> torch.Tensor:
    """Plain version: the [B, P, K] broadcast compare."""
    hit = (rows[:, None, :] == pool[None, :, None]).any(dim=-1)
    return (hit & (pool >= 0)[None, :]).to(torch.float32)


def pool_membership_mask(rows: torch.Tensor, pool: torch.Tensor) -> torch.Tensor:
    """rows: [B, K] int32 (-1 padded, K <= 128); pool: [P] int32.
    Returns [B, P] f32, 1.0 where ``pool[p]`` is among ``rows[b]``."""
    if build.on_cpu(rows, pool):
        return pool_membership_mask_reference(rows, pool)
    if rows.dim() != 2 or pool.dim() != 1:
        raise ValueError("rows must be [B, K] and pool [P]")
    b, k = rows.shape
    p = pool.shape[0]
    if not 1 <= k <= MAX_ROW:
        raise ValueError(f"row width {k} outside the kernel's 1..{MAX_ROW}")
    rows32 = rows.to(torch.int32).contiguous()
    pool32 = pool.to(torch.int32).contiguous()
    dev = rows.device
    out = torch.empty((b, p), dtype=torch.float32, device=dev)
    if b and p:
        lib = _lib()
        with torch.cuda.device(dev):
            err = lib.pool_mask_launch(rows32.data_ptr(), pool32.data_ptr(), b, k, p,
                                       out.data_ptr(), build.stream(dev))
        build.check(lib, err, "pool_membership_mask")
        pool_membership_mask.launches += 1
    return out


pool_membership_mask.launches = 0
