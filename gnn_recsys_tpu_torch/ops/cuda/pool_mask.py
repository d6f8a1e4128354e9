"""Dense-pool membership mask: CUDA kernel, its plain version, the wrapper.

Port of ``gnn_recsys_tpu/ops/pallas/pool_mask.py`` (``pool_membership_mask``):
``out[b, p] = 1.0`` where ``pool[p]`` is among ``rows[b]``.  Rows are the
padded already-seen rows of a batch's users (-1 padding never matches); the
result is ANDed with ``pool >= 0``.  The kernel is
``gnn_recsys_tpu_torch/csrc/pool_mask.cu`` (its header says what bounds it
and how its per-row hash sets work).  The wrapper takes the plain version
only for CPU tensors; for CUDA tensors it launches the kernel or raises, and
counts its launches in ``.launches``.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from gnn_recsys_tpu_torch.ops.cuda import build
from gnn_recsys_tpu_torch.utils.profiling import counter

_LIB = "pool_mask"
_P = ctypes.c_void_p
_I = ctypes.c_int

# Widest row the kernel takes (the JAX routing's cap, membership.py:94).
MAX_ROW = 128
# The kernel's tile (csrc/pool_mask.cu): rows and, at most, pool positions
# a block.
_TILE = (4, 1024)


class LaunchGeometry(NamedTuple):
    """A launch: block ``(x, y)`` owns rows ``y * tile_rows`` onward and the
    pool positions ``[x * chunk, (x + 1) * chunk)`` (4 a thread), each row a
    hash set of ``slots`` slots in ``smem_bytes`` of shared memory."""

    tile_rows: int
    chunk: int
    grid_x: int
    grid_y: int
    slots: int
    smem_bytes: int


def set_slots(k: int) -> int:
    """Slots of a row's set: the power of two at least ``32 * k``, at most
    2048 but never under ``16 * k`` (a set is at most a sixteenth full, so
    most probes end at their first slot)."""
    return max(min(1 << (32 * k - 1).bit_length(), 2048), 1 << (16 * k - 1).bit_length())


def launch_geometry(b: int, k: int, p: int) -> LaunchGeometry:
    """The grid for ``b`` rows of width ``k`` and a pool of ``p``: as few
    block columns as the tile allows, cut into equal chunks of whole
    16-byte stores."""
    tb, tp = _TILE
    grid_x = max(1, -(-p // tp))
    chunk = 4 * -(-p // (4 * grid_x))
    slots = set_slots(k)
    return LaunchGeometry(tb, chunk, grid_x, max(1, -(-b // tb)), slots, 4 * tb * slots)


def _bind(lib: ctypes.CDLL) -> None:
    lib.pool_mask_tile.argtypes = [ctypes.POINTER(_I)]
    lib.pool_mask_tile.restype = _I
    tile = (_I * 2)()
    build.check(lib, lib.pool_mask_tile(tile), "pool_mask_tile")
    if tuple(tile) != _TILE:  # the host's tile must be the kernel's
        raise RuntimeError(f"pool_mask.cu tile {tuple(tile)}, the host expects {_TILE}")
    lib.pool_mask_launch.argtypes = [_P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P]
    lib.pool_mask_launch.restype = _I


def _lib() -> ctypes.CDLL:
    return build.load(_LIB, _bind)


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
        geo = launch_geometry(b, k, p)
        with torch.cuda.device(dev):
            err = lib.pool_mask_launch(rows32.data_ptr(), pool32.data_ptr(), b, k, p,
                                       geo.grid_x, geo.chunk, geo.grid_y, geo.slots,
                                       out.data_ptr(), build.stream(dev))
        build.check(lib, err, "pool_membership_mask")
        pool_membership_mask.launches += 1
    return out


counter(pool_membership_mask, "launches")
