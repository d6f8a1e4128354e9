"""Fused leaf aggregation: CUDA kernels, their plain versions, the wrappers.

Port of ``gnn_recsys_tpu/ops/pallas/leaf_agg.py``: the sampled tree's leaf
level for ``*_nn`` aggregators with the embedding and the pre-aggregation
Linear folded into one ``[F -> H]`` affine map,

    agg[p] = sum_k mask_scaled[p, k] * relu(x_km[k, p] @ W + b)

where ``mask_scaled`` folds the mean's 1/count into the validity mask.
:func:`leaf_mean_nn` is a ``torch.autograd.Function`` whose forward and
backward are the kernels of ``gnn_recsys_tpu_torch/csrc/leaf_agg.cu`` (its
header says what bounds them); gradients flow to ``W`` and ``b`` only.
Each wrapper takes its plain version only for CPU tensors; for CUDA tensors
it launches its kernel or raises, and counts its launches in ``.launches``.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import torch

from gnn_recsys_tpu_torch.ops.cuda import build
from gnn_recsys_tpu_torch.utils.profiling import counter

_LIB = "leaf_agg"
_P = ctypes.c_void_p
_I = ctypes.c_int
# Blocks a launch aims at, per SM: the forward's occupancy at F = 8.  The
# backward holds 3 an SM, so at the training shape its whole grid (384
# blocks) is resident at once on 132 SMs.
_BLOCKS_PER_SM = 4
# The kernels' tile at each padded feature width FT (csrc/leaf_agg.cu, Tile):
# FT -> (parents a warp, columns a lane); a block is 4 warps of 32 lanes.
_TILES = {8: (8, 4), 16: (4, 4), 32: (4, 2), 64: (4, 1), 128: (2, 1)}


class LaunchGeometry(NamedTuple):
    """A launch of either leaf kernel: a grid of ``(grid_x, grid_y)``
    blocks; block ``(x, y)`` owns columns ``y * block_columns`` onward and
    walks the tiles ``x, x + grid_x, ...`` of ``tile_parents`` parents.  The
    backward writes one ``[F, H]`` + ``[H]`` partial a block ``x``, so
    ``grid_x`` is also its partial count."""

    tile_parents: int
    block_columns: int
    tiles: int
    grid_x: int
    grid_y: int


def tile_shape(f: int) -> Tuple[int, int]:
    """(parents a tile, columns a block) of the instantiation for width ``f``."""
    ft = next(t for t in _TILES if f <= t)
    parents, columns = _TILES[ft]
    return 4 * parents, 32 * columns


def launch_geometry(p: int, f: int, h: int, sms: int, block_p: int = 512) -> LaunchGeometry:
    """The grid for ``p`` parents, width ``f`` and ``h`` columns on a card
    of ``sms`` SMs: about ``_BLOCKS_PER_SM`` blocks an SM, each walking as
    many tiles as every other (at most ``block_p`` parents), and no block
    without a tile."""
    tp, bc = tile_shape(f)
    tiles = max(1, -(-p // tp))
    grid_y = max(1, -(-h // bc))
    per_block = -(-tiles * grid_y // (_BLOCKS_PER_SM * sms))
    per_block = max(1, min(per_block, block_p // tp))
    return LaunchGeometry(tp, bc, tiles, -(-tiles // per_block), grid_y)


def _geometry(p, f, h, block_p, dev) -> LaunchGeometry:
    return launch_geometry(p, f, h, torch.cuda.get_device_properties(dev).multi_processor_count,
                           block_p)


def _bind(lib: ctypes.CDLL) -> None:
    lib.leaf_tile_shape.argtypes = [_I, ctypes.POINTER(_I)]
    lib.leaf_tile_shape.restype = _I
    for ft in _TILES:  # the host's tiles must be the kernels'
        shape = (_I * 2)()
        build.check(lib, lib.leaf_tile_shape(ft, shape), "leaf_tile_shape")
        if tuple(shape) != tile_shape(ft):
            raise RuntimeError(f"leaf_agg.cu tiles {tuple(shape)} at F={ft}, "
                               f"the host expects {tile_shape(ft)}")
    lib.leaf_fwd_launch.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P]
    lib.leaf_fwd_launch.restype = _I
    lib.leaf_bwd_launch.argtypes = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                    _P, _P, _P, _P, _P]
    lib.leaf_bwd_launch.restype = _I


def _lib() -> ctypes.CDLL:
    return build.load(_LIB, _bind)


def leaf_kernel_supported(f: int) -> bool:
    """Feature widths the kernels take (F padded to 8, 16, 32, 64 or 128)."""
    return 1 <= f <= 128


# ----------------------------------------------------------------------
# Plain versions
# ----------------------------------------------------------------------

def _pre_activation(x_km, w, b) -> torch.Tensor:
    """z [K, P, H] in f32 (bf16 inputs widened, as the kernels do)."""
    return torch.einsum("kpf,fh->kph", x_km.float(), w.float()) + b.float()


def leaf_mean_nn_reference(x_km, mask_scaled, w, b) -> torch.Tensor:
    """Plain version of the forward (the einsum oracle, ``leaf_agg.py:228``):
    [P, H] in ``x_km``'s dtype, f32 accumulation.  Differentiable by
    autograd; it materializes the [K, P, H] activations."""
    z = torch.relu(_pre_activation(x_km, w, b))
    return torch.einsum("kph,pk->ph", z, mask_scaled.float()).to(x_km.dtype)


def leaf_mean_nn_bwd_reference(x_km, mask_scaled, w, b, g) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the backward: (dW [F, H], db [H]), f32."""
    z = _pre_activation(x_km, w, b)
    gm = g.float()[None, :, :] * mask_scaled.float().T[:, :, None]  # [K, P, H]
    gj = torch.where(z > 0, gm, torch.zeros_like(gm))
    return torch.einsum("kpf,kph->fh", x_km.float(), gj), gj.sum(dim=(0, 1))


# ----------------------------------------------------------------------
# Wrappers
# ----------------------------------------------------------------------

def _checked(x_km, mask_scaled, w, b):
    """The kernels' view of the inputs; raises on what they do not take."""
    if x_km.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"x_km must be f32 or bf16, got {x_km.dtype}")
    if x_km.dim() != 3 or w.dim() != 2 or b.dim() != 1 or mask_scaled.dim() != 2:
        raise ValueError("x_km must be [K, P, F], w [F, H], b [H], mask_scaled [P, K]")
    k, p, f = x_km.shape
    h = w.shape[1]
    if w.shape[0] != f or b.shape[0] != h or tuple(mask_scaled.shape) != (p, k):
        raise ValueError(f"shapes disagree: x {tuple(x_km.shape)}, w {tuple(w.shape)}, "
                         f"b {tuple(b.shape)}, mask {tuple(mask_scaled.shape)}")
    if not leaf_kernel_supported(f):
        raise ValueError(f"feature width {f} outside the kernel's 1..128")
    if w.dtype != x_km.dtype or b.dtype != x_km.dtype:
        raise ValueError(f"w and b must be {x_km.dtype} like x_km, got {w.dtype}, {b.dtype}")
    return (x_km.contiguous(), mask_scaled.float().contiguous(),
            w.contiguous(), b.contiguous(), (k, p, f, h))


def leaf_mean_nn_fwd(x_km, mask_scaled, w, b) -> torch.Tensor:
    """Forward: [P, H] in ``x_km``'s dtype."""
    if build.on_cpu(x_km, mask_scaled, w, b):
        return leaf_mean_nn_reference(x_km, mask_scaled, w, b)
    x, ms, w_, b_, (k, p, f, h) = _checked(x_km, mask_scaled, w, b)
    dev = x.device
    out = torch.empty((p, h), dtype=x.dtype, device=dev)
    if p and h:
        lib = _lib()
        geo = _geometry(p, f, h, 512, dev)
        with torch.cuda.device(dev):
            err = lib.leaf_fwd_launch(x.data_ptr(), ms.data_ptr(), w_.data_ptr(), b_.data_ptr(),
                                      k, p, f, h, int(x.dtype == torch.bfloat16), geo.grid_x,
                                      out.data_ptr(), build.stream(dev))
        build.check(lib, err, "leaf_mean_nn_fwd")
        leaf_mean_nn_fwd.launches += 1
    return out


counter(leaf_mean_nn_fwd, "launches")


def leaf_mean_nn_bwd(x_km, mask_scaled, w, b, g, block_p: int = 512):
    """Backward: (dW [F, H], db [H]) in f32 for the cotangent ``g`` [P, H]."""
    if build.on_cpu(x_km, mask_scaled, w, b, g):
        return leaf_mean_nn_bwd_reference(x_km, mask_scaled, w, b, g)
    x, ms, w_, b_, (k, p, f, h) = _checked(x_km, mask_scaled, w, b)
    if tuple(g.shape) != (p, h):
        raise ValueError(f"cotangent of shape {tuple(g.shape)}, expected {(p, h)}")
    dev = x.device
    g_ = g.to(x.dtype).contiguous()
    if not (p and h):  # no parents: zero gradients, nothing to launch
        return (torch.zeros((f, h), dtype=torch.float32, device=dev),
                torch.zeros((h,), dtype=torch.float32, device=dev))
    # The reduce kernel writes every element of dW and db.
    dw = torch.empty((f, h), dtype=torch.float32, device=dev)
    db = torch.empty((h,), dtype=torch.float32, device=dev)
    lib = _lib()
    blocks = _geometry(p, f, h, block_p, dev).grid_x  # one partial a block column
    dw_part = torch.empty((blocks, f, h), dtype=torch.float32, device=dev)
    db_part = torch.empty((blocks, h), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = lib.leaf_bwd_launch(
            x.data_ptr(), ms.data_ptr(), w_.data_ptr(), b_.data_ptr(), g_.data_ptr(),
            k, p, f, h, int(x.dtype == torch.bfloat16), blocks, dw_part.data_ptr(),
            db_part.data_ptr(), dw.data_ptr(), db.data_ptr(), build.stream(dev))
    build.check(lib, err, "leaf_mean_nn_bwd")
    leaf_mean_nn_bwd.launches += 1
    return dw, db


counter(leaf_mean_nn_bwd, "launches")


class _LeafMeanNN(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x_km, mask_scaled, w, b, block_p):
        ctx.save_for_backward(x_km, mask_scaled, w, b)
        ctx.block_p = block_p
        return leaf_mean_nn_fwd(x_km, mask_scaled, w, b)

    @staticmethod
    def backward(ctx, g):
        x_km, mask_scaled, w, b = ctx.saved_tensors
        dw, db = leaf_mean_nn_bwd(x_km, mask_scaled, w, b, g, block_p=ctx.block_p)
        # x (raw features) and the mask (graph structure) take no gradient.
        return None, None, dw.to(w.dtype), db.to(b.dtype), None


def leaf_mean_nn(x_km, mask_scaled, w, b, block_p: int = 512) -> torch.Tensor:
    """``agg[p] = sum_k mask_scaled[p,k] * relu(x_km[k,p] @ w + b)``.

    x_km: [K, P, F] f32 or bf16 (k-major); mask_scaled: [P, K] f32; w: [F, H];
    b: [H].  Returns [P, H] in ``x_km``'s dtype.  ``block_p`` bounds the
    parents one backward block sums before writing its partial."""
    return _LeafMeanNN.apply(x_km, mask_scaled, w, b, block_p)
