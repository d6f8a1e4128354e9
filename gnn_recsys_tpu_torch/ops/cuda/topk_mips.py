"""Full-catalog MIPS top-k: CUDA kernels, their plain versions, the wrappers.

Port of ``gnn_recsys_tpu/ops/pallas/topk_mips.py``.  The kernels live in
``gnn_recsys_tpu_torch/csrc/topk_mips.cu`` (its header says what bounds them
and how the simple design works):

* :func:`mips_topk` — per user, the top-``k`` of ``u . i`` over the whole
  catalog (TPU ``mips_topk``).
* :func:`mips_lse` — per user, the online max ``m`` and sum-exp ``s`` of the
  scores (pass 1 of the TPU ``mips_topk_boosted``).
* :func:`mips_boost` — per user, the top-``k`` of ``exp(u.i - m) / s +
  weight * pop[i]`` (pass 2).
* :func:`mips_topk_boosted` — the two passes together.

Ties go to the lowest item index (the TPU kernel's rule), so every plain
version selects with a stable descending sort; ``torch.topk`` does not
promise that order.  A wrapper takes the plain version only when its tensors
lie on the CPU; for CUDA tensors it launches the kernel or raises.  Each
wrapper counts its launches in a plain integer attribute ``.launches``.
"""

from __future__ import annotations

import contextlib
import ctypes
from typing import Tuple

import torch

from gnn_recsys_tpu_torch.ops.cuda import build

_LIB = "topk_mips"
_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib() -> ctypes.CDLL:
    lib = build.load(_LIB)
    if not getattr(lib, "_typed", False):
        lib.mips_max_k.argtypes = []
        lib.mips_max_k.restype = _I
        lib.mips_num_splits.argtypes = [_I, _I, _I, _I, _I]
        lib.mips_num_splits.restype = _I
        lib.mips_topk_launch.argtypes = [_P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P]
        lib.mips_topk_launch.restype = _I
        lib.mips_lse_launch.argtypes = [_P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P]
        lib.mips_lse_launch.restype = _I
        lib.mips_boost_launch.argtypes = [
            _P, _P, _P, _P, _P, ctypes.c_float, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P,
        ]
        lib.mips_boost_launch.restype = _I
        lib._typed = True
    return lib


def max_k() -> int:
    """Largest ``k`` the CUDA top-k kernels take (builds the library)."""
    return int(_lib().mips_max_k())


# ----------------------------------------------------------------------
# Plain versions
# ----------------------------------------------------------------------

@contextlib.contextmanager
def full_f32_matmul():
    """f32 products in full f32 (no TF32) for the duration of the block."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _as_compute(x: torch.Tensor, bf16: bool) -> torch.Tensor:
    """The kernel's view of an input: bf16-rounded if asked, then f32."""
    return (x.to(torch.bfloat16) if bf16 else x).float()


# Users per product in the plain versions ([1024, I] f32 scores at a time).
_CHUNK = 1024


def _chunks(n: int):
    return [(lo, min(lo + _CHUNK, n)) for lo in range(0, n, _CHUNK)]


def stable_topk(scores: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k of each row, ties to the lowest column (``torch.topk`` does not
    promise that): (values, indices)."""
    vals, idx = torch.sort(scores, dim=1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


def _empty_topk(n: int, k: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    return (torch.empty((n, k), dtype=torch.float32, device=device),
            torch.empty((n, k), dtype=torch.int64, device=device))


def mips_topk_reference(user_emb, item_emb, k: int, bf16: bool = False):
    """Plain version of :func:`mips_topk`: scores by user chunk, stable sort."""
    u = _as_compute(user_emb, bf16)
    it = _as_compute(item_emb, bf16)
    vals, idx = _empty_topk(u.shape[0], k, u.device)
    with full_f32_matmul():
        for lo, hi in _chunks(u.shape[0]):
            vals[lo:hi], idx[lo:hi] = stable_topk(u[lo:hi] @ it.T, k)
    return vals, idx


def mips_lse_reference(user_emb, item_emb, bf16: bool = False):
    """Plain version of :func:`mips_lse`: per-user (max, sum exp(s - max))."""
    u = _as_compute(user_emb, bf16)
    it = _as_compute(item_emb, bf16)
    m = torch.empty(u.shape[0], dtype=torch.float32, device=u.device)
    s = torch.empty_like(m)
    with full_f32_matmul():
        for lo, hi in _chunks(u.shape[0]):
            scores = u[lo:hi] @ it.T
            m[lo:hi] = scores.max(dim=1).values
            s[lo:hi] = torch.exp(scores - m[lo:hi, None]).sum(dim=1)
    return m, s


def mips_boost_reference(user_emb, item_emb, popularity, m, s, k: int,
                         weight: float = 1.0, bf16: bool = False):
    """Plain version of :func:`mips_boost`: top-k of ``exp(s-m)/sum + w*pop``."""
    u = _as_compute(user_emb, bf16)
    it = _as_compute(item_emb, bf16)
    pop = popularity.float().reshape(1, -1)
    vals, idx = _empty_topk(u.shape[0], k, u.device)
    with full_f32_matmul():
        for lo, hi in _chunks(u.shape[0]):
            scores = u[lo:hi] @ it.T
            boosted = torch.exp(scores - m[lo:hi, None]) / s[lo:hi, None] + weight * pop
            vals[lo:hi], idx[lo:hi] = stable_topk(boosted, k)
    return vals, idx


def mips_topk_boosted_reference(user_emb, item_emb, popularity, k: int,
                                weight: float = 1.0, bf16: bool = False):
    """Plain version of :func:`mips_topk_boosted`."""
    m, s = mips_lse_reference(user_emb, item_emb, bf16=bf16)
    return mips_boost_reference(user_emb, item_emb, popularity, m, s, k,
                                weight=weight, bf16=bf16)


# ----------------------------------------------------------------------
# Wrappers
# ----------------------------------------------------------------------

def _on_cpu(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on the CPU; raises unless they all lie on
    one CUDA device otherwise."""
    devices = {t.device for t in tensors}
    if all(d.type == "cpu" for d in devices):
        return True
    if len(devices) != 1 or next(iter(devices)).type != "cuda":
        raise ValueError(f"tensors must all be on one CUDA device, got {devices}")
    return False


def _kernel_input(x: torch.Tensor, bf16: bool) -> torch.Tensor:
    x = x.to(torch.bfloat16 if bf16 else torch.float32).contiguous()
    if x.data_ptr() % 16:  # the kernel reads 16-byte (f32) / 8-byte (bf16) groups
        x = x.clone()
    return x


def _check_shapes(user_emb, item_emb, k=None) -> Tuple[int, int, int]:
    if user_emb.dim() != 2 or item_emb.dim() != 2:
        raise ValueError("user_emb and item_emb must be 2-D")
    (num_users, d), (num_items, d_i) = user_emb.shape, item_emb.shape
    if d != d_i or d == 0 or d % 4:
        raise ValueError(f"embedding widths must match and be a multiple of 4, got {d}, {d_i}")
    if num_items == 0:
        raise ValueError("empty catalog")
    if k is not None:
        if not 1 <= k <= num_items:
            raise ValueError(f"k={k} must be in [1, num_items={num_items}]")
        if k > max_k():
            raise ValueError(f"k={k} exceeds the CUDA kernel's limit {max_k()}")
    return num_users, num_items, d


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


# Kernel modes of csrc/topk_mips.cu.
_TOPK, _LSE, _BOOST = 0, 1, 2


def _partials(lib, mode: int, num_users: int, num_items: int, k: int, bf16: bool, dev):
    """(splits, partial buffers) for one launch: the kernel splits the
    catalog into block columns when the users alone cannot fill the card."""
    splits = lib.mips_num_splits(num_users, num_items, k, mode, int(bf16))
    if mode == _LSE:
        shape = (splits, num_users)
        return splits, (torch.empty(shape, dtype=torch.float32, device=dev),
                        torch.empty(shape, dtype=torch.float32, device=dev))
    shape = (splits, num_users, k)
    return splits, (torch.empty(shape, dtype=torch.float32, device=dev),
                    torch.empty(shape, dtype=torch.int32, device=dev))


def mips_topk(user_emb: torch.Tensor, item_emb: torch.Tensor, k: int,
              bf16: bool = False):
    """Top-k inner-product search: (values [U, k] f32, indices [U, k] int64).

    ``bf16=True`` rounds the inputs to bfloat16 (half the bytes); products
    accumulate in f32 either way.  For cosine similarity, L2-normalize both
    inputs first.
    """
    if _on_cpu(user_emb, item_emb):
        return mips_topk_reference(user_emb, item_emb, k, bf16=bf16)
    num_users, num_items, d = _check_shapes(user_emb, item_emb, k)
    dev = user_emb.device
    ue, ie = _kernel_input(user_emb, bf16), _kernel_input(item_emb, bf16)
    vals, idx = _empty_topk(num_users, k, dev)
    if num_users:
        lib = _lib()
        with torch.cuda.device(dev):
            splits, (pv, pi) = _partials(lib, _TOPK, num_users, num_items, k, bf16, dev)
            err = lib.mips_topk_launch(
                ue.data_ptr(), ie.data_ptr(), num_users, num_items, d, k, int(bf16),
                splits, pv.data_ptr(), pi.data_ptr(), vals.data_ptr(), idx.data_ptr(),
                _stream(dev),
            )
        build.check(lib, err, "mips_topk")
        mips_topk.launches += 1
    return vals, idx


mips_topk.launches = 0


def mips_lse(user_emb: torch.Tensor, item_emb: torch.Tensor, bf16: bool = False):
    """Per-user softmax normaliser of the scores: (max [U], sum-exp [U])."""
    if _on_cpu(user_emb, item_emb):
        return mips_lse_reference(user_emb, item_emb, bf16=bf16)
    num_users, num_items, d = _check_shapes(user_emb, item_emb)
    dev = user_emb.device
    ue, ie = _kernel_input(user_emb, bf16), _kernel_input(item_emb, bf16)
    m = torch.empty(num_users, dtype=torch.float32, device=dev)
    s = torch.empty_like(m)
    if num_users:
        lib = _lib()
        with torch.cuda.device(dev):
            splits, (pm, ps) = _partials(lib, _LSE, num_users, num_items, 0, bf16, dev)
            err = lib.mips_lse_launch(
                ue.data_ptr(), ie.data_ptr(), num_users, num_items, d, int(bf16),
                splits, pm.data_ptr(), ps.data_ptr(), m.data_ptr(), s.data_ptr(),
                _stream(dev),
            )
        build.check(lib, err, "mips_lse")
        mips_lse.launches += 1
    return m, s


mips_lse.launches = 0


def mips_boost(user_emb: torch.Tensor, item_emb: torch.Tensor,
               popularity: torch.Tensor, m: torch.Tensor, s: torch.Tensor,
               k: int, weight: float = 1.0, bf16: bool = False):
    """Top-k of ``exp(u.i - m) / s + weight * popularity[i]`` per user."""
    if _on_cpu(user_emb, item_emb, popularity, m, s):
        return mips_boost_reference(user_emb, item_emb, popularity, m, s, k,
                                    weight=weight, bf16=bf16)
    num_users, num_items, d = _check_shapes(user_emb, item_emb, k)
    if popularity.numel() != num_items or m.numel() != num_users or s.numel() != num_users:
        raise ValueError("popularity must be [I]; m and s must be [U]")
    dev = user_emb.device
    ue, ie = _kernel_input(user_emb, bf16), _kernel_input(item_emb, bf16)
    pop = popularity.reshape(-1).float().contiguous()
    m32, s32 = m.float().contiguous(), s.float().contiguous()
    vals, idx = _empty_topk(num_users, k, dev)
    if num_users:
        lib = _lib()
        with torch.cuda.device(dev):
            splits, (pv, pi) = _partials(lib, _BOOST, num_users, num_items, k, bf16, dev)
            err = lib.mips_boost_launch(
                ue.data_ptr(), ie.data_ptr(), pop.data_ptr(), m32.data_ptr(),
                s32.data_ptr(), float(weight), num_users, num_items, d, k, int(bf16),
                splits, pv.data_ptr(), pi.data_ptr(), vals.data_ptr(), idx.data_ptr(),
                _stream(dev),
            )
        build.check(lib, err, "mips_boost")
        mips_boost.launches += 1
    return vals, idx


mips_boost.launches = 0


def mips_topk_boosted(user_emb: torch.Tensor, item_emb: torch.Tensor,
                      popularity: torch.Tensor, k: int, weight: float = 1.0,
                      bf16: bool = False):
    """Popularity-boosted top-k: rank ``softmax(u . I^T) + weight * pop`` per
    user (reference ``src/metrics.py:69-72``) in two passes over the catalog,
    never holding the [U, I] score block."""
    if _on_cpu(user_emb, item_emb, popularity):
        return mips_topk_boosted_reference(user_emb, item_emb, popularity, k,
                                           weight=weight, bf16=bf16)
    m, s = mips_lse(user_emb, item_emb, bf16=bf16)
    out = mips_boost(user_emb, item_emb, popularity, m, s, k, weight=weight,
                     bf16=bf16)
    mips_topk_boosted.launches += 1
    return out


mips_topk_boosted.launches = 0


def reset_launch_counts() -> None:
    for fn in (mips_topk, mips_lse, mips_boost, mips_topk_boosted):
        fn.launches = 0
