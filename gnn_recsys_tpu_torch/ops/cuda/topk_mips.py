"""Full-catalog MIPS top-k: CUDA kernels, their plain versions, the wrappers.

Port of ``gnn_recsys_tpu/ops/pallas/topk_mips.py``.  The kernels live in
``gnn_recsys_tpu_torch/csrc/topk_mips.cu``: one score-tile kernel whose three
epilogues serve the first three wrappers below (its header says what bounds
it and how each epilogue works):

* :func:`mips_topk` — per user, the top-``k`` of ``u . i`` over the whole
  catalog (TPU ``mips_topk``).
* :func:`mips_lse` — per user, the online max ``m`` and sum-exp ``s`` of the
  scores (pass 1 of the TPU ``mips_topk_boosted``).
* :func:`mips_boost` — per user, the top-``k`` of ``exp(u.i - m) / s +
  weight * pop[i]`` (pass 2).
* :func:`mips_topk_boosted` — the two passes together.
* :func:`mlp_topk` — per user, the top-``k`` of the MLP head's score
  (``pred='nn'``) over the whole catalog, from layer 1's two halves; the
  file's second kernel, ``mlp_topk_kernel``, with the same top-k lists.

Ties go to the lowest item index (the TPU kernel's rule), so every plain
version selects with a stable descending sort; ``torch.topk`` does not
promise that order.  A wrapper takes the plain version only when its tensors
lie on the CPU; for CUDA tensors it launches the kernel or raises (at any
width: :func:`kernel_inputs` zero-pads it to a multiple of 4).  Each wrapper
of a kernel counts its launches in a plain integer attribute ``.launches``;
:func:`mips_topk_boosted` launches none of its own (its passes count).
:func:`mlp_topk` also counts the pairs it scores in ``.pairs``, on either
route.
"""

from __future__ import annotations

import contextlib
import ctypes
from typing import NamedTuple, Tuple

import torch

from gnn_recsys_tpu_torch.ops.cuda import build
from gnn_recsys_tpu_torch.utils.profiling import counter

_LIB = "topk_mips"
_P = ctypes.c_void_p
_I = ctypes.c_int


def _bind(lib: ctypes.CDLL) -> None:
    """Type the exports of this library (or of an edited copy of its source)
    and check the host's plan against the kernel's."""
    lib.mips_max_k.argtypes = []
    lib.mips_max_k.restype = _I
    lib.mips_topk_smem_bytes.argtypes = [_I, _I, _I, _I]
    lib.mips_topk_smem_bytes.restype = _I
    lib.mips_topk_splits.argtypes = [_I] * 7
    lib.mips_topk_splits.restype = _I
    lib.mips_topk_launch.argtypes = [_P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P]
    lib.mips_topk_launch.restype = _I
    lib.mips_lse_launch.argtypes = [_P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P]
    lib.mips_lse_launch.restype = _I
    lib.mips_boost_launch.argtypes = [
        _P, _P, _P, _P, _P, ctypes.c_float, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P,
    ]
    lib.mips_boost_launch.restype = _I
    lib.mlp_topk_widths.argtypes = [_I]
    lib.mlp_topk_widths.restype = _I
    lib.mlp_topk_splits.argtypes = [_I, _I, _I]
    lib.mlp_topk_splits.restype = _I
    lib.mlp_topk_launch.argtypes = [_P] * 6 + [_I] * 4 + [_P] * 5
    lib.mlp_topk_launch.restype = _I
    if (lib.mlp_topk_widths(0), lib.mlp_topk_widths(1)) != (MLP_H1, MLP_H2):
        raise RuntimeError("csrc/topk_mips.cu and its wrapper disagree on the head's widths")
    for d in (36, 128, 256):  # the host's plan must be the kernel's
        for bf16 in (False, True):
            for resident in (False, True):
                for epi in EPILOGUES:
                    got = lib.mips_topk_smem_bytes(d, int(bf16), int(resident), epi)
                    want = topk_smem_bytes(d, bf16, resident, epi)
                    if got != want:
                        raise RuntimeError(
                            f"topk_mips.cu plans {got} bytes at D={d}, bf16={bf16}, "
                            f"resident={resident}, epilogue={epi}; the host {want}")


def _lib() -> ctypes.CDLL:
    return build.load(_LIB, _bind)


def max_k() -> int:
    """Largest ``k`` the CUDA top-k kernels take (builds the library)."""
    return int(_lib().mips_max_k())


# The epilogues of csrc/topk_mips.cu's topk_kernel: the top-k of the scores
# (mips_topk), the top-k of the boosted values (mips_boost), and the max and
# sum-exp of the scores (mips_lse).
EPI_TOPK, EPI_BOOST, EPI_LSE = 0, 1, 2
EPILOGUES = (EPI_TOPK, EPI_BOOST, EPI_LSE)

# Its shared-memory layout (tk_layout): users and catalog items a block and a
# tile, dims a ring stage, ring stages, entries of a user's buffer.
_TK_BU, _TK_BI, _TK_BK, _TK_STAGES, _TK_BUF = 128, 128, 32, 3, 64
SMEM_LIMIT = 232448  # bytes of shared memory a block may use
MLP_H1, MLP_H2 = 128, 32  # the MLP head's widths: mlp_topk_kernel's fixed tile shapes


class TopkPlan(NamedTuple):
    """A topk_kernel launch: whether the block's users stay in shared memory
    for the whole catalog walk (else they stream through the ring beside the
    items), and the block's shared-memory bytes."""

    resident_users: bool
    smem_bytes: int


def topk_smem_bytes(d: int, bf16: bool, resident_users: bool, epilogue: int = EPI_TOPK) -> int:
    """Shared-memory bytes of a topk_kernel block at width ``d`` (a multiple
    of 4): the ring and the resident users; for the top-k epilogues also the
    per-user buffers (list and candidates) and three per-user counters, and
    for the boost the users' m and s."""
    esize = 2 if bf16 else 4
    ldk = _TK_BK + 4
    stage = (_TK_BI + (0 if resident_users else _TK_BU)) * ldk * esize
    padded = -(-d // _TK_BK) * _TK_BK
    users = _TK_BU * 4 * ((padded // 4) | 1) * esize if resident_users else 0
    total = _TK_STAGES * stage + users
    if epilogue != EPI_LSE:
        total += _TK_BU * _TK_BUF * 8 + (5 if epilogue == EPI_BOOST else 3) * _TK_BU * 4
    return total


def topk_plan(d: int, bf16: bool, epilogue: int = EPI_TOPK) -> TopkPlan:
    """Resident users where they fit in a block's shared memory."""
    resident = topk_smem_bytes(d, bf16, True, epilogue)
    if resident <= SMEM_LIMIT:
        return TopkPlan(True, resident)
    return TopkPlan(False, topk_smem_bytes(d, bf16, False, epilogue))


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
    promise that): (values, indices), each its own ``[rows, k]`` tensor, so
    that the whole row's sort is freed (a kept slice would hold it: serving
    every user of a 30,000-item catalog then held 24 GB of sorted ids)."""
    vals, idx = torch.sort(scores, dim=1, descending=True, stable=True)
    return vals[:, :k].contiguous(), idx[:, :k].contiguous()


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


def mlp_scores(a_u, a_i, w2, b2, w3, b3, item_tile: int = 512) -> torch.Tensor:
    """The MLP head's scores of every (user, item) pair from layer 1's two
    halves, ``a_u = u W1_u^T + b1`` [U, 128] and ``a_i = i W1_i^T`` [I,
    128]: ``sigmoid(relu(relu(a_u + a_i) W2^T + b2) w3^T + b3)``, [U, I] f32,
    through ``[U, item_tile, 128]`` tiles of PyTorch operations (``w3`` [1,
    32], ``b3`` [1], the head's Linear shapes).  The caller picks the
    matmul precision."""
    tiles = []
    for lo in range(0, a_i.shape[0], item_tile):
        h = torch.relu(a_u[:, None, :] + a_i[None, lo:lo + item_tile, :])  # [U, T, 128]
        h = torch.relu(h @ w2.T + b2)  # [U, T, 32]
        tiles.append(torch.sigmoid(h @ w3.T + b3)[..., 0])
    return torch.cat(tiles, dim=1).float()


# Users per tile loop in the plain version of mlp_topk: get_recs's chunk.
_MLP_CHUNK = 128


def mlp_topk_reference(a_u, a_i, w2, b2, w3, b3, k: int):
    """Plain version of :func:`mlp_topk`: :func:`mlp_scores` by chunks of
    128 users in full f32, then a stable sort."""
    w3, b3 = w3.reshape(1, -1), b3.reshape(1)
    vals, idx = _empty_topk(a_u.shape[0], k, a_u.device)
    with full_f32_matmul():
        for lo in range(0, a_u.shape[0], _MLP_CHUNK):
            hi = lo + _MLP_CHUNK
            vals[lo:hi], idx[lo:hi] = stable_topk(mlp_scores(a_u[lo:hi], a_i, w2, b2, w3, b3), k)
    return vals, idx


# ----------------------------------------------------------------------
# Wrappers
# ----------------------------------------------------------------------

def kernel_inputs(user_emb: torch.Tensor, item_emb: torch.Tensor,
                  bf16: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """Both embedding matrices as the kernels read them: in the working type,
    contiguous, 16-byte aligned, and zero-padded on the right to a width that
    is a multiple of 4 (the kernels copy and load 4 dims of a row at a time).
    A zero column adds exactly 0 to every product, so no score changes."""
    pad = -user_emb.shape[1] % 4
    out = []
    for x in (user_emb, item_emb):
        x = x.to(torch.bfloat16 if bf16 else torch.float32)
        if pad:
            x = torch.nn.functional.pad(x, (0, pad))
        x = x.contiguous()
        if x.data_ptr() % 16:
            x = x.clone()
        out.append(x)
    return out[0], out[1]


def _check_shapes(user_emb, item_emb, k=None) -> Tuple[int, int]:
    if user_emb.dim() != 2 or item_emb.dim() != 2:
        raise ValueError("user_emb and item_emb must be 2-D")
    (num_users, d), (num_items, d_i) = user_emb.shape, item_emb.shape
    if d != d_i or d == 0:
        raise ValueError(f"embedding widths must match and be positive, got {d}, {d_i}")
    if num_items == 0:
        raise ValueError("empty catalog")
    if k is not None:
        if not 1 <= k <= num_items:
            raise ValueError(f"k={k} must be in [1, num_items={num_items}]")
        if k > max_k():
            raise ValueError(f"k={k} exceeds the CUDA kernel's limit {max_k()}")
    return num_users, num_items


def _launch_plan(lib, num_users: int, num_items: int, d: int, k: int, bf16: bool,
                 epilogue: int) -> Tuple[int, int]:
    """(resident users, catalog splits) of a topk_kernel launch, on the
    current device."""
    resident = int(topk_plan(d, bf16, epilogue).resident_users)
    splits = lib.mips_topk_splits(num_users, num_items, d, k, resident, int(bf16), epilogue)
    return resident, splits


def _partials(splits: int, num_users: int, k: int, dev):
    """Partial buffers for ``splits`` block columns of the catalog: (max,
    sum-exp) [splits, U] for ``k`` = 0, else top-k lists [splits, U, k]."""
    if not k:
        shape = (splits, num_users)
        return (torch.empty(shape, dtype=torch.float32, device=dev),
                torch.empty(shape, dtype=torch.float32, device=dev))
    shape = (splits, num_users, k)
    return (torch.empty(shape, dtype=torch.float32, device=dev),
            torch.empty(shape, dtype=torch.int32, device=dev))


def mips_topk(user_emb: torch.Tensor, item_emb: torch.Tensor, k: int,
              bf16: bool = False):
    """Top-k inner-product search: (values [U, k] f32, indices [U, k] int64).

    ``bf16=True`` rounds the inputs to bfloat16 (half the bytes); products
    accumulate in f32 either way.  For cosine similarity, L2-normalize both
    inputs first.
    """
    if build.on_cpu(user_emb, item_emb):
        return mips_topk_reference(user_emb, item_emb, k, bf16=bf16)
    num_users, num_items = _check_shapes(user_emb, item_emb, k)
    dev = user_emb.device
    ue, ie = kernel_inputs(user_emb, item_emb, bf16)
    d = ue.shape[1]
    vals, idx = _empty_topk(num_users, k, dev)
    if num_users:
        lib = _lib()
        with torch.cuda.device(dev):
            resident, splits = _launch_plan(lib, num_users, num_items, d, k, bf16, EPI_TOPK)
            pv, pi = _partials(splits, num_users, k, dev)
            err = lib.mips_topk_launch(
                ue.data_ptr(), ie.data_ptr(), num_users, num_items, d, k, int(bf16),
                resident, splits, pv.data_ptr(), pi.data_ptr(), vals.data_ptr(),
                idx.data_ptr(), build.stream(dev),
            )
        build.check(lib, err, "mips_topk")
        mips_topk.launches += 1
    return vals, idx


counter(mips_topk, "launches")


def mips_lse(user_emb: torch.Tensor, item_emb: torch.Tensor, bf16: bool = False):
    """Per-user softmax normaliser of the scores: (max [U], sum-exp [U])."""
    if build.on_cpu(user_emb, item_emb):
        return mips_lse_reference(user_emb, item_emb, bf16=bf16)
    num_users, num_items = _check_shapes(user_emb, item_emb)
    dev = user_emb.device
    ue, ie = kernel_inputs(user_emb, item_emb, bf16)
    d = ue.shape[1]
    m = torch.empty(num_users, dtype=torch.float32, device=dev)
    s = torch.empty_like(m)
    if num_users:
        lib = _lib()
        with torch.cuda.device(dev):
            resident, splits = _launch_plan(lib, num_users, num_items, d, 0, bf16, EPI_LSE)
            pm, ps = _partials(splits, num_users, 0, dev)
            err = lib.mips_lse_launch(
                ue.data_ptr(), ie.data_ptr(), num_users, num_items, d, int(bf16), resident,
                splits, pm.data_ptr(), ps.data_ptr(), m.data_ptr(), s.data_ptr(),
                build.stream(dev),
            )
        build.check(lib, err, "mips_lse")
        mips_lse.launches += 1
    return m, s


counter(mips_lse, "launches")


def mips_boost(user_emb: torch.Tensor, item_emb: torch.Tensor,
               popularity: torch.Tensor, m: torch.Tensor, s: torch.Tensor,
               k: int, weight: float = 1.0, bf16: bool = False):
    """Top-k of ``exp(u.i - m) / s + weight * popularity[i]`` per user."""
    if build.on_cpu(user_emb, item_emb, popularity, m, s):
        return mips_boost_reference(user_emb, item_emb, popularity, m, s, k,
                                    weight=weight, bf16=bf16)
    num_users, num_items = _check_shapes(user_emb, item_emb, k)
    if popularity.numel() != num_items or m.numel() != num_users or s.numel() != num_users:
        raise ValueError("popularity must be [I]; m and s must be [U]")
    dev = user_emb.device
    ue, ie = kernel_inputs(user_emb, item_emb, bf16)
    d = ue.shape[1]
    pop = popularity.reshape(-1).float().contiguous()
    m32, s32 = m.float().contiguous(), s.float().contiguous()
    vals, idx = _empty_topk(num_users, k, dev)
    if num_users:
        lib = _lib()
        with torch.cuda.device(dev):
            resident, splits = _launch_plan(lib, num_users, num_items, d, k, bf16, EPI_BOOST)
            pv, pi = _partials(splits, num_users, k, dev)
            err = lib.mips_boost_launch(
                ue.data_ptr(), ie.data_ptr(), pop.data_ptr(), m32.data_ptr(),
                s32.data_ptr(), float(weight), num_users, num_items, d, k, int(bf16),
                resident, splits, pv.data_ptr(), pi.data_ptr(), vals.data_ptr(), idx.data_ptr(),
                build.stream(dev),
            )
        build.check(lib, err, "mips_boost")
        mips_boost.launches += 1
    return vals, idx


counter(mips_boost, "launches")


def mips_topk_boosted(user_emb: torch.Tensor, item_emb: torch.Tensor,
                      popularity: torch.Tensor, k: int, weight: float = 1.0,
                      bf16: bool = False):
    """Popularity-boosted top-k: rank ``softmax(u . I^T) + weight * pop`` per
    user (reference ``src/metrics.py:69-72``) in two passes over the catalog,
    never holding the [U, I] score block."""
    if build.on_cpu(user_emb, item_emb, popularity):
        return mips_topk_boosted_reference(user_emb, item_emb, popularity, k,
                                           weight=weight, bf16=bf16)
    m, s = mips_lse(user_emb, item_emb, bf16=bf16)
    return mips_boost(user_emb, item_emb, popularity, m, s, k, weight=weight, bf16=bf16)


def _check_mlp(a_u, a_i, w2, b2, w3, b3, k: int) -> Tuple[int, int]:
    named = dict(a_u=a_u, a_i=a_i, w2=w2, b2=b2, w3=w3, b3=b3)
    for name, t in named.items():
        if t.dtype != torch.float32:
            raise ValueError(f"mlp_topk: {name} must be float32, got {t.dtype}")
    if a_u.dim() != 2 or a_i.dim() != 2 or a_u.shape[1] != MLP_H1 or a_i.shape[1] != MLP_H1:
        raise ValueError(f"mlp_topk: a_u and a_i must be [*, {MLP_H1}], got "
                         f"{tuple(a_u.shape)} and {tuple(a_i.shape)}")
    if (tuple(w2.shape) != (MLP_H2, MLP_H1) or tuple(b2.shape) != (MLP_H2,)
            or w3.numel() != MLP_H2 or b3.numel() != 1):
        raise ValueError(f"mlp_topk: the head must be w2 [{MLP_H2}, {MLP_H1}], b2 [{MLP_H2}], "
                         f"w3 of {MLP_H2} and b3 of 1, got {tuple(w2.shape)}, "
                         f"{tuple(b2.shape)}, {tuple(w3.shape)}, {tuple(b3.shape)}")
    num_items = a_i.shape[0]
    if not 1 <= k <= num_items:
        raise ValueError(f"mlp_topk: k={k} must be in [1, num_items={num_items}]")
    return a_u.shape[0], num_items


def mlp_topk(a_u: torch.Tensor, a_i: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor,
             w3: torch.Tensor, b3: torch.Tensor, k: int):
    """Top-k items of each user by the MLP head's score: (values [U, k] f32,
    indices [U, k] int64), value descending, then index ascending.

    ``a_u = u W1_u^T + b1`` [U, 128] and ``a_i = i W1_i^T`` [I, 128] are
    layer 1's two halves; ``w2`` [32, 128], ``b2`` [32], ``w3`` (32
    values), ``b3`` (one) the rest of the head, all f32.  Every pair is
    scored in full f32 (:func:`mlp_scores` is the function)."""
    num_users, num_items = _check_mlp(a_u, a_i, w2, b2, w3, b3, k)
    mlp_topk.pairs += num_users * num_items
    if build.on_cpu(a_u, a_i, w2, b2, w3, b3):
        return mlp_topk_reference(a_u, a_i, w2, b2, w3, b3, k)
    if k > max_k():
        raise ValueError(f"k={k} exceeds the CUDA kernel's limit {max_k()}")
    dev = a_u.device
    # Contiguous; the rows of a_u and a_i 16-byte aligned for the kernel's copies.
    args = [t.contiguous() for t in (a_u, a_i, w2, b2, w3.reshape(-1), b3.reshape(-1))]
    args[:2] = [t.clone() if t.data_ptr() % 16 else t for t in args[:2]]
    vals, idx = _empty_topk(num_users, k, dev)
    if num_users:
        lib = _lib()
        with torch.cuda.device(dev):
            splits = lib.mlp_topk_splits(num_users, num_items, k)
            pv, pi = _partials(splits, num_users, k, dev)
            err = lib.mlp_topk_launch(
                *(t.data_ptr() for t in args), num_users, num_items, k, splits,
                pv.data_ptr(), pi.data_ptr(), vals.data_ptr(), idx.data_ptr(),
                build.stream(dev))
        build.check(lib, err, "mlp_topk")
        mlp_topk.launches += 1
    return vals, idx


counter(mlp_topk, "launches", "pairs")
