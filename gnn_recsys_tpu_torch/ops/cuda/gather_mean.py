"""Neighbour gather + masked mean: CUDA kernels, their plain versions, the wrappers.

Port of ``gnn_recsys_tpu/ops/pallas/gather_mean.py`` (``gather_mean_pallas``),
the ``csc_gather_mean`` contract without edge weights:

    out[b] = sum_k m[b, k] * h[clip(nbr[b, k])] / max(sum_k m[b, k], 1)

with ids clipped into ``[0, N-1]`` and zeros for a row with no valid slot.
The table is f32 or bf16 (the model's computation dtype); the sums are f32
in the kernels and in their plain versions alike.  In bf16 the forward
rounds each sum to bf16 and then divides by the count, as the TPU kernel's
bf16 ``jnp.sum`` and division do; the backward rounds each row of ``dh``
once.
:func:`gather_mean` is a ``torch.autograd.Function`` whose forward and
backward are the kernels of ``gnn_recsys_tpu_torch/csrc/gather_mean.cu``; the
gradient flows to ``h`` only.  Both kernels move bytes, and are held by how
many dependent loads an SM keeps in flight and by the longest chain of them
one warp walks (the header of the source says what bounds them).  The
forward gives a warp a destination row (a block, at K > 32, whose warps load
only the valid slots' rows).  The backward uses no atomics: each row of
``dh`` sums the cotangent rows of the slots that read it in ascending slot
order and is written once, so two runs give the same bits.  It finds those
slots through a :class:`SlotTranspose`: the dedup'd block forward passes the
one its plan's sort already made (``ops/sampling.py:unique_plan``); any
other caller gets one built here from a stable sort of the ids
(:func:`slot_transpose`).  At K = 4 and 8 a warp walks one row; at any other
K a row's run is cut into chunks of :data:`CHUNK` entries, each walked by a
warp of its own, whose f32 partials are added in chunk order
(:func:`chunk_plan` is the host's view of that cut; the scratch it needs,
:func:`bwd_scratch_bytes`, follows from the shapes alone, so a CUDA graph
can capture the call).  Each wrapper takes its plain version only for CPU
tensors; for CUDA tensors it launches its kernels or raises, and counts one
launch a call in ``.launches``.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from gnn_recsys_tpu_torch.ops.cuda import build
from gnn_recsys_tpu_torch.utils.profiling import counter

_LIB = "gather_mean"
_P = ctypes.c_void_p
_I = ctypes.c_int

# Entries of a table row's run that one warp of the backward walks at K other
# than 4 and 8 (csrc/gather_mean.cu: CHUNK).
CHUNK = 128


def _bind(lib: ctypes.CDLL) -> None:
    lib.gather_mean_fwd_launch.argtypes = [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P]
    lib.gather_mean_bwd_launch.argtypes = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                                           _P, _P, _P]
    lib.gather_mean_bwd_scratch_bytes.argtypes = [_I, _I, _I, _I]
    lib.gather_mean_bwd_scratch_bytes.restype = ctypes.c_longlong
    for fn in (lib.gather_mean_fwd_launch, lib.gather_mean_bwd_launch, lib.gather_mean_bwd_chunk):
        fn.restype = _I
    if lib.gather_mean_bwd_chunk() != CHUNK:
        raise RuntimeError(f"gather_mean.cu walks chunks of {lib.gather_mean_bwd_chunk()} "
                           f"entries; the host plans for {CHUNK}")


def _lib() -> ctypes.CDLL:
    return build.load(_LIB, _bind)


def chunk_slots(b: int, k: int, n: int) -> int:
    """Chunk slots of the backward of a [b, k] gather into n rows at K other
    than 4 and 8: a row takes max(1, ceil(len / CHUNK)) chunks of its walked
    run, and the runs hold at most b * k entries, so n + ceil(b * k / CHUNK)
    bound them whatever the ids."""
    return n + -(-b * k // CHUNK)


def bwd_scratch_bytes(n: int, b: int, k: int, d: int) -> int:
    """Bytes of device scratch the backward takes (0 at K = 4 and 8): per
    destination row its scale (f32), per table row its run's ends and first
    chunk slot (int32, one more for the total), per chunk slot a flag
    (int32), then, 16-byte aligned, an f32 partial row a chunk slot
    (csrc/gather_mean.cu: bwd_layout)."""
    if k in (4, 8):
        return 0
    slots = chunk_slots(b, k, n)
    head = 4 * (b + n + n + (n + 1) + slots)
    return -(-head // 16) * 16 + 4 * slots * d


class SlotTranspose(NamedTuple):
    """The slots of a [B, K] gather grouped by the table row they read, for
    the backward.  ``order`` (int32 [L]) lists slot positions, grouped by
    row and ascending within one; row u's are ``order[start[u]:start[u+1]]``
    (``start`` int32 [N + 1]).  Slot (b, k) of the gather is the entry
    ``off + b * K + k``, and only the entries in ``[off, off + rows * K)``
    are walked: ``rows`` (int32 [1], on the device of the other tensors) is
    the number of destination rows whose cotangent can be nonzero, or None
    for all B.  The dedup'd block forward's plan sorts a whole lower
    frontier once; each gather reading that table has its own ``off``, and
    its destination table's unique count as ``rows``."""

    order: torch.Tensor
    start: torch.Tensor
    off: int = 0
    rows: Optional[torch.Tensor] = None


# ----------------------------------------------------------------------
# Plain versions
# ----------------------------------------------------------------------

def _clipped(nbr: torch.Tensor, n: int) -> torch.Tensor:
    return nbr.long().clamp(0, max(n - 1, 0))


def _acc(dtype: torch.dtype) -> torch.dtype:
    """The dtype the sums are taken in: f32 for bf16 (and f32) tables."""
    return torch.promote_types(dtype, torch.float32)


def gather_mean_reference(h: torch.Tensor, nbr: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Plain version of the forward (``ops/message.py``'s gather and masked
    mean): [B, D] in ``h``'s dtype, summed in f32; a bf16 sum is rounded to
    bf16 before the division, as the TPU kernel's is.  Differentiable by
    autograd."""
    acc = _acc(h.dtype)
    msgs = h[_clipped(nbr, h.shape[0])].to(acc)  # [B, K, D]
    m = mask.to(acc)
    total = (msgs * m[..., None]).sum(dim=1).to(h.dtype).to(acc)
    return (total / m.sum(dim=1).clamp(min=1.0)[:, None]).to(h.dtype)


def gather_mean_bwd_reference(dout: torch.Tensor, nbr: torch.Tensor, mask: torch.Tensor,
                              n: int) -> torch.Tensor:
    """Independent plain version of the backward: dh [n, D] in ``dout``'s
    dtype, the scatter-add (``index_add_``, in f32) of ``dout[b] * m[b, k] /
    max(count_b, 1)`` into the rows ``clip(nbr)``."""
    acc = _acc(dout.dtype)
    m = mask.to(acc)
    w = m / m.sum(dim=1, keepdim=True).clamp(min=1.0)  # [B, K]
    contrib = (w[..., None] * dout.to(acc)[:, None, :]).reshape(-1, dout.shape[1])
    dh = torch.zeros((n, dout.shape[1]), dtype=acc, device=dout.device)
    return dh.index_add_(0, _clipped(nbr, n).reshape(-1), contrib).to(dout.dtype)


def slot_transpose(nbr: torch.Tensor, mask: torch.Tensor, n: int) -> SlotTranspose:
    """The transpose of a gather that has no plan: a stable sort of the
    clipped ids, with masked slots keyed to row ``n`` so that they sort past
    every row and are never walked; no host sync."""
    key = torch.where(mask, _clipped(nbr, n), n).reshape(-1).to(torch.int32)
    srt, order = torch.sort(key, stable=True)
    rows = torch.arange(n + 1, dtype=torch.int32, device=key.device)
    return SlotTranspose(order.to(torch.int32), torch.searchsorted(srt, rows, out_int32=True))


def chunk_plan(transpose: SlotTranspose, n: int, b: int, k: int):
    """The backward's cut of the runs at K other than 4 and 8, as its prep
    and scan kernels make it: each table row's run narrowed to the entries
    in ``[off, off + rows * k)`` (``lo``, ``hi``, int64 [n]) and its first
    chunk slot (``cstart``, int64 [n + 1], ``cstart[n]`` the slots used);
    chunk c of row u walks entries ``[lo[u] + c * CHUNK, min(lo[u] + (c + 1)
    * CHUNK, hi[u]))``."""
    order, start, off, rows = transpose
    limit = b if rows is None else int(rows.clamp(0, b))
    srt, s = order.long(), start.long()
    # Each run is ascending, so a row's entries in range are one stretch of it.
    lo = s[:-1] + _count_below(srt, s, off)
    hi = s[:-1] + _count_below(srt, s, off + limit * k)
    chunks = ((hi - lo + CHUNK - 1) // CHUNK).clamp(min=1)
    cstart = torch.zeros(n + 1, dtype=torch.int64, device=order.device)
    cstart[1:] = torch.cumsum(chunks, 0)
    return lo, hi, cstart


def _count_below(srt: torch.Tensor, start: torch.Tensor, key: int) -> torch.Tensor:
    """Per row u, the entries of its run ``srt[start[u]:start[u+1]]`` below ``key``."""
    n = start.numel() - 1
    row = torch.repeat_interleave(torch.arange(n, device=srt.device), start[1:] - start[:-1])
    below = (srt[start[0]:start[-1]] < key).long()
    return torch.zeros(n, dtype=torch.int64, device=srt.device).index_add_(0, row, below)


def gather_mean_bwd_plain(dout: torch.Tensor, mask: torch.Tensor, n: int,
                          transpose: SlotTranspose) -> torch.Tensor:
    """Plain version of the backward kernel: the same walk over the
    transpose.  Entry e of ``order`` belongs to the dh row u with
    ``start[u] <= e < start[u+1]``; inside the walked range, where its slot
    is valid, it brings ``dout[b] / max(count_b, 1)``, and ``index_add_``
    adds the entries in order (ascending slot within a row), in f32; dh is
    in ``dout``'s dtype."""
    b, k = mask.shape
    order, start, off, rows = transpose
    limit = b if rows is None else rows.long().clamp(0, b)
    p = order.long() - off
    walked = (p >= 0) & (p < limit * k)
    p = torch.where(walked, p, 0)
    take = walked & mask.reshape(-1)[p]
    acc = _acc(dout.dtype)
    count = mask.to(acc).sum(dim=1).clamp(min=1.0)
    contrib = torch.where(take[:, None], (dout.to(acc) * (1.0 / count)[:, None])[p // k], 0.0)
    entries = torch.arange(order.numel(), dtype=start.dtype, device=start.device)
    # Entries past start[n] (masked slots of slot_transpose) bring zeros.
    row = (torch.searchsorted(start, entries, right=True) - 1).clamp(0, n - 1)
    dh = torch.zeros((n, dout.shape[1]), dtype=acc, device=dout.device)
    return dh.index_add_(0, row, contrib).to(dout.dtype)


# ----------------------------------------------------------------------
# Wrappers
# ----------------------------------------------------------------------

def _checked(x: torch.Tensor, nbr: torch.Tensor, mask: torch.Tensor, what: str):
    """The kernels' view of (table or cotangent, ids, mask); raises on what
    they do not take."""
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{what} must be f32 or bf16, got {x.dtype}")
    if x.dim() != 2 or nbr.dim() != 2 or tuple(mask.shape) != tuple(nbr.shape):
        raise ValueError(f"{what} must be [*, D], nbr and mask [B, K]; got {tuple(x.shape)}, "
                         f"{tuple(nbr.shape)}, {tuple(mask.shape)}")
    if nbr.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"nbr must be int32 or int64, got {nbr.dtype}")
    ids = nbr.to(torch.int32).contiguous()
    m = mask.to(torch.bool).contiguous().view(torch.uint8)
    return x.contiguous(), ids, m


def _checked_transpose(t: SlotTranspose, n: int, b: int, k: int,
                       dev: torch.device) -> SlotTranspose:
    """The backward kernel's view of a transpose; raises on what it does not take."""
    order, start, off, rows = t
    if order.dtype != torch.int32 or start.dtype != torch.int32 or order.dim() != 1:
        raise ValueError("transpose: order and start must be int32, order 1-D")
    if start.numel() != n + 1:
        raise ValueError(f"transpose: start has {start.numel()} entries for {n} rows")
    if not 0 <= off <= off + b * k <= order.numel() < 2**31:
        raise ValueError(f"transpose: entries [{off}, {off + b * k}) outside order "
                         f"[0, {order.numel()})")
    if rows is not None and (rows.dtype != torch.int32 or rows.numel() != 1
                             or rows.device != dev):
        raise ValueError(f"transpose: rows must be one int32 on {dev}")
    return SlotTranspose(order.contiguous(), start.contiguous(), off, rows)


def _vec(*tensors: torch.Tensor) -> int:
    """Whether the 16-byte path applies (4 f32 or 8 bf16 a load): D a
    multiple of a load's elements and every pointer 16-byte aligned."""
    per_load = 16 // tensors[0].element_size()
    return int(tensors[0].shape[1] % per_load == 0
               and all(t.data_ptr() % 16 == 0 for t in tensors))


def gather_mean_fwd(h: torch.Tensor, nbr: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Forward: h [N, D] f32 or bf16, nbr [B, K] int32/int64, mask [B, K]
    bool -> [B, D] in ``h``'s dtype."""
    if build.on_cpu(h, nbr, mask):
        return gather_mean_reference(h, nbr, mask)
    h_, ids, m = _checked(h, nbr, mask, "h")
    (n, d), (b, k) = h_.shape, ids.shape
    if n == 0 and b * k:
        raise ValueError("h has no rows to gather from")
    dev = h_.device
    out = torch.empty((b, d), dtype=h_.dtype, device=dev)
    if b and d:
        lib = _lib()
        with torch.cuda.device(dev):
            err = lib.gather_mean_fwd_launch(h_.data_ptr(), ids.data_ptr(), m.data_ptr(),
                                             n, b, k, d, _vec(h_, out),
                                             int(h_.dtype == torch.bfloat16), out.data_ptr(),
                                             build.stream(dev))
        build.check(lib, err, "gather_mean_fwd")
        gather_mean_fwd.launches += 1
    return out


counter(gather_mean_fwd, "launches")


def gather_mean_bwd(dout: torch.Tensor, nbr: torch.Tensor, mask: torch.Tensor, n: int,
                    transpose: Optional[SlotTranspose] = None) -> torch.Tensor:
    """Backward: dh [n, D] for the cotangent ``dout`` [B, D] (f32 or bf16;
    dh in its dtype), walking ``transpose`` (built from ``nbr`` and ``mask``
    when None)."""
    if transpose is None:
        transpose = slot_transpose(nbr, mask, n)
    if build.on_cpu(dout, nbr, mask, transpose.order, transpose.start):
        return gather_mean_bwd_plain(dout, mask, n, transpose)
    g, ids, m = _checked(dout, nbr, mask, "dout")
    (b, d), k = g.shape, ids.shape[1]
    if ids.shape[0] != b:
        raise ValueError(f"dout has {b} rows, nbr {ids.shape[0]}")
    dev = g.device
    order, start, off, rows = _checked_transpose(transpose, n, b, k, dev)
    dh = torch.empty((n, d), dtype=g.dtype, device=dev)  # the kernels write every row
    if n and d:
        lib = _lib()
        # One buffer whose size follows from the shapes alone (CUDA graphs).
        nbytes = bwd_scratch_bytes(n, b, k, d)
        scratch = torch.empty(nbytes, dtype=torch.uint8, device=dev) if nbytes else None
        with torch.cuda.device(dev):
            err = lib.gather_mean_bwd_launch(
                g.data_ptr(), m.data_ptr(), order.data_ptr(), start.data_ptr(),
                None if rows is None else rows.data_ptr(), off, n, b, k, d, _vec(g, dh),
                int(g.dtype == torch.bfloat16), dh.data_ptr(),
                None if scratch is None else scratch.data_ptr(), build.stream(dev))
        build.check(lib, err, "gather_mean_bwd")
        gather_mean_bwd.launches += 1
    return dh


counter(gather_mean_bwd, "launches")


class _GatherMean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, nbr, mask, transpose):
        ctx.save_for_backward(nbr, mask)
        ctx.n = h.shape[0]
        ctx.transpose = transpose
        return gather_mean_fwd(h, nbr, mask)

    @staticmethod
    def backward(ctx, g):
        nbr, mask = ctx.saved_tensors
        # The ids, the mask and the transpose (graph structure) take no gradient.
        return gather_mean_bwd(g, nbr, mask, ctx.n, ctx.transpose), None, None, None


def gather_mean(h: torch.Tensor, nbr: torch.Tensor, mask: torch.Tensor,
                transpose: Optional[SlotTranspose] = None) -> torch.Tensor:
    """``out[b] = sum_k mask[b,k] h[clip(nbr[b,k])] / max(sum_k mask[b,k], 1)``.

    h: [N, D] f32 or bf16; nbr: [B, K] int32 or int64 (any value where the
    mask is False); mask: [B, K] bool; ``transpose``: the gather's slots
    grouped by table row (:class:`SlotTranspose`), or None to have the
    backward sort them.  Returns [B, D] in ``h``'s dtype (sums in f32).  CPU tensors take the plain versions, CUDA
    tensors the kernels, forward and backward, through the same
    ``autograd.Function``."""
    # Converted once here, so that neither kernel's wrapper copies them again.
    return _GatherMean.apply(h, nbr.to(torch.int32).contiguous(),
                             mask.to(torch.bool).contiguous(), transpose)
