"""Operations and bytes of each kernel call, from its shapes, and the least
time the H100 could take for them.

Each input byte is counted read once and each output byte written once.
The leaf kernels compute in f32 on the CUDA cores whatever the storage
type; the pool mask's operations are its compares; MIPS multiplies in f32.
"""

from __future__ import annotations

# NVIDIA H100 SXM, data sheet: dense bf16 tensor-core rate, f32 outside
# the tensor cores, HBM3 bandwidth.
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12


def bound_s(flops: float, nbytes: float, peak_flops: float = PEAK_F32_FLOPS) -> float:
    """The least seconds: operations at the peak rate or bytes at the
    bandwidth, whichever takes longer."""
    return max(flops / peak_flops, nbytes / PEAK_BYTES_PER_S)


def leaf_fwd(k: int, p: int, f: int, h: int, elem: int) -> tuple:
    """``leaf_mean_nn`` forward over P parents of K slots: raw features [K,
    P, F], weights [F, H] and bias in ``elem`` bytes, the f32 scaled mask
    [P, K]; writes [P, H]."""
    io = elem * (k * p * f + f * h + h) + 4.0 * p * k
    return float(k * p * h * (2 * f + 4)), io + elem * p * h


def leaf_bwd(k: int, p: int, f: int, h: int, elem: int) -> tuple:
    """Its backward: reads the forward's inputs and the cotangent [P, H];
    writes dW and db in f32."""
    io = elem * (k * p * f + f * h + h) + 4.0 * p * k
    return float(k * p * h * (4 * f + 4)), io + elem * p * h + 4.0 * (f * h + h)


def pool_mask(b: int, k: int, p: int, valid: float) -> tuple:
    """``pool_membership_mask``: B rows of K int32 slots (``valid`` of them
    filled) against a pool of P ids; writes the [B, P] f32 mask."""
    return float(p) * float(valid), 4.0 * (b * k + p + b * p)


def mips_topk(u: int, i: int, d: int, fetch: int) -> tuple:
    """``mips_topk``: U users and I items of D f32; writes ``fetch`` (f32
    score, int64 index) pairs a user."""
    return 2.0 * u * i * d, 4.0 * (u + i) * d + u * fetch * 12.0


def gather_mean_fwd(b: int, k: int, n: int, d: int, valid: float, named: float,
                    elem: int) -> tuple:
    """``gather_mean`` forward: B rows of K int32 ids and bool mask into an
    [N, D] table; reads the ``named`` distinct rows its ``valid`` slots
    name, writes [B, D]."""
    io = 4.0 * b * k + b * k
    return float(valid) * d + b * d, io + elem * (float(named) * d + b * d)


def gather_mean_bwd(b: int, k: int, n: int, d: int, valid: float, named: float,
                    elem: int) -> tuple:
    """Its backward: reads the ids, the mask and the cotangent [B, D];
    writes every row of the table's gradient [N, D]."""
    io = 4.0 * b * k + b * k
    return 2.0 * float(valid) * d + b * d, io + elem * (b * d + n * d)
