"""A static edge set as a two-table cuckoo hash, for membership queries on
the device.

Port of ``gnn_recsys_tpu/ops/edge_hash.py``: (u, v) int32 pairs built once
on the host into two tables of ``capacity`` slots each (the JAX package's
numpy builder: round-based insertion with eviction, at most 1/3 load, the
same mixing constants and seed attempts), and queried with exactly two
probe positions a pair, four gathers and no loop.  The JAX package may build
through its C++ core instead, which places pairs differently: the two
builders' tables can differ, their answers do not.

The hash is 32-bit unsigned arithmetic.  The host build computes it in
numpy ``uint32``; the lookup, on the table's device, in int64 masked to 32
bits, where every right shift of a non-negative value is a logical one and
no product overflows (:func:`_mul32`).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

_EMPTY = np.int32(-1)
_M32 = 0xFFFFFFFF

# Distinct odd mixing constants per (table, seed attempt).
_MIX_A = (0x9E3779B1, 0x85EBCA77, 0xC2B2AE3D, 0x27D4EB2F,
          0x165667B1, 0xD3A2646D, 0xFD7046C5, 0xB55A4F09)
_MIX_B = (0x68E31DA5, 0xB2914249, 0x71FEB7C5, 0x3C6EF372,
          0x14292967, 0x5F356495, 0x2545F491, 0x9E297A2B)


def _constants(seed: int):
    """(a1, b1, a2, b2) of a seed attempt: one (a, b) pair a table."""
    return (_MIX_A[2 * seed % 8], _MIX_B[2 * seed % 8],
            _MIX_A[(2 * seed + 1) % 8], _MIX_B[(2 * seed + 1) % 8])


def _mix_np(u: np.ndarray, v: np.ndarray, a: int, b: int) -> np.ndarray:
    """32-bit avalanche hash of pairs, in numpy uint32 (wrapping)."""
    u = u.astype(np.uint32)
    v = v.astype(np.uint32)
    h = u * np.uint32(a) ^ (v * np.uint32(b) + np.uint32(0x9E3779B9))
    h = h ^ (h >> np.uint32(16))
    h = h * np.uint32(0x7FEB352D)
    h = h ^ (h >> np.uint32(15))
    h = h * np.uint32(0x846CA68B)
    return h ^ (h >> np.uint32(16))


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x * c mod 2**32`` for int64 ``x`` in [0, 2**32): the constant's
    halves keep each product below 2**48."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _mix(u: torch.Tensor, v: torch.Tensor, a: int, b: int) -> torch.Tensor:
    """:func:`_mix_np` on int64 tensors holding uint32 values."""
    u = u.long() & _M32
    v = v.long() & _M32
    h = _mul32(u, a) ^ ((_mul32(v, b) + 0x9E3779B9) & _M32)
    h = h ^ (h >> 16)
    h = _mul32(h, 0x7FEB352D)
    h = h ^ (h >> 15)
    h = _mul32(h, 0x846CA68B)
    return h ^ (h >> 16)


def _next_pow2(x: int) -> int:
    return 1 << max(int(x) - 1, 1).bit_length()


@dataclasses.dataclass
class EdgeHashTable:
    """Two cuckoo tables of (u, v) slots, -1 where empty."""

    slot_u: torch.Tensor  # [2, capacity] int32
    slot_v: torch.Tensor  # [2, capacity] int32
    seed: int

    @property
    def capacity(self) -> int:
        return self.slot_u.shape[1]

    def to(self, device) -> "EdgeHashTable":
        return EdgeHashTable(self.slot_u.to(device), self.slot_v.to(device), self.seed)


def build_edge_hash(src, dst, min_capacity: int = 4) -> EdgeHashTable:
    """Host-side cuckoo build of the distinct (src, dst) pairs
    (``edge_hash.py:63-131``, its numpy path): each round, every pending
    pair bids for its slot in its current table, one winner a slot, the
    evicted and the losers flip tables; a build that has not settled after
    400 rounds retries with the next seed's constants, then at twice the
    capacity.  Returns the table on the CPU (:meth:`EdgeHashTable.to`
    moves it)."""
    src = np.asarray(src, dtype=np.int32)
    dst = np.asarray(dst, dtype=np.int32)
    if src.size:
        pairs = np.unique(np.stack([src, dst], axis=1), axis=0)
    else:
        pairs = np.zeros((0, 2), dtype=np.int32)
    e = pairs.shape[0]
    capacity = max(_next_pow2(int(e * 1.5) + 1), min_capacity)

    for seed in range(4):
        mask = np.uint32(capacity - 1)
        a1, b1, a2, b2 = _constants(seed)
        slot_u = np.full((2, capacity), _EMPTY, dtype=np.int32)
        slot_v = np.full((2, capacity), _EMPTY, dtype=np.int32)
        slot_idx = np.full((2, capacity), -1, dtype=np.int64)  # the pair in each slot
        if e:
            h1 = (_mix_np(pairs[:, 0], pairs[:, 1], a1, b1) & mask).astype(np.int64)
            h2 = (_mix_np(pairs[:, 0], pairs[:, 1], a2, b2) & mask).astype(np.int64)
            hashes = np.stack([h1, h2], axis=1)  # [E, 2]
            pending = np.arange(e, dtype=np.int64)
            choice = np.zeros(e, dtype=np.int64)
            ok = False
            for _ in range(400):
                if pending.size == 0:
                    ok = True
                    break
                tab = choice[pending]
                pos = hashes[pending, tab]
                _, first = np.unique(tab * capacity + pos, return_index=True)
                winners, wtab, wpos = pending[first], tab[first], pos[first]
                evicted = slot_idx[wtab, wpos]
                evicted = evicted[evicted >= 0]
                slot_u[wtab, wpos] = pairs[winners, 0]
                slot_v[wtab, wpos] = pairs[winners, 1]
                slot_idx[wtab, wpos] = winners
                placed = np.zeros(e, dtype=bool)
                placed[winners] = True
                losers = pending[~placed[pending]]
                # Losers retry their other table; evicted pairs flip too.
                choice[losers] = 1 - choice[losers]
                choice[evicted] = 1 - choice[evicted]
                pending = np.concatenate([losers, evicted])
            if not ok:
                capacity *= 2
                continue
        return EdgeHashTable(torch.from_numpy(slot_u), torch.from_numpy(slot_v), seed)
    raise RuntimeError("cuckoo edge hash build failed")


def edge_hash_lookup(table: EdgeHashTable, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Is (u[i], v[i]) in the set?  ``u``, ``v``: int tensors of one shape
    on the table's device; returns bool of that shape (``edge_hash.py:171``):
    each pair's slot in either table, two probes, no loop."""
    cap_mask = table.capacity - 1
    a1, b1, a2, b2 = _constants(table.seed)
    u32, v32 = u.to(torch.int32), v.to(torch.int32)
    p1 = _mix(u32, v32, a1, b1) & cap_mask
    p2 = _mix(u32, v32, a2, b2) & cap_mask
    m1 = (table.slot_u[0][p1] == u32) & (table.slot_v[0][p1] == v32)
    m2 = (table.slot_u[1][p2] == u32) & (table.slot_v[1][p2] == v32)
    return m1 | m2
