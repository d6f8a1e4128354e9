#!/usr/bin/env python3
"""Where the ``mips_topk`` and ``pool_membership_mask`` kernels spend their
time on one NVIDIA card.

Run from the repository root on a CUDA host::

    python3 kernel_probe.py

It builds edited copies of ``gnn_recsys_tpu_torch/csrc/{topk_mips,pool_mask}.cu``
with ``nvcc`` into a temporary directory and prints one JSON line a case.  The
``topk_mips`` edits change the one ``topk_kernel`` template, so every
instantiation compiles with them; the probes run ``mips_topk``'s f32 one
with lists in the shared buffer (``topk_kernel<float, true, EPI_TOPK>``, k=26):

* ``topk_score_only``: ``mips_topk`` at the serving shape (U=4096, I=30,000,
  D=128, k=26) and over all 100k users, against a copy whose epilogue only
  sums its scores (the score tile alone: the floor the top-k selection
  stands on).
* ``boosted_passes``: ``mips_lse`` and ``mips_boost`` at the serving shape
  against the same score-only copy (``topk_kernel<float, false, EPI_LSE>``
  and ``<float, true, EPI_BOOST>``), with their largest differences from
  the plain versions.
* ``topk_phases``: a copy with ``clock64`` probes, cycles a warp spends in
  each phase of the kernel (waiting for a ring stage, copies and FMAs, the
  filter, the offers, barriers, sorting full buffers), the buffers sorted
  and the candidates offered a warp.
* ``pool_blocks``: a copy of the pool mask with ``globaltimer`` probes at
  [1024, 32, 2560] and [1024, 128, 2560]: the span of the grid, a block's
  life, its prologue (loads, set build) and the last block's start.

The copies patch the sources' text and stop with an error where a patched
line has changed; the MIPS wrappers launch a copy's kernels inside
``copy_call``.  Times are device times (``chip_smoke.device_ms``) or CUDA
events around a call (``chip_smoke.time_ms``).
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

import chip_smoke as cs
from gnn_recsys_tpu_torch.models.layers import l2_normalize
from gnn_recsys_tpu_torch.ops.cuda import build
from gnn_recsys_tpu_torch.ops.cuda import pool_mask as pm
from gnn_recsys_tpu_torch.ops.cuda import topk_mips as tm

P_, I_ = ctypes.c_void_p, ctypes.c_int
GTIME = ("__device__ __forceinline__ unsigned long long gtime() { unsigned long long t; "
         "asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t)); return t; }\n")
PHASES = ("wait", "copy_fma", "filter", "offer", "barrier", "sort")


def patch(src: str, pairs) -> str:
    for old, new in pairs:
        if src.count(old) != 1:
            raise RuntimeError(f"kernel_probe: the source no longer has one {old[:60]!r}")
        src = src.replace(old, new)
    return src


def export(symbol: str) -> str:
    return (f"\nextern \"C\" int probe_read(void* dst, int n) {{ return (int)cudaMemcpyFromSymbol("
            f"dst, {symbol}, (size_t)n * 8); }}\n")


SCORE_ONLY = [("    if (c != nchunks - 1) continue;\n", """    if (c != nchunks - 1) continue;
    {
      float sink = 0.f;
#pragma unroll
      for (int p = 0; p < 8; ++p)
#pragma unroll
        for (int q = 0; q < 8; ++q) sink += acc[p][q];
      if (sink == 1234.5f) part_vals[0] = sink;
      continue;
    }
""")]
# Per warp: cycles in each of PHASES, buffers sorted, candidates offered;
# then the block's start and end (globaltimer).
TOPK_PHASES = [
    ("#include <stdint.h>\n", "#include <stdint.h>\n__device__ unsigned long long g_probe[8192 * 8 * 10];\n"
     + GTIME + "#define PT(i) { const long long _n = clock64(); if (lane == 0) sprof[warp][i] += _n - pcm; "
     "pcm = _n; }\n"),
    ("#pragma unroll 1\n  for (int s = 0; s < total; ++s) {",
     "  __shared__ unsigned long long sprof[8][8];\n  if (lane == 0) for (int i = 0; i < 8; ++i) sprof[warp][i] = 0;\n"
     "  const unsigned long long gt0 = gtime();\n  long long pcm = clock64();\n"
     "#pragma unroll 1\n  for (int s = 0; s < total; ++s) {"),
    ("    __syncthreads();  // stage s is in; every thread is done with stage s - 1\n",
     "    __syncthreads();  // stage s is in; every thread is done with stage s - 1\n    PT(0)\n"),
    ("    if (c != nchunks - 1) continue;\n", "    PT(1)\n    if (c != nchunks - 1) continue;\n"),
    ("      while (true) {\n        // Offer:", "      PT(2)\n      while (true) {\n        // Offer:"),
    ("        // Offers only append; a tile whose offers all found room is done.\n"
     "        if (!__syncthreads_or(pend != 0ull)) break;\n",
     "        PT(3)\n        const int more = __syncthreads_or(pend != 0ull);\n        PT(4)\n"
     "        if (!more) break;\n"),
    ("          const int n = min(__shfl_sync(FULL, mine, j), BUF);\n",
     "          const int n = min(__shfl_sync(FULL, mine, j), BUF);\n"
     "          if (lane == 0) { sprof[warp][6] += 1; sprof[warp][7] += n; }\n"),
    ("        }\n        __syncthreads();\n#pragma unroll\n",
     "        }\n        PT(5)\n        __syncthreads();\n        PT(4)\n#pragma unroll\n"),
    ("            if (!(acc[p][q] >= t)) pend &= ~(1ull << (8 * p + q));\n        }\n      }\n",
     "            if (!(acc[p][q] >= t)) pend &= ~(1ull << (8 * p + q));\n        }\n        PT(2)\n"
     "      }\n"),
    ("      for (int q = 0; q < 8; ++q) acc[p][q] = 0.f;\n  }\n  __syncthreads();\n",
     "      for (int q = 0; q < 8; ++q) acc[p][q] = 0.f;\n  }\n  __syncthreads();\n"
     "  if (lane == 0) { unsigned long long* o = g_probe + ((blockIdx.y * gridDim.x + blockIdx.x) * 8 + warp) * 10;\n"
     "    for (int i = 0; i < 8; ++i) o[i] = sprof[warp][i]; o[8] = gt0; o[9] = gtime(); }\n"),
]
# Per block: start, sets initialised, sets built, end (globaltimer).
POOL_BLOCKS = [
    ("#include <stdint.h>\n", "#include <stdint.h>\n__device__ unsigned long long g_probe[16384 * 4];\n" + GTIME),
    ("  const int tid = threadIdx.x;\n", "  const int tid = threadIdx.x;\n  const unsigned long long gt0 = gtime();\n"),
    ("  __syncthreads();\n  if (p0 >= p_end) return;\n",
     "  __syncthreads();\n  const unsigned long long gt2 = gtime();\n  if (p0 >= p_end) return;\n"),
    ("}\n\n}  // namespace",
     "  if (tid == 0) { unsigned long long* o = g_probe + (blockIdx.y * gridDim.x + blockIdx.x) * 4;\n"
     "    o[0] = gt0; o[2] = gt2; o[3] = gtime(); }\n}\n\n}  // namespace"),
]


def say(case: str, **fields) -> None:
    print(json.dumps({"case": case, **fields}), flush=True)


def build_copies(tmp: str) -> dict:
    """name -> loaded library, built in parallel (one nvcc each)."""
    csrc = build.CSRC_DIR
    topk = open(os.path.join(csrc, "topk_mips.cu")).read()
    pool = open(os.path.join(csrc, "pool_mask.cu")).read()
    srcs = {"topk_score_only": patch(topk, SCORE_ONLY),
            "topk_phases": patch(topk, TOPK_PHASES) + export("g_probe"),
            "pool_blocks": patch(pool, POOL_BLOCKS) + export("g_probe")}
    procs = {}
    for name, src in srcs.items():
        path = os.path.join(tmp, f"{name}.cu")
        with open(path, "w") as f:
            f.write(src)
        so = os.path.join(tmp, f"lib{name}.so")
        procs[name] = (subprocess.Popen([build._nvcc(), *build.NVCC_FLAGS, "-o", so, path],
                                        stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), so)
    libs = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        libs[name] = ctypes.CDLL(so)
    return libs


def read(lib, n: int) -> np.ndarray:
    lib.probe_read.argtypes = [P_, I_]
    buf = np.zeros(n, np.uint64)
    if lib.probe_read(buf.ctypes.data, n):
        raise RuntimeError("probe_read failed")
    return buf.astype(np.int64)


def copy_call(lib, fn):
    """``fn`` with the MIPS wrappers launching the kernels of ``lib``, an
    edited copy of the library."""
    tm._bind(lib)

    def call():
        saved, tm._lib = tm._lib, (lambda: lib)
        try:
            return fn()
        finally:
            tm._lib = saved
    return call


def probe_boosted(libs, dev, gen) -> None:
    k = 26
    ue = l2_normalize(torch.randn(4096, 128, generator=gen, device=dev))
    ie = l2_normalize(torch.randn(30_000, 128, generator=gen, device=dev))
    pop = torch.rand(30_000, generator=gen, device=dev)
    rm, rs = tm.mips_lse_reference(ue, ie)
    rvals, _ = tm.mips_boost_reference(ue, ie, pop, rm, rs, k)
    lse = lambda: tm.mips_lse(ue, ie)  # noqa: E731
    boost = lambda: tm.mips_boost(ue, ie, pop, rm, rs, k)  # noqa: E731
    score_only = libs["topk_score_only"]
    m, s = lse()
    say("boosted_passes", users=4096,
        source={"mips_lse_ms": cs.device_ms(lse), "mips_boost_ms": cs.device_ms(boost),
                "lse_err": float(((m.double() + s.double().log()) -
                                  (rm.double() + rs.double().log())).abs().max()),
                "boost_err": float((boost()[0] - rvals).abs().max())},
        topk_score_only={"mips_lse_ms": cs.device_ms(copy_call(score_only, lse)),
                         "mips_boost_ms": cs.device_ms(copy_call(score_only, boost))})


def probe_topk(libs, dev, gen) -> None:
    k = 26
    ie = l2_normalize(torch.randn(30_000, 128, generator=gen, device=dev))
    for u in (4096, 100_000):
        ue = l2_normalize(torch.randn(u, 128, generator=gen, device=dev))
        timer = cs.device_ms if u == 4096 else (lambda fn: cs.time_ms(fn, reps=3, warmup=1))
        kernel = timer(lambda: tm.mips_topk(ue, ie, k))
        score_only = timer(copy_call(libs["topk_score_only"], lambda: tm.mips_topk(ue, ie, k)))
        say("topk_score_only", users=u, timer=("device_ms" if u == 4096 else "events_ms"),
            kernel_ms=kernel, score_only_ms=score_only)
        lib = libs["topk_phases"]
        copy_call(lib, lambda: tm.mips_topk(ue, ie, k))()
        _, splits = tm._launch_plan(lib, u, 30_000, 128, k, False, tm.EPI_TOPK)
        torch.cuda.synchronize()
        blocks = -(-u // 128) * splits
        pr = read(lib, blocks * 80).reshape(blocks, 8, 10)
        cycles = pr[:, :, :6]
        say("topk_phases", users=u, splits=splits,
            share={n: float(cycles[:, :, j].sum() / cycles.sum()) for j, n in enumerate(PHASES)},
            cycles_a_warp={n: float(cycles[:, :, j].mean()) for j, n in enumerate(PHASES)},
            sorts_a_warp=float(pr[:, :, 6].mean()), offers_sorted_a_warp=float(pr[:, :, 7].mean()),
            block_us=float(((pr[:, 0, 9] - pr[:, 0, 8]) / 1e3).mean()))


def probe_pool(libs, dev, gen) -> None:
    lib = libs["pool_blocks"]
    lib.pool_mask_launch.argtypes = [P_, P_, I_, I_, I_, I_, I_, I_, I_, P_, P_]
    for b, k, p in ((1024, 32, 2560), (1024, 128, 2560)):
        rows, pool = cs.pool_case(dev, gen, b, k, p)
        geo = pm.launch_geometry(b, k, p)
        out = torch.empty((b, p), device=dev)
        if lib.pool_mask_launch(rows.data_ptr(), pool.data_ptr(), b, k, p, geo.grid_x, geo.chunk,
                                geo.grid_y, geo.slots, out.data_ptr(), build.stream(dev)):
            raise RuntimeError("pool_mask copy: launch failed")
        torch.cuda.synchronize()
        if not torch.equal(out, pm.pool_membership_mask_reference(rows, pool)):
            raise AssertionError("pool_mask copy differs from the plain version")
        n = geo.grid_x * geo.grid_y
        t = read(lib, n * 4).reshape(n, 4)
        rel = (t - t[:, 0].min()) / 1e3
        say("pool_blocks", shape=[b, k, p], blocks=n,
            kernel_ms=cs.device_ms(lambda: pm.pool_membership_mask(rows, pool)),
            span_us=float(rel[:, 3].max()), block_us=float((rel[:, 3] - rel[:, 0]).mean()),
            prologue_us=float((rel[:, 2] - rel[:, 0]).mean()), last_start_us=float(rel[:, 0].max()))


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device")
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(0)
    with tempfile.TemporaryDirectory() as tmp:
        libs = build_copies(tmp)
        probe_topk(libs, dev, gen)
        probe_boosted(libs, dev, gen)
        probe_pool(libs, dev, gen)
    print(cs.smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
