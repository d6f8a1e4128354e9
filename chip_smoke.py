#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA card: build the hand-written
kernels, hold each against its plain version, serve recommendations with the
full-width Medium model, then train it.

Run from the repository root on a CUDA host (one card)::

    python3 chip_smoke.py

Phases, one line each; a failing phase raises and the exit code is not 0:

1. device: the card's name and power limit, torch and CUDA versions.
2. build: ``nvcc`` of ``gnn_recsys_tpu_torch/csrc/*.cu`` for sm_90a (one
   process a source, all at once), with the compiler's register /
   shared-memory / spill summary.
3. kernels: each kernel against its plain version; its time (``ms``: the
   device time of its kernels under ``torch.profiler``; ``events_ms``: CUDA
   events around back-to-back calls, host overhead included) beside the
   bound, the plain version's device time and, where one PyTorch call
   computes the same function, that call's.  The MIPS kernels at a serving shape (U=4096 users,
   I=30,000 items, D=128, k=26), a tied case, a bf16 case; ``leaf_mean_nn``
   forward and backward at the training step's widest leaf (P=18,432, K=8,
   F=8, H=256) in f32 and bf16, a ragged P and an all-masked row;
   ``pool_membership_mask`` at [1024, 32, 2560] with -1 padding and ragged
   B and P; ``gather_mean`` forward and backward at the dedup step's widest
   mean (B=38,912, K=8, N=30,000, D=256) and a ragged B, with an all-masked
   row and ids of -1 and >= N among the valid slots.
4. slice: the 100k-user / 30k-item synthetic graph of ``bench.py``, the
   Medium ``ConvModel`` (hidden 256, out 128, mean_nn, cos, 2 conv layers)
   with seeded random weights saved as a run; requests of 1, 128 and 4096
   users through ``inference_ondemand`` (and 4096 with the popularity
   boost), then ``get_metrics_at_k`` over every test user.  The kernels'
   launch counters must grow, every rec is a catalog id or -1, no
   already-bought item is recommended, and the kernel route agrees with the
   ``torch`` route.
5. train: the ``bench.py`` training step (dense pool of 2560, fanouts (8, 4),
   2048 edges a batch, batch-edge exclusion, max-margin loss, Adam) with the
   leaf and pool-mask kernels, about 200 steps on the same graph and model:
   median step time (CUDA events, batch assembly included), edges a second
   (all steps' edges over their host time), peak memory, the loss curve, launch
   counts that must grow by the exact per-step count, then 5 steps under
   ``torch.profiler`` (device time by kernel group, idle share); one step of
   the kernel route against the plain route (same parameters and draws);
   the trained model's recall@10, which must beat the random weights' of
   phase 4.
6. train_dedup: the same step through the dedup'd block forward
   (``MinibatchConfig(dedup=True)``), about 50 steps from fresh random
   weights: the same report, launch counts of exactly 8 / 8 / 2 / 0 a step
   (gather-mean forward / backward, pool mask, leaf), one step of the kernel
   route against the plain route (the gather-mean wrapper swapped for its
   plain version in the model for that step).
7. packed_leaf: one tree forward at fanouts (-1, -1) for 32 users and 32
   items through the packed leaf cache (``attach_leaf_features``) and
   without it.

Then a ``{"kernels": [...]}`` JSON line, the card's name and power limit,
and the last line ``{"ok": true, "device": {...}}``.  Exits non-zero without
a CUDA device.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from gnn_recsys_tpu_torch.config import HyperParams
from gnn_recsys_tpu_torch.graph.hetero import attach_leaf_features
from gnn_recsys_tpu_torch.inference import already_bought_from_graph, inference_ondemand
from gnn_recsys_tpu_torch.models import conv_model
from gnn_recsys_tpu_torch.models.conv_model import ConvModel
from gnn_recsys_tpu_torch.models.layers import l2_normalize
from gnn_recsys_tpu_torch.ops.cuda import build
from gnn_recsys_tpu_torch.ops.cuda import gather_mean as gm
from gnn_recsys_tpu_torch.ops.cuda import leaf_agg as la
from gnn_recsys_tpu_torch.ops.cuda import pool_mask as pm
from gnn_recsys_tpu_torch.ops.cuda import topk_mips as tm
from gnn_recsys_tpu_torch.ops.membership import build_padded_pair_set
from gnn_recsys_tpu_torch.ops.sampling import Draws
from gnn_recsys_tpu_torch.retrieval.metrics import get_metrics_at_k
from gnn_recsys_tpu_torch.retrieval.recs import get_recs
from gnn_recsys_tpu_torch.train.checkpoint import load_run, model_kwargs_to_config, save_run
from gnn_recsys_tpu_torch.train.full_batch import TrainState, compute_embeddings, init_model
from gnn_recsys_tpu_torch.train.minibatch import (
    EdgeStore,
    MinibatchConfig,
    iter_edge_batches,
    make_minibatch_loss,
    make_minibatch_step,
)
from gnn_recsys_tpu_torch.utils.synthetic import make_synthetic_data

# H100 SXM published peaks (NVIDIA data sheet): f32 outside the tensor
# cores, and HBM3 bandwidth.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
TOL = 1e-5  # f32 sums in another order than the plain version's product
# dW / db: sums of K*P terms, relative to the largest entry; the gather-mean
# backward's dh: sums of scaled cotangent rows, added by atomics in an order
# that changes from run to run.
GRAD_REL = 1e-5
BF16_RTOL = 2.0**-7  # one bf16 ulp: both sides round the same f32 sums
# One step, kernel route against plain route: the CPU tests' tolerances
# (tests/test_torch_minibatch.py).
LOSS_RTOL, STEP_GRAD_RTOL, STEP_GRAD_ATOL = 1e-5, 1e-4, 1e-6
BUYS = ("user", "buys", "item")
MIPS = ("gnn_recsys_tpu_torch/csrc/topk_mips.cu", "gnn_recsys_tpu/ops/pallas/topk_mips.py")
LEAF = ("gnn_recsys_tpu_torch/csrc/leaf_agg.cu", "gnn_recsys_tpu/ops/pallas/leaf_agg.py")
POOL = ("gnn_recsys_tpu_torch/csrc/pool_mask.cu", "gnn_recsys_tpu/ops/pallas/pool_mask.py")
GATHER = ("gnn_recsys_tpu_torch/csrc/gather_mean.cu", "gnn_recsys_tpu/ops/pallas/gather_mean.py")
NO_YARDSTICK = "no one-call PyTorch yardstick computes this function"


def say(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def time_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Mean time a call of ``fn`` in ms between CUDA events around
    back-to-back calls (after warm-up).  Where the host takes longer to
    issue a call than the card to run it, this measures the host."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def profiled_kernels(run, n: int):
    """``run`` ``n`` times under ``torch.profiler`` (after one warm-up call):
    (host ms a run, [(kernel name, launches, device us)])."""
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            run()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3 / n
    kernels = []
    for evt in prof.key_averages():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            us = getattr(evt, "self_device_time_total", None)
            kernels.append((evt.key, evt.count, evt.self_cuda_time_total if us is None else us))
    return host_ms, kernels


def device_ms(fn, reps: int = 20) -> float:
    """Device time of one call of ``fn`` in ms: the summed durations of the
    kernels it launches (``torch.profiler``).  Raises where the profiler
    records no kernel, so that ``ms`` always means device time."""
    _, kernels = profiled_kernels(fn, reps)
    if not kernels:
        raise RuntimeError("torch.profiler recorded no CUDA kernel for a call that launches one")
    return sum(us for _, _, us in kernels) / 1e3 / reps


def bound(flops: float, nbytes: float) -> tuple:
    """(least time in ms, what sets it) on the published H100 peaks."""
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


# ----------------------------------------------------------------------
# Checks
# ----------------------------------------------------------------------

def check_topk(what, vals, idx, rvals, ridx, exact_score) -> float:
    """Values within TOL of the plain version's; indices equal except at
    near-tied slots, where the kernel's item must score within TOL of the
    slot's plain value.  ``exact_score(rows, items)`` gives f64 scores.
    Returns the largest value difference."""
    err = float((vals - rvals).abs().max()) if vals.numel() else 0.0
    if not err <= TOL:
        raise AssertionError(f"{what}: values differ by {err}")
    rows, cols = torch.nonzero(idx != ridx, as_tuple=True)
    if rows.numel():
        gap = (exact_score(rows, idx[rows, cols]) - rvals[rows, cols].double()).abs()
        if not float(gap.max()) <= TOL:
            raise AssertionError(f"{what}: {rows.numel()} index mismatches, "
                                 f"largest score gap {float(gap.max())}")
    srt = idx.sort(dim=1).values
    if (srt[:, 1:] == srt[:, :-1]).any():
        raise AssertionError(f"{what}: repeated index in a row")
    return err


def dot_scores(ue, ie):
    ue64, ie64 = ue.double(), ie.double()
    return lambda r, i: (ue64[r] * ie64[i]).sum(dim=-1)


# ----------------------------------------------------------------------
# Phases
# ----------------------------------------------------------------------

def phase_device() -> str:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device")
    kind = torch.cuda.get_device_name(0)
    say("device", nvidia_smi=smi(), kind=kind, torch=torch.__version__,
        cuda=torch.version.cuda, count=torch.cuda.device_count())
    return kind


def phase_build() -> None:
    t0 = time.perf_counter()
    build.build(["topk_mips", "leaf_agg", "pool_mask", "gather_mean"])
    say("build", seconds=time.perf_counter() - t0, info=build.build_info)


def phase_kernels(dev, num_users=4096, num_items=30_000, dim=128, k=26,
                  weight=1.0, leaf=(8, 18_432, 8, 256), pool=(1024, 32, 2560),
                  gather=(38_912, 8, 30_000, 256), timed=True, seed=0) -> list:
    """Each kernel against its plain version on ``dev``; returns the rows of
    the kernels line (without launches).  ``leaf`` is (K, P, F, H),
    ``pool`` (B, K, P), ``gather`` (B, K, N, D)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    ue = l2_normalize(torch.randn(num_users, dim, generator=gen, device=dev))
    ie = l2_normalize(torch.randn(num_items, dim, generator=gen, device=dev))
    pop = torch.rand(num_items, generator=gen, device=dev)
    exact = dot_scores(ue, ie)
    rows = []

    def record(name, files, tpu_line, err, kernel, plain, library, flops, nbytes):
        b_ms, b_by = bound(flops, nbytes)
        row = {"name": name, "route": "cuda", "source": files[0],
               "replaces": f"{files[1]}:{tpu_line}", "launches": None,
               "max_abs_err": err, "ms": None, "plain_ms": None,
               "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}
        if library is None:
            row["library"] = NO_YARDSTICK
        if timed:
            with tm.full_f32_matmul():
                row.update(ms=device_ms(kernel), events_ms=time_ms(kernel),
                           plain_ms=device_ms(plain, reps=3))
                if library is not None:
                    row["library_ms"] = device_ms(library, reps=3)
        rows.append(row)
        say("kernel", **row)

    def mips(name, tpu_line, err, kernel, plain, library, flops, nbytes):
        record(name, MIPS, tpu_line, err, kernel, plain, library, flops, nbytes)

    flops = 2.0 * num_users * num_items * dim
    emb_bytes = 4.0 * (num_users + num_items) * dim
    topk_bytes = num_users * k * (4 + 8)

    # mips_topk, f32
    vals, idx = tm.mips_topk(ue, ie, k)
    rvals, ridx = tm.mips_topk_reference(ue, ie, k)
    err = check_topk("mips_topk f32", vals, idx, rvals, ridx, exact)
    # all items tied: exactly the lowest indices
    ie_tied = ie[:1].expand(num_items, dim).contiguous()
    _, tidx = tm.mips_topk(ue, ie_tied, k)
    if not torch.equal(tidx, torch.arange(k, device=dev).expand(num_users, k)):
        raise AssertionError("mips_topk: ties must go to the lowest indices")
    # bf16 inputs
    bvals, bidx = tm.mips_topk(ue, ie, k, bf16=True)
    brvals, bridx = tm.mips_topk_reference(ue, ie, k, bf16=True)
    err_bf16 = check_topk("mips_topk bf16", bvals, bidx, brvals, bridx,
                          dot_scores(ue.bfloat16(), ie.bfloat16()))
    say("kernel_bf16", name="mips_topk", max_abs_err=err_bf16)
    mips("mips_topk", 52, max(err, err_bf16),
           lambda: tm.mips_topk(ue, ie, k), lambda: tm.mips_topk_reference(ue, ie, k),
           lambda: torch.topk(ue @ ie.T, k, dim=1), flops, emb_bytes + topk_bytes)

    # pass 1: the softmax normaliser; error on the log-sum-exp scale
    m, s = tm.mips_lse(ue, ie)
    rm, rs = tm.mips_lse_reference(ue, ie)
    err = float(((m.double() + s.double().log()) - (rm.double() + rs.double().log())).abs().max())
    if not err <= TOL:
        raise AssertionError(f"mips_lse: log-sum-exp differs by {err}")
    mips("mips_lse", 108, err, lambda: tm.mips_lse(ue, ie),
           lambda: tm.mips_lse_reference(ue, ie),
           lambda: torch.logsumexp(ue @ ie.T, dim=1), flops, emb_bytes + 8.0 * num_users)

    # pass 2: boosted top-k on the plain normaliser
    vals, idx = tm.mips_boost(ue, ie, pop, rm, rs, k, weight=weight)
    rvals, ridx = tm.mips_boost_reference(ue, ie, pop, rm, rs, k, weight=weight)
    m64, s64, p64 = rm.double(), rs.double(), pop.double()
    err = check_topk(
        "mips_boost", vals, idx, rvals, ridx,
        lambda r, i: torch.exp(exact(r, i) - m64[r]) / s64[r] + weight * p64[i])
    _, tidx = tm.mips_topk_boosted(ue, ie_tied, torch.zeros_like(pop), k, weight=weight)
    if not torch.equal(tidx, torch.arange(k, device=dev).expand(num_users, k)):
        raise AssertionError("mips_boost: ties must go to the lowest indices")
    mips("mips_boost", 141, err,
           lambda: tm.mips_boost(ue, ie, pop, rm, rs, k, weight=weight),
           lambda: tm.mips_boost_reference(ue, ie, pop, rm, rs, k, weight=weight),
           lambda: torch.topk(torch.softmax(ue @ ie.T, dim=1) + weight * pop, k, dim=1),
           flops, emb_bytes + 4.0 * num_items + 8.0 * num_users + topk_bytes)
    leaf_rows(dev, gen, record, *leaf)
    pool_rows(dev, gen, record, *pool)
    gather_rows(dev, gen, record, *gather)
    return rows


def leaf_case(dev, gen, k, p, f, h, dtype=torch.float32):
    """Random leaf inputs: x [K, P, F], mask_scaled [P, K] with an all-masked
    row, w [F, H], b [H], and a cotangent g [P, H]."""
    x = torch.randn(k, p, f, generator=gen, device=dev)
    mask = (torch.rand(p, k, generator=gen, device=dev) < 0.7).float()
    mask[p // 2] = 0.0
    ms = mask / mask.sum(dim=1, keepdim=True).clamp(min=1.0)
    w = 0.3 * torch.randn(f, h, generator=gen, device=dev)
    b = 0.1 * torch.randn(h, generator=gen, device=dev)
    g = torch.randn(p, h, generator=gen, device=dev)
    return x.to(dtype), ms, w.to(dtype), b.to(dtype), g.to(dtype)


def leaf_rows(dev, gen, record, k, p, f, h) -> None:
    """``leaf_mean_nn`` forward and backward against their plain versions:
    f32 at the shape given, bf16 (forward) and a ragged P."""
    errs, grad_errs = [], []
    for pp in (p, p - 5 if p > 5 else p):
        x, ms, w, b, g = leaf_case(dev, gen, k, pp, f, h)
        out = la.leaf_mean_nn_fwd(x, ms, w, b)
        errs.append(float((out - la.leaf_mean_nn_reference(x, ms, w, b)).abs().max()))
        if not errs[-1] <= TOL or not (out[pp // 2] == 0).all():
            raise AssertionError(f"leaf_mean_nn_fwd P={pp}: differs by {errs[-1]} "
                                 f"or the all-masked row is not 0")
        dw, db = la.leaf_mean_nn_bwd(x, ms, w, b, g)
        for got, want in zip((dw, db), la.leaf_mean_nn_bwd_reference(x, ms, w, b, g)):
            grad_errs.append(float((got - want).abs().max()))
            if not grad_errs[-1] <= GRAD_REL * max(1.0, float(want.abs().max())):
                raise AssertionError(f"leaf_mean_nn_bwd P={pp}: differs by {grad_errs[-1]}")
        dw2, db2 = la.leaf_mean_nn_bwd(x, ms, w, b, g)
        if not (torch.equal(dw, dw2) and torch.equal(db, db2)):
            raise AssertionError("leaf_mean_nn_bwd: two runs differ")
    xb, msb, wb, bb, _ = leaf_case(dev, gen, k, p, f, h, torch.bfloat16)
    outb = la.leaf_mean_nn_fwd(xb, msb, wb, bb).float()
    refb = la.leaf_mean_nn_reference(xb, msb, wb, bb).float()
    if not ((outb - refb).abs() <= BF16_RTOL * refb.abs() + 1e-6).all():
        raise AssertionError("leaf_mean_nn_fwd bf16: beyond one bf16 ulp")
    say("kernel_bf16", name="leaf_mean_nn_fwd", max_abs_err=float((outb - refb).abs().max()))

    x, ms, w, b, g = leaf_case(dev, gen, k, p, f, h)
    io = 4.0 * (k * p * f + p * k + f * h + h)  # x, the mask, w, b
    record("leaf_mean_nn_fwd", LEAF, 78, max(errs),
           lambda: la.leaf_mean_nn_fwd(x, ms, w, b),
           lambda: la.leaf_mean_nn_reference(x, ms, w, b), None,
           float(k * p * h * (2 * f + 4)), io + 4.0 * p * h)
    record("leaf_mean_nn_bwd", LEAF, 94, max(grad_errs),
           lambda: la.leaf_mean_nn_bwd(x, ms, w, b, g),
           lambda: la.leaf_mean_nn_bwd_reference(x, ms, w, b, g), None,
           float(k * p * h * (4 * f + 4)), io + 4.0 * (p * h + f * h + h))


def pool_rows(dev, gen, record, b, k, p) -> None:
    """``pool_membership_mask`` against its plain version: -1 padded rows,
    the shape given and a ragged (B, P)."""
    for bb, pp in ((b, p), (b - 24 if b > 24 else b, p - 60 if p > 60 else p)):
        rows = torch.randint(0, 30_000, (bb, k), generator=gen, device=dev, dtype=torch.int32)
        valid = torch.randint(0, k + 1, (bb, 1), generator=gen, device=dev)
        rows[torch.arange(k, device=dev)[None, :] >= valid] = -1
        pool = torch.randint(0, 30_000, (pp,), generator=gen, device=dev, dtype=torch.int32)
        pool[: min(pp, k)] = rows[0, : min(pp, k)]  # some pairs hit; -1 never matches
        out = pm.pool_membership_mask(rows, pool)
        if not torch.equal(out, pm.pool_membership_mask_reference(rows, pool)):
            raise AssertionError(f"pool_membership_mask [{bb}, {k}, {pp}] differs")
    # Compares the function needs: every valid slot of a row, per pool entry.
    compares = float(p) * float((rows >= 0).sum())
    record("pool_membership_mask", POOL, 31, 0.0, lambda: pm.pool_membership_mask(rows, pool),
           lambda: pm.pool_membership_mask_reference(rows, pool), None,
           compares, 4.0 * (b * k + p + b * p))


def gather_case(dev, gen, b, k, n, d):
    """Random gather-mean inputs: h [N, D], int32 ids [B, K] with -1 and >= N
    among the valid slots (both clipped), a bool mask with an all-masked row,
    and a cotangent [B, D]."""
    h = torch.randn(n, d, generator=gen, device=dev)
    nbr = torch.randint(0, n, (b, k), generator=gen, device=dev, dtype=torch.int32)
    mask = torch.rand(b, k, generator=gen, device=dev) < 0.8
    mask[b // 2] = False
    nbr[0, 0], nbr[-1, -1] = -1, n + 3
    mask[0, 0] = mask[-1, -1] = True
    return h, nbr, mask, torch.randn(b, d, generator=gen, device=dev)


def gather_rows(dev, gen, record, b, k, n, d) -> None:
    """``gather_mean`` forward and backward against their plain versions at
    the shape given and a ragged B; the one-call yardstick is
    ``embedding_bag`` (sum, per-slot weights m / max(count, 1)), forward and
    its autograd backward."""
    errs, grad_errs = [], []
    for bb in (b, b - 7 if b > 7 else b):
        h, nbr, mask, g = gather_case(dev, gen, bb, k, n, d)
        out, want = gm.gather_mean_fwd(h, nbr, mask), gm.gather_mean_reference(h, nbr, mask)
        errs.append(float((out - want).abs().max()))
        if not errs[-1] <= TOL * max(1.0, float(want.abs().max())) or not (out[bb // 2] == 0).all():
            raise AssertionError(f"gather_mean_fwd B={bb}: differs by {errs[-1]} "
                                 f"or the all-masked row is not 0")
        dh, want = gm.gather_mean_bwd(g, nbr, mask, n), gm.gather_mean_bwd_reference(g, nbr, mask, n)
        grad_errs.append(float((dh - want).abs().max()))
        if not grad_errs[-1] <= GRAD_REL * max(1.0, float(want.abs().max())):
            raise AssertionError(f"gather_mean_bwd B={bb}: differs by {grad_errs[-1]}")

    h, nbr, mask, g = gather_case(dev, gen, b, k, n, d)
    m = mask.float()
    weights = m / m.sum(dim=1, keepdim=True).clamp(min=1.0)
    clipped = nbr.long().clamp(0, n - 1)
    h_req = h.clone().requires_grad_()
    bag = torch.nn.functional.embedding_bag(clipped, h_req, mode="sum",
                                            per_sample_weights=weights)
    valid = float(mask.sum())
    io = 4.0 * (n * d + b * k) + b * k  # h, the int32 ids, the bool mask
    record("gather_mean_fwd", GATHER, 49, max(errs), lambda: gm.gather_mean_fwd(h, nbr, mask),
           lambda: gm.gather_mean_reference(h, nbr, mask),
           lambda: torch.nn.functional.embedding_bag(clipped, h, mode="sum",
                                                     per_sample_weights=weights),
           valid * d + b * d, io + 4.0 * b * d)
    record("gather_mean_bwd", GATHER, 49, max(grad_errs),
           lambda: gm.gather_mean_bwd(g, nbr, mask, n),
           lambda: gm.gather_mean_bwd_reference(g, nbr, mask, n),
           lambda: torch.autograd.grad(bag, h_req, g, retain_graph=True),
           2.0 * valid * d + b * d, 4.0 * (b * d + b * k + n * d) + b * k)  # dout, ids, mask, dh


def _assert_recs_valid(recs: dict, bought_rows: np.ndarray, num_items: int) -> None:
    uids = np.fromiter(recs.keys(), dtype=np.int64)
    arr = np.asarray(list(recs.values()), dtype=np.int64)
    if not ((arr == -1) | ((arr >= 0) & (arr < num_items))).all():
        raise AssertionError("a rec is neither a catalog id nor -1")
    rows = bought_rows[uids]
    hit = (arr[:, :, None] == rows[:, None, :]) & (arr[:, :, None] >= 0)
    if hit.any():
        raise AssertionError("an already-bought item was recommended")


def _assert_routes_agree(a: torch.Tensor, b: torch.Tensor, score) -> int:
    """Kernel route ``a`` vs torch route ``b``: rows may differ only where
    the scores of the two lists agree within TOL (near-ties at the fetch
    boundary).  Returns the number of differing rows."""
    diff = torch.nonzero((a != b).any(dim=1)).flatten()
    for r in diff.tolist():
        sa, sb = score(r, a[r]).sort().values, score(r, b[r]).sort().values
        if not float((sa - sb).abs().max()) <= TOL:
            raise AssertionError(f"kernel and torch routes disagree for row {r}")
    return int(diff.numel())


def request_breakdown(run_dir, dev, uids, k) -> dict:
    """Host-clock seconds of the steps of one ``inference_ondemand`` request,
    run one by one (each ends in a device synchronize)."""
    out = {}

    def step(name, fn):
        t0 = time.perf_counter()
        result = fn()
        sync(dev)
        out[name] = time.perf_counter() - t0
        return result

    run = step("load_run", lambda: load_run(run_dir))
    g = run["graph"]

    def make_model():
        model = ConvModel(**model_kwargs_to_config(run["model_kwargs"]))
        model.load_state_dict(run["params"])
        return model.to(dev)

    model = step("build_model", make_model)
    feats = {nt: g.ndata[nt]["features"] for nt in g.ntypes}
    h = step("embed", lambda: compute_embeddings(model, g, feats, device=dev))
    ab_u, ab_i = already_bought_from_graph(g)
    ps = step("bought_table",
              lambda: build_padded_pair_set(ab_u, ab_i, num_src=g.num_nodes("user")))
    step("rank", lambda: get_recs(h["user"], h["item"], uids, k, already_bought=ps,
                                  device=dev).cpu())
    return out


def bench_data(num_users=100_000, num_items=30_000):
    """The synthetic click+purchase graph of ``bench.py:206-216``."""
    return make_synthetic_data(
        num_users=num_users, num_items=num_items, num_groups=64,
        interactions_per_user=10, test_per_user=2, feat_dim=8, with_clicks=True,
        seed=0, max_fanout=32,
    )


def medium_kwargs(graph, hidden=256, out=128) -> dict:
    """The Medium ``ConvModel`` of ``bench.py:218-233`` (f32)."""
    return dict(canonical_etypes=graph.canonical_etypes,
                dims=(("user", 8), ("item", 8), ("hidden", hidden), ("out", out)),
                n_layers=3, aggregator_type="mean_nn", pred="cos", aggregator_hetero="sum",
                embedding_layer=True)


def phase_slice(dev, data, hidden=256, out=128, request_sizes=(1, 128, 4096), k=10,
                on_card=True):
    """Serve the Medium model through the port's entry points on ``dev``;
    returns (the launch counts of the main path, the random weights'
    recall@k)."""
    num_users, num_items = data.num_users, data.num_items
    g = data.graph
    buys_u, buys_i = data.train_pairs[BUYS]
    counts = np.bincount(buys_i, minlength=num_items).astype(np.float32)
    g.ndata["item"]["popularity"] = torch.from_numpy(counts / counts.max())[:, None]
    kw = medium_kwargs(g, hidden, out)
    model = ConvModel(**kw, generator=torch.Generator().manual_seed(0))
    model_kwargs = dict(kw, canonical_etypes=[list(e) for e in kw["canonical_etypes"]],
                        dims=[list(d) for d in kw["dims"]], norm=True, dropout=0.0)
    bought_rows = build_padded_pair_set(buys_u, buys_i, num_src=num_users).rows.numpy()
    feats = {nt: g.ndata[nt]["features"] for nt in g.ntypes}
    rng = np.random.default_rng(1)
    report = {}

    with tempfile.TemporaryDirectory() as run_dir:
        t0 = time.perf_counter()
        save_run(run_dir, model.state_dict(), model_kwargs, hyper_params=HyperParams(),
                 graph=g)
        report["save_run_s"] = time.perf_counter() - t0
        model.to(dev)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        compute_embeddings(model, g, feats, device=dev)  # warm-up
        sync(dev)
        t0 = time.perf_counter()
        h = compute_embeddings(model, g, feats, device=dev)
        sync(dev)
        report["embed_s"] = time.perf_counter() - t0
        for nt, n in (("user", num_users), ("item", num_items)):
            if h[nt].shape != (n, out) or not torch.isfinite(h[nt]).all():
                raise AssertionError(f"{nt} embeddings: shape {tuple(h[nt].shape)} or not finite")

        # The main path: counters from 0, read right after.
        tm.reset_launch_counts()
        latencies = []
        for n, boost in [(n, False) for n in request_sizes] + [(request_sizes[-1], True)]:
            uids = rng.choice(num_users, n, replace=False).tolist()
            t0 = time.perf_counter()
            recs = inference_ondemand(run_dir, uids, k=k, use_popularity=boost, device=dev)
            sync(dev)
            latencies.append({"users": n, "boost": boost, "s": time.perf_counter() - t0})
            if sorted(recs) != sorted(uids) or any(len(r) != k for r in recs.values()):
                raise AssertionError("inference_ondemand answered other users or widths")
            _assert_recs_valid(recs, bought_rows, num_items)
        t0 = time.perf_counter()
        metrics = get_metrics_at_k(h["user"], h["item"], data.test_ground_truth,
                                   (buys_u, buys_i), k, device=dev)
        sync(dev)
        report["metrics_s"] = time.perf_counter() - t0
        launches = {fn.__name__: fn.launches for fn in
                    (tm.mips_topk, tm.mips_lse, tm.mips_boost, tm.mips_topk_boosted)}
        report["request_breakdown_s"] = request_breakdown(
            run_dir, dev, rng.choice(num_users, request_sizes[-1], replace=False), k)
    report.update(requests=latencies, launches=launches,
                  precision_recall_coverage=metrics)
    if on_card and not all(launches.values()):
        raise AssertionError(f"a kernel of the serving path never launched: {launches}")
    if not all(np.isfinite(metrics)) or not 0 <= metrics[1] <= 1:
        raise AssertionError(f"bad metrics {metrics}")

    # Kernel route against the torch route on the same embeddings.
    ps = build_padded_pair_set(buys_u, buys_i, num_src=num_users)
    uids = torch.as_tensor(rng.choice(num_users, request_sizes[-1], replace=False), device=dev)
    ue, ie = l2_normalize(h["user"]), l2_normalize(h["item"])
    pop = g.ndata["item"]["popularity"].reshape(-1).to(dev)
    cos = dot_scores(ue, ie)
    lse = torch.logsumexp(ue[uids].double() @ ie.double().T, dim=1)  # [len(uids)]
    differing = {}
    for boost in (False, True):
        route_kw = dict(already_bought=ps, device=dev, popularity=pop if boost else None)
        a = get_recs(h["user"], h["item"], uids, k, backend="cuda", **route_kw)
        b = get_recs(h["user"], h["item"], uids, k, backend="torch", **route_kw)

        def score(r, items, boost=boost):
            items = items[items >= 0]
            s = cos(uids[r].expand_as(items), items)
            return torch.exp(s - lse[r]) + pop[items].double() if boost else s

        differing["boost" if boost else "cos"] = _assert_routes_agree(a, b, score)
    report["routes_differing_rows"] = differing

    # The device's embeddings against the CPU's on a small graph (same weights).
    small = make_synthetic_data(num_users=500, num_items=200, seed=2).graph
    small_model = ConvModel(**dict(kw, canonical_etypes=small.canonical_etypes),
                            generator=torch.Generator().manual_seed(0))
    small_feats = {nt: small.ndata[nt]["features"] for nt in small.ntypes}
    on_cpu = compute_embeddings(small_model, small, small_feats, device="cpu")
    on_dev = compute_embeddings(small_model.to(dev), small, small_feats, device=dev)
    err = max(float((on_cpu[nt] - on_dev[nt].cpu()).abs().max()) for nt in on_cpu)
    if not err <= TOL:
        raise AssertionError(f"device and CPU embeddings differ by {err}")
    report["embed_device_vs_cpu_max_abs_err"] = err

    if on_card:
        # Full-catalog ranking of every user at the over-fetch width, alone.
        fetch = k + int(bought_rows.shape[1])
        report["rank_all_users"] = {
            "users": num_users, "fetch": fetch,
            "kernel_ms": time_ms(lambda: tm.mips_topk(ue, ie, fetch), reps=3, warmup=1),
            "plain_ms": time_ms(lambda: tm.mips_topk_reference(ue, ie, fetch), reps=1,
                                warmup=1),
        }
        report["max_memory_allocated_bytes"] = torch.cuda.max_memory_allocated(dev)
    say("slice", **report)
    return launches, metrics[1]


def leaf_branches(graph, ntype: str, level: int) -> int:
    """Leaf-kernel branches of one seed's tree: every in-etype of a level-1
    node (``_tree_level``: the self subtree, then each in-etype's)."""
    in_etypes = [et for et in graph.canonical_etypes if et[2] == ntype]
    if level == 1:
        return len(in_etypes)
    return leaf_branches(graph, ntype, level - 1) + sum(
        leaf_branches(graph, et[0], level - 1) for et in in_etypes)


def block_means(graph, seed_ntypes, levels: int) -> int:
    """Gather-mean launches of one dedup'd block forward: one per (level,
    node type of that level's table, in-etype), as its plan walks them
    (``_sampled_repr_dedup``: a level's table holds the node types above it
    and their in-etypes' sources)."""
    ntypes, means = list(seed_ntypes), 0
    for _ in range(levels):
        in_etypes = [et for nt in ntypes for et in graph.canonical_etypes if et[2] == nt]
        means += len(in_etypes)
        ntypes += [et[0] for et in in_etypes if et[0] not in ntypes]
    return means


def _grads(model) -> dict:
    return {n: (p.grad.clone() if p.grad is not None else torch.zeros_like(p))
            for n, p in model.named_parameters()}


def phase_train(dev, data, hidden=256, out=128, steps=200, batch_size=2048, pool=2560,
                fanouts=(8, 4), random_recall=None, k=10, on_card=True, dedup=False):
    """Train the Medium model with the ``bench.py`` step on ``dev`` (through
    the dedup'd block forward with ``dedup``); returns (the launch counts of
    the main path, the trained model)."""
    phase = "train_dedup" if dedup else "train"
    g = data.graph.to(dev)
    feats = {nt: g.ndata[nt]["features"] for nt in g.ntypes}
    kw = medium_kwargs(g, hidden, out)
    model = ConvModel(**kw, leaf_kernel=True)
    init_model(model, seed=0)  # the slice phase's random weights
    model.to(dev)
    cfg = MinibatchConfig(edge_batch_size=batch_size, fanouts=tuple(fanouts),
                          neg_mode="dense_pool", neg_pool_size=pool, pool_mask_kernel=True,
                          dedup=dedup)
    etypes = tuple(data.train_pairs)
    has_reverse = {et: True for et in etypes}
    tables = {et: build_padded_pair_set(u, i, num_src=data.num_users).to(dev)
              for et, (u, i) in data.train_pairs.items()}
    state = TrainState.create(model, lr=cfg.lr)
    step = make_minibatch_step(model, cfg, etypes, with_update=True, with_exclusion=True,
                               has_reverse=has_reverse)
    store = EdgeStore(data.graph, etypes)
    batches = iter_edge_batches(np.random.default_rng(0),
                                {et: np.arange(g.num_edges(et)) for et in etypes}, batch_size)
    draws = Draws(torch.Generator(device=dev).manual_seed(0))
    leaves = 0 if dedup else sum(leaf_branches(g, nt, model.num_conv_layers)
                                 for nt in ("user", "item"))
    means = block_means(g, ("user", "item"), model.num_conv_layers) if dedup else 0
    per_step = {"leaf_mean_nn_fwd": leaves, "leaf_mean_nn_bwd": leaves,
                "pool_membership_mask": len(etypes),
                "gather_mean_fwd": means, "gather_mean_bwd": means}
    counters = {"leaf_mean_nn_fwd": la.leaf_mean_nn_fwd, "leaf_mean_nn_bwd": la.leaf_mean_nn_bwd,
                "pool_membership_mask": pm.pool_membership_mask,
                "gather_mean_fwd": gm.gather_mean_fwd, "gather_mean_bwd": gm.gather_mean_bwd}

    # The main path: counters from 0, read right after.
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    for fn in counters.values():
        fn.launches = 0
    losses, events = [], []
    t0 = time.perf_counter()
    for _ in range(steps):
        if dev.type == "cuda":  # the window holds the batch's assembly too
            events.append((torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True)))
            events[-1][0].record()
        batch = store.batch(next(batches), True, dev)
        _, loss = step(state, g, feats, batch, tables, draws)
        if dev.type == "cuda":
            events[-1][1].record()
        losses.append(loss)
    sync(dev)
    train_s = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    losses = torch.stack(losses).cpu().numpy()
    window = max(1, min(20, steps // 5))
    first, last = float(losses[:window].mean()), float(losses[-window:].mean())
    edges = sum(len(v["u"]) for v in batch.values())
    report = {"steps": steps, "edges_per_step": edges, "train_s": train_s,
              "edges_per_s": steps * edges / train_s,
              "loss_first_mean": first, "loss_last_mean": last,
              "window": window, "launches": launches, "launches_per_step": per_step}
    if events:
        step_ms = [a.elapsed_time(b) for a, b in events]
        report.update(step_ms_median=float(np.median(step_ms)),
                      step_ms_min=float(np.min(step_ms)), step_ms_max=float(np.max(step_ms)),
                      max_memory_allocated_bytes=torch.cuda.max_memory_allocated(dev))
    if not np.isfinite(losses).all() or not last < first:
        raise AssertionError(f"the loss is not finite or does not fall: {first} -> {last}")
    for name, n in per_step.items():
        want = n * steps if on_card else 0
        if launches[name] != want:
            raise AssertionError(f"{name}: {launches[name]} launches, expected {want}")
    if on_card:
        report["profile"] = profile_steps(
            lambda: step(state, g, feats, store.batch(next(batches), True, dev), tables, draws))

    # One step through the kernels and through the plain route, same
    # parameters, batch and draws: loss and gradients must agree.  The tree's
    # plain route is the model without the leaf kernel; the dedup'd block
    # forward has no such switch (nor has the JAX package), so its model
    # calls the gather-mean wrapper's plain version for that one step.
    plain = ConvModel(**kw, leaf_kernel=False).to(dev)
    plain.load_state_dict(model.state_dict())
    batch = store.batch(next(batches), True, dev)

    def loss_and_grads(m, c, step_draws):
        m.train()
        m.zero_grad(set_to_none=True)
        loss = make_minibatch_loss(m, c, etypes, True, has_reverse)(
            g, feats, batch, tables, step_draws)
        loss.backward()
        return float(loss.detach()), _grads(m)

    rec = Draws(torch.Generator(device=dev).manual_seed(1), record=True)
    lk, gk = loss_and_grads(model, cfg, rec)
    conv_model.gather_mean = gm.gather_mean_reference
    try:
        lp, gp = loss_and_grads(plain, dataclasses.replace(cfg, pool_mask_kernel=False),
                                rec.replay())
    finally:
        conv_model.gather_mean = gm.gather_mean
    if not abs(lk - lp) <= LOSS_RTOL * abs(lp):
        raise AssertionError(f"{phase}: kernel and plain routes: loss {lk} vs {lp}")
    worst = 0.0
    for name, a in gk.items():
        excess = ((a - gp[name]).abs() - STEP_GRAD_RTOL * gp[name].abs()).max()
        worst = max(worst, float(excess))
    if not worst <= STEP_GRAD_ATOL:
        raise AssertionError(f"{phase}: kernel and plain routes: gradients differ by {worst} "
                             f"beyond rtol {STEP_GRAD_RTOL}")
    report["routes"] = {"loss_kernel": lk, "loss_plain": lp, "grad_excess_over_rtol": worst}

    # The trained model's quality against the random weights'.
    h = compute_embeddings(model, g, feats, device=dev)
    metrics = get_metrics_at_k(h["user"], h["item"], data.test_ground_truth,
                               data.train_pairs[BUYS], k, device=dev)
    report["precision_recall_coverage"] = metrics
    report["random_weights_recall"] = random_recall
    if random_recall is not None and not metrics[1] > random_recall:
        raise AssertionError(f"trained recall@{k} {metrics[1]} <= random weights' {random_recall}")
    say(phase, **report)
    return launches, model


def phase_packed_leaf(dev, data, model, seeds=32) -> None:
    """One tree forward at fanouts (-1, -1) for ``seeds`` users and items
    through the packed leaf cache and without it (same weights): within TOL."""
    g = data.graph.to(dev)
    feats = {nt: g.ndata[nt]["features"] for nt in g.ntypes}
    ids = {"user": torch.arange(seeds, device=dev), "item": torch.arange(seeds, device=dev)}
    fanouts = (-1,) * model.num_conv_layers
    t0 = time.perf_counter()
    packed_graph = attach_leaf_features(g, feats)
    sync(dev)
    attach_s = time.perf_counter() - t0
    model.eval()
    with torch.no_grad():
        draws = Draws(torch.Generator(device=dev).manual_seed(0))
        packed = model.sampled_repr(packed_graph, feats, ids, fanouts, draws)
        plain = model.sampled_repr(g, feats, ids, fanouts, draws)
    err = max(float((packed[nt] - plain[nt]).abs().max()) for nt in ids)
    if not err <= TOL:
        raise AssertionError(f"packed and unpacked leaves differ by {err}")
    cache = sum(r.nbr_feat.numel() * r.nbr_feat.element_size()
                for r in packed_graph.rels.values() if r.nbr_feat is not None)
    say("packed_leaf", seeds=seeds, max_abs_err=err, attach_s=attach_s, cache_bytes=cache)


# Kernel-name patterns of the step breakdown, first match wins.
KERNEL_GROUPS = (
    ("gather_mean", ("gather_mean",)),
    ("leaf_mean_nn", ("leaf_fwd", "leaf_bwd")),
    ("pool_membership_mask", ("pool_mask",)),
    ("matmul", ("gemm", "gemv", "cutlass", "sm90_", "splitK")),
    ("gather / scatter / index", ("index", "gather", "scatter", "Indexing")),
    ("reductions", ("reduce", "Reduce")),
    ("elementwise", ("elementwise", "vectorized", "Elementwise", "unrolled")),
)


def profile_steps(run_step, n=5, top_n=8) -> dict:
    """``n`` steps under ``torch.profiler``: host wall time, the device's
    busy time by kernel group (ms a step), its idle share, and the
    ``top_n`` kernels by device time."""
    wall_ms, kernels = profiled_kernels(run_step, n)
    if not kernels:
        raise RuntimeError("torch.profiler recorded no CUDA kernel for the training steps")
    groups = {name: 0.0 for name, _ in KERNEL_GROUPS}
    groups["other"] = 0.0
    for key, _, us in kernels:
        name = next((g for g, pats in KERNEL_GROUPS if any(p in key for p in pats)), "other")
        groups[name] += us / 1e3 / n
    busy = sum(groups.values())
    top = sorted(kernels, key=lambda kv: -kv[2])[:top_n]
    return {"steps": n, "wall_ms_per_step": wall_ms, "device_busy_ms_per_step": busy,
            "device_idle_share": 1.0 - busy / wall_ms,
            "kernels_per_step": sum(c for _, c, _ in kernels) / n,
            "device_ms_per_step_by_group": groups,
            "top_kernels": [{"name": key[:120], "per_step": c / n, "ms_per_step": us / 1e3 / n}
                            for key, c, us in top]}


def main() -> int:
    kind = phase_device()
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_build()
    rows = phase_kernels(dev)
    t0 = time.perf_counter()
    data = bench_data()
    say("graph", seconds=time.perf_counter() - t0,
        edges={"/".join(et): data.graph.num_edges(et) for et in data.graph.canonical_etypes})
    launches, random_recall = phase_slice(dev, data)
    train_launches, _ = phase_train(dev, data, random_recall=random_recall)
    launches.update(train_launches)
    # Each kernel's launches are counted on the path that runs it: the
    # gather-mean kernels on the dedup'd step's.
    dedup_launches, model = phase_train(dev, data, steps=50, dedup=True)
    for name in ("gather_mean_fwd", "gather_mean_bwd"):
        launches[name] = dedup_launches[name]
    phase_packed_leaf(dev, data, model)
    for row in rows:
        row["launches"] = launches[row["name"]]
    print(json.dumps({"kernels": rows}), flush=True)
    print(smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
