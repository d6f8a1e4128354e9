#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA card: build the hand-written
kernels, hold each against its plain version, then serve recommendations
with the full-width Medium model.

Run from the repository root on a CUDA host (one card)::

    python3 chip_smoke.py

Phases, one line each; a failing phase raises and the exit code is not 0:

1. device: the card's name and power limit, torch and CUDA versions.
2. build: ``nvcc`` of ``gnn_recsys_tpu_torch/csrc/*.cu`` for sm_90a, with the
   compiler's register / shared-memory / spill summary.
3. kernels: each MIPS kernel against its plain version at a serving shape
   (U=4096 users, I=30,000 items, D=128, k=26), a tied case, a bf16 case,
   and times (CUDA events) beside the bound and a library yardstick.
4. slice: the 100k-user / 30k-item synthetic graph of ``bench.py``, the
   Medium ``ConvModel`` (hidden 256, out 128, mean_nn, cos, 2 conv layers)
   with seeded random weights saved as a run; requests of 1, 128 and 4096
   users through ``inference_ondemand`` (and 4096 with the popularity
   boost), then ``get_metrics_at_k`` over every test user.  The kernels'
   launch counters must grow, every rec is a catalog id or -1, no
   already-bought item is recommended, and the kernel route agrees with the
   ``torch`` route.

Then a ``{"kernels": [...]}`` JSON line, the card's name and power limit,
and the last line ``{"ok": true, "device": {...}}``.  Exits non-zero without
a CUDA device.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from gnn_recsys_tpu_torch.config import HyperParams
from gnn_recsys_tpu_torch.inference import already_bought_from_graph, inference_ondemand
from gnn_recsys_tpu_torch.models.conv_model import ConvModel
from gnn_recsys_tpu_torch.models.layers import l2_normalize
from gnn_recsys_tpu_torch.ops.cuda import build
from gnn_recsys_tpu_torch.ops.cuda import topk_mips as tm
from gnn_recsys_tpu_torch.ops.membership import build_padded_pair_set
from gnn_recsys_tpu_torch.retrieval.metrics import get_metrics_at_k
from gnn_recsys_tpu_torch.retrieval.recs import get_recs
from gnn_recsys_tpu_torch.train.checkpoint import load_run, model_kwargs_to_config, save_run
from gnn_recsys_tpu_torch.train.full_batch import compute_embeddings
from gnn_recsys_tpu_torch.utils.synthetic import make_synthetic_data

# H100 SXM published peaks (NVIDIA data sheet): f32 outside the tensor
# cores, and HBM3 bandwidth.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
TOL = 1e-5  # f32 sums in another order than the plain version's product
BUYS = ("user", "buys", "item")
SOURCE = "gnn_recsys_tpu_torch/csrc/topk_mips.cu"
TPU_SOURCE = "gnn_recsys_tpu/ops/pallas/topk_mips.py"


def say(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def time_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Mean device time of ``fn`` in ms (CUDA events, after warm-up)."""
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
    build.build(["topk_mips"])
    say("build", seconds=time.perf_counter() - t0, info=build.build_info)


def phase_kernels(dev, num_users=4096, num_items=30_000, dim=128, k=26,
                  weight=1.0, timed=True, seed=0) -> list:
    """Each kernel against its plain version on ``dev``; returns the rows of
    the kernels line (without launches)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    ue = l2_normalize(torch.randn(num_users, dim, generator=gen, device=dev))
    ie = l2_normalize(torch.randn(num_items, dim, generator=gen, device=dev))
    pop = torch.rand(num_items, generator=gen, device=dev)
    exact = dot_scores(ue, ie)
    rows = []

    def record(name, tpu_line, err, kernel, plain, library, flops, nbytes):
        b_ms, b_by = bound(flops, nbytes)
        row = {"name": name, "route": "cuda", "source": SOURCE,
               "replaces": f"{TPU_SOURCE}:{tpu_line}", "launches": None,
               "max_abs_err": err, "ms": None, "plain_ms": None,
               "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}
        if timed:
            with tm.full_f32_matmul():
                row.update(ms=time_ms(kernel), plain_ms=time_ms(plain, reps=3),
                           library_ms=time_ms(library, reps=3))
        rows.append(row)
        say("kernel", **row)

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
    record("mips_topk", 52, max(err, err_bf16),
           lambda: tm.mips_topk(ue, ie, k), lambda: tm.mips_topk_reference(ue, ie, k),
           lambda: torch.topk(ue @ ie.T, k, dim=1), flops, emb_bytes + topk_bytes)

    # pass 1: the softmax normaliser; error on the log-sum-exp scale
    m, s = tm.mips_lse(ue, ie)
    rm, rs = tm.mips_lse_reference(ue, ie)
    err = float(((m.double() + s.double().log()) - (rm.double() + rs.double().log())).abs().max())
    if not err <= TOL:
        raise AssertionError(f"mips_lse: log-sum-exp differs by {err}")
    record("mips_lse", 108, err, lambda: tm.mips_lse(ue, ie),
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
    record("mips_boost", 141, err,
           lambda: tm.mips_boost(ue, ie, pop, rm, rs, k, weight=weight),
           lambda: tm.mips_boost_reference(ue, ie, pop, rm, rs, k, weight=weight),
           lambda: torch.topk(torch.softmax(ue @ ie.T, dim=1) + weight * pop, k, dim=1),
           flops, emb_bytes + 4.0 * num_items + 8.0 * num_users + topk_bytes)
    return rows


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


def phase_slice(dev, num_users=100_000, num_items=30_000, hidden=256, out=128,
                request_sizes=(1, 128, 4096), k=10, on_card=True) -> dict:
    """Serve the Medium model through the port's entry points on ``dev``;
    returns the launch counts of the main path."""
    t0 = time.perf_counter()
    data = make_synthetic_data(
        num_users=num_users, num_items=num_items, num_groups=64,
        interactions_per_user=10, test_per_user=2, feat_dim=8, with_clicks=True,
        seed=0, max_fanout=32,
    )
    g = data.graph
    buys_u, buys_i = data.train_pairs[BUYS]
    counts = np.bincount(buys_i, minlength=num_items).astype(np.float32)
    g.ndata["item"]["popularity"] = torch.from_numpy(counts / counts.max())[:, None]
    kw = dict(canonical_etypes=g.canonical_etypes,
              dims=(("user", 8), ("item", 8), ("hidden", hidden), ("out", out)),
              n_layers=3, aggregator_type="mean_nn", pred="cos", aggregator_hetero="sum",
              embedding_layer=True)
    model = ConvModel(**kw, generator=torch.Generator().manual_seed(0))
    model_kwargs = dict(kw, canonical_etypes=[list(e) for e in kw["canonical_etypes"]],
                        dims=[list(d) for d in kw["dims"]], norm=True, dropout=0.0)
    bought_rows = build_padded_pair_set(buys_u, buys_i, num_src=num_users).rows.numpy()
    feats = {nt: g.ndata[nt]["features"] for nt in g.ntypes}
    rng = np.random.default_rng(1)
    report = {"graph_s": time.perf_counter() - t0,
              "edges": {"/".join(et): g.num_edges(et) for et in g.canonical_etypes}}

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
    return launches


def main() -> int:
    kind = phase_device()
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_build()
    rows = phase_kernels(dev)
    launches = phase_slice(dev)
    for row in rows:
        row["launches"] = launches[row["name"]]
    print(json.dumps({"kernels": rows}), flush=True)
    print(smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
