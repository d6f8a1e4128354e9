"""A traced window: ``torch.profiler`` over a piece of the timed path, read
back from its Chrome trace into device intervals, kernel times by name, the
device's busy time and idle gaps labelled by what the host was doing."""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Tuple

import torch

WINDOW = "portbench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")

# Kernel groups by name, first match wins (the repository's smoke test's
# classifier, frozen here).
KERNEL_GROUPS = (
    ("gather_mean_fwd", ("gather_mean_fwd",)),
    ("gather_mean_bwd", ("gather_mean_bwd",)),
    ("leaf_mean_nn", ("leaf_fwd", "leaf_bwd")),
    ("pool_membership_mask", ("pool_mask",)),
    ("matmul", ("gemm", "gemv", "cutlass", "sm90_", "splitK", "nvjet")),
    ("gather / scatter / index", ("index", "gather", "scatter", "Indexing")),
    ("reductions", ("reduce", "Reduce")),
    ("elementwise", ("elementwise", "vectorized", "Elementwise", "unrolled")),
)


def kernel_group(name: str) -> str:
    return next((g for g, pats in KERNEL_GROUPS if any(p in name for p in pats)), "other")


@dataclass
class Trace:
    window_s: float
    device: List[Tuple[float, float, str]] = field(default_factory=list)  # (start s, end s, name)
    host: List[Tuple[float, float, str]] = field(default_factory=list)

    def busy_s(self) -> float:
        total, end = 0.0, float("-inf")
        for s, e, _ in sorted(self.device):
            if e > end:
                total += e - max(s, end)
                end = e
        return total

    def kernel_s(self, pattern) -> float:
        """Device seconds of the operations whose name holds ``pattern``
        (a string or a predicate on the name)."""
        hit = pattern if callable(pattern) else (lambda n: pattern in n)
        return sum(e - s for s, e, n in self.device if hit(n))

    def span_s(self, name: str) -> List[float]:
        """Seconds of each host span called ``name`` in the window."""
        return [e - s for s, e, n in self.host if n == name]

    def by_name(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for s, e, n in self.device:
            out[n] = out.get(n, 0.0) + e - s
        return out

    def idle_gaps(self) -> Dict[str, float]:
        """Idle seconds of the window by the innermost host event at each
        gap's middle ("host untraced" where there is none)."""
        gaps, end = [], 0.0
        for s, e, _ in sorted(self.device):
            if s > end:
                gaps.append((end, s))
            end = max(end, e)
        if end < self.window_s:
            gaps.append((end, self.window_s))
        out: Dict[str, float] = {}
        for a, b in gaps:
            mid = (a + b) / 2
            inside = [(e - s, n) for s, e, n in self.host if s <= mid <= e]
            label = min(inside)[1] if inside else "host untraced"
            out[label] = out.get(label, 0.0) + (b - a)
        return out

    def breakdown(self, top: int = 10) -> dict:
        ops = sorted(self.by_name().items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(self.idle_gaps().items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n[:160], s] for n, s in ops],
                "idle_gaps": [[n[:160], s] for n, s in gaps]}


@contextlib.contextmanager
def spans(module, labels: Dict[str, str]):
    """Wrap the functions ``module`` calls by the names in ``labels``, each
    call in a host span ``portbench.<label>``, for as long as the context
    lasts: spans around the calls into each layer, from the harness."""
    from torch.profiler import record_function

    held = {name: getattr(module, name) for name in labels}

    def wrap(fn, label):
        def call(*a, **kw):
            with record_function(f"portbench.{label}"):
                return fn(*a, **kw)
        return call

    try:
        for name, label in labels.items():
            setattr(module, name, wrap(held[name], label))
        yield
    finally:
        for name, fn in held.items():
            setattr(module, name, fn)


def trace(run: Callable[[], None], warm: Callable[[], None]) -> Trace:
    """``run`` under ``torch.profiler`` after one ``warm`` call in the
    profiler's warm-up cycle (the first kernels after tracing starts can go
    unrecorded); the window is ``run`` up to a device synchronize."""
    from torch.profiler import ProfilerActivity, profile, record_function, schedule

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        warm()
        _sync()
        prof.step()
        with record_function(WINDOW):
            run()
            _sync()
        prof.step()
    fd, path = tempfile.mkstemp(prefix="portbench_trace_", suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    return parse(events)


def parse(events: List[dict]) -> Trace:
    win = [e for e in events if e.get("ph") == "X" and e.get("name") == WINDOW
           and e.get("cat") == "user_annotation"]
    if not win:
        raise RuntimeError("the profiler recorded no window annotation")
    t0, t1 = float(win[0]["ts"]), float(win[0]["ts"]) + float(win[0]["dur"])
    tr = Trace(window_s=(t1 - t0) / 1e6)
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        s, d = float(e["ts"]), float(e["dur"])
        a, b = max(s, t0), min(s + d, t1)
        if b <= a:
            continue
        item = ((a - t0) / 1e6, (b - t0) / 1e6, str(e.get("name", "")))
        cat = e.get("cat", "")
        if cat in DEVICE_CATS:
            tr.device.append(item)
        elif cat in HOST_CATS and e.get("name") != WINDOW and not item[2].startswith(
                "ProfilerStep"):
            tr.host.append(item)
    return tr


def _sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()
