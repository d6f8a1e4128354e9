"""Device operations attributed to one of the program's spans, forward and
backward, from a ``torch.profiler`` Chrome trace.

An operation on the device (a kernel, memset or copy) is matched to its
launch on the host by correlation id.  A launch belongs to the span's
forward where it lies inside a host span of that name on its thread; to
its backward where it lies inside an autograd engine's evaluation of a
node whose forward op ran inside such a span: every op recorded under
autograd carries a sequence number, and the node it makes evaluates under
the same number (on the engine's thread).  ``harness/trace.py:parse``
keeps neither number, so this parser reads the raw events.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
from dataclasses import dataclass
from typing import Callable, Dict, List, Tuple

from portbench.harness.trace import DEVICE_CATS, _sync

EVALUATE = "autograd::engine::evaluate_function: "
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


@dataclass
class SpanOps:
    """The device operations of every span of one name in a trace."""

    spans: int
    fwd_s: float
    bwd_s: float
    fwd_ops: int
    bwd_ops: int


class _Intervals:
    """The union of host events' intervals by thread, for containment of a
    timestamp."""

    def __init__(self, events: List[dict]):
        by: Dict[Tuple, List[Tuple[float, float]]] = {}
        for e in events:
            s = float(e["ts"])
            by.setdefault((e.get("pid"), e.get("tid")), []).append((s, s + float(e["dur"])))
        self.starts, self.ends = {}, {}
        for key, iv in by.items():
            merged: List[List[float]] = []
            for s, e in sorted(iv):
                if merged and s <= merged[-1][1]:
                    merged[-1][1] = max(merged[-1][1], e)
                else:
                    merged.append([s, e])
            self.starts[key] = [s for s, _ in merged]
            self.ends[key] = [e for _, e in merged]

    def holds(self, e: dict) -> bool:
        key = (e.get("pid"), e.get("tid"))
        starts = self.starts.get(key)
        if not starts:
            return False
        ts = float(e["ts"])
        i = bisect.bisect_right(starts, ts) - 1
        return i >= 0 and ts <= self.ends[key][i]


def span_ops(events: List[dict], name: str) -> SpanOps:
    """The device seconds and counts of the operations that the spans
    called ``name`` launched (forward) and that the backward of their ops
    launched."""
    xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
    spans = [e for e in xs if e.get("cat") == "user_annotation" and e.get("name") == name]
    inside = _Intervals(spans)
    ops = [e for e in xs if e.get("cat") == "cpu_op"]
    seqs = {e["args"]["Sequence number"] for e in ops
            if "Sequence number" in e.get("args", {}) and inside.holds(e)}
    backward = _Intervals([
        e for e in ops if e.get("args", {}).get("Sequence number") in seqs
        and (e["name"].startswith(EVALUATE) or e["args"].get("Fwd thread id", 0))])
    fwd, bwd = set(), set()
    for e in xs:
        corr = e.get("args", {}).get("correlation")
        if e.get("cat") not in LAUNCH_CATS or corr is None:
            continue
        if inside.holds(e):
            fwd.add(corr)
        elif backward.holds(e):
            bwd.add(corr)
    out = SpanOps(spans=len(spans), fwd_s=0.0, bwd_s=0.0, fwd_ops=0, bwd_ops=0)
    for e in xs:
        corr = e.get("args", {}).get("correlation")
        if e.get("cat") not in DEVICE_CATS or corr is None:
            continue
        if corr in fwd:
            out.fwd_s += float(e["dur"]) / 1e6
            out.fwd_ops += 1
        elif corr in bwd:
            out.bwd_s += float(e["dur"]) / 1e6
            out.bwd_ops += 1
    return out


def profile_events(run: Callable[[], None]) -> List[dict]:
    """The Chrome trace's events of ``run()`` under ``torch.profiler``
    (host and device), up to a device synchronize."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        _sync()
    fd, path = tempfile.mkstemp(prefix="portbench_ops_", suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]
    finally:
        os.remove(path)
