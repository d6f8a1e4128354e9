"""Profiling and throughput: a ``torch.profiler`` trace context, the
program's spans, its counters (and the host-to-device byte counter), and an
edges-a-second meter (port of ``gnn_recsys_tpu/utils/profiling.py``)."""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Optional, Tuple

import torch


@contextlib.contextmanager
def profiler_trace(logdir: Optional[str]):
    """Record a ``torch.profiler`` trace of the block (host ops, and CUDA
    kernels where a card is present) and write it into ``logdir`` as a
    Chrome trace (``trace_<pid>_<ms>.json``, readable by TensorBoard's
    profiler and ``chrome://tracing``); nothing when ``logdir`` is None or
    empty."""
    if not logdir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(
        os.path.join(logdir, f"trace_{os.getpid()}_{int(time.time() * 1e3)}.json"))


# What a span is while no profiler records: one shared context that does
# nothing (``nullcontext`` can be entered again and again).
_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A host span called ``name`` around a ``with`` block: the block in a
    ``torch.profiler.record_function`` while a profiler records, and
    nothing at all otherwise (one check of the profiler's flag; no clock
    read, no object made).  The profiler is the only switch: a span is on
    in any ``torch.profiler`` window, :func:`profiler_trace`'s included,
    and off in a profiler's warm-up cycle.

    Spans land in the profiler's timeline beside the device's kernel and
    copy records, on one clock, and the profiler keeps them in memory until
    its exporter writes them out.  A span's parent is the span around it on
    the same thread: every span of one serving request lies inside that
    request's ``gnn.serve.request``.  That containment stands in for a
    request id, which a span cannot carry: the Chrome trace exporter drops
    ``record_function``'s arguments."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _NO_SPAN


# The program's counters, "owner.attribute" -> (owner, attribute): a
# captured CUDA graph carries every one across its replays.
DECLARED: Dict[str, Tuple[object, str]] = {}


def counter(owner, *attrs: str) -> None:
    """Declare the counters ``owner.<attr>``, plain integers that ``owner`` (a
    function or a class) adds to, and set them to 0."""
    for attr in attrs:
        setattr(owner, attr, 0)
        DECLARED[f"{owner.__qualname__}.{attr}"] = (owner, attr)


def counter_values() -> Dict[str, int]:
    return {name: getattr(owner, attr) for name, (owner, attr) in DECLARED.items()}


def add_counts(counts: Dict[str, int]) -> None:
    for name, n in counts.items():
        owner, attr = DECLARED[name]
        setattr(owner, attr, getattr(owner, attr) + n)


def reset_counters() -> None:
    add_counts({name: -n for name, n in counter_values().items()})


def to_device(x, device):
    """``x.to(device)`` for a tensor or a module, counting in
    ``to_device.h2d_bytes`` the bytes that leave host memory for another
    device: a tensor's ``nbytes`` (a module's parameters' and buffers')
    where it is on the CPU and ``device`` is not.  What is already on
    ``device``, or moves between devices, adds nothing.  The counter
    always counts; a caller that wants a fresh count resets it."""
    if torch.device(device).type != "cpu":
        held = [x] if isinstance(x, torch.Tensor) else [*x.parameters(), *x.buffers()]
        to_device.h2d_bytes += sum(t.nbytes for t in held if t.device.type == "cpu")
    return x.to(device)


counter(to_device, "h2d_bytes")


class ThroughputMeter:
    """Per-call edges/s with exponential smoothing (``profiling.py:32-62``):
    :meth:`start` before a unit of work, :meth:`stop` with its edge count
    after its results are on the host."""

    def __init__(self, alpha: float = 0.1):
        self.alpha = alpha
        self.edges_per_s: Optional[float] = None
        self.total_edges = 0
        self.total_time = 0.0
        self._t0: Optional[float] = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self, num_edges: int) -> float:
        """The rate since :meth:`start`; folds it into the smoothed rate."""
        dt = time.perf_counter() - self._t0
        rate = num_edges / max(dt, 1e-9)
        self.total_edges += num_edges
        self.total_time += dt
        if self.edges_per_s is None:
            self.edges_per_s = rate
        else:
            self.edges_per_s = self.alpha * rate + (1 - self.alpha) * self.edges_per_s
        return rate

    @property
    def mean_edges_per_s(self) -> float:
        return self.total_edges / max(self.total_time, 1e-9)
