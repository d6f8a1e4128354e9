"""Profiling and throughput: a ``torch.profiler`` trace context and an
edges-a-second meter (port of ``gnn_recsys_tpu/utils/profiling.py``)."""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

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
