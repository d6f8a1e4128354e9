"""Device timing by the chained-delta method (port of
``gnn_recsys_tpu/utils/timing.py``).

:func:`chain_time_per_call` times two chained runs of different lengths,
each ended by :func:`hard_sync`, and reports the slope ``(T2 - T1) / (n2 -
n1)``, so that the constant cost of a run's start and end cancels.  On a
CUDA device each run is timed between CUDA events and ended by
``torch.cuda.synchronize``; on the CPU by ``time.perf_counter``.
"""

from __future__ import annotations

import time
from typing import Callable, Optional

import torch


def _first_tensor(out) -> Optional[torch.Tensor]:
    """The first tensor of a (nested dict / list / tuple) output."""
    if torch.is_tensor(out):
        return out
    if isinstance(out, dict):
        out = list(out.values())
    if isinstance(out, (list, tuple)):
        for x in out:
            t = _first_tensor(x)
            if t is not None:
                return t
    return None


def hard_sync(out) -> float:
    """Wait for everything ``out`` depends on: synchronize its first
    tensor's CUDA device, then pull that tensor's sum to the host (the
    return value; 0.0 for an output without a tensor)."""
    x = _first_tensor(out)
    if x is None:
        return 0.0
    if x.device.type == "cuda":
        torch.cuda.synchronize(x.device)
    if x.dtype == torch.bool:
        x = x.int()
    return float(x.sum())


def _run_seconds(run: Callable, device: torch.device) -> float:
    """Seconds of ``run()`` up to its :func:`hard_sync`."""
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize(device)
        start.record()
        out = run()
        end.record()
        hard_sync(out)
        end.synchronize()
        return start.elapsed_time(end) / 1e3
    t0 = time.perf_counter()
    hard_sync(run())
    return time.perf_counter() - t0


def chain_time_per_call(
    fn: Callable,
    chain: Callable,
    n1: int = 2,
    n2: int = 12,
    reps: int = 2,
    warmup: Optional[Callable] = None,
) -> float:
    """Seconds a call of ``fn``: the least of ``reps`` timings of
    ``chain(n1)`` and of ``chain(n2)`` (``n`` chained calls, each consuming
    the previous one's output or state, the last output returned), as the
    slope ``(T(n2) - T(n1)) / (n2 - n1)``.  ``fn`` documents the call:
    ``chain(1)`` must run it once.  ``warmup`` (by default ``chain(1)``) runs
    first; its output's device picks the clock."""
    del fn
    first = warmup() if warmup is not None else chain(1)
    hard_sync(first)
    x = _first_tensor(first)
    device = x.device if x is not None else torch.device("cpu")
    t_min = {}
    for n in (n1, n2):
        hard_sync(chain(n))  # this length's first run outside the timing
        t_min[n] = min(_run_seconds(lambda: chain(n), device) for _ in range(reps))
    return (t_min[n2] - t_min[n1]) / (n2 - n1)
