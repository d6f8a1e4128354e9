#!/usr/bin/env python3
"""How many kernel records ``torch.profiler`` keeps of a small call, and
where it places them against the host's launches, as a process ages.

Run on a CUDA host::

    python3 profiler_probe.py [IDLE_S]

Each probe is ``chip_smoke.phase_profiler_window`` (one ``profiler_window``
JSON line: ``embedding_bag``'s forward at B, K, N, D = 2,104, 24, 904, 4,
profiled 10 times at each count of calls, 3, 20 and 200, and each idle time
at the window's edges, 0, 2, 20 and 100 ms; the records each kept; the gap
from launch to kernel start as the profiler places them).  Probes run
fresh, after ``IDLE_S`` seconds (default 150) with the card idle, after 400
profiles of the call, and after 2,000 replays of a CUDA graph.  The last
line is the card's name and power limit.
"""

from __future__ import annotations

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

PADS = (0.0, 0.002, 0.02, 0.1)
REPS = (3, 20, 200)


def probe(dev, when) -> None:
    cs.phase_profiler_window(dev, when, profiles=10, reps=REPS, pads=PADS)


def main() -> int:
    if not torch.cuda.is_available():
        print("profiler_probe.py needs a CUDA device", file=sys.stderr)
        return 1
    idle_s = float(sys.argv[1]) if len(sys.argv) > 1 else 150.0
    dev = torch.device("cuda")
    probe(dev, "fresh")
    time.sleep(idle_s)
    probe(dev, f"after {idle_s:g} s idle")
    x = torch.zeros(1 << 20, device=dev)
    for _ in range(400):
        cs.profiled_kernels(lambda: x.add_(1.0), 3)
    probe(dev, "after 400 profiles")
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        x.add_(1.0)
    torch.cuda.current_stream().wait_stream(side)
    with torch.cuda.graph(graph):
        for _ in range(20):
            x.add_(1.0)
    for _ in range(2000):
        graph.replay()
    torch.cuda.synchronize()
    probe(dev, "after 2,000 graph replays")
    print(cs.smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
