"""Run one cell of the port's benchmark on the card(s) of this machine.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints one JSON line last on standard output: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer metrics), ``device`` and, traced, a
``breakdown``; then ``checks``, each compared number with its limit, which
are also the last lines on standard error.  Exits non-zero, with no result,
where the cell's cards are missing or JAX got loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

# Import from the checkout's root (the port and this package), not from here.
sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

from portbench.harness import core  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    cell = core.load_cell(args.workload)

    import torch

    chips = int(cell.entry["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found",
              file=sys.stderr)
        return 2
    return run(cell, args, torch.device("cuda", 0), T_START)


def run(cell: core.Cell, args, dev, t_start: float) -> int:
    """The cell on ``dev`` (a test hands the CPU): drive, judge, print."""
    import json

    import torch

    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        torch.zeros(1, device=dev)  # the allocator exists before its peak is reset
        torch.cuda.reset_peak_memory_stats(dev)
    out = core.driver(cell).run(cell, args, dev, t_start)
    found = core.forbidden_modules()
    if found:
        print(f"portbench: modules of JAX or the JAX package were loaded: {found}",
              file=sys.stderr)
        return 3
    device = {"platform": "gpu" if dev.type == "cuda" else dev.type,
              "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
              "count": int(cell.entry["chips"]), "memory_peak_bytes": out.memory_peak_bytes}
    line = core.result_line(cell, out, bool(args.trace), device)
    for name, v, lim in out.checks:
        print(f"check {name} = {v!r} limit {lim!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
