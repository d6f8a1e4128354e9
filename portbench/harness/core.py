"""The harness's registry and result line.

Everything is found by name: a cell in ``BENCHMARK.json``, its
configuration's file, its traffic mix in ``portbench/traffic/<name>.json``
(whose ``driver`` names ``portbench/drivers/<driver>.py``), the cell's own
file ``portbench/workloads/<cell>.json`` (its limits and window), and each
per-layer metric's reader ``portbench/metrics/<metric>.py``.  Adding a
cell, configuration, traffic mix, driver or metric adds files and entries;
no file here changes.
"""

from __future__ import annotations

import importlib.util
import json
import math
import sys
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

ROOT = Path(__file__).resolve().parents[2]
FORBIDDEN = ("jax", "jaxlib", "flax", "gnn_recsys_tpu")


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    """One cell of the benchmark with everything its files say."""

    root: Path
    bench: dict
    entry: dict
    config: dict
    traffic: dict
    own: dict

    @property
    def name(self) -> str:
        return self.entry["name"]

    def metrics(self, section: str) -> List[dict]:
        """The metrics of ``section`` this cell reports: those that list it
        under ``workloads``, and those without the key that apply to every
        cell (an end-to-end metric) or to every cell that reports the
        end-to-end metric they move (a per-layer one)."""
        e2e = [m for m in self.bench["end_to_end"]
               if self.name in m.get("workloads", [self.name])]
        if section == "end_to_end":
            return e2e
        names = {m["name"] for m in e2e}
        return [m for m in self.bench["per_layer"]
                if (self.name in m["workloads"] if "workloads" in m else m["moves"] in names)]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    bench = read_json(root / "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    pb = root / "portbench"
    return Cell(root, bench, entry, read_json(root / conf["file"]),
                read_json(pb / "traffic" / f"{entry['traffic']}.json"),
                read_json(pb / "workloads" / f"{name}.json"))


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(cell: Cell):
    kind = cell.traffic["driver"]
    return load_module(cell.root / "portbench" / "drivers" / f"{kind}.py",
                       f"portbench_driver_{kind}")


def metric_reader(cell: Cell, name: str) -> Callable[[dict], Optional[float]]:
    return load_module(cell.root / "portbench" / "metrics" / f"{name}.py",
                       f"portbench_metric_{name}").read


def forbidden_modules() -> List[str]:
    """Top-level names of loaded modules that belong to JAX or the JAX
    package, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


@dataclass
class Outcome:
    """What a driver hands back."""

    attempted: int
    failed: int
    values: Dict[str, float]  # end-to-end values by metric name
    checks: List[Tuple[str, float, float]]  # (number, value, limit)
    memory_peak_bytes: int
    context: dict = field(default_factory=dict)  # what the metric readers read
    trace: object = None


def passes(checks) -> bool:
    return all(math.isfinite(v) and v <= lim for _, v, lim in checks)


def result_line(cell: Cell, out: Outcome, traced: bool, device: dict) -> dict:
    units = {m["name"]: m["unit"] for m in cell.bench["end_to_end"] + cell.bench["per_layer"]}
    metrics = {}
    if traced:
        ctx = dict(out.context, trace=out.trace)
        for m in cell.metrics("per_layer"):
            value = metric_reader(cell, m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": units[m["name"]]}
        device = dict(device, busy_s=out.trace.busy_s(), window_s=out.trace.window_s)
    else:
        for m in cell.metrics("end_to_end"):
            metrics[m["name"]] = {"value": out.values[m["name"]], "unit": units[m["name"]]}
    line = {"correct": passes(out.checks) and out.failed == 0, "attempted": out.attempted,
            "failed": out.failed, "metrics": metrics, "device": device}
    if traced:
        line["breakdown"] = out.trace.breakdown()
    line["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in out.checks}
    return line
