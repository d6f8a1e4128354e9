"""BENCHMARK.json and the harness's sources against the benchmark's rules:
names and units, which cell reports what, and what may be imported."""

import ast
import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]
SOURCES = sorted((ROOT / "portbench").rglob("*.py"))


def reported(cell: str, section: str) -> set:
    from portbench.harness import core

    c = core.Cell(ROOT, BENCH, next(w for w in BENCH["workloads"] if w["name"] == cell),
                  {}, {}, {})
    return {m["name"] for m in c.metrics(section)}


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51


@pytest.mark.parametrize("entry", BENCH["configs"] + BENCH["workloads"] + METRICS,
                         ids=lambda e: e["name"])
def test_names_and_units(entry):
    assert NAME.match(entry["name"])
    for key in ("config", "traffic"):
        if key in entry:
            assert NAME.match(entry[key])
    if "unit" in entry:
        assert UNIT.match(entry["unit"]) and entry["better"] in ("lower", "higher")


def test_names_unique():
    for group in (BENCH["configs"], BENCH["workloads"], METRICS):
        names = [e["name"] for e in group]
        assert len(names) == len(set(names))


@pytest.mark.parametrize("metric", BENCH["per_layer"], ids=lambda m: m["name"])
def test_moves_is_reported_where_the_metric_is(metric):
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert metric["moves"] in e2e
    cells = metric.get("workloads", [w["name"] for w in BENCH["workloads"]])
    for cell in cells:
        assert metric["moves"] in reported(cell, "end_to_end"), cell
        assert metric["name"] in reported(cell, "per_layer"), cell


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda w: w["name"])
def test_every_cell_has_its_files_and_metrics(cell):
    pb = ROOT / "portbench"
    assert (pb / "traffic" / f"{cell['traffic']}.json").exists()
    assert (pb / "workloads" / f"{cell['name']}.json").exists()
    e2e = reported(cell["name"], "end_to_end")
    assert "setup_s" in e2e and len(e2e) >= 2
    per_layer = reported(cell["name"], "per_layer")
    assert per_layer
    for name in per_layer:
        assert (pb / "metrics" / f"{name}.py").exists()


def test_configs_are_used_and_in_paths():
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert c["name"] in used
        assert c["file"].startswith("portbench/") and (ROOT / c["file"]).exists()


def imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_and_a_plain_reference(path):
    found = imports(path)
    assert not found & {"jax", "jaxlib", "flax", "gnn_recsys_tpu"}, found
    if "reference" in path.parts:
        assert "gnn_recsys_tpu_torch" not in found


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_reads_no_jax_era_benchmark_file(path):
    text = path.read_text()
    for name in ("bench" + ".py", "chip" + "_smoke", "benchmarks" + "/"):
        assert name not in text, name


def test_forbidden_modules_compares_whole_names(monkeypatch):
    import sys
    import types

    from portbench.harness import core

    monkeypatch.setitem(sys.modules, "gnn_recsys_tpu_torch_fake", types.ModuleType("x"))
    assert core.forbidden_modules() == [m for m in core.forbidden_modules()
                                        if m != "gnn_recsys_tpu_torch_fake"]
    monkeypatch.setitem(sys.modules, "gnn_recsys_tpu.models", types.ModuleType("y"))
    assert "gnn_recsys_tpu" in core.forbidden_modules()
