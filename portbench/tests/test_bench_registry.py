"""A later change adds a cell, a configuration, a traffic mix with its
driver and a per-layer metric by adding files and entries alone."""

import hashlib
import json
import types

from portbench import run as prun
from portbench.harness import core

DRIVER = '''
from portbench.harness import core


def run(cell, args, dev, t_start):
    return core.Outcome(attempted=3, failed=0,
                        values={"dummy_rate": float(cell.config["size"]) * cell.traffic["rate"],
                                "setup_s": 0.5},
                        checks=[("dummy_gap", 0.0, cell.own["limits"]["dummy_gap"])],
                        memory_peak_bytes=0, context={"kind": "dummy"},
                        trace=core_trace())


def core_trace():
    from portbench.harness.trace import Trace
    return Trace(window_s=1.0, device=[(0.0, 0.25, "dummy_kernel")])
'''

METRIC = '''
def read(ctx):
    return 100.0 * ctx["trace"].busy_s() / ctx["trace"].window_s if ctx["kind"] == "dummy" else None
'''


def digests(root):
    return {p: hashlib.sha256(p.read_bytes()).hexdigest()
            for p in (root / "portbench").rglob("*") if p.is_file()}


def test_new_cell_config_traffic_and_metric_are_new_files(tmp_path, capsys):
    from conftest import copy_benchmark

    root = copy_benchmark(tmp_path)
    before = digests(root)
    pb = root / "portbench"
    (pb / "configs" / "dummy-model.json").write_text(json.dumps({"size": 4}))
    (pb / "traffic" / "dummy-traffic.json").write_text(json.dumps({"driver": "dummy",
                                                                   "rate": 2.5}))
    (pb / "drivers" / "dummy.py").write_text(DRIVER)
    (pb / "workloads" / "dummy-cell.json").write_text(json.dumps(
        {"limits": {"dummy_gap": 0.1}}))
    (pb / "metrics" / "dummy_busy.py").write_text(METRIC)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "dummy-model", "source": "https://example.org/dummy",
                             "file": "portbench/configs/dummy-model.json", "reduced": [],
                             "why": "a test"})
    bench["workloads"].append({"name": "dummy-cell", "config": "dummy-model",
                               "traffic": "dummy-traffic", "chips": 1, "why": "a test"})
    bench["end_to_end"].append({"name": "dummy_rate", "unit": "x/s", "better": "higher",
                                "bound": 0.05, "source": "host_clock",
                                "workloads": ["dummy-cell"]})
    bench["per_layer"].append({"name": "dummy_busy", "unit": "%", "better": "higher",
                               "source": "device_trace", "layer": "dummy",
                               "moves": "dummy_rate", "workloads": ["dummy-cell"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = core.load_cell("dummy-cell", root=root)
    import torch

    for trace, want in ((0, {"dummy_rate": 10.0, "setup_s": 0.5}), (1, {"dummy_busy": 25.0})):
        args = types.SimpleNamespace(workload="dummy-cell", seed=1, seconds=1, trace=trace)
        assert prun.run(cell, args, torch.device("cpu"), 0.0) == 0
        line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert {k: v["value"] for k, v in line["metrics"].items()} == want
        assert line["correct"] is True and list(line)[-1] == "checks"
    after = digests(root)
    assert all(after[p] == h for p, h in before.items())
