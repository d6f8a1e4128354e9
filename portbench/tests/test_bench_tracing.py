"""The readers of the program's spans and counters on hand-built traces:
what each reads, and nothing where its span or counter is missing (as on a
program without them)."""

from pathlib import Path

import pytest

from portbench.harness import core
from portbench.harness.trace import Trace

METRICS = Path(__file__).resolve().parents[1] / "metrics"
SPAN_READERS = {"replay_host_ms.train": "train", "launch_idle_ms_per_step.train": "train",
                "load_graph_s.serve": "serve", "bought_table_s.serve": "serve"}


def reader(name):
    return core.load_module(METRICS / f"{name}.py", f"portbench_metric_{name}").read


def train_trace():
    """Two 2 ms replays in a 10 ms window; idle 1-2 ms (inside the first
    replay), 4-6 ms (middle at 5 ms, outside both) and 8-10 ms (middle at
    9 ms, inside the second)."""
    return Trace(window_s=0.010,
                 device=[(0.0, 0.001, "k"), (0.002, 0.004, "k"), (0.006, 0.008, "k")],
                 host=[(0.0005, 0.0025, "gnn.train.replay"), (0.0075, 0.0095, "gnn.train.replay"),
                       (0.004, 0.006, "cudaStreamSynchronize")])


def test_launch_idle_counts_only_gaps_inside_replays():
    ctx = {"kind": "train", "steps": 2, "trace": train_trace()}
    assert reader("launch_idle_ms_per_step.train")(ctx) == pytest.approx((1.0 + 2.0) / 2)
    assert reader("replay_host_ms.train")(ctx) == pytest.approx(2.0)


def test_serving_span_means():
    tr = Trace(window_s=3.0, host=[
        (0.0, 1.0, "gnn.serve.request"), (0.1, 0.8, "gnn.load_run.graph"),
        (0.85, 0.95, "gnn.serve.bought_table"), (1.0, 3.0, "gnn.serve.request"),
        (1.1, 2.0, "gnn.load_run.graph"), (2.0, 2.3, "gnn.serve.bought_table")])
    ctx = {"kind": "serve", "trace": tr}
    assert reader("load_graph_s.serve")(ctx) == pytest.approx(0.8)
    assert reader("bought_table_s.serve")(ctx) == pytest.approx(0.2)


@pytest.mark.parametrize("name", sorted(SPAN_READERS))
def test_span_readers_give_nothing_without_their_span(name):
    kind = SPAN_READERS[name]
    bare = Trace(window_s=1.0, device=[(0.0, 0.5, "k")], host=[(0.0, 1.0, "cudaGraphLaunch")])
    assert reader(name)({"kind": kind, "steps": 4, "trace": bare}) is None
    other = "serve" if kind == "train" else "train"
    assert reader(name)({"kind": other, "steps": 2, "trace": train_trace()}) is None


def test_h2d_reader_divides_the_counters(monkeypatch):
    from gnn_recsys_tpu_torch.inference import inference_ondemand
    from gnn_recsys_tpu_torch.utils.profiling import to_device

    read = reader("h2d_mb_per_request.serve")
    ctx = {"kind": "serve", "trace": Trace(window_s=1.0)}
    monkeypatch.setattr(to_device, "h2d_bytes", 3_000_000)
    monkeypatch.setattr(inference_ondemand, "requests", 0)
    assert read(ctx) is None  # no request returned
    monkeypatch.setattr(inference_ondemand, "requests", 2)
    assert read(ctx) == pytest.approx(1.5)
    assert read({"kind": "train", "steps": 1, "trace": train_trace()}) is None
    monkeypatch.delattr(to_device, "h2d_bytes")  # a program without the counter
    assert read(ctx) is None
