"""The LSTM cell (``train-medium-lstm-bf16``): a whole run on the CPU at a
tiny size past the harness's look for a card, sound and broken; its
control; its two readers and the span parser of ``harness/trace_ops.py``
on hand-built inputs."""

from pathlib import Path

import pytest
import torch
from test_bench_faults import half_batch, in_f32, loss_altered, run_cell, state_unchanged

from portbench import control_lstm
from portbench.harness import core
from portbench.harness.trace_ops import EVALUATE, span_ops

CELL = "train-medium-lstm-bf16"
SPAN = "gnn.lstm.reduce"
METRICS = Path(__file__).resolve().parents[1] / "metrics"


def reader(name):
    return core.load_module(METRICS / f"{name}.py", f"portbench_metric_{name}").read


def test_sound_run_is_correct(tiny_root, capsys, one_thread):
    in_f32(tiny_root)
    line = run_cell(tiny_root, CELL, capsys)
    assert line["correct"] is True and line["failed"] == 0, line["checks"]


@pytest.mark.parametrize("fault", (state_unchanged, half_batch, loss_altered),
                         ids=lambda f: f.__name__)
def test_broken_path_is_not_correct(tiny_root, capsys, monkeypatch, one_thread, fault):
    in_f32(tiny_root)
    fault(monkeypatch)
    line = run_cell(tiny_root, CELL, capsys)
    assert line["correct"] is False, line["checks"]


@pytest.mark.parametrize("mode", ("lowp", "half_batch", "state_unchanged"))
def test_control_and_faults_are_not_correct_tiny(tiny_root, one_thread, mode):
    """The fp8 control and both faults fail the cell's limits at a tiny
    size on the CPU, seed after seed."""
    cell = core.load_cell(CELL, root=tiny_root)
    limits = cell.own["limits"]
    for seed in (1, 2, 3):
        numbers = control_lstm.training(cell, seed, mode, torch.device("cpu"))
        assert not core.passes([(k, v, limits[k]) for k, v in numbers.items()]), numbers


def lstm_context(**over):
    lstm = {"spans_per_step": 16.0, "fwd_ms_per_step": 12.5, "bwd_ms_per_step": 25.0,
            "fwd_ops_per_step": 3000.0, "bwd_ops_per_step": 5960.0,
            "slot_steps_per_step": 112.0, "row_slots_per_step": 1011712.0}
    lstm.update(over)
    return {"kind": "train", "steps": 16, "lstm": lstm}


def test_lstm_readers():
    ctx = lstm_context()
    assert reader("lstm_ms_per_step.train")(ctx) == pytest.approx(37.5)
    assert reader("lstm_kernels_per_slot.train")(ctx) == pytest.approx(8960.0 / 112.0)


@pytest.mark.parametrize("ctx", (lstm_context(spans_per_step=0.0),
                                 {"kind": "train", "steps": 16, "lstm": {}},
                                 {"kind": "train", "steps": 16},
                                 dict(lstm_context(), kind="serve")),
                         ids=("no span", "untraced", "another driver", "serving"))
def test_lstm_readers_give_nothing_without_the_span(ctx):
    assert reader("lstm_ms_per_step.train")(ctx) is None
    assert reader("lstm_kernels_per_slot.train")(ctx) is None


def test_kernels_per_slot_gives_nothing_without_the_counter():
    ctx = lstm_context(slot_steps_per_step=None)
    assert reader("lstm_ms_per_step.train")(ctx) == pytest.approx(37.5)
    assert reader("lstm_kernels_per_slot.train")(ctx) is None


def X(name, cat, ts, dur, tid, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "pid": 1, "tid": tid,
            "args": args}


def hand_trace():
    """A forward thread (1) with one span and an engine thread (2).  In the
    span: ops of sequence numbers 5 and 6 and two launches; before it an op
    of 4.  The engine evaluates node 6 (with its nested node event), node 4
    and an accumulation without a number, one launch each, and launches
    once between evaluations."""
    return [
        X("aten::mm", "cpu_op", 0, 5, 1, **{"Sequence number": 4, "Fwd thread id": 0}),
        X(SPAN, "user_annotation", 10, 100, 1),
        X(SPAN, "gpu_user_annotation", 12, 90, 7),
        X("aten::linear", "cpu_op", 20, 30, 1, **{"Sequence number": 5, "Fwd thread id": 0}),
        X("cudaLaunchKernel", "cuda_runtime", 25, 2, 1, correlation=1),
        X("aten::sigmoid", "cpu_op", 60, 20, 1, **{"Sequence number": 6, "Fwd thread id": 0}),
        X("cuLaunchKernel", "cuda_driver", 65, 2, 1, correlation=2),
        X("cudaLaunchKernel", "cuda_runtime", 120, 2, 1, correlation=3),
        X(EVALUATE + "SigmoidBackward0", "cpu_op", 200, 50, 2,
          **{"Sequence number": 6, "Fwd thread id": 1}),
        X("SigmoidBackward0", "cpu_op", 201, 20, 2, **{"Sequence number": 6, "Fwd thread id": 1}),
        X("cudaLaunchKernel", "cuda_runtime", 240, 2, 2, correlation=4),
        X("cudaLaunchKernel", "cuda_runtime", 255, 2, 2, correlation=5),
        X(EVALUATE + "MmBackward0", "cpu_op", 260, 30, 2,
          **{"Sequence number": 4, "Fwd thread id": 1}),
        X("cudaLaunchKernel", "cuda_runtime", 270, 2, 2, correlation=6),
        X(EVALUATE + "torch::autograd::AccumulateGrad", "cpu_op", 300, 30, 2),
        X("cudaLaunchKernel", "cuda_runtime", 310, 2, 2, correlation=7),
        X("kernel_a", "kernel", 30, 4, 7, correlation=1),
        X("kernel_b", "kernel", 70, 6, 7, correlation=2),
        X("kernel_c", "kernel", 130, 8, 7, correlation=3),
        X("kernel_d", "kernel", 245, 10, 7, correlation=4),
        X("Memset (Device)", "gpu_memset", 258, 1, 7, correlation=5),
        X("kernel_f", "kernel", 275, 12, 7, correlation=6),
        X("kernel_g", "kernel", 315, 14, 7, correlation=7),
    ]


def test_span_parser_attributes_by_correlation_and_sequence_number():
    ops = span_ops(hand_trace(), SPAN)
    assert (ops.spans, ops.fwd_ops, ops.bwd_ops) == (1, 2, 1)
    assert ops.fwd_s == pytest.approx(10e-6) and ops.bwd_s == pytest.approx(10e-6)
    assert span_ops(hand_trace(), "gnn.other") == type(ops)(0, 0.0, 0.0, 0, 0)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ("lowp", "half_batch", "state_unchanged"))
def test_control_and_faults_are_not_correct_on_the_card(card, mode):
    """The fp8 control and both faults at the cell's own size on three
    seeds."""
    cell = core.load_cell(CELL)
    limits = cell.own["limits"]
    for seed in (2**31 + 101, 2**31 + 102, 2**31 + 103):
        numbers = control_lstm.training(cell, seed, mode, card)
        assert not core.passes([(k, v, limits[k]) for k, v in numbers.items()]), numbers
