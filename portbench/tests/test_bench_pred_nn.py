"""The MLP head's cell (``train-medium-pred_nn-bf16``): a whole run on the CPU
at a tiny size past the harness's look for a card, sound and broken; its
control; its two readers; and the head's count at the cell's sizes."""

from pathlib import Path

import pytest
import torch
from test_bench_faults import half_batch, in_f32, loss_altered, run_cell, state_unchanged

from portbench import control_pred_nn
from portbench.counts import kernels as kc
from portbench.counts import pred_nn as cp
from portbench.harness import core

CELL = "train-medium-pred_nn-bf16"
METRICS = Path(__file__).resolve().parents[1] / "metrics"
BUYS, CLICKS = ("user", "buys", "item"), ("user", "clicks", "item")


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


def assert_caught(mode, numbers, limits):
    """The numbers fail the limits; a loss altered by 2% fails ``loss_gap``
    itself, whatever bf16 does to the gradients' numbers."""
    keys = ("loss_gap",) if mode == "loss_altered" else tuple(numbers)
    assert not core.passes([(k, numbers[k], limits[k]) for k in keys]), numbers


@pytest.mark.parametrize("mode", ("lowp", "half_batch", "state_unchanged", "loss_altered"))
def test_control_and_faults_are_not_correct_tiny(tiny_root, one_thread, mode):
    """The fp8 control and the three faults fail the cell's limits at a
    tiny size on the CPU, seed after seed."""
    cell = core.load_cell(CELL, root=tiny_root)
    limits = cell.own["limits"]
    for seed in (1, 2, 3):
        numbers = control_pred_nn.training(cell, seed, mode, torch.device("cpu"))
        assert_caught(mode, numbers, limits)


def test_head_count_at_the_cells_sizes():
    """2,048 positives split 1,024 + 1,024, a pool of 2,560, out 128: rows
    2,048 + 2,048 + 2,560; pairs 2,048 x 2,560 + 2,048; layer 1 once a row
    through a 128 x 128 half, layers 2 and 3 on every pair."""
    widths = {BUYS: 1024, CLICKS: 1024}
    rows, pairs = cp.step_rows(widths, 2560), cp.step_pairs(widths, 2560)
    assert (rows, pairs) == (6656, 5_244_928)
    fwd = 2.0 * 6656 * 128 * 128 + 2.0 * 5_244_928 * (128 * 32 + 32)
    assert cp.forward_flops(rows, pairs, 128) == fwd == pytest.approx(43.52e9, rel=1e-3)
    flops, nbytes = cp.step_cost(rows, pairs, 128, 2)
    assert flops == 3 * fwd == pytest.approx(130.56e9, rel=1e-3)
    assert nbytes == 2 * (2 * 6656 * 128 + 4 * 5_244_928)
    least = cp.step_bound_s(rows, pairs, 128, 2, kc.PEAK_BF16_FLOPS)
    assert least == pytest.approx(flops / 989e12) == pytest.approx(0.132e-3, rel=1e-2)


def test_step_flops_swap_the_cosine_scores_for_the_head():
    from portbench.counts import model as mc

    widths, args = {BUYS: 4, CLICKS: 4}, ((3, 2), 8, 16, 8)
    schema = (BUYS, CLICKS, ("item", "bought-by", "user"), ("item", "clicked-by", "user"))
    nodes = {"user": 30, "item": 20}
    cos = mc.train_step(schema, widths, 10, *args, nodes)
    nn = cp.train_step(schema, widths, 10, *args, nodes)
    cosine = 2 * (2 * 4 * 8 + 2 * 4 * 10 * 8)
    head = cp.forward_flops(2 * 8 + 10, 2 * (4 + 40), 8)
    assert nn["flops"] == pytest.approx(cos["flops"] + 3 * (head - cosine))
    assert nn["leaves"] == cos["leaves"]


def pred_context(**over):
    pred = {"spans_per_step": 4.0, "fwd_ms_per_step": 3.0, "bwd_ms_per_step": 7.0,
            "fwd_ops_per_step": 40.0, "bwd_ops_per_step": 80.0, "pairs_per_step": 5_244_928.0,
            "step_device_ms_per_step": 14.0}
    pred.update(over)
    return {"kind": "train", "steps": 32, "pred": pred, "head_rows": 6656, "out": 128,
            "elem": 2, "dtype": "bfloat16"}


def test_pred_readers():
    ctx = pred_context()
    assert reader("pred_nn_ms_per_step.train")(ctx) == pytest.approx(10.0)
    least = cp.step_bound_s(6656, 5_244_928, 128, 2, kc.PEAK_BF16_FLOPS)
    assert reader("pred_nn_roofline")(ctx) == pytest.approx(100.0 * least / 10e-3)


@pytest.mark.parametrize("ctx", (pred_context(spans_per_step=0.0),
                                 {"kind": "train", "steps": 32, "pred": {}},
                                 {"kind": "train", "steps": 32},
                                 dict(pred_context(), kind="serve")),
                         ids=("no span", "untraced", "another driver", "serving"))
def test_pred_readers_give_nothing_without_the_span(ctx):
    assert reader("pred_nn_ms_per_step.train")(ctx) is None
    assert reader("pred_nn_roofline")(ctx) is None


def test_roofline_gives_nothing_without_the_counter():
    ctx = pred_context(pairs_per_step=None)
    assert reader("pred_nn_ms_per_step.train")(ctx) == pytest.approx(10.0)
    assert reader("pred_nn_roofline")(ctx) is None


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ("lowp", "half_batch", "state_unchanged", "loss_altered"))
def test_control_and_faults_are_not_correct_on_the_card(card, mode):
    """The fp8 control and the three faults at the cell's own size on three
    seeds."""
    cell = core.load_cell(CELL)
    limits = cell.own["limits"]
    for seed in (2**31 + 101, 2**31 + 102, 2**31 + 103):
        numbers = control_pred_nn.training(cell, seed, mode, card)
        assert_caught(mode, numbers, limits)
