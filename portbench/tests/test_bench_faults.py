"""A whole run of each cell on the CPU at a tiny size, past the harness's
look for a card: sound, it comes out correct; with the timed path broken
underneath, or with the control in the program's place, it does not."""

import json
import types

import pytest
import torch

from portbench import control
from portbench import run as prun
from portbench.harness import core

TRAIN = ("train-medium-tree", "train-large-pool_nn", "train-medium-dedup")
CELLS = TRAIN + ("serve-medium-ondemand",)


def in_f32(root):
    """The tiny copy in float32: sound runs then read rounding alone."""
    for cfg in (root / "portbench" / "configs").glob("*.json"):
        c = json.loads(cfg.read_text())
        c["model"]["dtype"] = "float32"
        cfg.write_text(json.dumps(c))


def run_cell(root, name, capsys, seed=2**31 + 11) -> dict:
    cell = core.load_cell(name, root=root)
    args = types.SimpleNamespace(workload=name, seed=seed, seconds=0.3, trace=0)
    assert prun.run(cell, args, torch.device("cpu"), 0.0) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(tiny_root, capsys, one_thread, name):
    in_f32(tiny_root)
    line = run_cell(tiny_root, name, capsys)
    assert line["correct"] is True and line["failed"] == 0, line["checks"]


def state_unchanged(monkeypatch):
    from gnn_recsys_tpu_torch.train.full_batch import TrainState

    monkeypatch.setattr(TrainState, "apply_gradients", lambda self: self.advance())


def half_batch(monkeypatch):
    from gnn_recsys_tpu_torch.train import minibatch

    scored = minibatch.scored_loss

    def first_half(cfg, etypes, batch, pool, scores, tables, parts=False):
        half = {et: batch[et]["u"].shape[0] // 2 for et in etypes}
        batch = {et: {k: v[:half[et]] for k, v in batch[et].items()} for et in etypes}
        scores = tuple({et: s[et][:half[et]] for et in etypes} for s in scores)
        return scored(cfg, etypes, batch, pool, scores, tables, parts)

    monkeypatch.setattr(minibatch, "scored_loss", first_half)


def loss_altered(monkeypatch):
    from gnn_recsys_tpu_torch.train import minibatch

    scored = minibatch.scored_loss
    monkeypatch.setattr(minibatch, "scored_loss", lambda *a, **k: scored(*a, **k) * 1.02)


def answer_altered(monkeypatch):
    from gnn_recsys_tpu_torch import inference

    get_recs = inference.get_recs

    def altered(user_emb, item_emb, *a, **k):
        recs = get_recs(user_emb, item_emb, *a, **k).clone()
        recs[0] = (recs[0] + 1) % item_emb.shape[0]
        return recs

    monkeypatch.setattr(inference, "get_recs", altered)


@pytest.mark.parametrize("name,fault", [(n, f) for n in TRAIN
                                        for f in (state_unchanged, half_batch, loss_altered)]
                         + [("serve-medium-ondemand", answer_altered)],
                         ids=lambda x: getattr(x, "__name__", x))
def test_broken_path_is_not_correct(tiny_root, capsys, monkeypatch, one_thread, name, fault):
    in_f32(tiny_root)
    fault(monkeypatch)
    line = run_cell(tiny_root, name, capsys)
    assert line["correct"] is False, line["checks"]


@pytest.mark.parametrize("name,precision", (("train-medium-tree", None),
                                            ("serve-medium-ondemand", "bfloat16")))
def test_control_is_not_correct_tiny(tiny_root, one_thread, name, precision):
    """The bf16 configuration's control, fp8, fails the cell's limits at a
    tiny size on the CPU.  The float32 configuration's control, TF32, exists
    on the card only; here the serving cell's bf16 reading stands in."""
    cell = core.load_cell(name, root=tiny_root)
    for seed in (1, 2, 3):
        if name.startswith("serve"):
            numbers = control.serving(cell, seed, "lowp", torch.device("cpu"), 20, precision)
        else:
            numbers = control.training(cell, seed, "lowp", torch.device("cpu"), precision)
        limits = cell.own["limits"]
        assert not core.passes([(k, v, limits[k]) for k, v in numbers.items()]), numbers


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct_on_the_card(card, name):
    """The control at the cell's own size on three seeds."""
    cell = core.load_cell(name)
    for seed in (2**31 + 101, 2**31 + 102, 2**31 + 103):
        if name.startswith("serve"):
            numbers = control.serving(cell, seed, "lowp", card, 45)
        else:
            numbers = control.training(cell, seed, "lowp", card)
        limits = cell.own["limits"]
        assert not core.passes([(k, v, limits[k]) for k, v in numbers.items()]), numbers
