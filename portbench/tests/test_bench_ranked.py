"""The cells served by ``drivers/ondemand_ranked.py``: each run whole on the
CPU at a tiny size past the harness's look for a card, sound and broken;
their control and faults; the head's two readers; and the serving head's
count at the cell's size."""

import json
import types
from pathlib import Path

import pytest
import torch

from portbench import control_ranked
from portbench import run as prun
from portbench.counts import kernels as kc
from portbench.counts import model as cm
from portbench.counts import serve_ranked as cs
from portbench.harness import core

NN, BOOSTED = "serve-medium-pred_nn-all", "serve-medium-boosted"
METRICS = Path(__file__).resolve().parents[1] / "metrics"
SCHEMA = (("user", "buys", "item"), ("item", "bought-by", "user"), ("user", "clicks", "item"),
          ("item", "clicked-by", "user"))


def run_cell(root, name, capsys, seed=2**31 + 11, trace=0) -> dict:
    cell = core.load_cell(name, root=root)
    args = types.SimpleNamespace(workload=name, seed=seed, seconds=0.3, trace=trace)
    assert prun.run(cell, args, torch.device("cpu"), 0.0) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def reader(name):
    return core.load_module(METRICS / f"{name}.py", f"portbench_metric_{name}").read


@pytest.mark.parametrize("trace", (0, 1))
@pytest.mark.parametrize("name", (NN, BOOSTED))
def test_sound_run_is_correct(tiny_root, capsys, one_thread, name, trace):
    line = run_cell(tiny_root, name, capsys, trace=trace)
    assert line["correct"] is True and line["failed"] == 0, line["checks"]
    if trace:
        want = {m["name"] for m in core.load_cell(name, root=tiny_root).metrics("per_layer")}
        # The CPU runs no device operation: the head's time reads 0, the shares nothing.
        assert set(line["metrics"]) == want - {"pred_nn_rank_roofline",
                                               "mips_topk_boosted_roofline"}, line["metrics"]


def cosine_served(monkeypatch):
    """The cosine ranking served for an ``nn`` run."""
    from gnn_recsys_tpu_torch import inference

    monkeypatch.setattr(inference, "model_score_fn", lambda pred, model: None)


def unboosted_served(monkeypatch):
    """The ranking without the boost served for a boosted request."""
    from gnn_recsys_tpu_torch import inference

    get_recs = inference.get_recs
    monkeypatch.setattr(inference, "get_recs",
                        lambda *a, **k: get_recs(*a, **dict(k, popularity=None)))


def next_one_served(monkeypatch):
    """Each user's k-th item swapped for its (k+1)-th."""
    from gnn_recsys_tpu_torch import inference

    get_recs = inference.get_recs

    def swapped(user_emb, item_emb, user_ids, k, **kw):
        recs = get_recs(user_emb, item_emb, user_ids, k + 1, **kw)
        return torch.cat([recs[:, :k - 1], recs[:, k:]], dim=1)

    monkeypatch.setattr(inference, "get_recs", swapped)


@pytest.mark.parametrize("name,fault", ((NN, cosine_served), (NN, next_one_served),
                                        (BOOSTED, unboosted_served),
                                        (BOOSTED, next_one_served)),
                         ids=lambda x: getattr(x, "__name__", x))
def test_broken_path_is_not_correct(tiny_root, capsys, monkeypatch, one_thread, name, fault):
    fault(monkeypatch)
    line = run_cell(tiny_root, name, capsys)
    assert line["correct"] is False, line["checks"]


@pytest.mark.parametrize("name,mode,precision", ((NN, "lowp", "bfloat16"), (NN, "cosine", None),
                                                 (BOOSTED, "lowp", "bfloat16"),
                                                 (BOOSTED, "unboosted", None)))
def test_control_and_faults_are_not_correct_tiny(tiny_root, one_thread, name, mode, precision):
    """The reference in bf16 (TF32, the float32 configuration's control,
    exists on the card only) and each cell's fault fail the cell's limit at
    a tiny size on the CPU, seed after seed."""
    cell = core.load_cell(name, root=tiny_root)
    for seed in (1, 2, 3):
        numbers = control_ranked.serving(cell, seed, mode, torch.device("cpu"), 20, precision)
        assert numbers["rank_gap"] > cell.own["limits"]["rank_gap"], numbers


def test_lowp_control_in_float32_reads_nothing(tiny_root, one_thread):
    """On the CPU ``tf32`` leaves float32 as it is: the reference against
    itself reads 0, so the limit's lower side is the program's own gap."""
    cell = core.load_cell(NN, root=tiny_root)
    assert control_ranked.serving(cell, 1, "lowp", torch.device("cpu"), 1)["rank_gap"] == 0.0


def test_head_count_at_the_cells_size():
    """100,000 users against 30,000 items: 3.0e9 pairs; layer 1 once a row
    through a 128 x 128 half, layers 2 and 3 on every pair: 2.48e13 FLOPs,
    0.37 s at the f32 peak."""
    pairs = 100_000 * 30_000
    flops, nbytes = cs.head_cost(100_000, 30_000, pairs, 128)
    assert flops == 2.0 * 130_000 * 128 * 128 + 2.0 * pairs * (128 * 32 + 32)
    assert flops == pytest.approx(2.48e13, rel=2e-3)
    assert nbytes == 4.0 * (130_000 * 128 + pairs)
    assert cs.head_bound_s(100_000, 30_000, pairs, 128) == pytest.approx(flops / 67e12)
    nodes = {"user": 100_000, "item": 30_000}
    cos = cm.request(SCHEMA, nodes, 2, 8, 256, 128, 100_000)
    assert cs.request(SCHEMA, nodes, 2, 8, 256, 128, 100_000, "cos") == cos
    assert cs.request(SCHEMA, nodes, 2, 8, 256, 128, 100_000, "nn") == pytest.approx(
        cos - 2.0 * pairs * 128 + flops)


def head_context(**over):
    head = {"spans": 782, "requests": 1, "ms_per_request": 3000.0, "ops_per_request": 4e5,
            "users": 100_000, "items": 30_000, "out": 128, "pairs_per_request": 3e9,
            "pairs": 3_000_000_000}
    head.update(over)
    return {"kind": "serve", "pred_rank": head}


def test_head_readers():
    ctx = head_context()
    assert reader("pred_nn_rank_ms.serve")(ctx) == pytest.approx(3000.0)
    least = cs.head_bound_s(100_000, 30_000, 3e9, 128)
    assert reader("pred_nn_rank_roofline")(ctx) == pytest.approx(100.0 * least / 3.0)
    two = head_context(requests=2, users=200_000, items=60_000, pairs=6_000_000_000)
    assert reader("pred_nn_rank_roofline")(two) == pytest.approx(100.0 * least / 3.0)
    assert least == pytest.approx(2.48e13 / kc.PEAK_F32_FLOPS, rel=2e-3)


@pytest.mark.parametrize("ctx", (head_context(spans=0), {"kind": "serve", "pred_rank": None},
                                 {"kind": "serve"}, dict(head_context(), kind="train")),
                         ids=("no span", "untraced", "another driver", "training"))
def test_head_readers_give_nothing_without_the_span(ctx):
    assert reader("pred_nn_rank_ms.serve")(ctx) is None
    assert reader("pred_nn_rank_roofline")(ctx) is None


def test_roofline_gives_nothing_without_the_counter():
    ctx = head_context(pairs=None, pairs_per_request=None)
    assert reader("pred_nn_rank_ms.serve")(ctx) == pytest.approx(3000.0)
    assert reader("pred_nn_rank_roofline")(ctx) is None


def test_boost_passes_at_the_cells_size():
    """4,096 users against 30,000 items of 128: each pass multiplies every
    pair once; the boost pass also reads the popularity and the lse pass's
    two floats a user, and writes ``fetch`` (score, index) pairs a user."""
    (lse_f, lse_b), (boost_f, boost_b) = cs.boost_passes(4096, 30_000, 128, 26)
    tables = 4.0 * (4096 + 30_000) * 128
    assert lse_f == boost_f == 2.0 * 4096 * 30_000 * 128
    assert lse_b == tables + 8.0 * 4096
    assert boost_b == tables + 4.0 * 30_000 + 8.0 * 4096 + 12.0 * 4096 * 26
    assert kc.bound_s(lse_f, lse_b) == pytest.approx(lse_f / kc.PEAK_F32_FLOPS)


class KernelTrace:
    """A traced window's device time by kernel name."""

    def __init__(self, seconds):
        self.seconds = seconds

    def kernel_s(self, hit):
        return sum(t for n, t in self.seconds.items() if hit(n))


def test_boost_roofline_reads_both_passes_kernels():
    calls = cs.boost_passes(100, 30_000, 128, 12) + cs.boost_passes(4096, 30_000, 128, 12)
    least = sum(kc.bound_s(*c) for c in calls)
    trace = KernelTrace({"void topk_kernel<float, false, 2>(...)": 0.6e-3,
                         "void topk_kernel<float, true, 1>(...)": 0.9e-3,
                         "void merge_kernel<12>(...)": 0.2e-3, "lse_combine_kernel": 0.3e-3,
                         "void at::native::vectorized_elementwise_kernel<...>": 5e-3})
    ctx = {"kind": "serve", "boost_calls": calls, "trace": trace}
    assert reader("mips_topk_boosted_roofline")(ctx) == pytest.approx(100.0 * least / 2e-3)


@pytest.mark.parametrize("ctx", ({"kind": "serve", "boost_calls": [], "trace": KernelTrace({})},
                                 {"kind": "serve", "trace": KernelTrace({"topk_kernel": 1.0})},
                                 {"kind": "serve", "boost_calls": [(1.0, 1.0)],
                                  "trace": KernelTrace({"gemm": 1.0})},
                                 {"kind": "train", "boost_calls": [(1.0, 1.0)]}),
                         ids=("unboosted", "another driver", "no kernel", "training"))
def test_boost_roofline_gives_nothing_without_its_passes(ctx):
    assert reader("mips_topk_boosted_roofline")(ctx) is None


@pytest.mark.cuda
@pytest.mark.parametrize("name,mode", ((NN, "lowp"), (NN, "cosine"), (BOOSTED, "lowp"),
                                       (BOOSTED, "unboosted")))
def test_control_and_faults_are_not_correct_on_the_card(card, name, mode):
    """The TF32 control and each cell's fault at the cell's own size on
    three seeds."""
    cell = core.load_cell(name)
    for seed in (2**31 + 101, 2**31 + 102, 2**31 + 103):
        numbers = control_ranked.serving(cell, seed, mode, card, 45)
        assert numbers["rank_gap"] > cell.own["limits"]["rank_gap"], numbers


def test_window_labels_idle_gaps_as_the_harness_does():
    """The driver's sweep gives ``Trace.idle_gaps``'s labels: nested and
    overlapping host events, ties in length, gaps outside every event."""
    import random

    from portbench.harness.trace import Trace

    drv = core.load_module(Path(__file__).resolve().parents[1] / "drivers" / "ondemand_ranked.py",
                           "portbench_driver_ondemand_ranked")
    rng = random.Random(7)
    for _ in range(20):
        device = [(t, t + rng.uniform(0.01, 0.3), "k") for t in
                  sorted(rng.uniform(0, 10) for _ in range(rng.randint(0, 40)))]
        host = []
        for _ in range(rng.randint(0, 30)):
            s = rng.uniform(-1, 10)
            host.append((s, s + rng.choice((0.5, 1.0, rng.uniform(0, 4))), rng.choice("abcd")))
        want = Trace(10.5, device, host).idle_gaps()
        got = drv.Window(10.5, device, host).idle_gaps()
        assert got.keys() == want.keys()
        assert all(got[n] == pytest.approx(want[n]) for n in want)
