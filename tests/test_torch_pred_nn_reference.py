"""The port's MLP head (``pred='nn'``) against the benchmark's plain
reference (``portbench/reference/pred_nn.py``), in float32 on a tiny graph
with the benchmark's seeded weights: ``PredictingLayer``,
``score_emb_pairs`` and ``score_pairs`` alone, and three training steps of
the sampled tree through the device-epoch functions against the reference's
own steps, drawing the same numbers.  The fp8 control misses the
tolerances.  Also the head's span and pair counter, and, on a card, that a
captured step's replays add the counter back.  No JAX here: the card test
runs with ``--noconftest``.

Tolerances (``TOL``) are f32 summation order: the port and the reference
sum the same products in other orders (the tree's towers and means, the
head's broadcast gradients, the loss), which reads 6e-8 on the losses, under
1e-6 on the gradients (their norms and distances) and 3e-6 on the
parameters' change here (Adam's first steps divide each gradient by its own
size, so a small leaf's rounding moves its change the most); the fp8 control
reads 0.3 on the gradients' norms and 0.76 on their distances."""

import json
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from gnn_recsys_tpu_torch.models.layers import PredictingLayer
from gnn_recsys_tpu_torch.ops.membership import build_padded_pair_set
from gnn_recsys_tpu_torch.ops.sampling import Draws
from gnn_recsys_tpu_torch.train.full_batch import TrainState
from gnn_recsys_tpu_torch.train.minibatch import (MinibatchConfig, device_edge_store,
                                                  make_epoch_fns)
from portbench.counts import pred_nn as cpred
from portbench.harness import core, program
from portbench.harness import data as bdata
from portbench.harness.trace_ops import span_ops
from portbench.reference import model as rmodel
from portbench.reference import pred_nn as rpred
from portbench.reference.train import slice_widths

ROOT = Path(__file__).resolve().parents[1]
DRIVER = core.load_module(ROOT / "portbench" / "drivers" / "device_epochs_pred_nn.py",
                          "portbench_driver_device_epochs_pred_nn")
TOL = {"loss_gap": 1e-5, "grad_gap": 1e-5, "update_gap": 1e-4, "grad_dist": 1e-5}
SEED = 2**31 + 17
STEPS = 3
SPAN = "gnn.pred.score"


@pytest.fixture(autouse=True)
def fresh_counter(monkeypatch):
    monkeypatch.setattr(PredictingLayer, "pairs", 0)


def tiny_config() -> dict:
    """The benchmark's MLP head configuration at a tiny size, in float32."""
    conf = json.loads((ROOT / "portbench" / "configs" / "medium-pred_nn-bf16.json").read_text())
    conf["graph"].update(num_users=300, num_items=120, num_groups=5, interactions_per_user=4,
                         max_fanout=8)
    conf["model"].update(hidden_dim=32, out_dim=16, dtype="float32")
    conf["step"].update(edge_batch_size=64, neg_pool_size=50, neg_sample_size=40,
                        epoch_chunk_steps=4, fanouts=[3, 2])
    return conf


class World:
    """The tiny configuration's graph, seeded weights and the port's
    device-epoch functions on ``dev``."""

    def __init__(self, dev):
        self.conf = conf = tiny_config()
        st = conf["step"]
        inp = program.inputs(conf, SEED)
        self.gd = gd = inp["graph"]
        self.etypes = etypes = gd["train_etypes"]
        self.p0 = DRIVER.weights(conf, inp, dev)
        self.graph = program.program_graph(conf, gd).to(dev)
        self.model = program.program_model(conf, gd, self.p0, dev)
        self.state = TrainState.create(self.model, lr=st["lr"])
        cfg = MinibatchConfig(
            edge_batch_size=st["edge_batch_size"], fanouts=tuple(st["fanouts"]),
            neg_mode=st["neg_mode"], neg_pool_size=st["neg_pool_size"],
            neg_sample_size=st["neg_sample_size"], pool_mask_kernel=st["pool_mask_kernel"],
            delta=st["delta"], lr=st["lr"], exclude_batch_edges=True,
            remove_false_negative=True, epoch_chunk_steps=st["epoch_chunk_steps"],
            device_epoch=True)
        counts = {et: len(gd["schema"][et][0]) for et in etypes}
        self.widths, _ = slice_widths(counts, st["edge_batch_size"])
        self.eids = {et: torch.arange(n, device=dev) for et, n in counts.items()}
        has_reverse = {et: rmodel.reverse(et) in self.graph.rels for et in etypes}
        self.perm_fn, self.chunk_fn = make_epoch_fns(self.model, cfg, etypes, True, True,
                                                     has_reverse, counts)
        users = gd["num_nodes"]["user"]
        self.inputs = (self.state, self.graph,
                       {nt: self.graph.ndata[nt]["features"] for nt in self.graph.ntypes},
                       {et: build_padded_pair_set(*gd["schema"][et], num_src=users).to(dev)
                        for et in etypes},
                       device_edge_store(self.graph, etypes, dev))
        self.gen = torch.Generator(device=dev).manual_seed(DRIVER.epoch_seed(SEED, 0))
        self.draws = Draws(self.gen)
        self.perms = self.perm_fn(self.eids, self.gen)

    def steps(self, t0: int, n: int) -> torch.Tensor:
        return self.chunk_fn(*self.inputs, self.perms, t0, self.draws, n)[1]

    def pairs_per_step(self) -> int:
        """B x P + B: every positive, and every positive against the pool."""
        return cpred.step_pairs(self.widths, self.conf["step"]["neg_pool_size"])


def program_first_steps(world: World) -> dict:
    named = dict(world.model.named_parameters())
    losses = [world.steps(0, 1)]
    grads = {k: (world.state.tx.state[p]["exp_avg"] / (1 - DRIVER.ADAM_B1)).clone()
             for k, p in named.items()}
    losses.append(world.steps(1, STEPS - 1))
    return {"losses": torch.cat(losses).tolist(), "grads": grads,
            "params": {k: p.detach().clone() for k, p in named.items()}}


def reference_steps(world: World, q=rmodel.identity) -> dict:
    rg, feats = program.reference_inputs(world.conf, world.gd, torch.device("cpu"))
    return rpred.run_steps(world.p0, rg, feats, world.etypes, DRIVER.epoch_seed(SEED, 0),
                           world.conf["step"], STEPS, q=q)


def within(numbers: dict) -> bool:
    return all(numbers[k] <= TOL[k] for k in TOL)


def head_weights(out: int) -> dict:
    """The head's leaves of the seeded weights, as the driver inits them."""
    spec = {k: v for k, v in rpred.param_spec((), {}, 8, out, 1).items()
            if k.startswith("pred_layer.")}
    return rpred.head_init(bdata.make_weights(spec, 5, torch.device("cpu")))


def test_head_init_is_the_references():
    """Xavier-uniform bounds with ReLU gain on the hidden Denses, gain 1 on
    the output, zero biases."""
    P = head_weights(16)
    for name, (fan_out, fan_in), gain in (("hidden_1", (128, 32), 2 ** 0.5),
                                          ("hidden_2", (32, 128), 2 ** 0.5),
                                          ("output", (1, 32), 1.0)):
        w = P[f"pred_layer.{name}.weight"]
        assert w.shape == (fan_out, fan_in)
        bound = gain * (6.0 / (fan_in + fan_out)) ** 0.5
        assert float(w.abs().max()) <= bound and float(w.abs().max()) > 0.5 * bound
        assert not P[f"pred_layer.{name}.bias"].any()


def test_head_and_scores_match_the_reference():
    """``PredictingLayer`` on the concat, ``score_emb_pairs`` on broadcast
    pairs (every user against every pool row) and ``score_pairs`` on
    gathered ids, against the reference's concatenation and three Denses."""
    world = World(torch.device("cpu"))
    P = {k: v for k, v in world.p0.items() if k.startswith("pred_layer.")}
    model = world.model
    gen = torch.Generator().manual_seed(3)
    hu, hi = torch.randn(7, 16, generator=gen), torch.randn(11, 16, generator=gen)
    with torch.no_grad():
        head = model.pred_layer(torch.cat([hu[:5], hi[:5]], dim=-1))[..., 0]
        torch.testing.assert_close(head, rpred.score(P, hu[:5], hi[:5]), rtol=1e-6, atol=1e-7)
        grid = model.score_emb_pairs(hu[:, None, :], hi[None, :, :])
        assert grid.shape == (7, 11) and grid.dtype == torch.float32
        torch.testing.assert_close(grid, rpred.score(P, hu[:, None, :], hi[None, :, :]),
                                   rtol=1e-6, atol=1e-7)
        et = ("user", "buys", "item")
        src = torch.randint(0, 7, (3, 4), generator=gen)
        dst = torch.randint(0, 11, (3, 4), generator=gen)
        scores = model.score_pairs({"user": hu, "item": hi}, {et: (src, dst)})[et]
        torch.testing.assert_close(scores, rpred.score(P, hu[src], hi[dst]), rtol=1e-6,
                                   atol=1e-7)
    assert PredictingLayer.pairs == 5 + 7 * 11 + 12


@pytest.fixture(scope="module")
def steps():
    held = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        world = World(torch.device("cpu"))
        return world, program_first_steps(world), reference_steps(world)
    finally:
        torch.set_num_threads(held)


def test_three_tree_steps_match_the_reference(steps):
    world, first, reference = steps
    numbers = DRIVER.compare(first, reference, world.p0)
    assert within(numbers), numbers
    assert first["losses"] == pytest.approx(reference["losses"], rel=TOL["loss_gap"])


def test_fp8_control_misses_a_tolerance(steps):
    world, _, reference = steps
    control = reference_steps(world, q=rmodel.rounding(torch.float8_e4m3fn))
    first = {"losses": control["losses"], "grads": control["first_grads"],
             "params": control["params"]}
    numbers = DRIVER.compare(first, reference, world.p0)
    assert not within(numbers), numbers


def test_span_and_counter_of_one_eager_step(tmp_path):
    """One eager step: the head runs in four ``gnn.pred.score`` spans (per
    training edge type its positives, then its pool), and the counter
    counts B x P + B pairs; the span parser finds the spans (a CPU trace has
    no device operations to attribute)."""
    world = World(torch.device("cpu"))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        world.steps(0, 1)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    spans = [e for e in events if e.get("name") == SPAN]
    assert {e["cat"] for e in spans} == {"user_annotation"}
    assert len(spans) == 2 * len(world.etypes)
    b = sum(world.widths.values())
    assert PredictingLayer.pairs == world.pairs_per_step() == b * 50 + b
    ops = span_ops(events, SPAN)
    assert ops.spans == len(spans) and ops.fwd_ops == ops.bwd_ops == 0


def test_cosine_head_runs_no_span(tmp_path):
    """The cosine model's step runs no head span and counts no pair."""
    conf = tiny_config()
    conf["model"]["pred"] = "cos"
    inp = program.inputs(conf, SEED)
    p0 = bdata.make_weights(program.spec(conf, inp["graph"]), inp["weight_seed"], "cpu")
    model = program.program_model(conf, inp["graph"], p0, "cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        model.score_emb_pairs(torch.randn(3, 16), torch.randn(3, 16))
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    assert not [e for e in events if e.get("name") == SPAN]
    assert PredictingLayer.pairs == 0


@pytest.mark.cuda
def test_replays_add_their_steps_pairs():
    """On the card: the capture's pairs are taken off the counter, and n
    replays add n steps' pairs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    world = World(torch.device("cuda"))
    world.steps(0, 0)  # the capture
    want = world.pairs_per_step()
    assert world.chunk_fn.captured.counts["PredictingLayer.pairs"] == want
    PredictingLayer.pairs = 0
    losses = world.steps(0, 3).cpu()
    assert bool(torch.isfinite(losses).all())
    assert PredictingLayer.pairs == 3 * want
