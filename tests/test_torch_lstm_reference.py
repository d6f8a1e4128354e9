"""The port's LSTM model against the benchmark's plain reference
(``portbench/reference/lstm.py``), in float32 on a tiny graph with the
benchmark's seeded weights: the masked reducer alone, and three training
steps of the sampled tree through the device-epoch functions against the
reference's own steps, drawing the same numbers.  The fp8 control misses
the tolerances.  Also the reducer's span and counters, and, on a card,
that a captured step's replays add them back.  No JAX here: the card test
runs with ``--noconftest``.

Tolerances (``TOL``) are f32 summation order: the port and the reference
sum the same products in other orders (the packed gates' input and
recurrent products, the towers, the loss), which reads 0 on the losses and
under 1e-7 on the gradients and the parameters' change here."""

import json
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from gnn_recsys_tpu_torch.models.layers import MaskedLSTMReducer
from gnn_recsys_tpu_torch.ops.membership import build_padded_pair_set
from gnn_recsys_tpu_torch.ops.sampling import Draws
from gnn_recsys_tpu_torch.train.full_batch import TrainState
from gnn_recsys_tpu_torch.train.minibatch import (MinibatchConfig, device_edge_store,
                                                  make_epoch_fns)
from portbench.counts import lstm as clstm
from portbench.harness import core, program
from portbench.harness import data as bdata
from portbench.harness.trace_ops import span_ops
from portbench.reference import lstm as rlstm
from portbench.reference import model as rmodel
from portbench.reference.train import slice_widths

ROOT = Path(__file__).resolve().parents[1]
DRIVER = core.load_module(ROOT / "portbench" / "drivers" / "device_epochs.py",
                          "portbench_driver_device_epochs")
TOL = {"loss_gap": 1e-5, "grad_gap": 1e-5, "update_gap": 1e-4}
SEED = 2**31 + 17
STEPS = 3
# The reducer's counters (``utils/profiling.py:counter``).
REDUCER_COUNTS = ("slot_steps", "row_slots")


@pytest.fixture(autouse=True)
def fresh_counters(monkeypatch):
    for name in REDUCER_COUNTS:
        monkeypatch.setattr(MaskedLSTMReducer, name, 0)


def tiny_config() -> dict:
    """The benchmark's LSTM configuration at a tiny size, in float32."""
    conf = json.loads((ROOT / "portbench" / "configs" / "medium-lstm-bf16.json").read_text())
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
        m, g = conf["model"], conf["graph"]
        spec = rlstm.param_spec(tuple(gd["schema"]),
                                {nt: g["feat_dim"] for nt in gd["num_nodes"]},
                                m["hidden_dim"], m["out_dim"], m["n_layers"])
        self.p0 = bdata.make_weights(spec, inp["weight_seed"], dev)
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

    def one_step_counts(self) -> dict:
        """What the reducer's counters read after one step's forward: a row
        a node and incoming edge type at each level above the leaves; K
        cell updates a call, one call per node set and incoming edge type."""
        st = self.conf["step"]
        widths, _ = slice_widths({et: len(self.gd["schema"][et][0]) for et in self.etypes},
                                 st["edge_batch_size"])
        b = sum(widths.values())
        seeds = {"user": b, "item": b + st["neg_pool_size"]}
        k1, k2 = st["fanouts"]
        # Per seed type: 2 calls at the top; below, its own 2 and 2 for each
        # of its 2 edge types' neighbours.
        rows = clstm.tree_row_slots(tuple(self.gd["schema"]), seeds, st["fanouts"])
        return {"slot_steps": len(seeds) * (2 * k2 + 6 * k1), "row_slots": rows}


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
    return rlstm.run_steps(world.p0, rg, feats, world.etypes, DRIVER.epoch_seed(SEED, 0),
                           world.conf["step"], STEPS, q=q)


def within(numbers: dict) -> bool:
    return all(numbers[k] <= TOL[k] for k in TOL)


def test_reducer_matches_the_reference_masked_lstm():
    """Holes in the mask are skipped, a row with no valid slot gives 0."""
    n, k, d, hidden = 40, 6, 12, 16
    spec = {"k.lstm.ih.weight": (4 * hidden, d), "k.lstm.hh.weight": (4 * hidden, hidden),
            "k.lstm.hh.bias": (4 * hidden,)}
    P = bdata.make_weights(spec, 5, torch.device("cpu"))
    reducer = MaskedLSTMReducer(d, hidden)
    reducer.load_state_dict({name[len("k.lstm."):]: v for name, v in P.items()})
    gen = torch.Generator().manual_seed(1)
    msgs = torch.randn(n, k, d, generator=gen)
    mask = torch.rand(n, k, generator=gen) < 0.6
    mask[:3] = False
    mask[3] = True
    mask[4, 0] = mask[4, -1] = False
    ours = reducer(msgs, mask)
    theirs = rlstm.Model(P, None, None).lstm("k", msgs, mask)
    assert torch.equal(ours[:3], torch.zeros(3, hidden))
    torch.testing.assert_close(ours, theirs, rtol=1e-5, atol=1e-6)
    # A skipped slot's message does not matter.
    noisy = torch.where(mask[..., None], msgs, torch.full_like(msgs, 1e3))
    torch.testing.assert_close(reducer(noisy, mask), ours, rtol=0, atol=0)


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


def test_span_and_counters_of_one_eager_step(tmp_path):
    """One eager step: every reducer call is one ``gnn.lstm.reduce`` span,
    and the counters count its forward exactly; the span parser finds the
    spans (a CPU trace has no device operations to attribute)."""
    world = World(torch.device("cpu"))
    want = world.one_step_counts()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        world.steps(0, 1)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    spans = [e for e in events if e.get("name") == "gnn.lstm.reduce"]
    assert {e["cat"] for e in spans} == {"user_annotation"}
    k1, k2 = world.conf["step"]["fanouts"]
    assert len(spans) * k1 >= want["slot_steps"] >= len(spans) * k2
    assert {n: getattr(MaskedLSTMReducer, n) for n in REDUCER_COUNTS} == want
    ops = span_ops(events, "gnn.lstm.reduce")
    assert ops.spans == len(spans) and ops.fwd_ops == ops.bwd_ops == 0


@pytest.mark.cuda
def test_replays_add_their_steps_counts():
    """On the card: the capture's counts are taken off the counters, and n
    replays add n steps' counts."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    world = World(torch.device("cuda"))
    world.steps(0, 0)  # the capture
    want = world.one_step_counts()
    counts = world.chunk_fn.captured.counts
    assert {n: counts[f"MaskedLSTMReducer.{n}"] for n in REDUCER_COUNTS} == want
    for name in REDUCER_COUNTS:
        setattr(MaskedLSTMReducer, name, 0)
    losses = world.steps(0, 3).cpu()
    assert bool(torch.isfinite(losses).all())
    assert {n: getattr(MaskedLSTMReducer, n) for n in REDUCER_COUNTS} == {
        n: 3 * v for n, v in want.items()}
