"""The port's spans and counters (``utils/profiling.py``: ``span`` and
``to_device``; ``inference_ondemand.requests``): a span does nothing
without a profiler and is one Chrome-trace annotation under one; serving
and training put their spans where their readers look; the host-to-device
byte count.  No JAX here: the card test runs with ``--noconftest``."""

import json
import os

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function, schedule

from gnn_recsys_tpu_torch import inference
from gnn_recsys_tpu_torch.models.conv_model import ConvModel
from gnn_recsys_tpu_torch.ops.membership import build_padded_pair_set
from gnn_recsys_tpu_torch.ops.sampling import Draws
from gnn_recsys_tpu_torch.train import minibatch as tmb
from gnn_recsys_tpu_torch.train.checkpoint import save_run
from gnn_recsys_tpu_torch.train.full_batch import TrainState
from gnn_recsys_tpu_torch.utils import profiling
from gnn_recsys_tpu_torch.utils.synthetic import make_synthetic_data

SERVE_SPANS = ("gnn.serve.request", "gnn.load_run", "gnn.load_run.params", "gnn.load_run.graph",
               "gnn.load_run.pickles", "gnn.serve.build", "gnn.serve.embed",
               "gnn.serve.bought_table", "gnn.serve.rank", "gnn.serve.to_host")


def _events(prof, tmp_path):
    path = os.path.join(tmp_path, "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        return json.load(f)["traceEvents"]


def _annotations(fn, tmp_path, activities=(ProfilerActivity.CPU,)):
    """``fn()`` under ``torch.profiler``: its result and the program's spans
    in the Chrome trace, as (name, start us, end us)."""
    with profile(activities=list(activities)) as prof:
        out = fn()
    spans = [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
             for e in _events(prof, tmp_path)
             if e.get("cat") == "user_annotation" and e.get("name", "").startswith("gnn.")]
    return out, spans


def _inside(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


@pytest.fixture
def fresh_counters(monkeypatch):
    monkeypatch.setattr(profiling.to_device, "h2d_bytes", 0)
    monkeypatch.setattr(inference.inference_ondemand, "requests", 0)


def test_span_off_enters_no_record_function(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered with no profiler running")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not torch.autograd._profiler_enabled()
    with profiling.span("gnn.test"):
        x = torch.ones(3) + 1
    assert x.sum() == 6


def test_span_on_is_one_annotation_the_harness_reads(tmp_path):
    """Under the profiler a span is one ``user_annotation`` of its name,
    which ``portbench.harness.trace.parse`` reads through ``span_s``; in the
    profiler's warm-up cycle it is off."""
    from portbench.harness import trace as htrace

    with profile(activities=[ProfilerActivity.CPU],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        with profiling.span("gnn.test.warm"):  # the warm-up cycle: not recording
            torch.ones(3) + 1
        prof.step()
        with record_function(htrace.WINDOW):
            with profiling.span("gnn.test"):
                torch.ones(64, 64) @ torch.ones(64, 64)
        prof.step()
    events = _events(prof, tmp_path)
    named = [e for e in events if e.get("name", "").startswith("gnn.test")]
    assert [(e["name"], e["cat"]) for e in named] == [("gnn.test", "user_annotation")]
    spans = htrace.parse(events).span_s("gnn.test")
    assert len(spans) == 1 and 0 < spans[0] <= float(named[0]["dur"]) / 1e6 + 1e-9


def test_to_device_counts_host_bytes_that_leave(fresh_counters):
    x = torch.zeros(5, 3, dtype=torch.float32)
    assert profiling.to_device(x, "cpu") is x
    assert profiling.to_device.h2d_bytes == 0
    m = profiling.to_device(x, "meta")
    assert m.device.type == "meta" and profiling.to_device.h2d_bytes == 60
    assert profiling.to_device(m, "meta") is m
    assert profiling.to_device.h2d_bytes == 60
    lin = torch.nn.Linear(4, 2)  # 8 + 2 f32 parameters
    assert profiling.to_device(lin, "meta") is lin
    assert lin.weight.device.type == "meta" and profiling.to_device.h2d_bytes == 100


def _tiny_run(run_dir):
    data = make_synthetic_data(num_users=40, num_items=30, num_groups=4, interactions_per_user=5,
                               test_per_user=1, feat_dim=8, with_clicks=True, seed=2)
    g = data.graph
    kw = {"canonical_etypes": [list(et) for et in g.canonical_etypes],
          "dims": [["user", 8], ["item", 8], ["hidden", 16], ["out", 8]],
          "n_layers": 3, "aggregator_type": "mean_nn"}
    model = ConvModel(g.canonical_etypes, (("user", 8), ("item", 8), ("hidden", 16), ("out", 8)),
                      n_layers=3, aggregator_type="mean_nn")
    save_run(run_dir, model.state_dict(), kw, graph=g, id_maps={}, extras={"note": 1})


def test_serving_spans_and_counters(tmp_path, fresh_counters):
    """Two requests: each serving span once a request, inside its
    ``gnn.serve.request``, ``load_run``'s parts inside ``gnn.load_run``;
    the request counter at 2, no byte counted on the CPU."""
    run_dir = str(tmp_path / "run")
    _tiny_run(run_dir)

    def serve():
        return [inference.inference_ondemand(run_dir, users, k=3, device="cpu")
                for users in ([0, 1, 2], [5])]

    answers, spans = _annotations(serve, tmp_path)
    assert [sorted(a) for a in answers] == [[0, 1, 2], [5]]
    assert sorted(n for n, _, _ in spans) == sorted(SERVE_SPANS * 2)
    requests = [s for s in spans if s[0] == "gnn.serve.request"]
    loads = [s for s in spans if s[0] == "gnn.load_run"]
    for s in spans:
        assert sum(_inside(s, r) for r in requests) == 1, s
        if s[0].startswith("gnn.load_run."):
            assert sum(_inside(s, r) for r in loads) == 1, s
    assert inference.inference_ondemand.requests == 2
    assert profiling.to_device.h2d_bytes == 0


def _train_world(dev):
    data = make_synthetic_data(num_users=40, num_items=30, num_groups=4, interactions_per_user=5,
                               test_per_user=1, feat_dim=8, with_clicks=True, seed=2)
    g = data.graph.to(dev)
    model = ConvModel(g.canonical_etypes, (("user", 8), ("item", 8), ("hidden", 16), ("out", 8)),
                      n_layers=3, aggregator_type="mean_nn").to(dev)
    etypes = tuple(data.train_pairs)
    counts = {et: g.num_edges(et) for et in etypes}
    cfg = tmb.MinibatchConfig(edge_batch_size=48, fanouts=(4, 3), neg_sample_size=5,
                              neg_pool_size=24, lr=3e-3)
    perm_fn, chunk_fn = tmb.make_epoch_fns(model, cfg, etypes, True, True,
                                           {et: True for et in etypes}, counts)
    tables = {et: build_padded_pair_set(u, i, num_src=g.num_nodes("user")).to(dev)
              for et, (u, i) in data.train_pairs.items()}
    feats = {nt: g.ndata[nt]["features"] for nt in g.ntypes}
    inputs = (TrainState.create(model, lr=cfg.lr), g, feats, tables,
              tmb.device_edge_store(g, etypes, dev))
    eids = {et: torch.arange(n, device=dev) for et, n in counts.items()}
    return perm_fn, chunk_fn, inputs, eids


def test_eager_chunk_is_one_span_a_call(tmp_path):
    perm_fn, chunk_fn, inputs, eids = _train_world(torch.device("cpu"))
    gen = torch.Generator().manual_seed(3)

    def epoch():
        perms = perm_fn(eids, gen)
        return [chunk_fn(*inputs, perms, t0, Draws(gen), n)[1] for t0, n in ((0, 2), (2, 1))]

    losses, spans = _annotations(epoch, tmp_path)
    assert [len(ls) for ls in losses] == [2, 1]
    assert sorted(n for n, _, _ in spans) == ["gnn.train.chunk", "gnn.train.chunk",
                                              "gnn.train.permutation"]


@pytest.mark.cuda
def test_captured_chunk_is_one_replay_span_a_step(tmp_path):
    """On the card: the first chunk captures (one ``gnn.train.capture``) and
    replays; each step of a chunk is one ``gnn.train.replay`` span, and no
    span comes from inside the captured body."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    perm_fn, chunk_fn, inputs, eids = _train_world(dev)
    gen = torch.Generator(device=dev).manual_seed(3)
    draws = Draws(gen)
    perms = perm_fn(eids, gen)
    cuda = (ProfilerActivity.CPU, ProfilerActivity.CUDA)
    _, first = _annotations(lambda: chunk_fn(*inputs, perms, 0, draws, 2), tmp_path, cuda)
    assert chunk_fn.captured is not None
    assert sorted(n for n, _, _ in first) == ["gnn.train.capture", "gnn.train.chunk",
                                              "gnn.train.replay", "gnn.train.replay"]
    losses, spans = _annotations(lambda: chunk_fn(*inputs, perms, 2, draws, 3)[1].cpu(),
                                 tmp_path, cuda)
    assert losses.shape == (3,) and bool(torch.isfinite(losses).all())
    assert sorted(n for n, _, _ in spans) == ["gnn.train.chunk"] + ["gnn.train.replay"] * 3
    chunk = next(s for s in spans if s[0] == "gnn.train.chunk")
    assert all(_inside(s, chunk) for s in spans)
