"""The port's profiling and timing helpers and the ranking metric
``mrr_neg_edges``, against the JAX package or their contract: a
``torch.profiler`` trace written into a directory (nothing for None), the
throughput meter's smoothing on a fixed clock, the chained-delta timer,
``train_minibatch(profile_logdir=..., host_edges=...)``, and the mean
reciprocal rank, ties included."""

import json
import os
import time
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_minibatch import ET_BUYS, ET_CLICKS, _small_world

from gnn_recsys_tpu.retrieval.metrics import mrr_neg_edges as jmrr
from gnn_recsys_tpu.utils import profiling as jprof
from gnn_recsys_tpu_torch.retrieval.metrics import mrr_neg_edges
from gnn_recsys_tpu_torch.train import minibatch as tmb
from gnn_recsys_tpu_torch.utils import profiling, timing


def test_mrr_neg_edges_matches_jax():
    """Random scores, and ties, which rank against the positive."""
    rng = np.random.default_rng(0)
    pos = rng.normal(size=17).astype(np.float32)
    neg = rng.normal(size=(17, 9)).astype(np.float32)
    neg[:5, :3] = pos[:5, None]  # ties
    neg[5] = pos[5]  # a row of ties: rank 10
    got = mrr_neg_edges(torch.from_numpy(pos), torch.from_numpy(neg))
    want = float(jmrr(jnp.asarray(pos), jnp.asarray(neg)))
    assert got.shape == () and got.dtype == torch.float32
    assert float(got) == pytest.approx(want, rel=1e-6)
    assert float(mrr_neg_edges(torch.zeros(1), torch.zeros(1, 9))) == pytest.approx(0.1)


def test_profiler_trace_writes_a_trace(tmp_path):
    with profiling.profiler_trace(str(tmp_path / "trace")):
        torch.ones(64, 64) @ torch.ones(64, 64)
    files = os.listdir(tmp_path / "trace")
    assert len(files) == 1 and files[0].endswith(".json")
    with open(tmp_path / "trace" / files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
    with profiling.profiler_trace(None):  # no trace, no directory
        torch.ones(2) + 1
    with profiling.profiler_trace(""):
        pass
    assert os.listdir(tmp_path) == ["trace"]


def test_throughput_meter_matches_jax(monkeypatch):
    """Both meters on the same fixed clock: the rates, the smoothed rate
    and the mean."""
    ticks = [0.0, 0.5, 1.0, 1.25, 3.0, 4.0, 4.0, 4.0 + 1e-12]
    seq = {}
    for mod in (jprof, profiling):
        clock = iter(ticks)
        monkeypatch.setattr(mod, "time", types.SimpleNamespace(perf_counter=lambda: next(clock)))
        meter = mod.ThroughputMeter(alpha=0.3)
        rates = []
        for edges in (100, 50, 400, 7):
            meter.start()
            rates.append(meter.stop(edges))
        seq[mod] = (rates, meter.edges_per_s, meter.mean_edges_per_s, meter.total_edges)
    assert seq[jprof] == seq[profiling]
    assert seq[profiling][0][:2] == [200.0, 200.0]


def test_timing_hard_sync_and_chain():
    """``hard_sync`` sums the first tensor of an output (bools as ints, 0.0
    without one); ``chain_time_per_call`` gives the slope of chained runs,
    about the per-call time of a call that sleeps."""
    assert timing.hard_sync({"a": [torch.ones(3, dtype=torch.bool)], "b": 7}) == 3.0
    assert timing.hard_sync((None, "x")) == 0.0
    assert timing.hard_sync(torch.arange(4.0)) == 6.0

    def chain(n):
        x = torch.zeros(())
        for _ in range(n):
            time.sleep(0.01)
            x = x + 1
        return x

    per_call = timing.chain_time_per_call(None, chain, n1=1, n2=4, reps=2)
    assert 0.009 < per_call < 0.05


def test_train_minibatch_profile_logdir_and_host_edges(tmp_path):
    """``host_edges`` builds the false-negative pair sets from host copies
    (the same history as from the graph's own arrays; another history from
    empty copies, which mask nothing); ``profile_logdir`` writes one trace
    of the run."""
    data, g, model, feats = _small_world(30, 20)
    cfg = tmb.MinibatchConfig(edge_batch_size=64, fanouts=(2, 2), neg_sample_size=4,
                              neg_mode="shared_pool", neg_pool_size=16, num_epochs=2,
                              metrics_every=0)
    eids = {et: np.arange(g.num_edges(et)) for et in (ET_BUYS, ET_CLICKS)}
    host = {et: (g.rels[et].src.numpy().copy(), g.rels[et].dst.numpy().copy())
            for et in eids}
    empty = {et: (np.zeros(0, np.int32), np.zeros(0, np.int32)) for et in eids}
    hists = []
    for kw in ({}, {"host_edges": host, "profile_logdir": str(tmp_path)},
               {"host_edges": empty}):
        _, hist = tmb.train_minibatch(model, g, g, feats, eids, None, cfg, device="cpu", **kw)
        hists.append(hist["train_loss"])
    assert hists[0] == hists[1] != hists[2] and len(hists[0]) == 2
    assert len(os.listdir(tmp_path)) == 1
