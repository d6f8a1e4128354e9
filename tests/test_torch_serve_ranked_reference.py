"""Serving ranked by the run's own predictor against the benchmark's plain
reference (``portbench/reference/serve_ranked.py``), in float32 on a tiny
graph with the benchmark's seeded weights: ``inference_ondemand`` on a
saved ``pred='nn'`` run (every user, and a listed subset) and on a saved
cosine run served with the popularity boost, each answer judged row by row
(``rank_gap``: how far below a user's k-th best allowed score a served item
lies).  Also the serving head's span and pair counter.  No JAX here.

``TOL`` is f32 summation order: the program factorises the head's first
Dense and the reference does not, and each embeds in its own order; the
gap read 0 at this size on every seed tried.  The head's own faults (the
cosine served for an ``nn`` run, the unboosted ranking for a boosted
request) read above 1e-4 here."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from gnn_recsys_tpu_torch.inference import inference_ondemand
from gnn_recsys_tpu_torch.ops.cuda.topk_mips import stable_topk
from gnn_recsys_tpu_torch.retrieval.recs import make_mlp_score_fn
from gnn_recsys_tpu_torch.train.checkpoint import save_run
from portbench.harness import core, program
from portbench.reference import model as rmodel
from portbench.reference import serve as rserve
from portbench.reference import serve_ranked as ranked

ROOT = Path(__file__).resolve().parents[1]
DRIVER = core.load_module(ROOT / "portbench" / "drivers" / "ondemand_ranked.py",
                          "portbench_driver_ondemand_ranked")
TOL = 1e-6
SEED = 2**31 + 23
K = 10
WEIGHT = 0.1
SPAN = "gnn.pred.rank"
USERS, ITEMS = 300, 100


@pytest.fixture(autouse=True)
def fresh_counter(monkeypatch):
    monkeypatch.setattr(make_mlp_score_fn, "pairs", 0)


@pytest.fixture(autouse=True)
def one_thread():
    held = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(held)


def tiny_config(name: str) -> dict:
    conf = json.loads((ROOT / "portbench" / "configs" / f"{name}.json").read_text())
    conf["graph"].update(num_users=USERS, num_items=ITEMS, num_groups=5,
                         interactions_per_user=4, max_fanout=8)
    conf["model"].update(hidden_dim=32, out_dim=16)
    return conf


class Run:
    """A tiny configuration's graph and seeded weights saved as a run
    directory, as the benchmark's driver saves them, and the reference's
    score of the same run."""

    def __init__(self, tmp_path, name: str, boost=None, seed: int = SEED):
        self.conf = conf = tiny_config(name)
        inp = program.inputs(conf, seed)
        self.gd = gd = inp["graph"]
        self.p0 = DRIVER.weights(conf, inp, "cpu")
        saved = DRIVER.with_popularity(gd) if boost is not None else gd
        self.dir = str(tmp_path / "run")
        save_run(self.dir, dict(self.p0), program.model_kwargs(conf, gd),
                 graph=program.program_graph(conf, saved))
        self.boost = boost
        self.rg, feats = program.reference_inputs(conf, gd, "cpu")
        h = rserve.embeddings(self.p0, self.rg, feats, conf["model"]["n_layers"] - 1)
        pop = ranked.popularity(self.rg) if boost is not None else None
        self.score = ranked.scorer(self.p0, h, conf["model"]["pred"], pop, boost or 0.0)
        self.h = h

    def serve(self, users):
        recs = inference_ondemand(self.dir, users, k=K, remove_already_bought=True,
                                  inference_mode="full_graph",
                                  use_popularity=self.boost is not None,
                                  weight_popularity=self.boost or 0.0, device="cpu")
        ids = np.arange(USERS) if isinstance(users, str) else np.asarray(users)
        return ids, torch.as_tensor(np.array([recs[int(u)] for u in ids]), dtype=torch.int64)

    def gap(self, asked, answers, score=None) -> float:
        return ranked.judge(score or self.score, self.rg, asked, answers, K)


def listed(n: int = 57) -> list:
    return np.random.default_rng(4).choice(USERS, n, replace=False).tolist()


@pytest.mark.parametrize("users", ("all", "listed"))
def test_nn_run_meets_the_reference(tmp_path, users):
    run = Run(tmp_path, "medium-pred_nn-f32")
    ids, served = run.serve("all" if users == "all" else listed())
    assert served.shape == (len(ids), K)
    assert run.gap([ids], [served]) <= TOL


@pytest.mark.parametrize("users", ("all", "listed"))
def test_boosted_cosine_run_meets_the_reference(tmp_path, users):
    run = Run(tmp_path, "medium-mean_nn-f32", boost=WEIGHT)
    ids, served = run.serve("all" if users == "all" else listed())
    assert run.gap([ids], [served]) <= TOL


def test_unboosted_cosine_run_meets_the_ranked_reference(tmp_path):
    """Without the boost the ranked reference is the cosine one of
    ``reference/serve.py``."""
    run = Run(tmp_path, "medium-mean_nn-f32")
    ids, served = run.serve(listed())
    assert run.gap([ids], [served]) <= TOL
    keys = rmodel.pair_keys(run.rg.src[rserve.BUYS], run.rg.dst[rserve.BUYS], ITEMS)
    assert rserve.judge(run.h, run.rg, [ids], [served], K) <= TOL
    u = torch.as_tensor(ids)
    assert torch.equal(ranked.allowed(run.score(u), run.rg, u, keys),
                       rserve.allowed_scores(run.h, run.rg, u, keys))


@pytest.mark.parametrize("name,boost,other", (("medium-pred_nn-f32", None, "cos"),
                                              ("medium-mean_nn-f32", WEIGHT, None)),
                         ids=("cosine for nn", "unboosted for boosted"))
def test_the_other_ranking_misses_the_tolerance(tmp_path, name, boost, other):
    run = Run(tmp_path, name, boost=boost)
    ids, served = run.serve("all")
    wrong = ranked.scorer(run.p0, run.h, other or "cos")
    answer = ranked.top_k(wrong, run.rg, torch.as_tensor(ids), K)
    assert run.gap([ids], [answer]) > 100 * TOL
    assert run.gap([ids], [served]) <= TOL


def test_judge_holds_every_answer_of_a_repeated_request(tmp_path):
    """Answers to the same users share the reference's scores; a fault in
    the second answer's last row still shows."""
    run = Run(tmp_path, "medium-pred_nn-f32")
    ids, served = run.serve("all")
    bad = served.clone()
    bad[-1, -1] = ranked.top_k(run.score, run.rg, torch.as_tensor(ids[-1:]), K + 1)[0, K]
    assert run.gap([ids, ids], [served, served]) <= TOL
    assert run.gap([ids, ids], [served, bad]) > TOL


def test_popularity_is_each_items_share_of_the_purchases():
    conf = tiny_config("medium-mean_nn-f32")
    gd = program.inputs(conf, SEED)["graph"]
    pop = DRIVER.with_popularity(gd)["ndata"]["item"]["popularity"]
    assert pop.shape == (ITEMS, 1) and pop.dtype == np.float32
    items = gd["schema"][rserve.BUYS][1]
    assert pop[items[0], 0] == pytest.approx(float((items == items[0]).sum()) / len(items))
    assert float(pop.sum()) == pytest.approx(1.0, rel=1e-6)
    rg, _ = program.reference_inputs(conf, gd, "cpu")
    np.testing.assert_array_equal(ranked.popularity(rg).numpy(), pop[:, 0])
    assert "popularity" not in gd["ndata"]["item"]


@pytest.mark.parametrize("users", ("all", "listed"))
def test_pairs_counter_counts_users_times_items(tmp_path, users):
    run = Run(tmp_path, "medium-pred_nn-f32")
    ids, _ = run.serve("all" if users == "all" else listed())
    assert make_mlp_score_fn.pairs == len(ids) * ITEMS


def test_rank_span_once_a_user_chunk(tmp_path):
    """Every user of the run in chunks of 128: three ``gnn.pred.rank``
    spans, each inside the request's ``gnn.serve.rank``."""
    run = Run(tmp_path, "medium-pred_nn-f32")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run.serve("all")
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    spans = [e for e in events if e.get("name") == SPAN]
    assert {e["cat"] for e in spans} == {"user_annotation"}
    assert len(spans) == -(-USERS // 128)
    rank = [e for e in events if e.get("name") == "gnn.serve.rank"]
    assert len(rank) == 1
    lo, hi = rank[0]["ts"], rank[0]["ts"] + rank[0]["dur"]
    assert all(lo <= e["ts"] and e["ts"] + e["dur"] <= hi for e in spans)
    assert make_mlp_score_fn.pairs == USERS * ITEMS


def test_cosine_run_opens_no_rank_span(tmp_path):
    run = Run(tmp_path, "medium-mean_nn-f32", boost=WEIGHT)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run.serve(listed())
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    assert not [e for e in events if e.get("name") == SPAN]
    assert make_mlp_score_fn.pairs == 0


@pytest.mark.parametrize("k", (1, 10, ITEMS))
def test_stable_topk_keeps_no_whole_sort(k):
    """Each chunk's top k owns only its ``[rows, k]`` entries, so ranking
    every user holds k ids a user, not the chunk's whole sort."""
    scores = torch.randn(7, ITEMS, generator=torch.Generator().manual_seed(0))
    vals, idx = stable_topk(scores, k)
    assert vals.untyped_storage().nbytes() == 7 * k * 4
    assert idx.untyped_storage().nbytes() == 7 * k * 8
    want = torch.sort(scores, dim=1, descending=True, stable=True)
    assert torch.equal(vals, want.values[:, :k]) and torch.equal(idx, want.indices[:, :k])
