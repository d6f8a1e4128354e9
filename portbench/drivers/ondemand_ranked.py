"""Serving traffic ranked by the run's own predictor: on-demand requests from
one client in a closed loop, as ``ondemand.py`` sends them, for a run that
ranks with the cosine (``pred='cos'``) or the MLP head (``pred='nn'``),
optionally boosted by popularity, for listed users or for every user.

``ondemand.py`` is this driver's special case (cosine, no boost, listed
users); the two differ in what the traffic may ask and in the reference
that judges the answers (``reference/serve_ranked.py``).  The traffic
gives ``users`` ``"all"`` (each request ``user_ids='all'``) or
``ondemand.py``'s size classes, ``k``, and ``weight_popularity`` (absent:
no boost).

Set-up saves the seeded model and its graph as a run directory (the
head's weights as ``reference/pred_nn.py:head_init`` makes them), with each
item's share of the graph's purchases as ``ndata['item']['popularity']``
where the traffic boosts (``data/etl.py``'s formula, every purchase in
its window: the graph has no dates), and sends one request of the smallest
and one of the largest size (one ``'all'`` request).  Each request of the window is ``inference_ondemand``: load
the run, embed every node, rank the catalog, bought items removed.
Afterwards every row of every answer is judged against the reference.

The traced run profiles ``traced_requests`` requests after a one-user one,
inside ``ondemand.py``'s host spans, and puts in the context the device
time and count of the operations that the program's ``gnn.pred.rank``
spans launched (``harness/trace_ops.py``) and the pairs that its
``make_mlp_score_fn.pairs`` counter counted; a program without the span or
the counter gives None there.  A boosted cosine run's context also holds
the least work of the two MIPS passes of each traced request
(``counts/serve_ranked.py:boost_passes``).
"""

from __future__ import annotations

import heapq
import os
import shutil
import statistics
import sys
import tempfile
import time
import traceback
from pathlib import Path

import numpy as np
import torch

from portbench.counts import kernels as kc
from portbench.counts import serve_ranked as counts
from portbench.harness import core, program
from portbench.harness import data as bdata
from portbench.harness.trace import WINDOW, Trace, parse, spans
from portbench.harness.trace_ops import profile_events, span_ops
from portbench.reference import pred_nn as rpred
from portbench.reference import serve as rserve
from portbench.reference import serve_ranked as ranked

base = core.load_module(Path(__file__).with_name("ondemand.py"), "portbench_driver_ondemand")
SPANS, sizes = base.SPANS, base.sizes

SPAN = "gnn.pred.rank"


def weights(conf: dict, inp: dict, dev) -> dict:
    """The run's seeded parameters; an ``nn`` run's head initialised as the
    reference's."""
    m, g, gd = conf["model"], conf["graph"], inp["graph"]
    if m["pred"] != "nn":
        return bdata.make_weights(program.spec(conf, gd), inp["weight_seed"], dev)
    if m["aggregator_type"] != "mean_nn":
        raise ValueError("the MLP head's reference runs on mean_nn")
    spec = rpred.param_spec(tuple(gd["schema"]), {nt: g["feat_dim"] for nt in gd["num_nodes"]},
                            m["hidden_dim"], m["out_dim"], m["n_layers"])
    return rpred.head_init(bdata.make_weights(spec, inp["weight_seed"], dev))


def with_popularity(gd: dict) -> dict:
    """``gd`` with each item's share of the purchases as ``ndata['item']
    ['popularity']``, shape [I, 1] float32."""
    n = np.bincount(gd["schema"][rserve.BUYS][1], minlength=gd["num_nodes"]["item"])
    ndata = {nt: dict(d) for nt, d in gd["ndata"].items()}
    ndata["item"]["popularity"] = (n / n.sum()).astype(np.float32)[:, None]
    return dict(gd, ndata=ndata)


def pairs_counter():
    """The program's head scorer where it counts the pairs it scores, else
    None."""
    from gnn_recsys_tpu_torch.retrieval import recs

    return recs.make_mlp_score_fn if hasattr(recs.make_mlp_score_fn, "pairs") else None


class Window(Trace):
    """``harness/trace.py``'s trace of a window, its idle gaps labelled in
    one sweep over the host events: the labels of ``Trace.idle_gaps``,
    whose scan of every host event for each gap does not end on an
    ``'all'`` request of the MLP head (about 4 x 10^5 gaps, 3 x 10^6 host
    events)."""

    def idle_gaps(self):
        gaps, end = [], 0.0
        for s, e, _ in sorted(self.device):
            if s > end:
                gaps.append((end, s))
            end = max(end, e)
        if end < self.window_s:
            gaps.append((end, self.window_s))
        host, live, i = sorted(self.host), [], 0
        out = {}
        for a, b in gaps:  # in order, so each middle lies past the last
            mid = (a + b) / 2
            while i < len(host) and host[i][0] <= mid:
                s, e, n = host[i]
                heapq.heappush(live, (e - s, n, e))
                i += 1
            while live and live[0][2] < mid:  # ended before this middle
                heapq.heappop(live)
            label = live[0][1] if live else "host untraced"
            out[label] = out.get(label, 0.0) + (b - a)
        return out


def profiled(warm, run, dev):
    """``warm()``, then ``run()`` inside the harness's window annotation,
    under one profiler: the window's trace (``harness/trace.py:parse``) and
    the operations that the head's spans launched in it."""
    from torch.profiler import record_function

    def body():
        warm()
        program.sync(dev)
        with record_function(WINDOW):
            run()
            program.sync(dev)

    t_prof = time.perf_counter()
    events = profile_events(body)
    t_read = time.perf_counter()
    win = next(e for e in events if e.get("ph") == "X" and e.get("name") == WINDOW
               and e.get("cat") == "user_annotation")
    t0, t1 = float(win["ts"]), float(win["ts"]) + float(win["dur"])
    inside = [e for e in events if t0 <= float(e.get("ts", -1)) <= t1]
    kernels = sum(1 for e in inside if e.get("cat") == "kernel")
    tr = parse(events)
    head = span_ops(inside, SPAN)
    print(f"portbench: traced {len(events)} events, {len(inside)} in the window, "
          f"{kernels} kernel records; profiled {t_read - t_prof:.3f} s, read "
          f"{time.perf_counter() - t_read:.3f} s", file=sys.stderr)
    return Window(tr.window_s, tr.device, tr.host), head


def run(cell: core.Cell, args, dev, t_start: float) -> core.Outcome:
    from gnn_recsys_tpu_torch import inference
    from gnn_recsys_tpu_torch.train.checkpoint import save_run

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    conf, traffic, own = cell.config, cell.traffic, cell.own
    m = conf["model"]
    if m["dtype"] != "float32":
        raise ValueError("a run directory keeps no compute dtype: inference_ondemand serves "
                         "in float32, so the configuration has to say float32")
    boost = traffic.get("weight_popularity")
    inp = program.inputs(conf, args.seed)
    gd = inp["graph"]
    num_users, num_items = gd["num_nodes"]["user"], gd["num_nodes"]["item"]
    p0 = weights(conf, inp, dev)
    run_dir = tempfile.mkdtemp(prefix=f"portbench_run_{cell.name}_")
    t_save = time.perf_counter()
    saved = with_popularity(gd) if boost is not None else gd
    save_run(run_dir, {k: v.cpu() for k, v in p0.items()}, program.model_kwargs(conf, gd),
             graph=program.program_graph(conf, saved))
    os.sync()  # the run directory on disk before the window: no writeback inside it
    t_save = time.perf_counter() - t_save
    k = traffic["k"]
    every = traffic.get("users") == "all"
    order = [num_users] if every else sizes(traffic, args.seed)
    rng = np.random.default_rng(bdata.sub_seed(args.seed, 5))

    def request(n_users: int):
        """The users asked for and the served lists; the time of the
        request alone."""
        if every and n_users == num_users:
            users, asked = np.arange(num_users, dtype=np.int64), "all"
        else:
            users = rng.choice(num_users, n_users, replace=False).astype(np.int64)
            asked = users.tolist()
        t0 = time.perf_counter()
        recs = inference.inference_ondemand(
            run_dir, asked, k=k, remove_already_bought=True, inference_mode="full_graph",
            use_popularity=boost is not None, weight_popularity=boost or 0.0, device=dev)
        program.sync(dev)
        seconds = time.perf_counter() - t0
        return users, torch.as_tensor(np.array([recs[int(u)] for u in users], dtype=np.int64)
                                      .reshape(len(users), k)), seconds

    for n in sorted({min(order), max(order)}):  # warm-up
        request(n)
    program.sync(dev)

    asked, answers, latencies, failed = [], [], [], 0

    def timed(n_users: int) -> None:
        nonlocal failed
        try:
            users, served, seconds = request(n_users)
        except Exception:  # a request that fails is counted and judged missing
            traceback.print_exc(file=sys.stderr)
            failed += 1
            latencies.append(float("inf"))
            return
        latencies.append(seconds)
        asked.append(users)
        answers.append(served)

    setup_s = time.perf_counter() - t_start
    tr, head, traced = None, None, []
    counter = pairs_counter()
    if args.trace:
        traced = order[:own["traced_requests"]] if every else order[1:1 + own["traced_requests"]]

        def window() -> None:
            if counter is not None:
                counter.pairs = 0
            for n in traced:
                timed(n)

        with spans(inference, SPANS):
            tr, ops = profiled(lambda: request(1), window, dev)
        pairs = counter.pairs if counter is not None else None
        n = len(traced)
        head = {"spans": ops.spans, "requests": n, "ms_per_request": 1e3 * ops.fwd_s / n,
                "ops_per_request": ops.fwd_ops / n, "users": sum(traced),
                "items": n * num_items, "out": m["out_dim"],
                "pairs_per_request": pairs / n if pairs is not None else None,
                "pairs": pairs}
        print(f"portbench: head in the traced requests {head}", file=sys.stderr)
    else:
        deadline = time.perf_counter() + args.seconds
        i = 0
        while time.perf_counter() < deadline:
            timed(order[i % len(order)])
            i += 1
    attempted = len(latencies)
    peak = program.peak_bytes(dev)
    shutil.rmtree(run_dir, ignore_errors=True)
    print(f"portbench: {attempted} requests, set-up {setup_s:.3f} s (save_run {t_save:.3f} s), "
          f"latencies {[round(x, 4) for x in latencies]}", file=sys.stderr)

    program.free(dev)
    rg, rfeats = program.reference_inputs(conf, gd, dev)
    t_judge = time.perf_counter()
    h = rserve.embeddings(p0, rg, rfeats, m["n_layers"] - 1)
    pop = ranked.popularity(rg) if boost is not None else None
    score = ranked.scorer(p0, h, m["pred"], pop, boost or 0.0)
    gap = ranked.judge(score, rg, asked, answers, k)
    print(f"portbench: judged {sum(len(u) for u in asked)} lists in "
          f"{time.perf_counter() - t_judge:.3f} s", file=sys.stderr)
    checks = [("rank_gap", gap, own["limits"]["rank_gap"])]

    q = statistics.quantiles(latencies, n=4) if len(latencies) > 1 else latencies * 3
    fetch = min(k + program.max_out_degree(gd["schema"][rserve.BUYS][0], num_users), num_items)
    boosted = boost is not None and m["pred"] == "cos"  # the MIPS kernels' two passes
    context = {
        "kind": "serve",
        "request_flops": [counts.request(tuple(gd["schema"]), gd["num_nodes"], m["n_layers"] - 1,
                                         conf["graph"]["feat_dim"], m["hidden_dim"],
                                         m["out_dim"], u, m["pred"]) for u in traced],
        "boost_calls": [c for u in traced if boosted
                        for c in counts.boost_passes(u, num_items, m["out_dim"], fetch)],
        "peak_flops": kc.PEAK_F32_FLOPS,
        "pred_rank": head}
    return core.Outcome(attempted=attempted, failed=failed,
                        values={"request_s.p50": q[1], "request_s.p75": q[2],
                                "setup_s": setup_s},
                        checks=checks, memory_peak_bytes=peak, context=context, trace=tr)
