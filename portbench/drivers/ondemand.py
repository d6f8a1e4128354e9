"""Serving traffic: on-demand requests from one client in a closed loop.

Set-up saves the seeded model and its graph as a run directory (the
port's ``save_run``) under the run's temporary directory and sends one
request of the smallest and one of the largest size.  Each request of the
window is ``inference_ondemand``: load the run, embed every node, rank the
catalog for the listed users, bought items removed.  The next request is
sent when the last one has answered, until ``--seconds`` have passed.  The
sizes are a fixed log-spaced list, shuffled by the seed, and each lists
users drawn from the seed.  Afterwards every answer of the window is
judged against the reference.  The traced run profiles ``traced_requests``
requests, with a host span around each layer the request calls.
"""

from __future__ import annotations

import os
import shutil
import statistics
import sys
import tempfile
import time
import traceback

import numpy as np
import torch

from portbench.counts import kernels as kc
from portbench.counts import model as counts
from portbench.harness import core, program
from portbench.harness import data as bdata
from portbench.harness.trace import spans, trace
from portbench.reference import serve as rserve


# The layers a request calls, as spans of the traced run.
SPANS = {"load_run": "serve.load_run", "ConvModel": "serve.build",
         "infer_embeddings": "serve.embed", "build_padded_pair_set": "serve.bought_table",
         "get_recs": "serve.rank"}


def sizes(traffic: dict, seed: int) -> list:
    n = traffic["size_classes"]
    lo, hi = np.log(traffic["users_min"]), np.log(traffic["users_max"])
    base = np.unique(np.rint(np.exp(np.linspace(lo, hi, n))).astype(int))
    rng = np.random.default_rng(bdata.sub_seed(seed, 4))
    return [int(s) for s in rng.permutation(np.resize(base, n))]


def run(cell: core.Cell, args, dev, t_start: float) -> core.Outcome:
    from gnn_recsys_tpu_torch import inference
    from gnn_recsys_tpu_torch.train.checkpoint import save_run

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    conf, traffic, own = cell.config, cell.traffic, cell.own
    if conf["model"]["dtype"] != "float32":
        raise ValueError("a run directory keeps no compute dtype: inference_ondemand serves "
                         "in float32, so the configuration has to say float32")
    inp = program.inputs(conf, args.seed)
    gd = inp["graph"]
    num_users, num_items = gd["num_nodes"]["user"], gd["num_nodes"]["item"]
    spec = program.spec(conf, gd)
    p0 = bdata.make_weights(spec, inp["weight_seed"], dev)
    run_dir = os.path.join(tempfile.gettempdir(), f"portbench_run_{cell.name}")
    shutil.rmtree(run_dir, ignore_errors=True)
    t_save = time.perf_counter()
    save_run(run_dir, {k: v.cpu() for k, v in p0.items()}, program.model_kwargs(conf, gd),
             graph=program.program_graph(conf, gd))
    os.sync()  # the run directory on disk before the window: no writeback inside it
    t_save = time.perf_counter() - t_save
    k = traffic["k"]
    order = sizes(traffic, args.seed)
    rng = np.random.default_rng(bdata.sub_seed(args.seed, 5))

    def request(n_users: int):
        users = rng.choice(num_users, n_users, replace=False).astype(np.int64)
        recs = inference.inference_ondemand(run_dir, users.tolist(), k=k,
                                            remove_already_bought=True,
                                            inference_mode="full_graph", use_popularity=False,
                                            device=dev)
        return users, torch.as_tensor([recs[int(u)] for u in users], dtype=torch.int64)

    for n in (min(order), max(order)):  # warm-up
        request(n)
    program.sync(dev)

    asked, answers, latencies, failed, tr = [], [], [], 0, None

    def timed(n_users: int) -> None:
        nonlocal failed
        t0 = time.perf_counter()
        try:
            users, served = request(n_users)
            program.sync(dev)
        except Exception:  # a request that fails is counted and judged missing
            traceback.print_exc(file=sys.stderr)
            failed += 1
            latencies.append(float("inf"))
            return
        latencies.append(time.perf_counter() - t0)
        asked.append(users)
        answers.append(served)

    setup_s = time.perf_counter() - t_start
    if args.trace:
        n_traced = own["traced_requests"]
        with spans(inference, SPANS):
            tr = trace(lambda: [timed(n) for n in order[1:1 + n_traced]],
                       lambda: timed(order[0]))
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
          f"latencies "
          f"{[round(x, 4) for x in latencies]}", file=sys.stderr)

    program.free(dev)
    rg, rfeats = program.reference_inputs(conf, gd, dev)
    n_conv = conf["model"]["n_layers"] - 1
    h = rserve.embeddings(p0, rg, rfeats, n_conv)
    gap = rserve.judge(h, rg, asked, answers, k)
    checks = [("rank_gap", gap, own["limits"]["rank_gap"])]

    q = statistics.quantiles(latencies, n=4) if len(latencies) > 1 else latencies * 3
    m, gconf = conf["model"], conf["graph"]
    buys_u = gd["schema"][rserve.BUYS][0]
    fetch = min(k + program.max_out_degree(buys_u, num_users), num_items)
    traced = [len(u) for u in asked[1:]] if args.trace else []
    context = {
        "kind": "serve",
        "request_flops": [counts.request(tuple(gd["schema"]), gd["num_nodes"], n_conv,
                                         gconf["feat_dim"], m["hidden_dim"], m["out_dim"], u)
                          for u in traced],
        "mips_calls": [kc.mips_topk(u, num_items, m["out_dim"], fetch) for u in traced],
        "peak_flops": kc.PEAK_F32_FLOPS}
    return core.Outcome(attempted=attempted, failed=failed,
                        values={"request_s.p50": q[1], "request_s.p75": q[2],
                                "setup_s": setup_s},
                        checks=checks, memory_peak_bytes=peak, context=context, trace=tr)
