"""Readings that set the limits of the cells served by
``drivers/ondemand_ranked.py`` (``serve-medium-pred_nn-all``,
``serve-medium-boosted``), made apart from the benchmark's runs
(``control.py`` does the same for the other cells, and lends its
precisions).

    python3 portbench/control_ranked.py --workload <cell>
        --mode <lowp|cosine|unboosted> --seeds S [S ...] [--requests N]
        [--precision tf32|bfloat16|float8_e4m3fn]

For each seed it builds the cell's inputs as a run does, ranks them with
the reference changed as ``--mode`` says, at the cell's own size, and
prints the ``rank_gap`` that the cell's reference reads for those answers:

* ``lowp``: the control, the whole answer (embeddings, scores, top k) one
  precision below the configuration's (TF32 for float32), or in
  ``--precision`` for a further reading;
* ``cosine`` (a fault): the cosine ranking in place of the run's MLP head;
* ``unboosted`` (a fault): the ranking without the popularity boost.

``'all'`` traffic ranks every user once (every such answer is the same);
listed traffic ranks ``--requests`` requests of the cell's sizes.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from portbench import control  # noqa: E402
from portbench.harness import core, program  # noqa: E402
from portbench.harness import data as bdata  # noqa: E402
from portbench.reference import serve as rserve  # noqa: E402
from portbench.reference import serve_ranked as ranked  # noqa: E402

MODES = ("lowp", "cosine", "unboosted")


def serving(cell: core.Cell, seed: int, mode: str, dev, requests: int, precision=None) -> dict:
    drv = core.driver(cell)
    conf, traffic = cell.config, cell.traffic
    m = conf["model"]
    inp = program.inputs(conf, seed)
    gd = inp["graph"]
    p0 = drv.weights(conf, inp, dev)
    rg, feats = program.reference_inputs(conf, gd, dev)
    n_conv, k, boost = m["n_layers"] - 1, traffic["k"], traffic.get("weight_popularity")
    torch.backends.cuda.matmul.allow_tf32 = False
    h = rserve.embeddings(p0, rg, feats, n_conv)
    pop = ranked.popularity(rg) if boost is not None else None
    truth = ranked.scorer(p0, h, m["pred"], pop, boost or 0.0)
    if mode == "lowp":
        q = control.lower_rounding(precision or control.LOWER[m["dtype"]])
        h_low = rserve.embeddings(p0, rg, feats, n_conv, q=q)
        other = ranked.scorer(p0, h_low, m["pred"], pop, boost or 0.0, q)
    elif mode == "cosine":
        other = ranked.scorer(p0, h, "cos", pop, boost or 0.0)
    elif mode == "unboosted":
        other = ranked.scorer(p0, h, m["pred"])
    else:
        raise ValueError(f"serving has no mode {mode!r}")
    num_users = rg.num_nodes["user"]
    if traffic.get("users") == "all":
        asked = [np.arange(num_users, dtype=np.int64)]
    else:
        rng = np.random.default_rng(bdata.sub_seed(seed, 5))
        order = drv.sizes(traffic, seed)
        asked = [rng.choice(num_users, order[i % len(order)], replace=False)
                 for i in range(requests)]
    answers = [ranked.top_k(other, rg, torch.as_tensor(u, dtype=torch.int64, device=dev), k)
               for u in asked]
    torch.backends.cuda.matmul.allow_tf32 = False
    return {"rank_gap": ranked.judge(truth, rg, asked, answers, k)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--mode", required=True, choices=MODES)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--requests", type=int, default=45)
    p.add_argument("--device", default="cuda")
    p.add_argument("--precision", choices=("tf32", "bfloat16", "float8_e4m3fn"),
                   help="lowp: this precision, not the one below the configuration's")
    args = p.parse_args(argv)
    cell = core.load_cell(args.workload)
    dev = torch.device(args.device)
    for seed in args.seeds:
        t0 = time.perf_counter()
        numbers = serving(cell, seed, args.mode, dev, args.requests, args.precision)
        print(json.dumps({"workload": cell.name, "mode": args.mode, "seed": seed,
                          "precision": args.precision, **numbers,
                          "seconds": time.perf_counter() - t0}), flush=True)
        program.free(dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
