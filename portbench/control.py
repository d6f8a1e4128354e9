"""Readings that set a cell's limits, made apart from the benchmark's runs.

    python3 portbench/control.py --workload <cell> --mode <lowp|half_batch|state_unchanged>
        --seeds S [S ...] [--precision tf32|bfloat16|float8_e4m3fn]

For each seed it builds the cell's inputs as a run does and puts the
reference, changed as ``--mode`` says, in the program's place, at the
cell's own size, and prints the numbers that decide ``correct``:

* ``lowp``: the control, the reference in the precision just below the
  configuration's (float8 e4m3 for bf16; TF32 for float32), or in
  ``--precision`` for a further reading;
* ``half_batch`` (training): each step's loss over the first half of each
  edge type's positives only;
* ``state_unchanged`` (training): no update applied, so the optimizer
  holds no gradient and the parameters do not move (reads 1 on both).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

import torch  # noqa: E402

from portbench.harness import core, program  # noqa: E402
from portbench.harness import data as bdata  # noqa: E402
from portbench.reference import model as ref  # noqa: E402
from portbench.reference import serve as rserve  # noqa: E402
from portbench.reference import train as rtrain  # noqa: E402

LOWER = {"bfloat16": "float8_e4m3fn", "float32": "tf32"}


def to_bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(x.dtype)


def lower_rounding(precision: str):
    """``q`` for the reference in ``precision``; TF32 is switched on for
    the matmuls until the caller switches it off."""
    torch.backends.cuda.matmul.allow_tf32 = precision == "tf32"
    if precision == "tf32":
        return ref.identity
    if precision == "bfloat16":
        return to_bf16
    return ref.rounding(getattr(torch, precision))


def training(cell: core.Cell, seed: int, mode: str, dev, precision=None) -> dict:
    drv = core.driver(cell)
    conf = cell.config
    inp = program.inputs(conf, seed)
    gd = inp["graph"]
    p0 = bdata.make_weights(program.spec(conf, gd), inp["weight_seed"], dev)
    rg, feats = program.reference_inputs(conf, gd, dev)
    es = drv.epoch_seed(seed, 0)
    n = cell.own["first_steps"]
    torch.backends.cuda.matmul.allow_tf32 = False
    same = dict(dedup=conf["step"]["dedup"], model=conf["model"],
                dropout_seed=drv.dropout_seed(seed))
    reference = rtrain.run_steps(p0, rg, feats, gd["train_etypes"], es, conf["step"], n, **same)
    low = precision or LOWER[conf["model"]["dtype"]]
    q = lower_rounding(low) if mode == "lowp" else ref.identity
    other = rtrain.run_steps(p0, rg, feats, gd["train_etypes"], es, conf["step"], n, q=q,
                             half_batch=mode == "half_batch", frozen=mode == "state_unchanged",
                             **same)
    torch.backends.cuda.matmul.allow_tf32 = False
    first = {"losses": other["losses"], "grads": other["first_grads"], "params": other["params"]}
    if mode == "state_unchanged":
        first["grads"] = {k: torch.zeros_like(v) for k, v in first["grads"].items()}
    return drv.compare(first, reference, p0)


def serving(cell: core.Cell, seed: int, mode: str, dev, requests: int, precision=None) -> dict:
    if mode != "lowp":
        raise ValueError(f"serving has no mode {mode!r}")
    drv = core.driver(cell)
    conf = cell.config
    inp = program.inputs(conf, seed)
    gd = inp["graph"]
    p0 = bdata.make_weights(program.spec(conf, gd), inp["weight_seed"], dev)
    rg, feats = program.reference_inputs(conf, gd, dev)
    n_conv = conf["model"]["n_layers"] - 1
    k = cell.traffic["k"]
    torch.backends.cuda.matmul.allow_tf32 = False
    h = rserve.embeddings(p0, rg, feats, n_conv)
    # The whole answer in the lower precision: embeddings, scores, top k.
    q = lower_rounding(precision or LOWER[conf["model"]["dtype"]])
    h_low = rserve.embeddings(p0, rg, feats, n_conv, q=q)
    keys = ref.pair_keys(rg.src[rserve.BUYS], rg.dst[rserve.BUYS], rg.num_nodes["item"])
    rng = __import__("numpy").random.default_rng(bdata.sub_seed(seed, 5))
    order = drv.sizes(cell.traffic, seed)
    asked, answers = [], []
    for i in range(requests):
        users = rng.choice(rg.num_nodes["user"], order[i % len(order)], replace=False)
        u = torch.as_tensor(users, dtype=torch.int64, device=dev)
        asked.append(users)
        answers.append(rserve.top_k(rserve.allowed_scores(h_low, rg, u, keys, q), k))
    torch.backends.cuda.matmul.allow_tf32 = False
    return {"rank_gap": rserve.judge(h, rg, asked, answers, k)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--mode", required=True, choices=("lowp", "half_batch", "state_unchanged"))
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--requests", type=int, default=45)
    p.add_argument("--device", default="cuda")
    p.add_argument("--precision", choices=("tf32", "bfloat16", "float8_e4m3fn"),
                   help="lowp: this precision, not the one below the configuration's")
    args = p.parse_args(argv)
    cell = core.load_cell(args.workload)
    dev = torch.device(args.device)
    for seed in args.seeds:
        if cell.traffic["driver"] == "ondemand":
            numbers = serving(cell, seed, args.mode, dev, args.requests, args.precision)
        else:
            numbers = training(cell, seed, args.mode, dev, args.precision)
        print(json.dumps({"workload": cell.name, "mode": args.mode, "seed": seed,
                          "precision": args.precision, **numbers}),
              flush=True)
        program.free(dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
