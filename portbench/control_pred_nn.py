"""Readings that set the MLP head's cell's limits, made apart from the
benchmark's runs (``control.py`` does the same for the cosine cells).

    python3 portbench/control_pred_nn.py --workload train-medium-pred_nn-bf16
        --mode <sound|loss_altered|lowp|half_batch|state_unchanged> --seeds S [S ...]
        [--precision float8_e4m3fn|bfloat16]

For each seed it builds the cell's inputs as a run does and prints the
numbers that decide ``correct``:

* ``sound``: a run of the cell with a window of one chunk (the program's
  first steps against the reference, as every run compares them);
* ``loss_altered``: the same run with the program's loss times 1.02 (as
  ``portbench/tests/test_bench_faults.py:loss_altered``), which the cell's
  ``loss_gap`` limit has to catch;
* ``lowp``: the control, the head's reference in the program's place one
  precision below the configuration's (float8 e4m3 for bf16), or in
  ``--precision`` for a further reading;
* ``half_batch``: the reference with each step's loss over the first half
  of each edge type's positives only;
* ``state_unchanged``: the reference with no update applied, so the
  optimizer holds no gradient and the parameters do not move (reads 1 on
  both).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time
import types

sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

import torch  # noqa: E402

from portbench import control  # noqa: E402
from portbench.harness import core, program  # noqa: E402
from portbench.reference import model as ref  # noqa: E402
from portbench.reference import pred_nn as rpred  # noqa: E402


@contextlib.contextmanager
def loss_altered(factor: float = 1.02):
    """The program's loss times ``factor`` while the block runs."""
    from gnn_recsys_tpu_torch.train import minibatch

    scored = minibatch.scored_loss
    minibatch.scored_loss = lambda *a, **k: scored(*a, **k) * factor
    try:
        yield
    finally:
        minibatch.scored_loss = scored


def training(cell: core.Cell, seed: int, mode: str, dev, precision=None) -> dict:
    drv = core.driver(cell)
    if mode in ("sound", "loss_altered"):
        args = types.SimpleNamespace(workload=cell.name, seed=seed, seconds=0.0, trace=0)
        with loss_altered() if mode == "loss_altered" else contextlib.nullcontext():
            outcome = drv.run(cell, args, dev, time.perf_counter())
        return {k: v for k, v, _ in outcome.checks}
    conf = cell.config
    inp = program.inputs(conf, seed)
    gd = inp["graph"]
    p0 = drv.weights(conf, inp, dev)
    rg, feats = program.reference_inputs(conf, gd, dev)
    es, n, etypes = drv.epoch_seed(seed, 0), cell.own["first_steps"], gd["train_etypes"]
    reference = rpred.run_steps(p0, rg, feats, etypes, es, conf["step"], n)
    low = precision or control.LOWER[conf["model"]["dtype"]]
    q = control.lower_rounding(low) if mode == "lowp" else ref.identity
    other = rpred.run_steps(p0, rg, feats, etypes, es, conf["step"], n, q=q,
                            half_batch=mode == "half_batch", frozen=mode == "state_unchanged")
    first = {"losses": other["losses"], "grads": other["first_grads"], "params": other["params"]}
    if mode == "state_unchanged":
        first["grads"] = {k: torch.zeros_like(v) for k, v in first["grads"].items()}
    return drv.compare(first, reference, p0)


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", default="train-medium-pred_nn-bf16")
    p.add_argument("--mode", required=True,
                   choices=("sound", "loss_altered", "lowp", "half_batch", "state_unchanged"))
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--device", default="cuda")
    p.add_argument("--precision", choices=("float8_e4m3fn", "bfloat16"),
                   help="lowp: this precision, not the one below the configuration's")
    args = p.parse_args(argv)
    cell = core.load_cell(args.workload)
    dev = torch.device(args.device)
    for seed in args.seeds:
        t0 = time.perf_counter()
        numbers = training(cell, seed, args.mode, dev, args.precision)
        print(json.dumps({"workload": cell.name, "mode": args.mode, "seed": seed,
                          "precision": args.precision, **numbers,
                          "seconds": time.perf_counter() - t0}), flush=True)
        program.free(dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
