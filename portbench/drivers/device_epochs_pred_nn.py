"""Training traffic of the MLP head's configuration (``pred='nn'``): the
port's device epochs, epoch after epoch, as ``device_epochs.py`` runs them
(the same set-up, first steps, window and comparison), with the head's
plain reference (``reference/pred_nn.py``) and its least work
(``counts/pred_nn.py``).

The weights are drawn as for every cell, then the head is initialised as
the reference initialises it (``reference/pred_nn.py:head_init``).  The
traced run profiles ``traced_steps`` replays in place of the window, then
``eager_steps`` eager steps of the same step (``make_epoch_fns(...,
capture=False)``, after one unprofiled), and puts in the context, a step at
a time, the device time and count of the operations that the program's
``gnn.pred.score`` spans launched, forward and backward
(``harness/trace_ops.py``), the pairs that the head's ``pairs`` counter
counted, and the device time of all the eager steps' operations; a program
without the span or the counter gives None there.
Afterwards the program is freed and the reference follows the first steps.
"""

from __future__ import annotations

import statistics
import sys
import time
from pathlib import Path

import numpy as np
import torch

from portbench.counts import pred_nn as counts
from portbench.harness import core, program
from portbench.harness import data as bdata
from portbench.harness.trace import DEVICE_CATS, trace
from portbench.harness.trace_ops import profile_events, span_ops
from portbench.reference import pred_nn as ref
from portbench.reference.model import reverse
from portbench.reference.train import slice_widths

base = core.load_module(Path(__file__).with_name("device_epochs.py"),
                        "portbench_driver_device_epochs")
epoch_seed, dropout_seed, ADAM_B1 = base.epoch_seed, base.dropout_seed, base.ADAM_B1

SPAN = "gnn.pred.score"
NUMBERS = ("loss_gap", "grad_gap", "update_gap", "grad_dist")


def compare(first: dict, reference: dict, p0: dict) -> dict:
    """``device_epochs.py``'s three numbers, and ``grad_dist``: the worst
    leaf's distance between the program's and the reference's first
    gradients, over the reference's norm of that leaf or of the median
    leaf, whichever is larger.  Norms alone miss half a batch here: bf16
    moves each leaf's norm by up to 5% (the head's gradient is a difference
    of near-equal sums over the pool), and half a batch's gradient has
    nearly the whole batch's norm, pointing elsewhere."""
    numbers = base.compare(first, reference, p0)
    prog, refv = first["grads"], reference["first_grads"]
    rn = {k: float(refv[k].double().norm()) for k in refv}
    med = statistics.median(rn.values())
    numbers["grad_dist"] = max(float((prog[k].double() - refv[k].double()).norm())
                               / max(rn[k], med, 1e-30) for k in refv)
    return numbers


def spec(conf: dict, gd: dict) -> dict:
    m, g = conf["model"], conf["graph"]
    if m["pred"] != "nn" or m["aggregator_type"] != "mean_nn" or m["dropout"]:
        raise ValueError("this driver runs the MLP head on mean_nn without dropout")
    return ref.param_spec(tuple(gd["schema"]), {nt: g["feat_dim"] for nt in gd["num_nodes"]},
                          m["hidden_dim"], m["out_dim"], m["n_layers"])


def weights(conf: dict, inp: dict, dev) -> dict:
    """The run's seeded parameters, the head initialised as the reference's."""
    return ref.head_init(bdata.make_weights(spec(conf, inp["graph"]), inp["weight_seed"], dev))


def pairs_counter():
    """The program's head class where it counts the pairs it scores, else
    None."""
    from gnn_recsys_tpu_torch.models.layers import PredictingLayer

    return PredictingLayer if hasattr(PredictingLayer, "pairs") else None


def eager_profile(step, n: int, dev) -> dict:
    """``step()`` once, then ``n`` times under the profiler: the head's
    device ms and operations a step, forward and backward, its pairs a step
    (None without the counter), and the device ms a step of every operation
    of the same eager steps, against which the head's share is read."""
    step()
    program.sync(dev)
    counter = pairs_counter()
    if counter is not None:
        counter.pairs = 0
    events = profile_events(lambda: [step() for _ in range(n)])
    ops = span_ops(events, SPAN)
    device_s = sum(float(e["dur"]) / 1e6 for e in events
                   if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS and "dur" in e)
    out = {"spans_per_step": ops.spans / n,
           "fwd_ms_per_step": 1e3 * ops.fwd_s / n, "bwd_ms_per_step": 1e3 * ops.bwd_s / n,
           "fwd_ops_per_step": ops.fwd_ops / n, "bwd_ops_per_step": ops.bwd_ops / n,
           "pairs_per_step": counter.pairs / n if counter is not None else None,
           "step_device_ms_per_step": 1e3 * device_s / n}
    print(f"portbench: eager head profile {out}", file=sys.stderr)
    return out


def run(cell: core.Cell, args, dev, t_start: float) -> core.Outcome:
    from gnn_recsys_tpu_torch.ops.cuda import build
    from gnn_recsys_tpu_torch.ops.membership import build_padded_pair_set
    from gnn_recsys_tpu_torch.ops.sampling import Draws
    from gnn_recsys_tpu_torch.train.full_batch import TrainState
    from gnn_recsys_tpu_torch.train.minibatch import (MinibatchConfig, device_edge_store,
                                                      make_epoch_fns)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    conf, own = cell.config, cell.own
    st = conf["step"]
    inp = program.inputs(conf, args.seed)
    gd = inp["graph"]
    etypes = gd["train_etypes"]

    g = program.program_graph(conf, gd).to(dev)
    feats = {nt: g.ndata[nt]["features"] for nt in g.ntypes}
    p0 = weights(conf, inp, dev)
    model = program.program_model(conf, gd, p0, dev)
    state = TrainState.create(model, lr=st["lr"])
    mcfg = MinibatchConfig(
        edge_batch_size=st["edge_batch_size"], fanouts=tuple(st["fanouts"]),
        neg_mode=st["neg_mode"], neg_pool_size=st["neg_pool_size"],
        neg_sample_size=st["neg_sample_size"], pool_mask_kernel=st["pool_mask_kernel"],
        delta=st["delta"], lr=st["lr"], exclude_batch_edges=st["exclude_batch_edges"],
        remove_false_negative=st["remove_false_negative"], dedup=st["dedup"],
        epoch_chunk_steps=st["epoch_chunk_steps"], device_epoch=True)
    num_users = gd["num_nodes"]["user"]
    tables = {et: build_padded_pair_set(*gd["schema"][et], num_src=num_users).to(dev)
              for et in etypes}
    counts_by_et = {et: len(gd["schema"][et][0]) for et in etypes}
    widths, n_batches = slice_widths(counts_by_et, st["edge_batch_size"])
    width = sum(widths.values())
    eids = {et: torch.arange(n, device=dev) for et, n in counts_by_et.items()}
    store = device_edge_store(g, etypes, dev)
    has_reverse = {et: reverse(et) in g.rels for et in etypes}
    fn_args = (model, mcfg, etypes, True, mcfg.exclude_batch_edges, has_reverse, counts_by_et)
    perm_fn, chunk_fn = make_epoch_fns(*fn_args)
    gen = torch.Generator(device=dev)
    draws = Draws(gen)

    def epoch_start(epoch: int):
        gen.manual_seed(epoch_seed(args.seed, epoch))
        return perm_fn(eids, gen)

    def steps(perms, t0: int, n: int) -> torch.Tensor:
        return chunk_fn(state, g, feats, tables, store, perms, t0, draws, n)[1]

    # The capture (on a CUDA device) before the epoch's generator is seeded,
    # then the first steps through the window's own call.
    t_capture = time.perf_counter()
    if dev.type == "cuda":
        steps(epoch_start(0), 0, 0)
    t_capture = time.perf_counter() - t_capture
    torch.manual_seed(dropout_seed(args.seed))
    perms = epoch_start(0)
    n_first = own["first_steps"]
    first_losses = [steps(perms, 0, 1)]
    program.sync(dev)
    named = dict(model.named_parameters())
    # No first moment: the optimizer got no gradient.
    grads = {k: (state.tx.state.get(p, {}).get("exp_avg", torch.zeros_like(p))
                 / (1 - ADAM_B1)).detach().clone() for k, p in named.items()}
    first_losses.append(steps(perms, 1, n_first - 1))
    program.sync(dev)
    first = {"losses": torch.cat(first_losses).tolist(), "grads": grads,
             "params": {k: p.detach().clone() for k, p in named.items()}}
    launched = {k: f.launches for k, f in build.launch_counters().items() if f.launches}
    counter = pairs_counter()
    print(f"portbench: kernel launches over set-up's steps {launched}; head pairs "
          f"{counter.pairs if counter is not None else None}", file=sys.stderr)
    t = n_first
    chunk = st["epoch_chunk_steps"]

    attempted, window_losses, tr, pred = 0, [], None, {}
    setup_s = time.perf_counter() - t_start
    if args.trace:
        warm = lambda: steps(perms, t, chunk)  # noqa: E731
        t_traced = own["traced_steps"]
        tr = trace(lambda: window_losses.append(steps(perms, t + chunk, t_traced)), warm)
        attempted = t_traced
        elapsed = tr.window_s
    else:
        epoch, pending, current = 0, [], []
        t0 = time.perf_counter()
        deadline = t0 + args.seconds
        while True:
            if t >= n_batches:  # the epoch's mean loss read on the host, a new epoch
                float(torch.cat(current).mean())
                epoch, t, current = epoch + 1, 0, []
                perms = epoch_start(epoch)
            n = min(chunk, n_batches - t)
            ls = steps(perms, t, n)
            current.append(ls)
            window_losses.append(ls)
            t += n
            attempted += n
            if dev.type == "cuda":  # the host runs at most two chunks ahead
                ev = torch.cuda.Event()
                ev.record()
                pending.append(ev)
                if len(pending) > 2:
                    pending.pop(0).synchronize()
            if time.perf_counter() >= deadline:
                break
        program.sync(dev)
        elapsed = time.perf_counter() - t0
    losses = torch.cat(window_losses) if window_losses else torch.zeros(0)
    failed = int((~torch.isfinite(losses)).sum())
    peak = program.peak_bytes(dev)
    if args.trace:  # the same step, eager, after the window
        eager_perm_fn, eager_chunk_fn = make_epoch_fns(*fn_args, capture=False)
        eager_gen = torch.Generator(device=dev).manual_seed(epoch_seed(args.seed, 1))
        eager_perms = eager_perm_fn(eids, eager_gen)
        pred = eager_profile(lambda: eager_chunk_fn(state, g, feats, tables, store, eager_perms,
                                                    0, Draws(eager_gen), 1),
                             own["eager_steps"], dev)
    print(f"portbench: {attempted} steps in {elapsed:.3f} s, set-up {setup_s:.3f} s (capture "
          f"{t_capture:.3f} s), first losses {first['losses']}", file=sys.stderr)

    del model, state, chunk_fn, perm_fn, store, tables, g, feats, losses, window_losses
    program.free(dev)
    rg, rfeats = program.reference_inputs(conf, gd, dev)
    reference = ref.run_steps(p0, rg, rfeats, etypes, epoch_seed(args.seed, 0), st, n_first)
    numbers = compare(first, reference, p0)
    limits = own["limits"]
    checks = [(k, numbers[k], limits[k]) for k in NUMBERS]

    m, gconf = conf["model"], conf["graph"]
    cost = counts.train_step(tuple(gd["schema"]), widths, st["neg_pool_size"], st["fanouts"],
                             gconf["feat_dim"], m["hidden_dim"], m["out_dim"], gd["num_nodes"])
    pool_rows = []
    for et in etypes:
        deg = np.bincount(gd["schema"][et][0], minlength=num_users)
        pool_rows.append((widths[et], -(-int(deg.max()) // 8) * 8, st["neg_pool_size"],
                          widths[et] * float(deg.mean())))
    context = {"kind": "train", "steps": attempted, "step_flops": cost["flops"],
               "leaf_calls": cost["leaves"] if m["leaf_kernel"] else [],
               "pool_calls": pool_rows if st["pool_mask_kernel"] else [], "gather_calls": [],
               "feat_dim": gconf["feat_dim"], "hidden": m["hidden_dim"], "out": m["out_dim"],
               "elem": 2 if m["dtype"] == "bfloat16" else 4, "dtype": m["dtype"], "pred": pred,
               "head_rows": counts.step_rows(widths, st["neg_pool_size"])}
    return core.Outcome(attempted=attempted, failed=failed,
                        values={"train_edges_per_s": attempted * width / elapsed,
                                "setup_s": setup_s},
                        checks=checks, memory_peak_bytes=peak, context=context, trace=tr)
