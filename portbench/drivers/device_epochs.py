"""Training traffic: the port's device epochs, epoch after epoch.

Set-up builds the graph and the seeded weights, the trainer's state and its
epoch functions (``train/minibatch.py:make_epoch_fns``), captures the step,
and runs the epoch's first ``first_steps`` steps through the same call as
the window; their losses, the first gradient (from Adam's first moment
after one step) and the parameters after the last are kept.  The window
continues that epoch and starts new ones as ``run_device_epoch`` does (the
generator seeded with the epoch's seed, the permutation, chunks of steps),
reading each epoch's mean loss on the host, until ``--seconds`` have
passed; it reports every positive edge trained over the window's seconds.
The traced run profiles ``traced_steps`` steps instead of the window.
Afterwards the program is freed and the reference follows the first steps.
"""

from __future__ import annotations

import statistics
import sys
import time

import numpy as np
import torch

from portbench.counts import model as counts
from portbench.harness import core, program
from portbench.harness import data as bdata
from portbench.harness.trace import trace
from portbench.reference import model as ref
from portbench.reference import train as rtrain

ADAM_B1 = 0.9


def epoch_seed(seed: int, epoch: int) -> int:
    return bdata.sub_seed(seed, 3, epoch)


def dropout_seed(seed: int) -> int:
    """The default generator's seed before the first step (dropout's masks)."""
    return bdata.sub_seed(seed, 6)


def norm_gap(prog: dict, refv: dict, names) -> float:
    """The worst leaf's gap between the program's and the reference's
    norms, over the reference's norm of that leaf or of the median leaf,
    whichever is larger."""
    rn = {k: float(refv[k].double().norm()) for k in names}
    med = statistics.median(rn.values())
    return max(abs(float(prog[k].double().norm()) - rn[k]) / max(rn[k], med, 1e-30)
               for k in names)


def compare(first: dict, reference: dict, p0: dict) -> dict:
    """The three numbers that decide ``correct``."""
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(first["losses"], reference["losses"]))
    names = list(reference["first_grads"])
    gnorm = {k: float(reference["first_grads"][k].double().norm()) for k in names}
    med = statistics.median(gnorm.values())
    moved = [k for k in names if gnorm[k] >= 1e-3 * med]
    d_prog = {k: first["params"][k] - p0[k] for k in moved}
    d_ref = {k: reference["params"][k] - p0[k] for k in moved}
    print(f"portbench: parameter change compared on {len(moved)} of {len(names)} leaves "
          f"(the rest had a reference gradient under 1e-3 of the median leaf's)", file=sys.stderr)
    return {"loss_gap": loss_gap,
            "grad_gap": norm_gap(first["grads"], reference["first_grads"], names),
            "update_gap": norm_gap(d_prog, d_ref, moved)}


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
    spec = program.spec(conf, gd)

    g = program.program_graph(conf, gd).to(dev)
    feats = {nt: g.ndata[nt]["features"] for nt in g.ntypes}
    p0 = bdata.make_weights(spec, inp["weight_seed"], dev)
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
    widths, n_batches = rtrain.slice_widths(counts_by_et, st["edge_batch_size"])
    width = sum(widths.values())
    eids = {et: torch.arange(n, device=dev) for et, n in counts_by_et.items()}
    store = device_edge_store(g, etypes, dev)
    has_reverse = {et: ref.reverse(et) in g.rels for et in etypes}
    perm_fn, chunk_fn = make_epoch_fns(model, mcfg, etypes, True, mcfg.exclude_batch_edges,
                                       has_reverse, counts_by_et)
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
    print(f"portbench: kernel launches over set-up's steps {launched}", file=sys.stderr)
    t = n_first
    chunk = st["epoch_chunk_steps"]

    attempted, window_losses, tr = 0, [], None
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
    print(f"portbench: {attempted} steps in {elapsed:.3f} s, set-up {setup_s:.3f} s (capture "
          f"{t_capture:.3f} s), first losses {first['losses']}", file=sys.stderr)

    del model, state, chunk_fn, perm_fn, store, tables, g, feats, losses, window_losses
    program.free(dev)
    rg, rfeats = program.reference_inputs(conf, gd, dev)
    reference = rtrain.run_steps(p0, rg, rfeats, etypes, epoch_seed(args.seed, 0), st, n_first,
                                 dedup=st["dedup"], model=conf["model"],
                                 dropout_seed=dropout_seed(args.seed))
    numbers = compare(first, reference, p0)
    limits = own["limits"]
    checks = [(k, numbers[k], limits[k]) for k in ("loss_gap", "grad_gap", "update_gap")]

    m, gconf = conf["model"], conf["graph"]
    cost = counts.train_step(tuple(gd["schema"]), widths, st["neg_pool_size"], st["fanouts"],
                             gconf["feat_dim"], m["hidden_dim"], m["out_dim"], gd["num_nodes"],
                             dedup=st["dedup"],
                             full_width=-(-gconf["max_fanout"] // 8) * 8)
    pool_rows = []
    for et in etypes:
        deg = np.bincount(gd["schema"][et][0], minlength=num_users)
        pool_rows.append((widths[et], -(-int(deg.max()) // 8) * 8, st["neg_pool_size"],
                          widths[et] * float(deg.mean())))
    context = {"kind": "train", "steps": attempted, "step_flops": cost["flops"],
               "leaf_calls": cost["leaves"] if m["leaf_kernel"] else [],
               "pool_calls": pool_rows if st["pool_mask_kernel"] else [],
               "gather_calls": reference["gathers"],
               "feat_dim": gconf["feat_dim"], "hidden": m["hidden_dim"],
               "elem": 2 if m["dtype"] == "bfloat16" else 4, "dtype": m["dtype"]}
    return core.Outcome(attempted=attempted, failed=failed,
                        values={"train_edges_per_s": attempted * width / elapsed,
                                "setup_s": setup_s},
                        checks=checks, memory_peak_bytes=peak, context=context, trace=tr)
