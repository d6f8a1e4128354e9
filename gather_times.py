#!/usr/bin/env python3
"""Device times of several checkouts' gather-mean kernels on the same inputs,
in one process on one card.

Run on a CUDA host, from the checkout whose ``chip_smoke.py`` makes the
inputs::

    python3 gather_times.py TREE [TREE ...]

Each TREE is a directory holding a checkout of this repository (``git
archive`` another commit into the git-ignored ``_chip/``); its
``ops/cuda/gather_mean.py`` is loaded with its own ``build.py``, so its
kernels are built from its own ``csrc/``.  The inputs are this checkout's:
the dedup'd bench step's plan (``chip_smoke.phase_train`` with a
``GatherTap``, 50 steps on the bench graph), the search's three trials and
the CLI drill (``phase_hp_search``, ``phase_etl_cli``, whose gather checks
run as they do in ``chip_smoke.py`` and are then timed here), and the
kernel phase's uniform (38,912, 8, 30,000, 256) and skewed full-fanout
(904, 1,280, 3,000, 256) cases.  For each shape, dtype and direction, each
tree's wrapper is timed with ``chip_smoke.device_ms`` in the order given,
then in reverse (A, B, B, A), and the largest difference between the trees'
outputs is kept.  Prints one JSON line a case (``gather_times``), then the
card's name and power limit.
"""

from __future__ import annotations

import importlib.util
import os
import sys

import torch

import chip_smoke as cs


def load_tree(tree: str, tag: int):
    """``tree``'s gather_mean module, bound to ``tree``'s own build module."""
    def load(name, rel):
        spec = importlib.util.spec_from_file_location(name, os.path.join(tree, rel))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    build = load(f"_gather_times_build_{tag}", "gnn_recsys_tpu_torch/ops/cuda/build.py")
    gm = load(f"_gather_times_gm_{tag}", "gnn_recsys_tpu_torch/ops/cuda/gather_mean.py")
    gm.build = build
    return gm


def compare(trees, mods, label, h, nbr, mask, g, tr) -> None:
    """Both directions of every tree on one input, timed A, B, ..., B, A."""
    n = h.shape[0]
    calls = {"fwd": [lambda m=m: m.gather_mean_fwd(h, nbr, mask) for m in mods],
             "bwd": [lambda m=m: m.gather_mean_bwd(g, nbr, mask, n, tr) for m in mods]}
    line = {"label": label, "shape": [*nbr.shape, *h.shape], "dtype": str(h.dtype)}
    for direction, fns in calls.items():
        outs = [fn() for fn in fns]
        line[f"{direction}_tree_gap"] = max(float((o.float() - outs[0].float()).abs().max())
                                            for o in outs)
        times = {tree: [] for tree in trees}
        for i in list(range(len(trees))) + list(reversed(range(len(trees)))):
            times[trees[i]].append(cs.device_ms(fns[i]))
        line[f"{direction}_ms"] = times
    cs.say("gather_times", **line)


def compare_calls(trees, mods, tap, label, bf16) -> None:
    """:func:`compare` on the first captured call of each shape, in f32 and,
    with ``bf16``, in bf16."""
    seen = set()
    for call in tap.captured:
        if call["shape"] in seen:
            continue
        seen.add(call["shape"])
        for cast in (torch.float32, torch.bfloat16)[:2 if bf16 else 1]:
            compare(trees, mods, label(call["shape"]), call["h"].to(cast), call["nbr"],
                    call["mask"], call["dout"].to(cast), call["transpose"])


def main(trees) -> int:
    cs.phase_device()
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    cs.phase_build()
    # As in phase_compare.py: the trials run without the smoke's other phases.
    cs.TRIAL_LEFTOVER_BYTES = 1 << 30
    trees = [os.path.abspath(t) for t in trees]
    mods = [load_tree(t, i) for i, t in enumerate(trees)]

    gen = torch.Generator(device=dev).manual_seed(0)
    h, nbr, mask, g = cs.gather_case(dev, gen, 38_912, 8, 30_000, 256)
    for cast in (torch.float32, torch.bfloat16):
        compare(trees, mods, "uniform", h.to(cast), nbr, mask, g.to(cast),
                cs.gm.slot_transpose(nbr, mask, 30_000))
    h, nbr, mask, g, tr = cs.skewed_gather_case(dev, torch.Generator(device=dev).manual_seed(29),
                                                904, 1280, 3000, 256)
    for cast in (torch.float32, torch.bfloat16):
        compare(trees, mods, "wide", h.to(cast), nbr, mask, g.to(cast), tr)

    data = cs.bench_data()
    tap = cs.GatherTap()
    cs.phase_train(dev, data, steps=50, tap=tap)
    compare_calls(trees, mods, tap, cs.gather_label, bf16=True)

    checks = cs.phase_gather_steps

    def checked_and_timed(dev_, tap_, timed=True, label=cs.gather_label, bf16=True):
        rows = checks(dev_, tap_, timed=False, label=label, bf16=bf16)
        compare_calls(trees, mods, tap_, label, bf16)
        return rows

    cs.phase_gather_steps = checked_and_timed
    try:
        cs.phase_hp_search(dev)
        cs.phase_etl_cli(dev)
    finally:
        cs.phase_gather_steps = checks
    print(cs.smi(), flush=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) < 2:
        raise SystemExit(__doc__)
    sys.exit(main(sys.argv[1:]))
