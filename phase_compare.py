#!/usr/bin/env python3
"""One ``chip_smoke.py`` phase from several checkouts of this repo, in the
order given, each in a process of its own on one card; then one dropout
alone in each form.

Run on a CUDA host::

    python3 phase_compare.py PHASE TREE [TREE ...]

PHASE is ``hp_search`` (the search's three trials), ``remat`` (the bf16
LSTM tree step with and without ``remat_levels``, on the bench graph),
``sharded_serving`` (catalog-sharded serving on the bench graph: meshes of
shards on the first card, then over every card where there are several) or
``train_sharded`` (the multi-device training steps on the bench graph; the
dp step over every card too where there are several), or
``train_sharded_cards`` (only its parts across cards: the two-process step,
on NCCL with a card each, and the dp step over every card).
Each TREE is a directory that holds a checkout (``chip_smoke.py`` at its
root); its kernels are built there.  ``hp_search`` runs without the phases
before it, so its check of the memory a trial leaves is widened to 1 GiB.
Each run prints one JSON line ``{"tree", "seconds", "lines"}``: of each of
the phase's JSON lines, the step times, peak memory, dropout and recall@10
(of ``sharded_serving``'s and ``train_sharded``'s, the whole line).
Then ``dropout_forms``: the forward and backward of one dropout over 16M
bf16 entries at trial 3's p (0.584), in ms a call, the mean of 20 after 3
warm-ups (CUDA events): ATen's fused kernel (``nn.functional.dropout``),
the ``rand`` / ``where`` form, and this checkout's ``layers.dropout``.  The
last line is the card's name and power limit.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch  # noqa: E402

from gnn_recsys_tpu_torch.models import layers  # noqa: E402

SETUP = """
import torch
import chip_smoke as cs
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
# Alone, the first trial also allocates what the smoke's earlier phases
# would have allocated before it (201,326,592 bytes on the H100).
cs.TRIAL_LEFTOVER_BYTES = 1 << 30
cs.phase_build()
"""
RUNS = {"hp_search": 'cs.phase_hp_search(torch.device("cuda"))',
        "remat": 'cs.phase_remat(torch.device("cuda"), cs.bench_data())',
        "sharded_serving": 'cs.phase_sharded_serving(torch.device("cuda"), cs.bench_data())',
        "train_sharded": 'cs.phase_train_sharded(torch.device("cuda"), cs.bench_data())',
        "train_sharded_cards": 'cs.phase_train_sharded(torch.device("cuda"), cs.bench_data(), '
                               'cards_only=True)'}
# The JSON lines each phase prints.
LINES = {"hp_search": "hp_trial", "remat": "remat", "sharded_serving": "sharded_serving",
         "train_sharded": "train_sharded", "train_sharded_cards": "train_sharded"}
KEYS = ("step_ms_median", "step_ms_median_remat", "max_memory_allocated_bytes",
        "max_memory_allocated_bytes_remat", "bit_identical")


def run_tree(phase: str, tree: str) -> dict:
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", SETUP + RUNS[phase]], cwd=tree,
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"{tree}: exit {proc.returncode}\n{proc.stderr[-4000:]}")
    lines = []
    for line in proc.stdout.splitlines():
        if f'"phase": "{LINES[phase]}"' in line:
            d = json.loads(line[line.index("{"):])
            if phase in ("sharded_serving", "train_sharded", "train_sharded_cards"):
                lines.append(d)
                continue
            row = {k: d[k] for k in KEYS if k in d}
            if "dropout_check" in d:
                row.update(dropout=d["dropout_check"]["dropout"],
                           recall=d["precision_recall_coverage"][1])
            lines.append(row)
    return {"tree": tree, "seconds": time.perf_counter() - t0, "lines": lines}


def time_form(fn, x, grad, warm=3, reps=20) -> float:
    for _ in range(warm):
        fn(x).backward(grad)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn(x).backward(grad)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def dropout_forms(p: float = 0.5842873457118251, n: int = 16 << 20) -> dict:
    dev = torch.device("cuda")
    x = torch.randn(n, device=dev).to(torch.bfloat16).requires_grad_()
    grad = torch.randn(n, device=dev).to(torch.bfloat16)

    def rand_where(v):
        keep = torch.rand(v.shape, device=v.device) >= p
        return torch.where(keep, v * (1.0 / (1.0 - p)), torch.zeros_like(v))

    forms = {"fused": lambda v: torch.nn.functional.dropout(v, p, True),
             "rand_where": rand_where,
             "layers_dropout": lambda v: layers.dropout(v, p)}
    return {name: time_form(fn, x, grad) for name, fn in forms.items()}


def main() -> int:
    if not torch.cuda.is_available():
        print("phase_compare.py needs a CUDA device", file=sys.stderr)
        return 1
    phase, trees = sys.argv[1], sys.argv[2:]
    for tree in trees:
        print(json.dumps(run_tree(phase, tree)), flush=True)
    print(json.dumps({"dropout_forms": dropout_forms()}))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
