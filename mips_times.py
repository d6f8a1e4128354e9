#!/usr/bin/env python3
"""Device times of one checkout's MIPS wrappers at the request shape, for
every fetch width serving can ask for.

Run on a CUDA host::

    python3 mips_times.py [ROOT]

``ROOT`` (default: this file's directory) is a checkout of this repository:
its ``gnn_recsys_tpu_torch`` and ``chip_smoke.py`` are imported, so one copy
of this script times two checkouts in turn, each in a process of its own
(compare two only on one card in one run: before, after, after, before).
Shape: U=4,096 users against I=30,000 items at D=128, f32, random unit
embeddings and popularity from seed 0.  ``k``: 26 is the synthetic graph's
fetch (k=10 plus 16 bought items a user), 100 and 266 the widths a request
fetches when one of its users has bought 90 or 256 items
(``retrieval/recs.py``: k plus the batch's longest bought row).  Prints one
JSON line: device ms a call (``chip_smoke.device_ms``) of ``mips_topk``,
``mips_lse`` and ``mips_boost`` (on the plain normaliser) at each ``k``, and
the card's name and power limit.
"""

from __future__ import annotations

import json
import os
import sys

ROOT = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else os.path.dirname(__file__))
sys.path[0] = ROOT

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from gnn_recsys_tpu_torch.models.layers import l2_normalize  # noqa: E402
from gnn_recsys_tpu_torch.ops.cuda import topk_mips as tm  # noqa: E402

FETCHES = (26, 100, 266)


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device")
    if not tm.__file__.startswith(ROOT):
        raise RuntimeError(f"imported {tm.__file__}, not the checkout at {ROOT}")
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(0)
    ue = l2_normalize(torch.randn(4096, 128, generator=gen, device=dev))
    ie = l2_normalize(torch.randn(30_000, 128, generator=gen, device=dev))
    pop = torch.rand(30_000, generator=gen, device=dev)
    m, s = tm.mips_lse_reference(ue, ie)
    out = {"root": ROOT, "mips_lse": cs.device_ms(lambda: tm.mips_lse(ue, ie))}
    for k in FETCHES:
        out[f"mips_topk k={k}"] = cs.device_ms(lambda: tm.mips_topk(ue, ie, k))
        out[f"mips_boost k={k}"] = cs.device_ms(lambda: tm.mips_boost(ue, ie, pop, m, s, k))
    out["smi"] = cs.smi()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
