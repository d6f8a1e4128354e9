"""On-demand inference CLI (port of ``gnn_recsys_tpu/cli/main_inference.py``;
reference ``main_inference.py:179-222``).

The options are the JAX package's (argparse in place of click), plus
``--device``.  ``--mesh N`` serves over N devices: the cards, or with
``--device cpu`` a mesh of N CPU entries (embedding inference data-parallel,
catalog-sharded retrieval; the recommendations are the single-device ones
up to near-ties: the sharded embedding pass sums in another order).

Usage:
    python -m gnn_recsys_tpu_torch.cli.main_inference --run-dir models/run1 \\
        --user-ids u123 --user-ids u456 [--k 10]
    python -m gnn_recsys_tpu_torch.cli.main_inference --run-dir models/run1 --all [--mesh 4]
"""

from __future__ import annotations

import argparse
from typing import Dict, Optional, Sequence

import torch

from gnn_recsys_tpu_torch.inference import inference_ondemand
from gnn_recsys_tpu_torch.parallel.mesh import Mesh, make_mesh


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m gnn_recsys_tpu_torch.cli.main_inference",
        description="Recommendations from a saved run directory.",
        epilog="--mesh N serves over N devices: N cards, or N CPU entries with --device cpu.")
    p.add_argument("--run-dir", required=True,
                   help="Directory written by main_train / hp search save.")
    p.add_argument("--user-ids", action="append", default=[],
                   help="External user ids (repeatable).")
    p.add_argument("--all", dest="all_users", action="store_true",
                   help="Recommend for every known user.")
    p.add_argument("--k", type=int, default=10)
    p.add_argument("--keep-already-bought", action="store_true")
    p.add_argument("--use-popularity", dest="use_popularity", action="store_true", default=None,
                   help="Popularity boost at serving. Default: auto, boost iff the saved run "
                        "trained the hinge objective with popularity_importance on (the boost "
                        "is negative for softmax-trained latents).")
    p.add_argument("--no-use-popularity", dest="use_popularity", action="store_false")
    p.add_argument("--weight-popularity", type=float, default=1.0)
    p.add_argument("--mesh", dest="mesh_devices", type=int, default=0,
                   help="Distribute serving over N devices (embedding inference "
                        "data-parallel + catalog-sharded retrieval; 0 = single device). "
                        "Results equal the single-device ones up to near-ties from the "
                        "embeddings' summation order.")
    p.add_argument("--device", default="cuda",
                   help="Where the model embeds and ranks (default: the CUDA device).")
    return p


def serving_mesh(n: int, device: str) -> Optional[Mesh]:
    """The mesh of ``--mesh n``: None for 0, else ``n`` cards, or ``n`` CPU
    entries when ``device`` is the CPU (``main_inference.py:39-44``)."""
    if not n:
        return None
    if torch.device(device).type == "cpu":
        return make_mesh(n, devices=["cpu"] * n)
    return make_mesh(n)


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    parser = build_parser()
    args = parser.parse_args(argv)
    ids = "all" if args.all_users else list(args.user_ids)
    if not ids:
        parser.error("pass --user-ids ... or --all")
    recs = inference_ondemand(args.run_dir, ids, k=args.k,
                              remove_already_bought=not args.keep_already_bought,
                              use_popularity=args.use_popularity,
                              weight_popularity=args.weight_popularity, device=args.device,
                              mesh=serving_mesh(args.mesh_devices, args.device))
    for uid, items in recs.items():
        print(f"{uid}: {items}")
    return recs


if __name__ == "__main__":
    main()
