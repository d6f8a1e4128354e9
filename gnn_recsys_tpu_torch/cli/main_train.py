"""Full-training CLI (port of ``gnn_recsys_tpu/cli/main_train.py``;
reference ``main_train.py:409-428``).

Loads hyperparameters from a JSON file (the search's best), presplits the
full interaction file with a 1-day test window (main_train.py:89-96), cuts
the subtrain and validation sizes to 0.01 (main_train.py:81-82), trains,
reports test metrics on the purchase-only and all-interaction ground truths
(main_train.py:271-294), and saves every artifact inference needs.  The
options are the JAX package's (argparse in place of click), plus
``--device`` and ``--plots-dir``.

Usage:
    python -m gnn_recsys_tpu_torch.cli.main_train --interactions-path ... \\
        --item-feat-path ... --user-feat-path ... --out-dir models/run1
"""

from __future__ import annotations

import argparse
import json
from typing import Optional, Sequence

from gnn_recsys_tpu_torch.config import SPECIFIC, FixedParams, HyperParams
from gnn_recsys_tpu_torch.data.io import read_data, save_txt
from gnn_recsys_tpu_torch.data.presplit import presplit_data
from gnn_recsys_tpu_torch.trial import TrialResult, run_trial
from gnn_recsys_tpu_torch.utils.logging import get_logger


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m gnn_recsys_tpu_torch.cli.main_train",
                                description="Train on the full interaction log and save the "
                                            "run.")
    p.add_argument("--interactions-path", required=True,
                   help="Full (unsplit) user-item interaction file.")
    p.add_argument("--item-feat-path", required=True)
    p.add_argument("--user-feat-path", required=True)
    for name in ("item-sport", "user-sport", "sport-sportg", "sport-feat", "sport-onehot"):
        p.add_argument(f"--{name}-path", default="")
    p.add_argument("--hyper-json", default=None,
                   help="JSON file of hyperparameters (from hpsearch).")
    p.add_argument("--out-dir", default="models/full_train")
    p.add_argument("--num-epochs", type=int, default=100)
    p.add_argument("--patience", type=int, default=3)
    p.add_argument("--edge-batch-size", type=int, default=2048)
    p.add_argument("--item-id-type", default=SPECIFIC)
    p.add_argument("--duplicates", default="keep_all")
    p.add_argument("--test-days", type=int, default=1, help="main_train.py:89-96 uses 1 day.")
    p.add_argument("--check-embedding", action="store_true",
                   help="Print qualitative rec/coverage analysis after training.")
    p.add_argument("--result-filepath", default="outputs/result_log.txt")
    p.add_argument("--plots-dir", default="plots",
                   help="Where the loss and metric plots go (needs matplotlib); an empty "
                        "value draws none.")
    p.add_argument("--device", default="cuda",
                   help="Where the model trains and evaluates (default: the CUDA device).")
    return p


def main(argv: Optional[Sequence[str]] = None) -> TrialResult:
    args = build_parser().parse_args(argv)
    hyper = HyperParams()
    if args.hyper_json:
        with open(args.hyper_json) as f:
            hyper = HyperParams(**json.load(f))

    interactions = read_data(args.interactions_path)
    item_feat = read_data(args.item_feat_path)
    train_df, test_df = presplit_data(item_feat, interactions, num_min=3, remove_unk=True,
                                      sort=True, test_size_days=args.test_days)
    fixed = FixedParams(remove=0.0, num_epochs=args.num_epochs, patience=args.patience,
                        edge_batch_size=args.edge_batch_size, item_id_type=args.item_id_type,
                        duplicates=args.duplicates, include_sport=bool(args.item_sport_path),
                        # Full training uses tiny evaluation splits (main_train.py:81-82).
                        valid_size=0.01, subtrain_size=0.01)
    dataframes = dict(train=train_df, test=test_df, item_feat=item_feat,
                      user_feat=read_data(args.user_feat_path))
    if args.item_sport_path:
        dataframes.update(item_sport=read_data(args.item_sport_path),
                          user_sport=read_data(args.user_sport_path),
                          sport_sportg=read_data(args.sport_sportg_path),
                          sport_feat=read_data(args.sport_feat_path),
                          sport_onehot=read_data(args.sport_onehot_path))

    result = run_trial(fixed, hyper, dataframes=dataframes, save_dir=args.out_dir,
                       save_threshold=-1.0,  # always save after full training
                       plots_dir=args.plots_dir or None, verbose=True,
                       check_embedding=args.check_embedding, device=args.device)
    msg = (f"FULL TRAIN recall={result.recall:.4f} "
           f"precision={result.precision:.4f} coverage={result.coverage:.4f} "
           f"recall_purchase={result.recall_purchase:.4f} "
           f"time={result.train_time_s:.0f}s saved_to={result.saved_to}")
    save_txt(msg, args.result_filepath)
    get_logger(__name__).info(msg)
    print(msg)
    return result


if __name__ == "__main__":
    main()
