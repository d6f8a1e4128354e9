"""Hyperparameter-search CLI (port of ``gnn_recsys_tpu/cli/main_hp.py``;
reference ``main.py:529-607``).

Runs the search over full build / train / evaluate trials; each trial logs
its result and checkpoints the search for crash recovery.  The options are
the JAX package's (argparse in place of click), plus ``--device``.

Usage:
    python -m gnn_recsys_tpu_torch.cli.main_hp --train-path ... --test-path ... \\
        --item-feat-path ... --user-feat-path ... [options]
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

from gnn_recsys_tpu_torch.config import SPECIFIC, DataPaths, FixedParams, HyperParams
from gnn_recsys_tpu_torch.data.io import save_txt
from gnn_recsys_tpu_torch.hpsearch import SearchState, run_search
from gnn_recsys_tpu_torch.trial import SAVE_THRESHOLDS, run_trial
from gnn_recsys_tpu_torch.utils.logging import get_logger

PATH_OPTIONS = ("item_sport_path", "user_sport_path", "sport_sportg_path", "sport_feat_path",
                "sport_onehot_path")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m gnn_recsys_tpu_torch.cli.main_hp",
                                description="Hyperparameter search over full trials.")
    p.add_argument("--from-beginning", action="store_true",
                   help="Restart the search instead of resuming from checkpoint.")
    p.add_argument("--visualization", action="store_true",
                   help="Save loss/metric plots per trial.")
    p.add_argument("--remove", type=float, default=0.99, help="Proportion of users removed.")
    p.add_argument("--num-epochs", type=int, default=100)
    p.add_argument("--start-epoch", type=int, default=0)
    p.add_argument("--patience", type=int, default=3)
    p.add_argument("--edge-batch-size", type=int, default=2048)
    p.add_argument("--item-id-type", default=SPECIFIC)
    p.add_argument("--duplicates", default="keep_all")
    p.add_argument("--n-calls", type=int, default=200, help="Search budget (trials).")
    p.add_argument("--logdir", default=".")
    for name in ("train_path", "test_path", "item_feat_path", "user_feat_path"):
        p.add_argument("--" + name.replace("_", "-"), required=True)
    for name in PATH_OPTIONS:
        p.add_argument("--" + name.replace("_", "-"), default="")
    p.add_argument("--result-filepath", default="outputs/result_log.txt")
    p.add_argument("--device", default="cuda",
                   help="Where trials train and evaluate (default: the CUDA device).")
    return p


def main(argv: Optional[Sequence[str]] = None) -> SearchState:
    args = build_parser().parse_args(argv)
    paths = DataPaths(train_path=args.train_path, test_path=args.test_path,
                      item_feat_path=args.item_feat_path, user_feat_path=args.user_feat_path,
                      result_filepath=args.result_filepath,
                      **{name: getattr(args, name) for name in PATH_OPTIONS})
    fixed = FixedParams(remove=args.remove, num_epochs=args.num_epochs,
                        start_epoch=args.start_epoch, patience=args.patience,
                        edge_batch_size=args.edge_batch_size, item_id_type=args.item_id_type,
                        duplicates=args.duplicates, include_sport=bool(args.item_sport_path))
    best_recall = SAVE_THRESHOLDS.get(args.item_id_type, 0.08)

    def fitness(hyper: HyperParams) -> float:
        nonlocal best_recall
        # models/best holds the best run so far: a trial saves only when it
        # beats both the reference's threshold (main.py:404-405) and every
        # earlier trial.
        result = run_trial(fixed, hyper, paths=paths, save_dir=f"{args.logdir}/models/best",
                           save_threshold=best_recall,
                           plots_dir=f"{args.logdir}/plots" if args.visualization else None,
                           verbose=True, device=args.device)
        best_recall = max(best_recall, result.recall)
        line = (f"hyper={hyper} recall={result.recall:.4f} "
                f"precision={result.precision:.4f} coverage={result.coverage:.4f} "
                f"recall_purchase={result.recall_purchase:.4f} "
                f"time={result.train_time_s:.0f}s")
        if result.inference_recall is not None:
            line += f" inference_recall={result.inference_recall:.4f}"
        if result.inference_recall_all_users is not None:
            line += f" inference_recall_all_users={result.inference_recall_all_users:.4f}"
        save_txt(line, paths.result_filepath)
        return result.recall

    state = run_search(fitness, n_calls=args.n_calls, logdir=args.logdir,
                       from_beginning=args.from_beginning, verbose=True)
    log = get_logger(__name__)
    log.info("best recall: %.4f", -state.best.objective)
    log.info("best hyper: %s", state.best.hyper)
    return state


if __name__ == "__main__":
    main()
