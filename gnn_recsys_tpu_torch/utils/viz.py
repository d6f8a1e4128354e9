"""Training-curve plots (port of ``gnn_recsys_tpu/utils/viz.py``; reference
``src/utils_vizualization.py:8-41``).  matplotlib is imported only when a
plot is drawn."""

from __future__ import annotations

import os
from typing import Optional, Sequence


def plot_train_loss(
    hp_string: str,
    viz: dict,
    out_dir: str = "plots",
    stem: Optional[str] = None,
) -> Sequence[str]:
    """Save loss and metric curves to ``plots/`` with the HP string as title.

    ``viz`` keys (matching the reference's dict): ``train_loss_list``,
    ``loss_list`` (validation), and optionally ``train_precision_list`` /
    ``val_precision_list`` (any *_list metric pairs are plotted together).
    Returns the written file paths.
    """
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    os.makedirs(out_dir, exist_ok=True)
    stem = stem or "train"
    written = []

    fig, ax = plt.subplots()
    if "train_loss_list" in viz:
        ax.plot(viz["train_loss_list"], label="train loss")
    if "loss_list" in viz:
        ax.plot(viz["loss_list"], label="valid loss")
    ax.set_xlabel("epoch")
    ax.set_ylabel("loss")
    ax.set_title(hp_string, fontsize=6)
    ax.legend()
    path = os.path.join(out_dir, f"{stem}_loss.png")
    fig.savefig(path, dpi=120)
    plt.close(fig)
    written.append(path)

    metric_keys = [
        k for k in viz
        if k.endswith("_list") and k not in ("train_loss_list", "loss_list")
    ]
    if metric_keys:
        fig, ax = plt.subplots()
        for k in sorted(metric_keys):
            ax.plot(viz[k], label=k[:-5])
        ax.set_xlabel("eval point")
        ax.set_title(hp_string, fontsize=6)
        ax.legend()
        path = os.path.join(out_dir, f"{stem}_metrics.png")
        fig.savefig(path, dpi=120)
        plt.close(fig)
        written.append(path)
    return written
