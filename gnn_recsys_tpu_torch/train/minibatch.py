"""Embedding inference dispatcher.

Port of ``infer_embeddings`` (``gnn_recsys_tpu/train/minibatch.py:541``) in
its ``full_graph`` mode.  The sampled-tree trainer and the ``node_batches``
mode wait for the training slice (ROADMAP.md).
"""

from __future__ import annotations

from typing import Dict

import torch

from gnn_recsys_tpu_torch.graph.hetero import HeteroGraph
from gnn_recsys_tpu_torch.models.conv_model import ConvModel
from gnn_recsys_tpu_torch.train.full_batch import compute_embeddings


def infer_embeddings(
    model: ConvModel,
    graph: HeteroGraph,
    features: Dict[str, torch.Tensor],
    mode: str = "full_graph",
    device=None,
) -> Dict[str, torch.Tensor]:
    """Embeddings of every node.  ``mode='full_graph'`` is one layer-wise
    pass over the whole graph (:func:`compute_embeddings`)."""
    if mode == "full_graph":
        return compute_embeddings(model, graph, features, device=device)
    if mode == "node_batches":
        raise NotImplementedError(
            "node_batches inference needs the sampled tree, not ported yet (ROADMAP.md)"
        )
    raise ValueError(f"unknown inference mode {mode!r}")
