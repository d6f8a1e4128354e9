"""Full-graph embedding inference.

Port of ``compute_embeddings`` (``gnn_recsys_tpu/train/full_batch.py:149``).
The full-batch trainer waits for the training slice (ROADMAP.md).
"""

from __future__ import annotations

from typing import Dict

import torch

from gnn_recsys_tpu_torch.graph.hetero import HeteroGraph
from gnn_recsys_tpu_torch.models.conv_model import ConvModel


def compute_embeddings(
    model: ConvModel,
    graph: HeteroGraph,
    features: Dict[str, torch.Tensor],
    device=None,
) -> Dict[str, torch.Tensor]:
    """Embeddings of every node in one layer-wise pass over the whole graph
    (reference ``get_embeddings``, src/train/run.py:311-349), in eval mode
    and without autograd.

    ``device``: where to run; by default the device of ``features``.  The
    graph and features are moved there; the model must already live there.
    """
    dev = torch.device(device) if device is not None else next(iter(features.values())).device
    graph = graph.to(dev)
    features = {nt: x.to(dev) for nt, x in features.items()}
    was_training = model.training
    model.eval()
    try:
        with torch.no_grad():
            return model(graph, features)
    finally:
        model.train(was_training)
