"""Parameter init, the optimizer state, and full-graph embedding inference.

Port of ``init_model``, ``TrainState`` and ``compute_embeddings``
(``gnn_recsys_tpu/train/full_batch.py:53-167``).  ``TrainState`` holds
``torch.optim.Adam`` (optax's ``adam``) and, optionally, the cosine
schedule; the host training loop steps it eagerly, and the device-epoch
route switches it to Adam's capturable form so that a CUDA graph replays
the whole step, update included.  The full-batch trainer waits for a later
slice (ROADMAP.md).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from gnn_recsys_tpu_torch.graph.hetero import HeteroGraph
from gnn_recsys_tpu_torch.models.conv_model import ConvModel


def init_model(model: ConvModel, seed: int = 0) -> Dict[str, torch.Tensor]:
    """Draw every parameter (every (layer, etype) pair, as the JAX package's
    schema-complete init) from a CPU ``torch.Generator`` seeded ``seed``, so
    the values do not depend on where the model lives; returns the model's
    state_dict.  Parameter shapes do not depend on the graph."""
    dev = next(model.parameters()).device
    model.to("cpu").reset_parameters(torch.Generator().manual_seed(seed))
    model.to(dev)
    return model.state_dict()


@dataclasses.dataclass
class TrainState:
    """The model, its Adam optimizer and the number of updates applied.

    optax's ``adam`` and ``torch.optim.Adam`` apply the same update,
    ``lr * m_hat / (sqrt(v_hat) + eps)`` with eps outside the square root
    (b1 0.9, b2 0.999, eps 1e-8).  Unlike flax's immutable state, this one
    updates the model's parameters in place.  An update has a device half,
    Adam's step, and a host half (:meth:`advance`): the schedule, which
    writes a Python float ``lr``, and the count.  A CUDA graph of the
    training step (``train/graph_step.py``) captures the device half in
    Adam's capturable form (:meth:`make_capturable`), its learning rate read
    from a device tensor filled before each replay; the host half runs after
    each replay."""

    model: ConvModel
    tx: torch.optim.Optimizer
    schedule: Optional[torch.optim.lr_scheduler.LRScheduler] = None
    step: int = 0

    @classmethod
    def create(cls, model: ConvModel, lr: float = 1e-3,
               decay_steps: Optional[int] = None) -> "TrainState":
        """Adam at ``lr``; with ``decay_steps``, decayed to 0 over that many
        updates (the values of optax's ``cosine_decay_schedule``, alpha 0,
        up to ``decay_steps``)."""
        tx = torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8)
        schedule = None
        if decay_steps is not None:
            schedule = torch.optim.lr_scheduler.CosineAnnealingLR(
                tx, T_max=max(1, decay_steps), eta_min=0.0)
        return cls(model=model, tx=tx, schedule=schedule)

    def apply_gradients(self) -> None:
        """One update from the gradients in the parameters' ``.grad``."""
        self.tx.step()
        self.advance()

    def advance(self) -> None:
        """The host half of an update: the schedule's next ``lr`` and the count."""
        if self.schedule is not None:
            self.schedule.step()
        self.step += 1

    def make_capturable(self) -> None:
        """Switch Adam to its capturable form (``capturable=True``: its
        update counts live on the parameters' device, so a CUDA graph can
        capture its step); the update it applies is the same."""
        for group in self.tx.param_groups:
            group["capturable"] = True
        for p, st in self.tx.state.items():
            if torch.is_tensor(st.get("step")):
                st["step"] = st["step"].to(p.device, torch.float32)


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
