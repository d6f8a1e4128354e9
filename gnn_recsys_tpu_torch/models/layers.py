"""Per-etype message-passing layers.

Port of ``gnn_recsys_tpu/models/layers.py``: a SAGEConv-style update

    z = ReLU(W_self . h_self + W_neigh . AGG(neighbours))

for the ``mean``, ``mean_nn`` and ``pool_nn`` aggregators and their
``*_edge`` variants, with an optional zero-guarded L2 row norm.  As in the
JAX package, the layer does not aggregate: ``transform_src`` (dropout and
the optional pre-MLP, once per source node) and ``combine`` (the towers,
ReLU and norm) surround a reduction that the model runs.

Linear weights are ``[out, in]`` (PyTorch's layout); ``models/convert.py``
maps them to and from flax's ``[in, out]`` kernels.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

AGGREGATOR_TYPES = (
    "mean",
    "mean_nn",
    "pool_nn",
    "lstm",
    "mean_edge",
    "mean_nn_edge",
    "pool_nn_edge",
    "lstm_edge",
)
_PREAGG = ("mean_nn", "mean_nn_edge", "pool_nn", "pool_nn_edge")

RELU_GAIN = math.sqrt(2.0)


def xavier_uniform_relu_(weight: torch.Tensor,
                         generator: Optional[torch.Generator] = None) -> None:
    """Xavier-uniform init with ReLU gain (reference ``src/model.py:45-53``;
    the JAX package's ``xavier_uniform_gain(RELU_GAIN)``)."""
    nn.init.xavier_uniform_(weight, gain=RELU_GAIN, generator=generator)


def lecun_normal_(weight: torch.Tensor,
                  generator: Optional[torch.Generator] = None) -> None:
    """flax's default Dense kernel init: truncated normal (2 std), variance
    1 / fan_in, std corrected for the truncation."""
    std = math.sqrt(1.0 / weight.shape[1]) / 0.87962566103423978
    nn.init.trunc_normal_(weight, std=std, a=-2 * std, b=2 * std, generator=generator)


class NodeEmbedding(nn.Module):
    """Linear projection of raw node features (reference src/model.py:10-24)."""

    def __init__(self, in_feats: int, out_feats: int):
        super().__init__()
        self.proj_feats = nn.Linear(in_feats, out_feats)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        lecun_normal_(self.proj_feats.weight, generator)
        nn.init.zeros_(self.proj_feats.bias)

    def forward(self, node_feats: torch.Tensor) -> torch.Tensor:
        return self.proj_feats(node_feats)


class ConvLayer(nn.Module):
    """One message-passing layer for one canonical edge type."""

    def __init__(
        self,
        in_neigh_feats: int,
        in_self_feats: int,
        out_feats: int,
        aggregator_type: str = "mean",
        dropout: float = 0.0,
        norm: bool = True,
    ):
        super().__init__()
        if aggregator_type not in AGGREGATOR_TYPES:
            raise KeyError(f"Aggregator type {aggregator_type} not recognized.")
        if aggregator_type.startswith("lstm"):
            raise NotImplementedError(
                "the lstm aggregator is not ported yet (ROADMAP.md, queue 1)"
            )
        self.aggregator_type = aggregator_type
        self.norm = norm
        self.dropout = nn.Dropout(dropout)
        self.fc_self = nn.Linear(in_self_feats, out_feats, bias=False)
        self.fc_neigh = nn.Linear(in_neigh_feats, out_feats, bias=False)
        if aggregator_type in _PREAGG:
            self.fc_preagg = nn.Linear(in_neigh_feats, in_neigh_feats, bias=False)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        for lin in (self.fc_self, self.fc_neigh, getattr(self, "fc_preagg", None)):
            if lin is not None:
                xavier_uniform_relu_(lin.weight, generator)

    @property
    def reducer(self) -> str:
        """'mean' or 'max': which reduction the model runs."""
        return "max" if self.aggregator_type.startswith("pool") else "mean"

    @property
    def edge_weighted(self) -> bool:
        return self.aggregator_type.endswith("_edge")

    def transform_src(self, h_neigh: torch.Tensor) -> torch.Tensor:
        """Dropout + optional ReLU(pre-MLP), applied on source-node states."""
        h = self.dropout(h_neigh)
        if self.aggregator_type in _PREAGG:
            h = torch.relu(self.fc_preagg(h))
        return h

    def combine(self, h_self: torch.Tensor, h_neigh_agg: torch.Tensor) -> torch.Tensor:
        """Self/neighbour towers, ReLU, optional L2 row norm whose zero rows
        stay zero (reference src/model.py:226-235)."""
        z = torch.relu(self.fc_self(self.dropout(h_self)) + self.fc_neigh(h_neigh_agg))
        if self.norm:
            z_norm = torch.linalg.vector_norm(z, ord=2, dim=-1, keepdim=True)
            z = z / torch.where(z_norm == 0.0, torch.ones_like(z_norm), z_norm)
        return z


def l2_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """torch ``F.normalize(p=2, dim=-1)`` semantics: the norm is clamped at
    ``eps`` (not zero-guarded as in :meth:`ConvLayer.combine`)."""
    norm = torch.linalg.vector_norm(x, ord=2, dim=-1, keepdim=True)
    return x / norm.clamp(min=eps)
