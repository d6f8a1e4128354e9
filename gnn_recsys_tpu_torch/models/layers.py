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

``dtype`` is flax's computation dtype (``nn.Dense(dtype=...)``): None keeps
the inputs' dtype (f32), ``torch.bfloat16`` casts each Linear's input,
weight and bias to bf16 (:func:`dense`), so its output and every
elementwise op after it (ReLU, the row norm) are bf16, while the parameters
stay f32.  This is not ``torch.autocast``, which keeps norms and sums in f32
where the JAX package runs them in bf16.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
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
SIGMOID_GAIN = 1.0


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


def dense(lin: nn.Linear, x: torch.Tensor, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``lin(x)`` with flax ``Dense(dtype=dtype)`` semantics
    (``gnn_recsys_tpu/models/layers.py:118-123``): with a dtype, the input,
    weight and bias are cast to it, and the product is rounded to it before
    the bias is added, as flax adds it; None is ``lin(x)``."""
    if dtype is None:
        return lin(x)
    y = F.linear(x.to(dtype), lin.weight.to(dtype))
    return y if lin.bias is None else y + lin.bias.to(dtype)


def row_norm(x: torch.Tensor) -> torch.Tensor:
    """The L2 norm of each row, keepdim (``jnp.linalg.norm(x, ord=2,
    axis=-1, keepdims=True)``).  In bf16 as JAX takes it: the squares
    rounded to bf16, summed in f32 and rounded, then the root; torch's
    ``vector_norm`` would widen the whole computation."""
    if x.dtype == torch.bfloat16:
        return torch.sqrt((x * x).sum(dim=-1, keepdim=True))
    return torch.linalg.vector_norm(x, ord=2, dim=-1, keepdim=True)


class NodeEmbedding(nn.Module):
    """Linear projection of raw node features (reference src/model.py:10-24)."""

    def __init__(self, in_feats: int, out_feats: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.proj_feats = nn.Linear(in_feats, out_feats)
        self.dtype = dtype

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        lecun_normal_(self.proj_feats.weight, generator)
        nn.init.zeros_(self.proj_feats.bias)

    def forward(self, node_feats: torch.Tensor) -> torch.Tensor:
        return dense(self.proj_feats, node_feats, self.dtype)


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
        dtype: Optional[torch.dtype] = None,
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
        self.dtype = dtype  # the computation dtype (None: the inputs')
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
            h = torch.relu(dense(self.fc_preagg, h, self.dtype))
        return h

    def combine(self, h_self: torch.Tensor, h_neigh_agg: torch.Tensor) -> torch.Tensor:
        """Self/neighbour towers, ReLU, optional L2 row norm whose zero rows
        stay zero (reference src/model.py:226-235); in the computation dtype."""
        z = torch.relu(dense(self.fc_self, self.dropout(h_self), self.dtype)
                       + dense(self.fc_neigh, h_neigh_agg, self.dtype))
        if self.norm:
            z_norm = row_norm(z)
            z = z / torch.where(z_norm == 0.0, torch.ones_like(z_norm), z_norm)
        return z


class PredictingLayer(nn.Module):
    """The MLP scoring head of ``pred='nn'`` (``layers.py:211-229``;
    reference ``src/model.py:240-272``): concat(u, i) -> Dense 128 -> ReLU ->
    Dense 32 -> ReLU -> Dense 1 -> sigmoid, in the model's computation
    dtype.  ``in_feats`` is the concat's width (twice the embedding's)."""

    def __init__(self, in_feats: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.hidden_1 = nn.Linear(in_feats, 128)
        self.hidden_2 = nn.Linear(128, 32)
        self.output = nn.Linear(32, 1)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        for lin, gain in ((self.hidden_1, RELU_GAIN), (self.hidden_2, RELU_GAIN),
                          (self.output, SIGMOID_GAIN)):
            nn.init.xavier_uniform_(lin.weight, gain=gain, generator=generator)
            nn.init.zeros_(lin.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.relu(dense(self.hidden_1, x, self.dtype))
        x = torch.relu(dense(self.hidden_2, x, self.dtype))
        return torch.sigmoid(dense(self.output, x, self.dtype))


def l2_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """torch ``F.normalize(p=2, dim=-1)`` semantics: the norm is clamped at
    ``eps`` (not zero-guarded as in :meth:`ConvLayer.combine`); bf16 rows
    stay bf16 (:func:`row_norm`)."""
    return x / row_norm(x).clamp(min=eps)
