"""Per-etype message-passing layers.

Port of ``gnn_recsys_tpu/models/layers.py``: a SAGEConv-style update

    z = ReLU(W_self . h_self + W_neigh . AGG(neighbours))

for the ``mean``, ``mean_nn``, ``pool_nn`` and ``lstm`` aggregators and
their ``*_edge`` variants, with an optional zero-guarded L2 row norm.  As in
the JAX package, the layer does not aggregate: ``transform_src`` (dropout
and the optional pre-MLP, once per source node) and ``combine`` (the
towers, ReLU and norm) surround a reduction that the model runs; the LSTM's
reduction is the layer's :class:`MaskedLSTMReducer`.

Linear weights are ``[out, in]`` (PyTorch's layout); ``models/convert.py``
maps them to and from flax's ``[in, out]`` kernels, and the LSTM's packed
gate weights to and from flax's eight ``LSTMCell`` Denses.

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

from gnn_recsys_tpu_torch.ops.cuda.lstm_cell import lstm_cell
from gnn_recsys_tpu_torch.utils.profiling import counter, span

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


def orthogonal_(weight: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> None:
    """flax's ``initializers.orthogonal()`` on each [H, H] gate block of a
    packed ``[4H, H]`` recurrent weight: a Haar-random orthogonal matrix
    per block (QR of a normal matrix, signs fixed by R's diagonal)."""
    with torch.no_grad():
        for block in weight.chunk(4, dim=0):
            nn.init.orthogonal_(block, generator=generator)


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


def dropout_keep_mask(like: torch.Tensor, p: float) -> torch.Tensor:
    """Dropout's keep mask for ``like``: a bool Bernoulli(1 - ``p``) draw an
    element, one kernel, from PyTorch's default generator on ``like``'s
    device."""
    return torch.empty_like(like, dtype=torch.bool).bernoulli_(1.0 - p)


class _MaskedScale(torch.autograd.Function):
    """``x * keep * scale`` and its gradient, each one kernel: ATen's own
    dropout arithmetic (``native_dropout_backward``, the scale applied in
    f32 as ``nn.Dropout``'s fused kernel applies it).  Autograd through
    that op would scale the gradient by ``keep * scale`` rounded to the
    input's dtype."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, keep: torch.Tensor, scale: float) -> torch.Tensor:
        ctx.save_for_backward(keep)
        ctx.scale = scale
        return torch.ops.aten.native_dropout_backward(x, keep, scale)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        (keep,) = ctx.saved_tensors
        return torch.ops.aten.native_dropout_backward(grad, keep, ctx.scale), None, None


def dropout(x: torch.Tensor, p: float, keep_mask=dropout_keep_mask) -> torch.Tensor:
    """Inverted dropout, the model's only one: ``x / (1 - p)`` where
    ``keep_mask(x, p)`` holds, else 0.  A rematerialised tree level passes a
    ``keep_mask`` that records the masks in its forward and hands the same
    ones out in its recompute, so both draw as the plain step does."""
    return _MaskedScale.apply(x, keep_mask(x, p), 1.0 / (1.0 - p))


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


class MaskedLSTMReducer(nn.Module):
    """An LSTM over the slot axis of padded messages; returns the final
    hidden state (``MaskedLSTMReducer``, ``gnn_recsys_tpu/models/
    layers.py:79-109``; reference ``src/model.py:107-121``).

    The cell is flax's ``LSTMCell`` with a zero carry ``(c, h)``::

        i = sigmoid(x W_ii + h W_hi + b_hi)   f = sigmoid(x W_if + h W_hf + b_hf)
        g = tanh(x W_ig + h W_hg + b_hg)      o = sigmoid(x W_io + h W_ho + b_ho)
        c' = f c + i g                        h' = o tanh(c')

    and the carry keeps its old value on every slot whose mask is False
    (``_MaskedLSTMStep``), so holes in the mask are skipped.  The gates are
    packed in the order i, f, g, o: ``ih`` is the ``[4H, in]`` input weight
    (no bias), ``hh`` the ``[4H, H]`` recurrent weight with its bias.  Each
    product rounds where flax's ``Dense(dtype=...)`` rounds (:func:`dense`),
    with the weights and the bias cast once a call and each slot's gradient
    cast back before autograd sums the K slots in the parameters' dtype
    (:class:`_SlotParam`); the carry takes the messages' dtype.

    The K steps are a Python loop of static length with no host sync, so a
    CUDA graph captures it.  A step is the slot's two products (cuBLAS) and
    one cell update, :func:`~gnn_recsys_tpu_torch.ops.cuda.lstm_cell.lstm_cell`:
    on the card one fused kernel forward and one backward
    (``csrc/lstm_cell.cu``), which round as flax's bf16 cell rounds; on the
    CPU the same cell as PyTorch ops with the same hand-written backward.
    cuDNN's LSTM is still not used: it assumes the valid slots form a prefix,
    and the sampled tree's exclusion leaves holes.

    Each call runs in a ``gnn.lstm.reduce`` span and counts, in counters
    on the class (``utils/profiling.py:counter``), its cell updates
    (``slot_steps``: K a call) and its rows times slots (``row_slots``: N K)."""

    def __init__(self, in_feats: int, features: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.features = features
        self.dtype = dtype
        self.ih = nn.Linear(in_feats, 4 * features, bias=False)
        self.hh = nn.Linear(features, 4 * features)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """flax's ``LSTMCell`` defaults: ``lecun_normal`` input kernels,
        ``orthogonal`` recurrent kernels, zero biases."""
        lecun_normal_(self.ih.weight, generator)
        orthogonal_(self.hh.weight, generator)
        nn.init.zeros_(self.hh.bias)

    def forward(self, msgs: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """msgs [N, K, D], mask [N, K] bool -> the final h [N, H]."""
        n, k = msgs.shape[:2]
        MaskedLSTMReducer.slot_steps += k
        MaskedLSTMReducer.row_slots += n * k
        with span("gnn.lstm.reduce"):
            dt = self.dtype
            params = (self.ih.weight, self.hh.weight, self.hh.bias)
            casts = None if dt is None else [p.detach().to(dt) for p in params]
            c = msgs.new_zeros((n, self.features))
            h = msgs.new_zeros((n, self.features))
            # One slot a step; the input product too, so that no [K, N, 4H]
            # tensor is ever held (``unbind``'s backward stacks the slots once).
            for x, m in zip(msgs.unbind(1), mask.unbind(1)):
                w_ih, w_hh, b = params if casts is None else [
                    _SlotParam.apply(p, q) for p, q in zip(params, casts)]
                xw = F.linear(x if dt is None else x.to(dt), w_ih)
                hw = F.linear(h if dt is None else h.to(dt), w_hh)
                c, h = lstm_cell(xw, hw, b, c, h, m)
        return h


counter(MaskedLSTMReducer, "slot_steps", "row_slots")


class _SlotParam(torch.autograd.Function):
    """A parameter as one slot of :class:`MaskedLSTMReducer` takes it: the
    forward hands on the copy cast once a call, the backward casts the
    slot's gradient back to the parameter's dtype.  Autograd then sums the
    K slots' gradients in f32, as it sums those of a cast a slot
    (:func:`dense`) and as flax's ``nn.scan`` sums the cotangents of its
    broadcast parameters."""

    @staticmethod
    def forward(ctx, param: torch.Tensor, cast: torch.Tensor) -> torch.Tensor:
        ctx.dtype = param.dtype
        return cast.view_as(cast)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return grad.to(ctx.dtype), None


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
        self.aggregator_type = aggregator_type
        self.norm = norm
        self.dtype = dtype  # the computation dtype (None: the inputs')
        self.dropout_p = dropout
        self.fc_self = nn.Linear(in_self_feats, out_feats, bias=False)
        self.fc_neigh = nn.Linear(in_neigh_feats, out_feats, bias=False)
        if aggregator_type in _PREAGG:
            self.fc_preagg = nn.Linear(in_neigh_feats, in_neigh_feats, bias=False)
        if self.reducer == "lstm":
            self.lstm = MaskedLSTMReducer(in_neigh_feats, in_neigh_feats, dtype=dtype)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        for lin in (self.fc_self, self.fc_neigh, getattr(self, "fc_preagg", None)):
            if lin is not None:
                xavier_uniform_relu_(lin.weight, generator)
        if self.reducer == "lstm":
            self.lstm.reset_parameters(generator)

    @property
    def reducer(self) -> str:
        """'mean', 'max' or 'lstm': which reduction the model runs."""
        if self.aggregator_type.startswith("pool"):
            return "max"
        return "lstm" if self.aggregator_type.startswith("lstm") else "mean"

    @property
    def edge_weighted(self) -> bool:
        return self.aggregator_type.endswith("_edge")

    def _drop(self, x: torch.Tensor, keep_mask=None) -> torch.Tensor:
        """:func:`dropout` in train mode, with the masks from ``keep_mask``
        where a caller supplies them (a rematerialised tree level)."""
        if not self.training or self.dropout_p == 0.0:
            return x
        return dropout(x, self.dropout_p, keep_mask or dropout_keep_mask)

    def transform_src(self, h_neigh: torch.Tensor, keep_mask=None) -> torch.Tensor:
        """Dropout + optional ReLU(pre-MLP), applied on source-node states."""
        h = self._drop(h_neigh, keep_mask)
        if self.aggregator_type in _PREAGG:
            h = torch.relu(dense(self.fc_preagg, h, self.dtype))
        return h

    def combine(self, h_self: torch.Tensor, h_neigh_agg: torch.Tensor,
                keep_mask=None) -> torch.Tensor:
        """Self/neighbour towers, ReLU, optional L2 row norm whose zero rows
        stay zero (reference src/model.py:226-235); in the computation dtype."""
        z = torch.relu(dense(self.fc_self, self._drop(h_self, keep_mask), self.dtype)
                       + dense(self.fc_neigh, h_neigh_agg, self.dtype))
        if self.norm:
            z_norm = row_norm(z)
            z = z / torch.where(z_norm == 0.0, torch.ones_like(z_norm), z_norm)
        return z


class PredictingLayer(nn.Module):
    """The MLP scoring head of ``pred='nn'`` (``layers.py:211-229``;
    reference ``src/model.py:240-272``): concat(u, i) -> Dense 128 -> ReLU ->
    Dense 32 -> ReLU -> Dense 1 -> sigmoid, in the model's computation
    dtype.  ``in_feats`` is the concat's width (twice the embedding's).

    Each call counts the pairs it scores, the score tensor's element count,
    in a counter on the class (``pairs``; ``utils/profiling.py:counter``)."""

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
        PredictingLayer.pairs += math.prod(x.shape[:-1])
        x = torch.relu(dense(self.hidden_1, x, self.dtype))
        x = torch.relu(dense(self.hidden_2, x, self.dtype))
        return torch.sigmoid(dense(self.output, x, self.dtype))


counter(PredictingLayer, "pairs")


def l2_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """torch ``F.normalize(p=2, dim=-1)`` semantics: the norm is clamped at
    ``eps`` (not zero-guarded as in :meth:`ConvLayer.combine`); bf16 rows
    stay bf16 (:func:`row_norm`)."""
    return x / row_norm(x).clamp(min=eps)
