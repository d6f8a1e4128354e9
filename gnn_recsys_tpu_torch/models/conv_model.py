"""Hetero GraphSAGE-style model, full-graph path.

Port of ``ConvModel`` (``gnn_recsys_tpu/models/conv_model.py:86-305``): an
optional per-ntype embedding Linear, a stack of per-etype
:class:`ConvLayer`\\ s with a cross-etype reduction (``sum``, ``mean`` or
``max``), and the cosine predictor.  ``get_repr`` runs the whole graph
layer by layer; the sampled-tree minibatch path and ``pred="nn"`` are not
ported yet (ROADMAP.md).

Layer-count rules as in the reference: ``n_layers`` counts the embedding
layer when present, so there are ``n_layers - 1`` conv layers with
``embedding_layer=True`` and ``n_layers`` otherwise.

Submodules carry the flax module names (``user_embed``,
``layer0_user__buys__item``, ...), so a state_dict key is the flax path
with dots: ``layer0_user__buys__item.fc_self.weight``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from gnn_recsys_tpu_torch.graph.hetero import CanonicalEtype, HeteroGraph
from gnn_recsys_tpu_torch.models.layers import AGGREGATOR_TYPES, ConvLayer, NodeEmbedding
from gnn_recsys_tpu_torch.ops.message import coo_segment_max, coo_segment_mean


def _etype_key(etype: CanonicalEtype) -> str:
    return "__".join(etype)


class ConvModel(nn.Module):
    """Full hetero message-passing model.

    ``dims`` is the reference's ``dim_dict`` as (name, dim) pairs: one entry
    per node type (its feature width) plus ``hidden`` and ``out``.  Weights
    are drawn from ``generator`` (a fresh ``torch.Generator`` seeded 0 when
    None) with the JAX package's init rules.  The port computes in f32
    (bf16 serving: ROADMAP.md).
    """

    def __init__(
        self,
        canonical_etypes: Sequence[CanonicalEtype],
        dims: Sequence[Tuple[str, int]],
        n_layers: int = 3,
        norm: bool = True,
        dropout: float = 0.0,
        aggregator_type: str = "mean",
        pred: str = "cos",
        aggregator_hetero: str = "sum",
        embedding_layer: bool = True,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        if aggregator_type not in AGGREGATOR_TYPES:
            raise KeyError(f"Aggregator type {aggregator_type} not recognized.")
        if pred not in ("cos", "nn"):
            raise KeyError(f"Prediction function {pred} not recognized.")
        if aggregator_hetero not in ("sum", "mean", "max"):
            raise KeyError(f"Cross-etype aggregator {aggregator_hetero} not recognized.")
        if pred == "nn":
            raise NotImplementedError("pred='nn' (the MLP head) is not ported yet (ROADMAP.md)")
        self.canonical_etypes = tuple(tuple(e) for e in canonical_etypes)
        self.dims = tuple((str(k), int(v)) for k, v in dims)
        self.n_layers = n_layers
        self.norm = norm
        self.dropout = dropout
        self.aggregator_type = aggregator_type
        self.pred = pred
        self.aggregator_hetero = aggregator_hetero
        self.embedding_layer = embedding_layer

        dim = self.dim_dict
        self.embed: Dict[str, NodeEmbedding] = {}
        if embedding_layer:
            for nt in self.ntypes:
                self.embed[nt] = NodeEmbedding(dim[nt], dim["hidden"])
                self.add_module(f"{nt}_embed", self.embed[nt])

        def conv_dict(idx: int, in_dims: Dict[str, int], out_feats: int):
            layer = {}
            for et in self.canonical_etypes:
                layer[_etype_key(et)] = ConvLayer(
                    in_neigh_feats=in_dims[et[0]], in_self_feats=in_dims[et[2]],
                    out_feats=out_feats, aggregator_type=aggregator_type,
                    dropout=dropout, norm=norm,
                )
                self.add_module(f"layer{idx}_{_etype_key(et)}", layer[_etype_key(et)])
            return layer

        # Input layer only without an embedding layer; n_layers-2 hidden; 1 output.
        self.layers: List[Dict[str, ConvLayer]] = []
        if not embedding_layer:
            self.layers.append(conv_dict(0, dim, dim["hidden"]))
        hidden_dims = {nt: dim["hidden"] for nt in self.ntypes}
        for _ in range(n_layers - 2):
            self.layers.append(conv_dict(len(self.layers), hidden_dims, dim["hidden"]))
        self.layers.append(conv_dict(len(self.layers), hidden_dims, dim["out"]))
        self.reset_parameters(generator)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        for mod in self.children():
            mod.reset_parameters(generator)

    @property
    def dim_dict(self) -> Dict[str, int]:
        return dict(self.dims)

    @property
    def ntypes(self) -> Tuple[str, ...]:
        seen = []
        for s, _, d in self.canonical_etypes:
            for t in (s, d):
                if t not in seen:
                    seen.append(t)
        return tuple(seen)

    @property
    def num_conv_layers(self) -> int:
        return (self.n_layers - 1) if self.embedding_layer else self.n_layers

    def embed_features(self, h: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Per-ntype feature projection (reference src/model.py:462-466)."""
        return {nt: self.embed[nt](x) if nt in self.embed else x for nt, x in h.items()}

    def _one_etype(self, layer: ConvLayer, graph: HeteroGraph,
                   etype: CanonicalEtype, h: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Aggregate + combine for one etype; returns z for the dst nodes."""
        src_t, _, dst_t = etype
        rel = graph.rels[etype]
        h_src = layer.transform_src(h[src_t])
        # *_edge variants weight by occurrence on user-item etypes only.
        edge_weight = None
        if (layer.edge_weighted and src_t in ("user", "item")
                and dst_t in ("user", "item") and "occurrence" in rel.edata):
            edge_weight = rel.edata["occurrence"]
        segment = coo_segment_max if layer.reducer == "max" else coo_segment_mean
        agg = segment(h_src, rel.src, rel.dst, graph.num_nodes(dst_t), edge_weight)
        return layer.combine(h[dst_t], agg)

    def _cross_etype_reduce(self, zs: torch.Tensor) -> torch.Tensor:
        """Reduce the stacked per-etype outputs of one dst ntype."""
        if self.aggregator_hetero == "sum":
            return zs.sum(dim=0)
        if self.aggregator_hetero == "mean":
            return zs.mean(dim=0)
        return zs.amax(dim=0)

    def hetero_conv_step(self, layer_idx: int, graph: HeteroGraph,
                         h: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """One HeteroGraphConv step over the full graph."""
        layer_dict = self.layers[layer_idx]
        per_dst: Dict[str, list] = {}
        for etype in graph.canonical_etypes:
            key = _etype_key(etype)
            if key not in layer_dict or etype[0] not in h or etype[2] not in h:
                continue
            per_dst.setdefault(etype[2], []).append(
                self._one_etype(layer_dict[key], graph, etype, h)
            )
        return {dst: self._cross_etype_reduce(torch.stack(zs)) for dst, zs in per_dst.items()}

    def get_repr(self, graph: HeteroGraph,
                 h: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """All conv layers, full-graph layer-wise (reference src/model.py:415-421
        with blocks == the whole graph)."""
        for i in range(len(self.layers)):
            h = self.hetero_conv_step(i, graph, h)
        return h

    def forward(self, graph: HeteroGraph,
                features: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Embeddings of every node: feature projection, then all conv layers."""
        return self.get_repr(graph, self.embed_features(features))
