"""Hetero GraphSAGE-style model: full-graph and sampled-tree paths.

Port of ``ConvModel`` (``gnn_recsys_tpu/models/conv_model.py``): an
optional per-ntype embedding Linear, a stack of per-etype
:class:`ConvLayer`\\ s with a cross-etype reduction (``sum``, ``mean`` or
``max``), and the cosine or MLP predictor (``pred='cos'`` / ``'nn'``).
``get_repr`` runs the whole graph layer by layer (``forward``: every
node's embedding; ``full_pass``: the JAX ``__call__``, embeddings and the
scores of given pairs); ``sampled_repr`` / ``minibatch_forward`` expand static-shape
sampled trees of global node ids (one independent sample per occurrence,
the JAX package's ``dedup=False`` tree) or, with ``dedup=True``, the dedup'd
block forward (each level's unique nodes computed once).  The ``lstm``
aggregators run on all three routes through the layer's masked LSTM;
``remat_levels`` recomputes each tree level in the backward
(``torch.utils.checkpoint``).  The tree takes the sharded hooks of the
multi-device steps (``feature_lookup``, ``neighbor_sample``;
``parallel/sharded.py``).

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
from torch.utils.checkpoint import checkpoint

from gnn_recsys_tpu_torch.graph.hetero import CanonicalEtype, HeteroGraph
from gnn_recsys_tpu_torch.models.layers import (
    AGGREGATOR_TYPES,
    ConvLayer,
    NodeEmbedding,
    PredictingLayer,
    dense,
    dropout_keep_mask,
    l2_normalize,
)
from gnn_recsys_tpu_torch.ops.cuda.gather_mean import SlotTranspose, gather_mean
from gnn_recsys_tpu_torch.ops.cuda.leaf_agg import leaf_kernel_supported, leaf_mean_nn
from gnn_recsys_tpu_torch.ops.message import coo_segment_max, coo_segment_mean, edge_dot
from gnn_recsys_tpu_torch.ops.sampling import (
    UniquePlan,
    exclusion_table,
    full_neighbors_packed,
    sample_neighbors,
    unique_plan,
)
from gnn_recsys_tpu_torch.utils.profiling import span

# Edge pairs per etype: (src ids, dst ids).
PairDict = Dict[CanonicalEtype, Tuple[torch.Tensor, torch.Tensor]]


def _etype_key(etype: CanonicalEtype) -> str:
    return "__".join(etype)


def _take_rows(table: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """``table[pos]`` for in-range positions of any shape, through
    ``index_select``: its backward is an ``index_add_``, where advanced
    indexing's (a sort, then one warp a destination row) took 12.5 ms of a
    dedup'd step's device time on the H100 (PERF.md)."""
    return table.index_select(0, pos.reshape(-1).long()).reshape(*pos.shape, table.shape[-1])


def _exclusion_kwargs(excl) -> Dict[str, torch.Tensor]:
    """One translated exclusion entry as a ``sample_neighbors`` argument:
    2-D = sign-marked neighbour table, 1-D = positional bool flags."""
    if excl is None:
        return {}
    return {"nbr_table": excl} if excl.dim() == 2 else {"exclude_flags": excl}


class RowTransform:
    """A per-row map of the tree (a leaf's embed, or its composed embed and
    ``fc_preagg``) handed to a ``feature_lookup`` hook, which applies it
    where the rows are: ``fn(model, rows)``.  :meth:`on` binds the same map
    to another copy of the model (a replica on the rows' owner device)."""

    def __init__(self, model: "ConvModel", fn):
        self.model, self.fn = model, fn

    def __call__(self, rows: torch.Tensor) -> torch.Tensor:
        return self.fn(self.model, rows)

    def on(self, model: "ConvModel") -> "RowTransform":
        return RowTransform(model, self.fn)


class _LevelTape:
    """The random numbers of one rematerialised tree level.  The forward
    takes them from ``draws`` and keeps them; each recompute in the backward
    hands the same ones out again, in the same order, so that the level
    recomputes the values of its forward: the samplers' uniforms, and the
    keep masks of its dropouts (:meth:`keep_mask`, drawn by
    :func:`~gnn_recsys_tpu_torch.models.layers.dropout_keep_mask` as the
    plain step draws them, from PyTorch's default generator, whose state is
    never read: a CUDA graph captures the draws).  An inner level's tape
    takes its numbers from the outer one's."""

    def __init__(self, draws):
        self.draws = draws
        self.taken: List[torch.Tensor] = []
        self.pos: Optional[int] = None  # -1: recording; else the next to replay

    def rewind(self) -> "_LevelTape":
        """Start a run of the level: the first records, later ones replay."""
        self.pos = -1 if self.pos is None else 0
        return self

    def _take(self, make) -> torch.Tensor:
        if self.pos == -1:
            out = make()
            self.taken.append(out)
            return out
        out = self.taken[self.pos]
        self.pos += 1
        return out

    def uniform(self, shape: Sequence[int]) -> torch.Tensor:
        return self._take(lambda: self.draws.uniform(shape))

    def keep_mask(self, like: torch.Tensor, p: float) -> torch.Tensor:
        source = getattr(self.draws, "keep_mask", None) or dropout_keep_mask
        return self._take(lambda: source(like, p))


class ConvModel(nn.Module):
    """Full hetero message-passing model.

    ``dims`` is the reference's ``dim_dict`` as (name, dim) pairs: one entry
    per node type (its feature width) plus ``hidden`` and ``out``.  Weights
    are drawn from ``generator`` (a fresh ``torch.Generator`` seeded 0 when
    None) with the JAX package's init rules.

    ``dtype`` is the computation dtype (the JAX package's ``conv_model.py:103-106``): None
    (or ``torch.float32``, stored as None) computes in f32; ``torch.bfloat16`` runs every Linear, the message
    reductions, the row norms and the cross-etype reduction in bf16 (flax's
    ``Dense(dtype=...)`` semantics, :func:`~gnn_recsys_tpu_torch.models.
    layers.dense`), while the parameters (and so Adam's state) stay f32 and
    the scores leave the model as f32.  The full-graph mean sums in f32
    (``ops/message.py``).

    ``remat_levels`` (the JAX package's ``conv_model.py:454-497``) wraps
    each sampled-tree level above the leaves in a non-reentrant
    ``torch.utils.checkpoint`` when autograd records: the backward
    recomputes a level from its id frontier instead of keeping its
    activations.  The recompute replays the level's draws and dropout masks
    (:class:`_LevelTape`), so the loss and gradients are the plain tree's.

    ``leaf_kernel`` runs the folded ``*_nn`` mean leaf of the sampled tree
    through the fused :func:`~gnn_recsys_tpu_torch.ops.cuda.leaf_agg.leaf_mean_nn`
    (a CUDA kernel for CUDA tensors, its plain version on the CPU);
    ``leaf_block`` bounds the parents one block of its backward sums.
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
        remat_levels: bool = False,
        leaf_kernel: bool = False,
        leaf_block: int = 512,
        dtype: Optional[torch.dtype] = None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        if aggregator_type not in AGGREGATOR_TYPES:
            raise KeyError(f"Aggregator type {aggregator_type} not recognized.")
        if pred not in ("cos", "nn"):
            raise KeyError(f"Prediction function {pred} not recognized.")
        if aggregator_hetero not in ("sum", "mean", "max"):
            raise KeyError(f"Cross-etype aggregator {aggregator_hetero} not recognized.")
        if dtype not in (None, torch.float32, torch.bfloat16):
            raise ValueError(f"computation dtype {dtype} is neither None, f32 nor bf16")
        dtype = None if dtype == torch.float32 else dtype  # one f32 path: nn.Linear's
        self.dtype = dtype
        self.remat_levels = remat_levels
        self.leaf_kernel = leaf_kernel
        self.leaf_block = leaf_block
        self._leaf_weights: Optional[Dict] = None  # set during a sampled_repr walk
        self._hooks = (None, None)  # (feature_lookup, neighbor_sample) of a walk
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
                self.embed[nt] = NodeEmbedding(dim[nt], dim["hidden"], dtype=dtype)
                self.add_module(f"{nt}_embed", self.embed[nt])

        def conv_dict(idx: int, in_dims: Dict[str, int], out_feats: int):
            layer = {}
            for et in self.canonical_etypes:
                layer[_etype_key(et)] = ConvLayer(
                    in_neigh_feats=in_dims[et[0]], in_self_feats=in_dims[et[2]],
                    out_feats=out_feats, aggregator_type=aggregator_type,
                    dropout=dropout, norm=norm, dtype=dtype,
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
        if pred == "nn":  # the MLP head on concat(u, i)
            self.pred_layer = PredictingLayer(2 * dim["out"], dtype=dtype)
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
        if layer.reducer == "lstm":
            # The LSTM reads ordered mailboxes: the padded CSC rows, -1
            # padding clipped before the gather and zeroed by the mask.
            msgs = _take_rows(h_src, rel.nbr.clamp(min=0))
            if edge_weight is not None:
                msgs = msgs * edge_weight.to(msgs.dtype)[rel.nbr_eid.long()][..., None]
            agg = self._reduce(layer, msgs, rel.nbr_mask)
        else:
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
        """Embeddings of every node: feature projection, then all conv layers.
        (The JAX model's ``__call__`` also scores pairs: :meth:`full_pass`.)"""
        return self.get_repr(graph, self.embed_features(features))

    def full_pass(self, graph: HeteroGraph, features: Dict[str, torch.Tensor],
                  pos_pairs: PairDict, neg_pairs: PairDict):
        """The full-batch pass, the JAX model's ``__call__``
        (``conv_model.py:1190-1204``; reference ``ConvModel.forward``,
        src/model.py:423-470): embed, every conv layer over the whole graph,
        then the scores of the positive and negative pairs.  Returns (h,
        pos_score, neg_score).  Dropout follows ``self.training``."""
        h = self(graph, features)
        return h, self.score_pairs(h, pos_pairs), self.score_pairs(h, neg_pairs)

    # ------------------------------------------------------------------
    # Sampled-tree minibatch forward
    # ------------------------------------------------------------------
    def sampled_repr(self, graph: HeteroGraph, features: Dict[str, torch.Tensor],
                     seeds: Dict[str, torch.Tensor], fanouts: Sequence[int], draws,
                     exclude_eids: Optional[Dict[CanonicalEtype, torch.Tensor]] = None,
                     dedup: bool = False, feature_lookup=None,
                     neighbor_sample=None) -> Dict[str, torch.Tensor]:
        """Minibatch representations over sampled trees
        (``conv_model.py:310-428``): level ``l`` samples ``fanouts[l-1]``
        neighbours of every frontier node (-1: the whole padded row), depth
        equals the number of conv layers, and every gather reads the global
        graph and feature tables.

        seeds: ntype -> int ids of any shape; ``draws`` gives the uniform
        draws of every sampler call, in walk order (:mod:`.ops.sampling`); a
        draw source with a ``for_seeds(ntype)`` method hands each seed
        type's tree its own view of the draws.
        exclude_eids: etype -> edge ids kept out of the sampled
        neighbourhoods (translated once into sign-marked tables), or an
        already translated table / flag array.  ``dedup``: the dedup'd block
        forward (:meth:`_sampled_repr_dedup`) instead of the tree.  Dropout
        follows ``self.training``.  Returns ntype -> [*seed_shape, out_dim].

        The hooks of the multi-device steps (``parallel/sharded.py``; tree
        route only, and they bypass ``remat_levels``):

        * ``feature_lookup(ntype, flat_ids[, row_transform])`` replaces every
          raw feature read.  For the node types in its attribute
          ``transform_ntypes`` (a set; none by default) the tree hands it the
          per-row map that follows the read (a :class:`RowTransform`: the
          leaf's embed, or the composed leaf transform), and the hook must
          return the transformed rows.  The leaf kernel and the packed leaf
          cache read local tables and are not used with it.
        * ``neighbor_sample(etype, ids, fanout, u, mode, with_eids, excl)``
          replaces ``sample_neighbors`` for the etypes in its attribute
          ``etypes``; ``u`` are the draws the local sampler would have taken
          (None at fanout -1), ``excl`` the exclusion entry untranslated (the
          batch's edge ids: marking its own rows is the hook's job).
        """
        if len(fanouts) != len(self.layers):
            raise ValueError(f"fanouts has {len(fanouts)} entries, model has "
                             f"{len(self.layers)} conv layers")
        hook_etypes = (frozenset(getattr(neighbor_sample, "etypes", ()))
                       if neighbor_sample is not None else frozenset())
        if exclude_eids is not None:
            exclude_eids = {
                et: (exclusion_table(graph.rels[et], v)
                     if v.dim() == 1 and v.dtype != torch.bool and et in graph.rels
                     and et not in hook_etypes else v)
                for et, v in exclude_eids.items()
            }
        if dedup:
            if feature_lookup is not None or neighbor_sample is not None:
                raise ValueError("feature_lookup/neighbor_sample are supported on the tree path only")
            return self._sampled_repr_dedup(graph, features, seeds, tuple(fanouts), draws,
                                            exclude_eids)
        # Composed leaf weights, once per (layer, etype) for the whole walk;
        # a rematerialised level computes its own (its recompute must run
        # the ops its forward ran).
        self._leaf_weights = None if self.remat_levels else {}
        self._hooks = (feature_lookup, neighbor_sample)
        views = getattr(draws, "for_seeds", None)
        try:
            return {nt: self._tree(graph, features, exclude_eids, tuple(fanouts),
                                   len(self.layers), nt, ids,
                                   draws if views is None else views(nt))
                    for nt, ids in seeds.items()}
        finally:
            self._leaf_weights = None
            self._hooks = (None, None)

    def _tree(self, graph, features, exclude_eids, fanouts, level, ntype, ids, draws):
        """One tree level on the flattened frontier, reshaped back; with
        ``remat_levels``, above the leaves and while autograd records,
        through a checkpoint that replays the level's random numbers."""
        args = (graph, features, exclude_eids, fanouts, level, ntype)
        hooked = self._hooks != (None, None)
        if self.remat_levels and level > 0 and torch.is_grad_enabled() and not hooked:
            tape = _LevelTape(draws)
            out = checkpoint(lambda flat: self._tree_level(*args, flat, tape.rewind()),
                             ids.reshape(-1), use_reentrant=False, preserve_rng_state=False)
        else:
            out = self._tree_level(*args, ids.reshape(-1), draws)
        return out.reshape(*ids.shape, out.shape[-1])

    def _fetch_rows(self, features, ntype: str, ids: torch.Tensor) -> torch.Tensor:
        """Raw feature rows of the 1-D ``ids``, through the walk's
        ``feature_lookup`` hook where there is one."""
        lookup = self._hooks[0]
        if lookup is not None:
            return lookup(ntype, ids)
        table = features[ntype]
        return table[ids.long().clamp(0, table.shape[0] - 1)]

    def _pushes_transform(self, ntype: str) -> bool:
        """Whether the walk's lookup hook applies the row maps of ``ntype``."""
        lookup = self._hooks[0]
        return lookup is not None and ntype in getattr(lookup, "transform_ntypes", ())

    def _no_dropout(self, layer: ConvLayer) -> bool:
        return layer.dropout_p == 0.0 or not self.training

    def _can_fold_leaf(self, layer: ConvLayer, src_ntype: str, level: int) -> bool:
        """Whether the leaf's embed + fc_preagg pair folds into one affine
        map (``conv_model.py:499``): both are affine when dropout is off."""
        return (level == 1 and self.embedding_layer and src_ntype in self.embed
                and layer.aggregator_type in ("mean_nn", "mean_nn_edge", "pool_nn",
                                              "pool_nn_edge")
                and self._no_dropout(layer))

    def _composed_leaf_weights(self, layer: ConvLayer, src_ntype: str, d_raw: int,
                               dtype) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(W_eff [d_raw, H], b_eff [H])`` of embed + fc_preagg, by probing
        each module at basis points (``conv_model.py:522-544``): the rows of
        ``embed([0; I])`` are ``[b1; W1 + b1]``, so ``W_eff = ((W1 + b1) -
        b1) @ W2`` as the JAX package computes it (not ``W1 @ W2``).  Within
        one ``sampled_repr`` walk each pair is computed once."""
        key = (id(layer), src_ntype, d_raw, dtype)
        cache = self._leaf_weights
        if cache is not None and key in cache:
            return cache[key]
        dev = layer.fc_preagg.weight.device
        probe = torch.cat([torch.zeros((1, d_raw), dtype=dtype, device=dev),
                           torch.eye(d_raw, dtype=dtype, device=dev)])
        eb = self.embed[src_ntype](probe)
        w2 = dense(layer.fc_preagg, torch.eye(eb.shape[-1], dtype=eb.dtype, device=dev),
                   layer.dtype)  # [H, H]
        out = ((eb[1:] - eb[0]) @ w2, eb[0] @ w2)
        if cache is not None:
            cache[key] = out
        return out

    def _leaf_transform_composed(self, layer, src_ntype: str, raw: torch.Tensor) -> torch.Tensor:
        """``relu(fc_preagg(embed(raw)))`` through the composed weights."""
        w_eff, b_eff = self._composed_leaf_weights(layer, src_ntype, raw.shape[-1], raw.dtype)
        return torch.relu(raw.to(w_eff.dtype) @ w_eff + b_eff)

    @staticmethod
    def _edge_weighted(layer: ConvLayer, etype: CanonicalEtype, rel) -> bool:
        """``*_edge`` variants weight by occurrence on user-item etypes only."""
        return (layer.edge_weighted and etype[0] in ("user", "item")
                and etype[2] in ("user", "item") and "occurrence" in rel.edata)

    def _tree_level(self, graph, features, exclude_eids, fanouts, level, ntype, ids, draws):
        """``conv_model.py:566-850``: the self branch first, then each
        in-etype in ``graph.canonical_etypes`` order, sampled and then
        recursed into; ``ids`` is 1-D.  A :class:`_LevelTape` as ``draws``
        also supplies the dropout masks."""
        if level == 0:
            if self.embedding_layer and ntype in self.embed and self._pushes_transform(ntype):
                return self._hooks[0](ntype, ids, RowTransform(
                    self, lambda m, x, nt=ntype: m.embed[nt](x)))
            x = self._fetch_rows(features, ntype, ids)
            if self.embedding_layer and ntype in self.embed:
                x = self.embed[ntype](x)
            return x
        layer_dict = self.layers[level - 1]
        fanout = fanouts[level - 1]
        in_etypes = [et for et in graph.canonical_etypes
                     if et[2] == ntype and _etype_key(et) in layer_dict]
        if not in_etypes:
            raise ValueError(f"node type {ntype} has no incoming etypes")
        h_self = self._tree(graph, features, exclude_eids, fanouts, level - 1, ntype, ids, draws)
        keep_mask = getattr(draws, "keep_mask", None)
        lookup, sampler = self._hooks
        hook_etypes = getattr(sampler, "etypes", ()) if sampler is not None else ()
        zs = []
        for etype in in_etypes:
            layer = layer_dict[_etype_key(etype)]
            rel = graph.rels[etype]
            excl = None if exclude_eids is None else exclude_eids.get(etype)
            need_eid = self._edge_weighted(layer, etype, rel)
            raw_packed = None
            if etype in hook_etypes:
                # Sharded adjacency: the hook fetches the frontier's rows from
                # their owners and samples them with the same draws.
                u = None if fanout == -1 else draws.uniform((*ids.shape, fanout))
                nbr, eid, mask = sampler(etype, ids, max(fanout, 1), u,
                                         "full" if fanout == -1 else "uniform", need_eid, excl)
            elif (level == 1 and fanout == -1 and rel.nbr_feat is not None and not need_eid
                    and (excl is None or excl.dim() == 2) and lookup is None):
                # The packed leaf cache: every neighbour's raw features in one
                # row read a node (``conv_model.py:645-678``).
                raw_packed, mask = full_neighbors_packed(rel, ids, nbr_table=excl)
                nbr = eid = None
            else:
                u = None if fanout == -1 else draws.uniform((*ids.shape, fanout))
                nbr, eid, mask = sample_neighbors(
                    rel, ids, max(fanout, 1), u=u, mode="full" if fanout == -1 else "uniform",
                    with_eids=need_eid, **_exclusion_kwargs(excl))
            agg = self._aggregate(graph, features, exclude_eids, fanouts, level, etype, layer,
                                  rel, nbr, eid, mask, need_eid, draws, raw_packed)
            zs.append(layer.combine(h_self, agg, keep_mask))
        return self._cross_etype_reduce(torch.stack(zs))

    def _aggregate(self, graph, features, exclude_eids, fanouts, level, etype, layer, rel,
                   nbr, eid, mask, need_eid, draws, raw_packed=None) -> torch.Tensor:
        """The neighbour aggregate of one sampled etype branch; ``raw_packed``
        [P, K, F] are the leaf's raw features from the packed cache (then
        ``nbr`` is None)."""
        src_t = etype[0]
        keep_mask = getattr(draws, "keep_mask", None)

        def raw_rows():
            if raw_packed is not None:
                return raw_packed
            return self._fetch_rows(features, src_t, nbr.reshape(-1)).reshape(*nbr.shape, -1)

        if (level == 1 and self.embedding_layer and src_t in self.embed
                and layer.aggregator_type == "mean" and self._no_dropout(layer)):
            # Plain 'mean': the affine embed commutes with the masked mean, so
            # average the raw features and embed once per node; zero-degree
            # rows stay 0 (``conv_model.py:689-717``).
            raw = raw_rows()
            count = mask.to(raw.dtype).sum(dim=-1)
            s = (raw * mask[..., None].to(raw.dtype)).sum(dim=-2) / count.clamp(min=1.0)[..., None]
            agg = self.embed[src_t](s)
            return agg * (count > 0)[..., None].to(agg.dtype)
        lookup = self._hooks[0]
        if (self.leaf_kernel and raw_packed is None and not need_eid and layer.reducer == "mean"
                and lookup is None and self._can_fold_leaf(layer, src_t, level)
                and leaf_kernel_supported(features[src_t].shape[-1])):
            # The fused leaf: gather k-major, then one kernel computes the
            # masked mean of relu(x @ W_eff + b_eff) without the [P, K, H]
            # per-message activations (``conv_model.py:718-759``).
            w_eff, b_eff = self._composed_leaf_weights(layer, src_t, features[src_t].shape[-1],
                                                       self.dtype or torch.float32)
            kf = nbr.shape[-1]
            pkids = nbr.reshape(-1, kf)  # [P, K] parent-major ids
            p0 = pkids.shape[0]
            x = self._fetch_rows(features, src_t, pkids.T.reshape(-1))  # k-major
            x_km = x.to(w_eff.dtype).reshape(kf, p0, -1)
            maskf = mask.reshape(p0, kf).float()
            mask_scaled = maskf / maskf.sum(dim=1, keepdim=True).clamp(min=1.0)
            agg = leaf_mean_nn(x_km, mask_scaled, w_eff, b_eff, self.leaf_block)
            return agg.reshape(*nbr.shape[:-1], agg.shape[-1])
        if self._can_fold_leaf(layer, src_t, level):
            if raw_packed is None and self._pushes_transform(src_t):
                # The composed leaf transform applied where the rows are.
                key = _etype_key(etype)
                msgs = lookup(src_t, nbr.reshape(-1), RowTransform(
                    self, lambda m, x, lvl=level, key=key, nt=src_t:
                    m._leaf_transform_composed(m.layers[lvl - 1][key], nt, x)))
                msgs = msgs.reshape(*nbr.shape, msgs.shape[-1])
            else:
                msgs = self._leaf_transform_composed(layer, src_t, raw_rows())
        elif level == 1:
            # The leaf's rows, from the packed cache or gathered: the level-0
            # chain (embed if any), then transform_src.
            x = raw_rows()
            if self.embedding_layer and src_t in self.embed:
                x = self.embed[src_t](x)
            msgs = layer.transform_src(x, keep_mask)
        else:
            h_nbr = self._tree(graph, features, exclude_eids, fanouts, level - 1, src_t, nbr,
                               draws)
            msgs = layer.transform_src(h_nbr, keep_mask)
        if need_eid:
            w = rel.edata["occurrence"].to(msgs.dtype)[eid.long()]
            msgs = msgs * w[..., None]
        return self._reduce(layer, msgs, mask)

    @staticmethod
    def _reduce(layer: ConvLayer, msgs: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """The layer's masked reduction over the slot axis of ``msgs``
        [..., K, D]: the mean over valid slots, the max (0 without one), or
        the LSTM's final state over the slots, masked ones zeroed and
        skipped."""
        if layer.reducer == "lstm":
            k, d = msgs.shape[-2:]
            flat = torch.where(mask[..., None], msgs, torch.zeros_like(msgs)).reshape(-1, k, d)
            agg = layer.lstm(flat, mask.reshape(-1, k))
            return agg.reshape(*msgs.shape[:-2], agg.shape[-1])
        if layer.reducer == "mean":
            total = (msgs * mask[..., None].to(msgs.dtype)).sum(dim=-2)
            count = mask.to(msgs.dtype).sum(dim=-1)
            return total / count.clamp(min=1.0)[..., None]
        neg = torch.full_like(msgs, float("-inf"))
        agg = torch.where(mask[..., None], msgs, neg).amax(dim=-2)
        return torch.where(torch.isfinite(agg), agg, torch.zeros_like(agg))

    # ------------------------------------------------------------------
    # Dedup'd block forward
    # ------------------------------------------------------------------
    def _sampled_repr_dedup(self, graph, features, seeds, fanouts, draws,
                            exclude_eids) -> Dict[str, torch.Tensor]:
        """Unique-frontier (DGL-block-style) sampled forward
        (``conv_model.py:852-1040``), in two passes with static shapes:

        1. top-down: each level's frontier is deduplicated into a unique id
           table of static capacity (:func:`unique_plan`), each unique node's
           neighbours are sampled once, and the positions of the self and
           neighbour ids in the next level's table are kept;
        2. bottom-up: each level computes over its unique nodes only, with the
           etype's ``transform_src`` applied to the unique source table before
           the gather (per-node maps commute with the gather).  The mean
           without edge weights is the gather-mean kernel
           (:func:`~gnn_recsys_tpu_torch.ops.cuda.gather_mean.gather_mean`),
           whose backward walks the lower frontier's sort from step 1 (a
           :class:`~gnn_recsys_tpu_torch.ops.cuda.gather_mean.SlotTranspose`
           of the gather's segment, up to its table's unique count);
           edge-weighted means and ``max`` are plain PyTorch.

        Draw order, the JAX package's, so that its draws replay: one draw per
        (level from the top; ntype in the order of that level's table dict;
        in-etype in ``graph.canonical_etypes`` order), of shape ``(cap,
        fanout)``, none at fanout -1.  ``cap`` is ``min(frontier size,
        num_nodes)`` rounded up to a multiple of 8 (at least 8), and the
        table's padding rows (id 0) are sampled too: they use up draws and
        compute rows that nothing reads.  The top table's dict follows
        ``seeds``; a lower table's follows the order its segments were
        pushed: per ntype of the level above, its own ids first, then each
        in-etype's sampled neighbours.
        """
        n_layers = len(self.layers)

        def cap_for(nt: str, n: int) -> int:
            cap = min(n, graph.num_nodes(nt))
            return max(8, -(-cap // 8) * 8)

        def uniqify(frontier: Dict[str, list], transposed=()) -> Dict[str, UniquePlan]:
            out = {}
            for nt, segs in frontier.items():
                flat = torch.cat(segs)
                out[nt] = unique_plan(flat, cap_for(nt, flat.shape[0]), nt in transposed)
            return out

        tables: List[Optional[Dict[str, UniquePlan]]] = [None] * (n_layers + 1)
        tables[n_layers] = uniqify({nt: [ids.reshape(-1)] for nt, ids in seeds.items()})
        plans: List[Optional[Dict]] = [None] * n_layers
        for lvl in range(n_layers, 0, -1):
            fanout = fanouts[lvl - 1]
            layer_dict = self.layers[lvl - 1]
            frontier: Dict[str, list] = {}
            gathered = set()  # lower node types that a gather-mean reads

            def push(nt: str, arr: torch.Tensor):
                segs = frontier.setdefault(nt, [])
                off = sum(s.numel() for s in segs)
                segs.append(arr.reshape(-1))
                return nt, off, arr.numel()

            plan = {}
            for nt, table in tables[lvl].items():
                uids = table.uniq
                in_etypes = [et for et in graph.canonical_etypes
                             if et[2] == nt and _etype_key(et) in layer_dict]
                if not in_etypes:
                    raise ValueError(f"node type {nt} has no incoming etypes")
                entry = {"self_ref": push(nt, uids), "etypes": {}}
                for et in in_etypes:
                    layer, rel = layer_dict[_etype_key(et)], graph.rels[et]
                    excl = None if exclude_eids is None else exclude_eids.get(et)
                    need_eid = self._edge_weighted(layer, et, rel)
                    u = None if fanout == -1 else draws.uniform((uids.shape[0], fanout))
                    nbr, eid, mask = sample_neighbors(
                        rel, uids, max(fanout, 1), u=u,
                        mode="full" if fanout == -1 else "uniform", with_eids=need_eid,
                        **_exclusion_kwargs(excl))
                    gather = layer.reducer == "mean" and not need_eid
                    if gather:
                        gathered.add(et[0])
                    entry["etypes"][et] = {"ref": push(et[0], nbr), "shape": nbr.shape,
                                           "mask": mask, "eid": eid, "gather": gather}
                plan[nt] = entry
            lower = uniqify(frontier, gathered)
            for nt, entry in plan.items():
                nt0, off, ln = entry["self_ref"]
                entry["self_pos"] = lower[nt0].inv[off:off + ln]
                for ed in entry["etypes"].values():
                    nt0, off, ln = ed["ref"]
                    ed["nbr_pos"] = lower[nt0].inv[off:off + ln].reshape(ed["shape"])
                    if ed["gather"]:
                        # The backward walks this gather's segment of the lower
                        # frontier's sort, up to its table's unique count.
                        ed["transpose"] = SlotTranspose(lower[nt0].order, lower[nt0].start, off,
                                                        tables[lvl][nt].count)
            tables[lvl - 1] = lower
            plans[lvl - 1] = plan

        keep_mask = getattr(draws, "keep_mask", None)
        h = {}
        for nt, table in tables[0].items():
            x = self._fetch_rows(features, nt, table.uniq)
            h[nt] = self.embed[nt](x) if self.embedding_layer and nt in self.embed else x
        for lvl in range(1, n_layers + 1):
            layer_dict = self.layers[lvl - 1]
            h_next = {}
            for nt, entry in plans[lvl - 1].items():
                h_self = _take_rows(h[nt], entry["self_pos"])
                zs = []
                for et, ed in entry["etypes"].items():
                    layer, rel = layer_dict[_etype_key(et)], graph.rels[et]
                    src_table = layer.transform_src(h[et[0]], keep_mask)
                    nbr_pos, mask = ed["nbr_pos"], ed["mask"]
                    if ed["gather"]:
                        agg = gather_mean(src_table, nbr_pos, mask, ed["transpose"])
                    else:
                        msgs = _take_rows(src_table, nbr_pos)
                        if self._edge_weighted(layer, et, rel):
                            w = rel.edata["occurrence"].to(msgs.dtype)[ed["eid"].long()]
                            msgs = msgs * w[..., None]
                        agg = self._reduce(layer, msgs, mask)
                    zs.append(layer.combine(h_self, agg, keep_mask))
                h_next[nt] = self._cross_etype_reduce(torch.stack(zs))
            h = h_next
        return {nt: _take_rows(h[nt], tables[n_layers][nt].inv.reshape(seeds[nt].shape))
                for nt in seeds}

    # ------------------------------------------------------------------
    # Scoring
    # ------------------------------------------------------------------
    def score_emb_pairs(self, emb_u: torch.Tensor, emb_v: torch.Tensor) -> torch.Tensor:
        """Scores of embedding pairs on the last axis, shapes broadcast
        (``conv_model.py:1045-1062``): cosine, or the MLP head on the concat
        (reference src/model.py:317-327, 275-305).  f32.  The head runs in
        a ``gnn.pred.score`` span."""
        if self.pred == "cos":
            return (l2_normalize(emb_u) * l2_normalize(emb_v)).sum(dim=-1).float()
        with span("gnn.pred.score"):
            u, v = torch.broadcast_tensors(emb_u, emb_v)
            return self.pred_layer(torch.cat([u, v], dim=-1))[..., 0].float()

    def score_pairs(self, h: Dict[str, torch.Tensor], pairs: PairDict) -> Dict:
        """Scores of (src, dst) node-id pairs per etype (``conv_model.py:1159-1188``):
        cosine as ``edge_dot`` of the L2-normalised tables, or the MLP head on
        the gathered concat (in a ``gnn.pred.score`` span).  Id tensors may
        have any shape; the f32 scores keep it."""
        out = {}
        for etype, (src_ids, dst_ids) in pairs.items():
            hu, hv = h[etype[0]], h[etype[2]]
            src, dst = src_ids.reshape(-1), dst_ids.reshape(-1)
            if self.pred == "cos":
                scores = edge_dot(l2_normalize(hu), l2_normalize(hv), src, dst)
            else:
                with span("gnn.pred.score"):
                    x = torch.cat([_take_rows(hu, src), _take_rows(hv, dst)], dim=-1)
                    scores = self.pred_layer(x).reshape(-1)
            out[etype] = scores.reshape(src_ids.shape).float()
        return out

    def minibatch_forward(self, graph: HeteroGraph, features: Dict[str, torch.Tensor],
                          batch: PairDict, neg_pool: torch.Tensor,
                          neg_idx: Dict[CanonicalEtype, Optional[torch.Tensor]],
                          fanouts: Sequence[int], draws,
                          exclude_eids: Optional[Dict[CanonicalEtype, torch.Tensor]] = None,
                          dedup: bool = False, feature_lookup=None, neighbor_sample=None):
        """Sampled-tree forward and scoring of one minibatch
        (``conv_model.py:1064-1157``).

        batch: etype -> (pos_u [B], pos_i [B]); neg_pool: [P] item ids;
        neg_idx: etype -> [B, S] indices into the pool, or None to score the
        whole pool (dense pool: one [B, P] product).
        Returns (pos_scores, neg_scores, neg_dsts), dicts per etype.
        """
        etypes = list(batch)
        pos_us = [batch[et][0].long() for et in etypes]
        pos_is = [batch[et][1].long() for et in etypes]
        reprs = self.sampled_repr(
            graph, features,
            {"user": torch.cat(pos_us), "item": torch.cat(pos_is + [neg_pool.long()])},
            fanouts, draws, exclude_eids=exclude_eids, dedup=dedup,
            feature_lookup=feature_lookup, neighbor_sample=neighbor_sample)
        offsets = [0]
        for p in pos_us:
            offsets.append(offsets[-1] + p.shape[0])
        pool_emb = reprs["item"][offsets[-1]:]
        pool_norm = l2_normalize(pool_emb) if self.pred == "cos" else None
        pos_scores, neg_scores, neg_dsts = {}, {}, {}
        for j, et in enumerate(etypes):
            lo, hi = offsets[j], offsets[j + 1]
            ue, ie = reprs["user"][lo:hi], reprs["item"][lo:hi]
            pos_scores[et] = self.score_emb_pairs(ue, ie)
            idx = neg_idx[et]
            if self.pred == "cos":
                scores = (l2_normalize(ue) @ pool_norm.T).float()  # [B, P]
                neg_scores[et] = scores if idx is None else scores.gather(1, idx.long())
            elif idx is None:  # the MLP head on every (positive, pool item)
                with span("gnn.pred.score"):
                    neg_scores[et] = self.pred_layer.score_cross(ue, pool_emb)
            else:
                neg_scores[et] = self.score_emb_pairs(ue[:, None, :], _take_rows(pool_emb, idx))
            neg_dsts[et] = (neg_pool[None, :].expand(hi - lo, -1) if idx is None
                            else neg_pool[idx.long()])
        return pos_scores, neg_scores, neg_dsts
