"""A plain PyTorch reference of the recommender with the learned pair scorer
(``pred='nn'``: hieucnm/GNN-RecSys ``src/model.py:240-305``,
``PredictingLayer`` and ``PredictingModule``; the MLP tower of Neural
Collaborative Filtering, He et al., WWW 2017, arXiv 1708.05031), written
from the model's definition.

It imports nothing of the measured package and reuses the graph, sampler,
tree, products, loss and Adam of :mod:`.model`.  A pair ``(u, i)`` of the
GNN's output rows scores

    s(u, i) = sigmoid(w3 . relu(W2 . relu(W1 . [h_u ; h_i] + b1) + b2) + b3)

with ``W1`` ``[128, 2 out]``, ``W2`` ``[32, 128]``, ``w3`` ``[1, 32]``, as
the reference repository writes it: the concatenation, then three Denses.
It is not factorised, so that it stays independent of any rewrite of the
program's head.  With the dense pool every positive scores against every
pool item through the tower; the loss is the cosine model's max-margin
loss on these scores.

Departures from the program (``gnn_recsys_tpu_torch``), which the limits
of ``correct`` have to hold:

* float32 with TF32 off, against the program's bf16 (each product's
  inputs, weights and output rounded to bf16, every elementwise op in
  bf16, parameters and Adam in f32);
* the sampled tree without dropout and the dense pool only; the program
  also runs the dedup'd block forward, dropout and the shared pool.

``q`` rounds each product's inputs and output (:func:`.model.linear`), so
``q = model.rounding(torch.float8_e4m3fn)`` is the control one precision
below the program's.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch

from portbench.reference import model as ref
from portbench.reference.model import Adam, Graph, contains, linear, max_margin
from portbench.reference.train import Draws, slice_widths

Etype = ref.Etype

HEAD = (("hidden_1", 128), ("hidden_2", 32), ("output", 1))


def param_spec(etypes: Sequence[Etype], feat_dims: Dict[str, int], hidden: int, out: int,
               n_layers: int) -> Dict[str, Tuple[int, ...]]:
    """Name -> shape of every parameter of the ``mean_nn`` model with the MLP
    head, under the program's state-dict names: :func:`.model.param_spec`,
    then the head's three Denses ``pred_layer.<dense>.weight`` ``[out,
    in]`` and ``.bias``."""
    spec = ref.param_spec(etypes, feat_dims, hidden, out, n_layers, "mean_nn")
    d_in = 2 * out
    for name, d_out in HEAD:
        spec[f"pred_layer.{name}.weight"] = (d_out, d_in)
        spec[f"pred_layer.{name}.bias"] = (d_out,)
        d_in = d_out
    return spec


def head_init(P: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """``P`` with the head initialised as the reference initialises it
    (``PredictingLayer.reset_parameters``) from weights drawn
    Xavier-uniform with ReLU gain: the output Dense at gain 1, every bias of
    the head zero."""
    out = dict(P)
    out["pred_layer.output.weight"] = P["pred_layer.output.weight"] / 2.0 ** 0.5
    for name, _ in HEAD:
        out[f"pred_layer.{name}.bias"] = torch.zeros_like(P[f"pred_layer.{name}.bias"])
    return out


def score(P: Dict[str, torch.Tensor], hu: torch.Tensor, hi: torch.Tensor,
          q=ref.identity) -> torch.Tensor:
    """The head's scores of the pairs ``(hu, hi)`` on the last axis, shapes
    broadcast: the concatenation, then the three Denses."""
    u, i = torch.broadcast_tensors(hu, hi)
    x = torch.cat([u, i], dim=-1)
    for name, _ in HEAD[:-1]:
        x = torch.relu(linear(x, P[f"pred_layer.{name}.weight"], P[f"pred_layer.{name}.bias"], q))
    x = linear(x, P["pred_layer.output.weight"], P["pred_layer.output.bias"], q)
    return torch.sigmoid(x)[..., 0]


def run_steps(P0: Dict[str, torch.Tensor], graph: Graph, feats: Dict[str, torch.Tensor],
              train_etypes: Sequence[Etype], epoch_seed: int, step: dict, steps: int,
              q=ref.identity, half_batch: bool = False, frozen: bool = False) -> dict:
    """``steps`` training steps of the ``mean_nn`` model with the MLP head on
    the sampled tree from ``P0``, drawing exactly as :func:`.train.run_steps`
    draws: each step's loss, the first step's gradients and the parameters
    after the last.  ``half_batch`` (a fault): each step's loss keeps only
    the first half of each edge type's positives; ``frozen`` (a fault): no
    update is applied.  Switches TF32 off for the process: every f32
    product stays f32."""
    if step["dedup"] or step["neg_mode"] != "dense_pool":
        raise ValueError("the MLP head's reference runs the sampled tree and the dense pool only")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = graph.nbr[train_etypes[0]].device
    counts = {et: int(graph.src[et].numel()) for et in train_etypes}
    widths, _ = slice_widths(counts, step["edge_batch_size"])
    num_items = graph.num_nodes["item"]
    keys = {et: ref.pair_keys(graph.src[et], graph.dst[et], num_items) for et in train_etypes}
    gen = torch.Generator(device=dev).manual_seed(epoch_seed)
    perms = {et: torch.arange(counts[et], device=dev)[
        torch.randperm(counts[et], generator=gen, device=dev)] for et in train_etypes}
    draws = Draws(gen)
    params = {k: v.detach().clone().requires_grad_(True) for k, v in P0.items()}
    adam = Adam(params, step["lr"])
    losses: List[float] = []
    first_grads: Optional[Dict[str, torch.Tensor]] = None
    fanouts = tuple(step["fanouts"])
    for t in range(steps):
        batch = {}
        for et in train_etypes:
            n = widths[et]
            eids = perms[et][(t * n + torch.arange(n, device=dev)) % counts[et]]
            batch[et] = (graph.src[et][eids], graph.dst[et][eids], eids)
        pool = draws.randint((step["neg_pool_size"],), num_items).long()
        excluded = {}
        for et, (_, _, eids) in batch.items():
            flags = torch.zeros(counts[et], dtype=torch.bool, device=dev)
            flags[eids] = True
            excluded[et] = flags
            if ref.reverse(et) in graph.src:
                excluded[ref.reverse(et)] = flags
        m = ref.Model(params, graph, feats, q)
        users = torch.cat([batch[et][0] for et in train_etypes])
        items = torch.cat([batch[et][1] for et in train_etypes] + [pool])
        hu = m.tree("user", users, len(fanouts), fanouts, draws, excluded)
        hi = m.tree("item", items, len(fanouts), fanouts, draws, excluded)
        hpool = hi[users.shape[0]:]
        pos, neg, fneg, rows = {}, {}, {}, {}
        lo = 0
        for et in train_etypes:
            u, _, _ = batch[et]
            hi_ = lo + u.shape[0]
            pos[et] = score(params, hu[lo:hi_], hi[lo:hi_], q)
            neg[et] = score(params, hu[lo:hi_, None, :], hpool[None, :, :], q)  # [B, P]
            fneg[et] = contains(keys[et], u[:, None], pool[None, :], num_items)
            rows[et] = torch.arange(u.shape[0], device=dev) < u.shape[0] // 2
            lo = hi_
        loss = max_margin(pos, neg, fneg, step["delta"], rows if half_batch else None)
        grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
        if first_grads is None:
            first_grads = {k: g.detach().clone() for k, g in grads.items()}
        if not frozen:
            adam.step(params, grads)
        losses.append(float(loss.detach()))
    return {"losses": losses, "first_grads": first_grads,
            "params": {k: v.detach() for k, v in params.items()}}
