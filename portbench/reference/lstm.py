"""A plain PyTorch reference of the recommender with the LSTM aggregator
(GraphSAGE-LSTM: Hamilton, Ying and Leskovec, "Inductive Representation
Learning on Large Graphs", NeurIPS 2017; hieucnm/GNN-RecSys
``src/model.py:107-121,164-169,210-221``, after DGL's ``SAGEConv``),
written from the model's definition.

It imports nothing of the measured package and reuses the graph, sampler,
products, loss and Adam of :mod:`.model`.  Each conv layer, for each edge
type into a node type, runs an LSTM over the sampled neighbours' rows, one
slot at a time from a zero carry ``(c, h)``, with no pre-MLP::

    gates = x W_ih^T + h W_hh^T + b_hh       (i, f, g, o: [H] each, in order)
    c' = sigmoid(f) c + sigmoid(i) tanh(g)   h' = sigmoid(o) tanh(c')

The carry keeps its value on every slot that is not valid (a sampled edge
of the batch, or of a node with no neighbour), so such slots are skipped,
as DGL's mailbox never holds them; a row with no valid slot gives 0.  The
final ``h`` takes the mean's place in ``relu(W_self h_self + W_neigh h)``,
the row is normalised, and the edge types' outputs are summed.

Departures from the program (``gnn_recsys_tpu_torch``), which the limits
of ``correct`` have to hold:

* float32 with TF32 off, against the program's bf16 (each product's
  inputs, weights and output rounded to bf16, every elementwise op in
  bf16, parameters and Adam in f32);
* ``torch.sigmoid`` for the gates, against the program's ``gate_sigmoid``
  (``1 / (1 + exp(-x))`` with each op rounded to bf16);
* the sampled tree without dropout only; the program also runs the dedup'd
  block forward and dropout.

``q`` rounds each product's inputs and output (:func:`.model.linear`), so
``q = model.rounding(torch.float8_e4m3fn)`` is the control one precision
below the program's.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch

from portbench.reference import model as ref
from portbench.reference.model import Adam, Graph, contains, linear, max_margin, sample
from portbench.reference.train import Draws, slice_widths

Etype = ref.Etype


def param_spec(etypes: Sequence[Etype], feat_dims: Dict[str, int], hidden: int, out: int,
               n_layers: int) -> Dict[str, Tuple[int, ...]]:
    """Name -> shape of every parameter of the LSTM model with an embedding
    layer, under the program's state-dict names: per conv layer and edge
    type the towers ``[out, hidden]`` and the LSTM's packed input weight
    ``[4H, H]``, recurrent weight ``[4H, H]`` and its bias ``[4H]``."""
    spec = {}
    for nt in ref.ntypes_of(etypes):
        spec[f"{nt}_embed.proj_feats.weight"] = (hidden, feat_dims[nt])
        spec[f"{nt}_embed.proj_feats.bias"] = (hidden,)
    n_conv = n_layers - 1
    for layer in range(n_conv):
        d_out = out if layer == n_conv - 1 else hidden
        for et in etypes:
            key = f"layer{layer}_{ref.etype_key(et)}"
            spec[f"{key}.fc_self.weight"] = (d_out, hidden)
            spec[f"{key}.fc_neigh.weight"] = (d_out, hidden)
            spec[f"{key}.lstm.ih.weight"] = (4 * hidden, hidden)
            spec[f"{key}.lstm.hh.weight"] = (4 * hidden, hidden)
            spec[f"{key}.lstm.hh.bias"] = (4 * hidden,)
    return spec


class Model(ref.Model):
    """The LSTM model's forward over parameters ``P`` on the sampled tree."""

    def __init__(self, P: Dict[str, torch.Tensor], graph: Graph,
                 feats: Dict[str, torch.Tensor], q=ref.identity):
        super().__init__(P, graph, feats, q, aggregator="lstm", dropout=0.0)

    def lstm(self, key: str, msgs: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """The final ``h`` [n, H] of the masked LSTM of layer and edge type
        ``key`` over ``msgs`` [n, K, D]; the carry stays where ``mask``
        [n, K] is False."""
        w_ih, w_hh = self.P[f"{key}.lstm.ih.weight"], self.P[f"{key}.lstm.hh.weight"]
        b_hh = self.P[f"{key}.lstm.hh.bias"]
        hidden = w_hh.shape[1]
        c = msgs.new_zeros((msgs.shape[0], hidden))
        h = msgs.new_zeros((msgs.shape[0], hidden))
        for s in range(msgs.shape[1]):
            gates = linear(msgs[:, s], w_ih, q=self.q) + linear(h, w_hh, b_hh, self.q)
            i, f, g, o = gates.split(hidden, dim=-1)
            c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            h_new = torch.sigmoid(o) * torch.tanh(c_new)
            valid = mask[:, s, None]
            c, h = torch.where(valid, c_new, c), torch.where(valid, h_new, h)
        return h

    def tree(self, nt: str, ids: torch.Tensor, level: int, fanouts: Sequence[int], draws,
             excluded: Dict[Etype, torch.Tensor]) -> torch.Tensor:
        """The sampled tree's output for the 1-D ``ids`` at ``level``, in the
        walk order of :meth:`.model.Model.tree`."""
        if level == 0:
            return self.embed(nt, self.feats[nt][ids])
        h_self = self.tree(nt, ids, level - 1, fanouts, draws, excluded)
        fanout = fanouts[level - 1]
        out = None
        for et in self.graph.in_etypes(nt):
            u = draws.uniform((ids.shape[0], fanout))
            nbr, mask = sample(self.graph, et, ids, u, excluded.get(et))
            h_nbr = self.tree(et[0], nbr.reshape(-1), level - 1, fanouts, draws, excluded)
            key = f"layer{level - 1}_{ref.etype_key(et)}"
            agg = self.lstm(key, h_nbr.reshape(ids.shape[0], fanout, -1), mask)
            z = self.combine(key, h_self, agg)
            out = z if out is None else out + z
        return out


def run_steps(P0: Dict[str, torch.Tensor], graph: Graph, feats: Dict[str, torch.Tensor],
              train_etypes: Sequence[Etype], epoch_seed: int, step: dict, steps: int,
              q=ref.identity, half_batch: bool = False, frozen: bool = False) -> dict:
    """``steps`` training steps of the LSTM model on the sampled tree from
    ``P0``, drawing exactly as :func:`.train.run_steps` draws: each step's
    loss, the first step's gradients and the parameters after the last.
    ``half_batch`` (a fault): each step's loss keeps only the first half of
    each edge type's positives; ``frozen`` (a fault): no update is
    applied.  Switches TF32 off for the process: every f32 product stays
    f32."""
    if step["dedup"]:
        raise ValueError("the LSTM reference runs the sampled tree only")
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
    shared = step["neg_mode"] == "shared_pool"
    for t in range(steps):
        batch = {}
        for et in train_etypes:
            n = widths[et]
            eids = perms[et][(t * n + torch.arange(n, device=dev)) % counts[et]]
            batch[et] = (graph.src[et][eids], graph.dst[et][eids], eids)
        pool = draws.randint((step["neg_pool_size"],), num_items).long()
        picks = {et: draws.randint((widths[et], step["neg_sample_size"]),
                                   step["neg_pool_size"]).long()
                 for et in train_etypes} if shared else {}
        excluded = {}
        for et, (_, _, eids) in batch.items():
            flags = torch.zeros(counts[et], dtype=torch.bool, device=dev)
            flags[eids] = True
            excluded[et] = flags
            if ref.reverse(et) in graph.src:
                excluded[ref.reverse(et)] = flags
        m = Model(params, graph, feats, q)
        users = torch.cat([batch[et][0] for et in train_etypes])
        items = torch.cat([batch[et][1] for et in train_etypes] + [pool])
        nu = ref.cosine_normalize(m.tree("user", users, len(fanouts), fanouts, draws, excluded))
        ni = ref.cosine_normalize(m.tree("item", items, len(fanouts), fanouts, draws, excluded))
        npool = ni[users.shape[0]:]
        pos, neg, fneg, rows = {}, {}, {}, {}
        lo = 0
        for et in train_etypes:
            u, _, _ = batch[et]
            hi = lo + u.shape[0]
            pos[et] = (nu[lo:hi] * ni[lo:hi]).sum(dim=-1)
            neg[et] = q(nu[lo:hi] @ npool.T)
            dst = pool[None, :]
            if shared:  # each positive's picks of the pool
                neg[et], dst = neg[et].gather(1, picks[et]), pool[picks[et]]
            fneg[et] = contains(keys[et], u[:, None], dst, num_items)
            rows[et] = torch.arange(u.shape[0], device=dev) < u.shape[0] // 2
            lo = hi
        loss = max_margin(pos, neg, fneg, step["delta"], rows if half_batch else None)
        grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
        if first_grads is None:
            first_grads = {k: g.detach().clone() for k, g in grads.items()}
        if not frozen:
            adam.step(params, grads)
        losses.append(float(loss.detach()))
    return {"losses": losses, "first_grads": first_grads,
            "params": {k: v.detach() for k, v in params.items()}}
