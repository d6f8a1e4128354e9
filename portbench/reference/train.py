"""The reference's first training steps of a device epoch.

An epoch draws, from one generator seeded with the epoch's seed, each
training edge type's permutation of its edges, then every step's numbers:
the negative pool (``pool`` item ids), with a shared pool each edge type's
picks into it (``[B, S]``), then the samples of the step's users and then
of its items and pool, in the walk order of :mod:`.model`.  Dropout's
masks come from the default generator of the device, seeded with
``dropout_seed`` before the first step.  Step ``t`` trains, per edge type, the edges at positions
``(t * n + arange(n)) % count`` of the permutation, ``n`` the edge type's
share of the batch.  Random numbers come from ``torch.rand`` /
``torch.randint`` / ``torch.randperm`` on that generator, so the reference
and the measured program draw the same numbers on one device.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch

from portbench.reference import model as ref

Etype = ref.Etype


class Draws:
    def __init__(self, generator: torch.Generator):
        self.generator, self.device = generator, generator.device

    def uniform(self, shape) -> torch.Tensor:
        return torch.rand(tuple(shape), generator=self.generator, device=self.device)

    def randint(self, shape, high: int) -> torch.Tensor:
        return torch.randint(0, high, tuple(shape), generator=self.generator,
                             device=self.device, dtype=torch.int32)


def slice_widths(counts: Dict[Etype, int], batch: int):
    """Per edge type its share of a batch, and the steps of an epoch."""
    total = sum(counts.values())
    widths = {et: max(1, round(batch * c / max(total, 1))) for et, c in counts.items()}
    return widths, max(1, -(-total // batch))


def run_steps(P0: Dict[str, torch.Tensor], graph: ref.Graph, feats: Dict[str, torch.Tensor],
              train_etypes: Sequence[Etype], epoch_seed: int, step: dict, steps: int,
              q=ref.identity, half_batch: bool = False, dedup: bool = False,
              model: Optional[dict] = None, dropout_seed: int = 0,
              frozen: bool = False) -> dict:
    """``steps`` training steps from ``P0``: each step's loss, the first
    step's gradients, the parameters after the last, and the first step's
    neighbour means (``dedup``: the dedup'd block forward instead of the
    tree).  ``model``: the configuration's aggregator and dropout.
    ``half_batch`` (a fault): each step's loss keeps only the first half of
    each edge type's positives; ``frozen`` (a fault): no update is applied."""
    model = model or {"aggregator_type": "mean_nn", "dropout": 0.0}
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
    adam = ref.Adam(params, step["lr"])
    losses: List[float] = []
    first_grads: Optional[Dict[str, torch.Tensor]] = None
    fanouts = tuple(step["fanouts"])
    gathers: list = []
    shared = step["neg_mode"] == "shared_pool"
    if model["dropout"]:
        torch.manual_seed(dropout_seed)
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
        m = ref.Model(params, graph, feats, q, model["aggregator_type"], model["dropout"])
        levels = len(fanouts)
        users = torch.cat([batch[et][0] for et in train_etypes])
        items = torch.cat([batch[et][1] for et in train_etypes] + [pool])
        if dedup:
            h = m.dedup({"user": users, "item": items}, fanouts, draws, excluded,
                        gathers if t == 0 else None)
            hu, hi = h["user"], h["item"]
        else:
            hu = m.tree("user", users, levels, fanouts, draws, excluded)
            hi = m.tree("item", items, levels, fanouts, draws, excluded)
        nu, ni = ref.cosine_normalize(hu), ref.cosine_normalize(hi)
        npool = ni[users.shape[0]:]
        pos, neg, fneg, rows = {}, {}, {}, {}
        lo = 0
        for et in train_etypes:
            u, i, _ = batch[et]
            hi_ = lo + u.shape[0]
            pos[et] = (nu[lo:hi_] * ni[lo:hi_]).sum(dim=-1)
            neg[et] = q(nu[lo:hi_] @ npool.T)
            dst = pool[None, :]
            if shared:  # each positive's picks of the pool
                neg[et], dst = neg[et].gather(1, picks[et]), pool[picks[et]]
            fneg[et] = ref.contains(keys[et], u[:, None], dst, num_items)
            rows[et] = torch.arange(u.shape[0], device=dev) < u.shape[0] // 2
            lo = hi_
        loss = ref.max_margin(pos, neg, fneg, step["delta"], rows if half_batch else None)
        grads = torch.autograd.grad(loss, list(params.values()))
        grads = dict(zip(params, grads))
        if first_grads is None:
            first_grads = {k: g.detach().clone() for k, g in grads.items()}
        if not frozen:
            adam.step(params, grads)
        losses.append(float(loss.detach()))
    return {"losses": losses, "first_grads": first_grads,
            "params": {k: v.detach() for k, v in params.items()}, "gathers": gathers}
