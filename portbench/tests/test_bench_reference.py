"""The plain reference at tiny sizes: its float32 arithmetic against the
same in float64, its neighbour lists against a direct count, its sampler
against its rule, and its Adam against ``torch.optim.Adam``."""

import numpy as np
import pytest
import torch

from portbench.harness import data as bdata
from portbench.reference import model as ref
from portbench.reference import train as rtrain

GRAPH = {"num_users": 60, "num_items": 25, "num_groups": 3, "interactions_per_user": 3,
         "test_per_user": 1, "in_group_prob": 0.9, "feat_dim": 4, "max_fanout": 4}
STEP = {"edge_batch_size": 32, "fanouts": [3, 2], "neg_mode": "dense_pool",
        "neg_pool_size": 10, "neg_sample_size": 6, "delta": 0.266, "lr": 1e-3}


def world(aggregator="mean_nn", seed=5):
    gd = bdata.make_graph(GRAPH, seed)
    spec = ref.param_spec(tuple(gd["schema"]), {"user": 4, "item": 4}, 8, 6, 3, aggregator)
    p0 = bdata.make_weights(spec, seed, "cpu")
    g = ref.Graph(gd["schema"], gd["num_nodes"], GRAPH["max_fanout"], "cpu")
    feats = {nt: torch.from_numpy(gd["ndata"][nt]["features"]) for nt in gd["num_nodes"]}
    return gd, p0, g, feats


def as64(p0, feats):
    return {k: v.double() for k, v in p0.items()}, {k: v.double() for k, v in feats.items()}


@pytest.mark.parametrize("dedup", (False, True))
def test_forward_float32_against_float64(dedup):
    gd, p0, g, feats = world()
    seeds = {"user": torch.arange(0, 20), "item": torch.arange(0, 25)}
    outs = []
    for P, f in ((p0, feats), as64(p0, feats)):
        draws = rtrain.Draws(torch.Generator().manual_seed(3))
        m = ref.Model(P, g, f)
        if dedup:
            outs.append(m.dedup(seeds, (3, 2), draws, {}))
        else:
            outs.append({nt: m.tree(nt, ids, 2, (3, 2), draws, {}) for nt, ids in seeds.items()})
    for nt in seeds:
        torch.testing.assert_close(outs[0][nt].double(), outs[1][nt], rtol=1e-5, atol=1e-6)


def test_full_graph_float32_against_float64():
    gd, p0, g, feats = world("pool_nn")
    h32 = ref.Model(p0, g, feats, aggregator="pool_nn").full_graph(2)
    P, f = as64(p0, feats)
    h64 = ref.Model(P, g, f, aggregator="pool_nn").full_graph(2)
    for nt in h32:
        torch.testing.assert_close(h32[nt].double(), h64[nt], rtol=1e-5, atol=1e-6)


def test_steps_float32_against_float64():
    gd, p0, g, feats = world()
    r32 = rtrain.run_steps(p0, g, feats, gd["train_etypes"], 7, STEP, 2)
    P, f = as64(p0, feats)
    r64 = rtrain.run_steps(P, g, f, gd["train_etypes"], 7, STEP, 2)
    # The first step's loss and gradients to float32 rounding; after Adam's
    # first update (lr * sign for every entry) near-zero gradients may flip.
    assert r32["losses"][0] == pytest.approx(r64["losses"][0], rel=1e-5)
    assert r32["losses"][1] == pytest.approx(r64["losses"][1], rel=1e-3)
    for k in p0:
        torch.testing.assert_close(r32["first_grads"][k].double(), r64["first_grads"][k],
                                   rtol=1e-4, atol=1e-7)


def test_neighbour_lists_keep_the_last_edges_in_edge_order():
    src = np.array(list(range(10, 20)) + [1, 2], dtype=np.int32)
    dst = np.array([0] * 10 + [1, 1], dtype=np.int32)
    et = ("user", "buys", "item")
    g = ref.Graph({et: (src, dst)}, {"user": 20, "item": 3}, 8, "cpu")
    assert g.nbr[et][0].tolist() == list(range(12, 20))
    assert g.eid[et][0].tolist() == list(range(2, 10))
    assert g.nbr[et][1].tolist() == [1, 2] + [-1] * 6
    assert g.nbr[et][2].tolist() == [-1] * 8


def test_sampler_rule_and_exclusion():
    src = np.array([5, 6, 7, 1], dtype=np.int32)
    dst = np.array([0, 0, 0, 1], dtype=np.int32)
    et = ("user", "buys", "item")
    g = ref.Graph({et: (src, dst)}, {"user": 10, "item": 3}, None, "cpu")
    u = torch.tensor([[0.0, 0.34, 0.999], [0.5, 0.5, 0.5], [0.1, 0.2, 0.3]])
    excluded = torch.tensor([False, True, False, False])
    nbr, mask = ref.sample(g, et, torch.tensor([0, 1, 2]), u, excluded)
    assert nbr.tolist() == [[5, 0, 7], [1, 1, 1], [0, 0, 0]]
    assert mask.tolist() == [[True, False, True], [True, True, True], [False] * 3]


def test_contains_and_max_margin():
    keys = ref.pair_keys(torch.tensor([0, 1, 1]), torch.tensor([2, 0, 2]), 3)
    assert ref.contains(keys, torch.tensor([[0], [1]]), torch.tensor([[0, 1, 2]]), 3).tolist() \
        == [[False, False, True], [True, False, True]]
    et = ("user", "buys", "item")
    loss = ref.max_margin({et: torch.tensor([0.5])}, {et: torch.tensor([[0.6, 0.1]])},
                          {et: torch.tensor([[True, False]])}, 0.2)
    assert float(loss) == pytest.approx((0.0 + 0.0) / 2 + max(0.0, 0.1 + 0.2 - 0.5) / 2)


def test_adam_matches_torch():
    torch.manual_seed(0)
    p = {"w": torch.randn(4, 3)}
    mine, theirs = p["w"].clone(), p["w"].clone().requires_grad_(True)
    adam, opt = ref.Adam({"w": mine}, 1e-2), torch.optim.Adam([theirs], lr=1e-2)
    for _ in range(3):
        g = torch.randn(4, 3)
        adam.step({"w": mine}, {"w": g})
        theirs.grad = g.clone()
        opt.step()
    torch.testing.assert_close(mine, theirs.detach(), rtol=1e-6, atol=1e-7)
