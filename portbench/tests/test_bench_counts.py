"""The frozen operation and byte counts at shapes worked by hand."""

import pytest

from portbench.counts import kernels as kc
from portbench.counts import model as mc

BUYS, BOUGHT = ("user", "buys", "item"), ("item", "bought-by", "user")


def test_leaf_counts():
    # K 2, P 3, F 4, H 5, bf16: 2*3*5*(2*4+4) ops; x 24, w 20, b 5 bf16, mask 6 f32, out 15 bf16
    assert kc.leaf_fwd(2, 3, 4, 5, 2) == (360.0, 2 * (24 + 20 + 5) + 4 * 6 + 2 * 15)
    assert kc.leaf_bwd(2, 3, 4, 5, 2) == (2 * 3 * 5 * 20.0,
                                          2 * (24 + 20 + 5) + 4 * 6 + 2 * 15 + 4 * (20 + 5))


def test_pool_mask_and_mips_counts():
    assert kc.pool_mask(2, 3, 5, 4.0) == (20.0, 4.0 * (6 + 5 + 10))
    assert kc.mips_topk(2, 3, 4, 5) == (48.0, 4.0 * 5 * 4 + 2 * 5 * 12.0)


def test_bound_takes_the_slower_side():
    assert kc.bound_s(67e12, 0.0) == pytest.approx(1.0)
    assert kc.bound_s(0.0, 3.35e12) == pytest.approx(1.0)
    assert kc.bound_s(989e12, 1.0, kc.PEAK_BF16_FLOPS) == pytest.approx(1.0)


def test_tree_forward_by_hand():
    # One conv layer (fanouts (2,)), user <- item only; seeds: 3 users.
    # Level 1 users: embed 3 users (2*3*F*H) and 6 sampled items (2*6*F*H),
    # pre-MLP on 6 rows (2*6*H*H), towers on 3 rows (2*2*3*H*out).
    f, h, o = 4, 5, 6
    flops, leaves = mc.tree_forward((BOUGHT,), {"user": 3}, (2,), f, h, o)
    assert leaves == [(2, 3)]
    assert flops == 2 * 3 * f * h + 2 * 6 * f * h + 2 * 6 * h * h + 4 * 3 * h * o


def test_two_level_leaves_follow_the_walk():
    _, leaves = mc.tree_forward((BUYS, BOUGHT), {"user": 2}, (3, 2), 1, 1, 1)
    # user level 2: self -> level-1 user (1 leaf call, P 2); then bought-by:
    # 4 items at level 1 (1 leaf call, P 4)
    assert leaves == [(3, 2), (3, 4)]


def test_request_adds_the_ranking():
    n = {"user": 2, "item": 3}
    base = mc.full_graph((BUYS, BOUGHT), n, 1, 4, 5, 6)
    # embed 5 nodes; pre-MLP on 2 users and 3 items; towers on 3 items and 2 users
    assert base == 2 * 5 * 4 * 5 + 2 * (2 + 3) * 5 * 5 + 4 * 3 * 5 * 6 + 4 * 2 * 5 * 6
    assert mc.request((BUYS, BOUGHT), n, 1, 4, 5, 6, 7) == base + 2 * 7 * 3 * 6
