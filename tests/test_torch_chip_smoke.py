"""Rehearsal of chip_smoke.py on the CPU at a tiny size: the same phases run
on CPU tensors, where every wrapper takes its plain version (so there are no
timings and no launches to count)."""

import pytest
import torch

import chip_smoke

KERNELS = ["mips_topk", "mips_lse", "mips_boost", "leaf_mean_nn_fwd", "leaf_mean_nn_bwd",
           "pool_membership_mask", "gather_mean_fwd", "gather_mean_bwd"]
NO_YARDSTICK = ["leaf_mean_nn_fwd", "leaf_mean_nn_bwd", "pool_membership_mask"]


@pytest.fixture(scope="module")
def data():
    return chip_smoke.bench_data(num_users=300, num_items=120)


def test_kernel_phase_rehearsal():
    rows = chip_smoke.phase_kernels(torch.device("cpu"), num_users=40, num_items=300,
                                    dim=16, k=6, leaf=(4, 37, 5, 16), pool=(40, 8, 70),
                                    gather=(41, 5, 30, 12), timed=False)
    assert [r["name"] for r in rows] == KERNELS
    for row in rows:
        assert row["max_abs_err"] == 0.0
        assert row["bound_by"] in ("bytes", "operations") and row["bound_ms"] > 0
        assert row["source"].startswith("gnn_recsys_tpu_torch/csrc/")
        assert row["replaces"].startswith("gnn_recsys_tpu/ops/pallas/")
        assert ("library" in row) == (row["name"] in NO_YARDSTICK)
    # At the serving shape the ranking is bound by f32 operations.
    ms, by = chip_smoke.bound(2.0 * 4096 * 30_000 * 128, 4.0 * (4096 + 30_000) * 128)
    assert by == "operations" and abs(ms - 0.4695) < 1e-3


def test_slice_and_train_phase_rehearsal(data):
    launches, recall = chip_smoke.phase_slice(torch.device("cpu"), data, hidden=32, out=16,
                                              request_sizes=(1, 8, 64), on_card=False)
    assert launches == {"mips_topk": 0, "mips_lse": 0, "mips_boost": 0,
                        "mips_topk_boosted": 0}
    assert 0.0 <= recall <= 1.0
    launches, _ = chip_smoke.phase_train(torch.device("cpu"), data, hidden=32, out=16, steps=16,
                                         batch_size=128, pool=48, random_recall=recall,
                                         on_card=False)
    assert set(launches) == set(KERNELS[3:]) and not any(launches.values())


def test_train_dedup_and_packed_leaf_rehearsal(data):
    launches, model = chip_smoke.phase_train(torch.device("cpu"), data, hidden=32, out=16,
                                             steps=16, batch_size=128, pool=48, on_card=False,
                                             dedup=True)
    assert set(launches) == set(KERNELS[3:]) and not any(launches.values())
    chip_smoke.phase_packed_leaf(torch.device("cpu"), data, model, seeds=8)


def test_leaf_branch_count_of_the_bench_tree(data):
    """12 leaf-kernel branches a step at the bench config: 6 per seed type."""
    model = chip_smoke.ConvModel(**chip_smoke.medium_kwargs(data.graph, 32, 16))
    counts = [chip_smoke.leaf_branches(data.graph, nt, model.num_conv_layers)
              for nt in ("user", "item")]
    assert counts == [6, 6]


def test_block_mean_count_of_the_bench_plan(data):
    """8 gather-mean launches a dedup'd forward at the bench config: 2 levels
    x 2 node types x 2 in-etypes."""
    assert chip_smoke.block_means(data.graph, ("user", "item"), 2) == 8


def test_main_refuses_without_a_card():
    if torch.cuda.is_available():
        return
    try:
        chip_smoke.main()
    except RuntimeError as e:
        assert "no CUDA device" in str(e)
    else:
        raise AssertionError("main() ran without a card")
