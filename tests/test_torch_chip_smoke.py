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
    tap = chip_smoke.GatherTap()
    launches, model = chip_smoke.phase_train(torch.device("cpu"), data, hidden=32, out=16,
                                             steps=16, batch_size=128, pool=48, on_card=False,
                                             tap=tap)
    assert set(launches) == set(KERNELS[3:]) and not any(launches.values())
    # 8 gather-mean calls a step, in 4 shapes (2 levels x 2 node types).
    assert sum(tap.calls_by_shape.values()) == 16 * 8 and len(tap.calls_by_shape) == 4
    assert len(tap.captured) == 8 and all("dout" in c for c in tap.captured)
    assert all(c["transpose"].rows is not None for c in tap.captured)
    assert chip_smoke.conv_model.gather_mean is chip_smoke.gm.gather_mean
    rows = chip_smoke.phase_gather_steps(torch.device("cpu"), tap, timed=False)
    assert [r["name"].split(":")[0] for r in rows] == ["gather_mean_fwd", "gather_mean_bwd"] * 4
    assert all(r["max_abs_err"] <= 1e-6 and r["bound_ms"] > 0 for r in rows)
    chip_smoke.phase_packed_leaf(torch.device("cpu"), data, model, seeds=8)


def test_per_call_ms_survives_lost_records():
    """Each kernel's mean recorded duration times its launches a call: 17 of
    20 records of a one-launch kernel and 37 of 40 of a two-launch one."""
    full = [("a", 20, 200.0), ("b", 40, 400.0)]
    lost = [("a", 17, 170.0), ("b", 37, 370.0)]
    assert chip_smoke.per_call_ms(full, 20) == chip_smoke.per_call_ms(lost, 20) == 0.03


def test_slot_stats_counts_valid_slots_per_source_row():
    nbr = torch.tensor([[0, 1, 1], [1, 2, 0], [0, 0, 0]])
    mask = torch.tensor([[True, True, False], [True, True, True], [True, True, False]])
    stats = chip_smoke.slot_stats(nbr, mask, 4, rows=2)
    assert stats["masked_share"] == pytest.approx(2 / 9)
    assert stats["all_rows"]["valid_slots"] == 7 and stats["all_rows"]["max"] == 4
    cut = stats["without_padding"]
    assert cut["valid_slots"] == 5 and cut["max"] == 2 and cut["mean"] == 5 / 4


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


def _ptxas_lines(fwd_spill=0):
    """``ptxas -v`` lines as ``build`` keeps them, for the leaf kernels."""
    lines = []
    for name, regs, spill in (("leaf_fwd_kernelIfLi8EEEvPKT_", 128, fwd_spill),
                              ("leaf_fwd_kernelIfLi16EEEvPKT_", 154, 0),
                              ("leaf_bwd_kernelIfLi8EEEvPKT_", 162, 0),
                              ("leaf_bwd_reduce_kernelEPKfS1_", 26, 0)):
        lines += [f"ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_115{name}' "
                  f"for 'sm_90a'",
                  f"{spill} bytes stack frame, {spill} bytes spill stores, "
                  f"{spill // 2} bytes spill loads",
                  f"ptxas info    : Used {regs} registers, used 1 barriers, 404 bytes cmem[0]"]
    return lines


def test_leaf_ptxas_reads_registers_and_refuses_spills():
    summary = chip_smoke.build.ptxas_summary(_ptxas_lines())
    assert len(summary) == 4
    assert {v["registers"] for v in summary.values()} == {128, 154, 162, 26}
    got = chip_smoke.leaf_ptxas(_ptxas_lines())
    assert got["leaf_mean_nn_fwd"] == {"leaf_fwd_kernelIfLi8EE": {"registers": 128,
                                                                 "spill_bytes": 0}}
    assert set(got["leaf_mean_nn_bwd"]) == {"leaf_bwd_kernelIfLi8EE", "leaf_bwd_reduce_kernel"}
    with pytest.raises(AssertionError, match="spills 12 bytes"):
        chip_smoke.leaf_ptxas(_ptxas_lines(fwd_spill=8))
