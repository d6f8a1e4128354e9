"""Rehearsal of chip_smoke.py on the CPU at a tiny size: the same phases run
on CPU tensors, where every wrapper takes its plain version (so there are no
timings and no launches to count)."""

import torch

import chip_smoke


def test_kernel_phase_rehearsal():
    rows = chip_smoke.phase_kernels(torch.device("cpu"), num_users=40, num_items=300,
                                    dim=16, k=6, timed=False)
    assert [r["name"] for r in rows] == ["mips_topk", "mips_lse", "mips_boost"]
    for row in rows:
        assert row["max_abs_err"] == 0.0
        assert row["bound_by"] in ("bytes", "operations") and row["bound_ms"] > 0
    # At the serving shape the ranking is bound by f32 operations.
    ms, by = chip_smoke.bound(2.0 * 4096 * 30_000 * 128, 4.0 * (4096 + 30_000) * 128)
    assert by == "operations" and abs(ms - 0.4695) < 1e-3


def test_slice_phase_rehearsal():
    launches = chip_smoke.phase_slice(torch.device("cpu"), num_users=300, num_items=120,
                                      hidden=32, out=16, request_sizes=(1, 8, 64),
                                      on_card=False)
    assert launches == {"mips_topk": 0, "mips_lse": 0, "mips_boost": 0,
                        "mips_topk_boosted": 0}


def test_main_refuses_without_a_card():
    if torch.cuda.is_available():
        return
    try:
        chip_smoke.main()
    except RuntimeError as e:
        assert "no CUDA device" in str(e)
    else:
        raise AssertionError("main() ran without a card")
