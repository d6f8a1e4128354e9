"""Rehearsal of chip_smoke.py on the CPU at a tiny size: the same phases run
on CPU tensors, where every wrapper takes its plain version (so there are no
timings and no launches to count)."""

import json

import pytest
import torch
from test_torch_minibatch import one_torch_thread  # noqa: F401 (autouse)

import chip_smoke

KERNELS = ["mips_topk", "mips_lse", "mips_boost", "leaf_mean_nn_fwd", "leaf_mean_nn_bwd",
           "pool_membership_mask", "gather_mean_fwd", "gather_mean_bwd"]
# The kernels line's rows of the kernel phase: each kernel, the leaf and
# gather-mean kernels again in bf16, the gather-mean kernels at a
# full-fanout shape in f32 and bf16, the LSTM cell's in f32 and bf16, and
# the MLP head's tower in bf16; mlp_topk, the MLP head's ranking, after the
# MIPS kernels.
WIDE = "wide:B9_K40_N7_D12"
ROWS = ["mips_topk", "mips_lse", "mips_boost", "mlp_topk", "leaf_mean_nn_fwd",
        "leaf_mean_nn_bwd", "leaf_mean_nn_fwd:bf16", "leaf_mean_nn_bwd:bf16",
        "pool_membership_mask", "gather_mean_fwd", "gather_mean_bwd", "gather_mean_fwd:bf16",
        "gather_mean_bwd:bf16",
        f"gather_mean_fwd:{WIDE}", f"gather_mean_bwd:{WIDE}", f"gather_mean_fwd:bf16:{WIDE}",
        f"gather_mean_bwd:bf16:{WIDE}", "lstm_cell_fwd", "lstm_cell_bwd", "lstm_cell_fwd:bf16",
        "lstm_cell_bwd:bf16", "pred_tower_fwd:bf16", "pred_tower_bwd:bf16"]
NO_YARDSTICK = ["leaf_mean_nn_fwd", "leaf_mean_nn_bwd", "pool_membership_mask"]


@pytest.fixture(scope="module")
def data():
    return chip_smoke.bench_data(num_users=300, num_items=120)


def test_kernel_phase_rehearsal():
    rows = chip_smoke.phase_kernels(torch.device("cpu"), num_users=40, num_items=300,
                                    dim=16, k=6, leaf=(4, 37, 5, 16), pool=(40, 8, 70),
                                    gather=(41, 5, 30, 12), wide=(9, 40, 7, 12),
                                    lstm=((7, 21), 12), pred=(19, 37),
                                    mlp=((20, 42, 266), 300, 700), timed=False)
    assert [r["name"] for r in rows] == ROWS
    for row in rows:
        assert row["max_abs_err"] == 0.0
        assert row["bound_by"] in ("bytes", "operations") and row["bound_ms"] > 0
        assert row["source"].startswith("gnn_recsys_tpu_torch/csrc/")
        # The LSTM cell, the head's tower and its ranking replace no Pallas
        # kernel: their rows name the JAX package's reducer, head and ranking.
        lstm = row["name"].startswith("lstm_cell")
        no_twin = lstm or row["name"].startswith("pred_tower")
        assert row["replaces"].startswith(
            "gnn_recsys_tpu/retrieval/recs.py:" if row["name"] == "mlp_topk"
            else "gnn_recsys_tpu/models/layers.py:" if no_twin else "gnn_recsys_tpu/ops/pallas/")
        assert not lstm or row["bit_equal_share"] == 1.0
        assert ("library" in row) == (row["name"].split(":")[0] in NO_YARDSTICK)
    # At the serving shape the ranking is bound by f32 operations; the
    # tower's bf16 rows by the tensor cores'.
    ms, by = chip_smoke.bound(2.0 * 4096 * 30_000 * 128, 4.0 * (4096 + 30_000) * 128)
    assert by == "operations" and abs(ms - 0.4695) < 1e-3
    ms, by = chip_smoke.bound(1024 * 2560 * 8256.0, 0.0, chip_smoke.PEAK_BF16_FLOPS)
    assert by == "operations" and abs(ms - 0.02189) < 1e-4


def test_slice_and_train_phase_rehearsal(data, capsys):
    launches, recall = chip_smoke.phase_slice(torch.device("cpu"), data, hidden=32, out=16,
                                              request_sizes=(1, 8, 64), on_card=False)
    assert launches == {"mips_topk": 0, "mips_lse": 0, "mips_boost": 0}
    assert 0.0 <= recall <= 1.0
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    # Four requests, each served the graph's bought-by rows.
    assert report["bought_table_routes"] == {"requests": 4, "from_graph": 4, "packed": 0}
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
    # No kernel launches on the CPU: each shape's count stays 0.
    assert set(tap.launches["gather_mean_fwd"]) == set(tap.calls_by_shape)
    assert not any(c for by_shape in tap.launches.values() for c in by_shape.values())
    assert len(tap.captured) == 8 and all("dout" in c for c in tap.captured)
    assert all(c["transpose"].rows is not None for c in tap.captured)
    assert chip_smoke.conv_model.gather_mean is chip_smoke.gm.gather_mean
    rows = chip_smoke.phase_gather_steps(torch.device("cpu"), tap, timed=False)
    # Each of the 4 shapes in f32, then in bf16.
    names = [r["name"].rsplit(":", 1)[0] for r in rows]
    assert names == ["gather_mean_fwd", "gather_mean_bwd",
                     "gather_mean_fwd:bf16", "gather_mean_bwd:bf16"] * 4
    assert all(r["max_abs_err"] <= 1e-6 and r["bound_ms"] > 0 for r in rows)
    chip_smoke.phase_packed_leaf(torch.device("cpu"), data, model, seeds=8)


@pytest.mark.parametrize("dedup", [False, True])
def test_train_graph_rehearsal(data, dedup):
    """Phase 9 through the trainer's device epochs, on the CPU the eager
    body: the loss falls, and the eager-against-graph check (here the eager
    body twice) agrees bit for bit.  A dedup run's gather-mean calls go
    through a tap (8 a step, in the 4 shapes of the dedup step)."""
    tap = chip_smoke.GatherTap() if dedup else None
    launches = chip_smoke.phase_train_graph(torch.device("cpu"), data, hidden=32, out=16,
                                            steps=8, valid_steps=2, batch_size=128, pool=48,
                                            dedup=dedup, on_card=False, check_steps=3, tap=tap)
    assert set(launches) == set(KERNELS[3:]) and not any(launches.values())
    if dedup:
        assert len(tap.calls_by_shape) == 4 and sum(tap.calls_by_shape.values()) % 8 == 0
        assert not any(c for by_shape in tap.launches.values() for c in by_shape.values())
        assert chip_smoke.conv_model.gather_mean is chip_smoke.gm.gather_mean


def test_gather_tap_adds_captured_launches_at_each_replay():
    """Launches counted during a capture leave the tap's counts and come back
    once a replay; totals must match the wrappers' counts."""
    tap = chip_smoke.GatherTap()
    shape = (16, 8, 40, 12)
    tap.launches["gather_mean_fwd"][shape] = 2  # warm-up steps
    tap.in_graph["gather_mean_fwd"][shape] = tap.in_graph["gather_mean_bwd"][shape] = 1
    captured = tap.take_graph()
    assert not any(tap.in_graph.values())
    for _ in range(3):
        tap.replayed(captured)
    assert tap.launches["gather_mean_fwd"][shape] == 5
    assert tap.launches["gather_mean_bwd"][shape] == 3
    tap.check_totals({"gather_mean_fwd": 5, "gather_mean_bwd": 3}, "replays")
    with pytest.raises(AssertionError, match="add up"):
        tap.check_totals({"gather_mean_fwd": 6, "gather_mean_bwd": 3}, "replays")


@pytest.mark.parametrize("dedup", [False, True])
def test_train_graph_bf16_rehearsal(data, dedup):
    """Phase 10: phase 9 with ``ConvModel(dtype=bfloat16)``; the eager
    body's two runs agree within the bf16 tolerances, and the trained bf16
    model's embeddings (bf16) go through the recall check."""
    launches = chip_smoke.phase_train_graph(torch.device("cpu"), data, hidden=32, out=16,
                                            steps=8, valid_steps=2, batch_size=128, pool=48,
                                            dedup=dedup, on_card=False, check_steps=3,
                                            dtype=torch.bfloat16, random_recall=0.0)
    assert set(launches) == set(KERNELS[3:]) and not any(launches.values())


def test_train_graph_nn_rehearsal(data, capsys):
    """Phase 10's step with the MLP head on the CPU: the dense pool's cross
    form (the tower's plain version) through the device epochs' eager body,
    the loss falls, the eager-against-graph check agrees, and the step
    counts the tower's two forward and two backward calls."""
    launches = chip_smoke.phase_train_graph(torch.device("cpu"), data, hidden=32, out=16,
                                            steps=8, valid_steps=2, batch_size=128, pool=48,
                                            on_card=False, check_steps=3, dtype=torch.bfloat16,
                                            pred="nn")
    assert set(launches) == set(KERNELS[3:]) | {"pred_tower_fwd", "pred_tower_bwd"}
    assert not any(launches.values())
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert report["launches_per_step"]["pred_tower_fwd"] == 2
    assert report["launches_per_step"]["pred_tower_bwd"] == 2
    # Each step scores 2 x 64 positives alone and against the 48 pool items;
    # the tower takes the pool's pairs (the counters count the eager body too).
    assert report["tower_pairs"] > 0
    assert report["tower_pairs"] * 49 == report["head_pairs"] * 48


@pytest.mark.parametrize("pred", ["cos", "nn"])
def test_train_full_batch_rehearsal(pred, capsys):
    """Phases 11 and 12: the full-batch trainer with each head, the card's
    step against the CPU's (here the CPU twice: the same bits; the f64
    witness within the bound), the cosine evaluation's recs through both
    routes and, for the MLP head, a saved run served and held against the
    CPU request."""
    launches = chip_smoke.phase_train_full_batch(
        torch.device("cpu"), pred, num_users=300, num_items=120, hidden=32, out=16, epochs=20,
        check_size=(300, 120), serve_users=16, on_card=False)
    assert launches == {"mips_topk": 0, "mlp_topk": 0}
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert report["phase"] == "train_full_batch" + ("_nn" if pred == "nn" else "")
    assert len(report["loss"]) == 20 and report["epoch_ms_min"] <= report["epoch_ms_median"]
    gaps = report["step_card_vs_cpu"]["grad_gap_of_largest"]
    assert gaps["card_vs_cpu"] == gaps["card_vs_card_again"] == 0.0
    assert 0.0 < gaps["cpu_vs_cpu_f64"] == gaps["card_vs_cpu_f64"]
    assert gaps["card_vs_cpu_f64"] <= chip_smoke.FULL_BATCH_F64_GRAD_REL
    if pred == "cos":
        routes = report["eval_routes"]
        assert routes["users"] > 0 and routes["max_score_gap"] <= chip_smoke.TOL
    else:
        assert "eval_routes" not in report and report["serve"]["users"] == 16


def test_hp_search_rehearsal(capsys):
    """Phase hp_search at a tiny world (rows capped at 8): three trials whose
    proposals are the search's first three, each trained two epochs through
    the device epochs' eager body and evaluated (with the boost in trials 2
    and 3), and a resumed search that runs no trial.  Each trial's ranking
    is held route against route, and trial 1's gather-mean calls (the one
    mean aggregator on the dedup'd forward) give a row a shape."""
    launches, rows = chip_smoke.phase_hp_search(torch.device("cpu"), num_users=200,
                                                num_items=150, max_fanout=8,
                                                edge_batch_size=256, on_card=False)
    assert launches == {}  # CPU tensors: the plain versions, no launch
    lines = [json.loads(line) for line in capsys.readouterr().out.strip().splitlines()]
    trials = [line for line in lines if line["phase"] == "hp_trial"]
    search = lines[-1]
    assert search["phase"] == "hp_search" and search["resumed_trials"] == 3
    assert [t["index"] for t in trials] == [1, 2, 3]
    assert [t["dedup"] for t in trials] == [True, True, False]
    assert [t["boosted"] for t in trials] == [False, True, True]
    for t, want in zip(trials, chip_smoke.HP_TRIALS):
        assert t["hyper"]["aggregator_type"] == want["aggregator_type"]
        assert t["epochs"] == 2 and len(t["valid_loss"]) == 2 and t["updates"] > 0
        assert all(w <= 8 for w in t["train_graph_row_width"].values())
        assert 0.0 <= t["initial_weights_recall"] <= 1.0
    assert search["objectives"] == [-t["precision_recall_coverage"][1] for t in trials]
    for t in trials:
        routes = t["eval_routes"]
        assert routes["boosted"] == t["boosted"] and routes["rows_differing"] == 0
        assert routes["users"] > 0 and routes["k"] == 10
    names = [row["name"] for row in rows]
    assert names and all(n.split(":")[1] == "hp1" for n in names)
    assert {n.split(":")[0] for n in names} == set(chip_smoke.GATHER_KERNELS)
    assert len(set(names)) == len(names)
    assert trials[0]["gather_max_abs_err"] == {row["name"]: 0.0 for row in rows}
    assert all(row["launches"] == 0 and row["bound_ms"] > 0 for row in rows)
    assert trials[1]["gather_max_abs_err"] == {}  # pool_nn: no gather-mean call
    assert "gather_max_abs_err" not in trials[2]  # the tree forward


def test_etl_cli_rehearsal(capsys):
    """Phase etl_cli at 200 users and 80 items: raw CSV logs, the windows'
    row counts, the presplit, ``main_hp`` (two trials from the files),
    ``main_train`` and two ``main_inference`` requests, each trial reported
    with its ETL stages; the saved run's rankings and every trial's
    evaluation held route against route, and every dedup'd trial's
    gather-mean plan held against the plain versions (rows
    ``gather_mean_*:etl-<trial>:…``)."""
    launches, rows = chip_smoke.phase_etl_cli(torch.device("cpu"), num_users=200, num_items=80,
                                              epochs=2, edge_batch_size=256,
                                              named_users=("u7", "u42", "u123"), on_card=False)
    assert set(launches.values()) == {0}  # CPU tensors: the plain versions, no launch
    lines = [json.loads(line) for line in capsys.readouterr().out.strip().splitlines()]
    trials = [line for line in lines if line["phase"] == "etl_trial"]
    phase = lines[-1]
    assert phase["phase"] == "etl_cli" and phase["interactions"] > 5000
    w = phase["windows"]
    assert w["rows_lifespan"] < w["rows_purchase_window"] < w["rows_full"]
    assert w["rows_click_window"] < w["rows_full"]
    assert [t["trial"] for t in trials] == ["hp1", "hp2", "train1"]
    for t in trials:
        assert sorted(t["etl_s"]) == ["build_graph", "create_ids", "df_to_adjacency_list",
                                      "format_dfs", "import_features"]
        assert t["epochs"] == 2 and t["updates"] > 0 and t["inference_recall"] is not None
        assert min(t["split_s"], t["build_s"], t["train_s"], t["evaluate_s"]) > 0
        assert t["nodes"]["user"] > 0 and t["edges"]["user/buys/item"] > 0
    assert trials[0]["dedup"] and trials[0]["hyper"]["aggregator_type"] == "mean_nn"
    assert trials[2]["saved_to"] is not None
    assert phase["all_users"] > 100 and sorted(phase["named_recs"]) == ["u123", "u42", "u7"]
    assert all(len(v) == 10 for v in phase["named_recs"].values())
    assert phase["routes"]["rows_differing"] == 0 and phase["routes"]["users"] > 0
    assert sorted(phase["trial_routes"]) == ["hp1", "hp2", "train1"]
    for routes in phase["trial_routes"].values():
        assert routes["test"]["rows_differing"] == 0 and routes["test"]["users"] > 0
    names = [row["name"] for row in rows]
    assert names and len(set(names)) == len(names)
    assert {n.split(":")[0] for n in names} == set(chip_smoke.GATHER_KERNELS)
    planned = {"etl-" + t["trial"] for t in trials
               if t["dedup"] and t["hyper"]["aggregator_type"] == "mean_nn"}
    assert {n.split(":")[1] for n in names} == planned and "etl-hp1" in planned
    assert all(row["max_abs_err"] == 0.0 and row["launches"] == 0 for row in rows)


def test_popularity_recall_matches_the_jax_gates_baseline():
    """``popularity_recall`` is the JAX package's gate baseline
    (``tests/test_e2e_fullbatch.py``) computed with the port's metrics."""
    from test_e2e_fullbatch import popularity_baseline_recall

    from gnn_recsys_tpu.utils.synthetic import make_synthetic_data as jmake

    kw = dict(num_users=120, num_items=60, num_groups=4, interactions_per_user=10,
              test_per_user=3, feat_dim=8, with_clicks=True, seed=0)
    want = popularity_baseline_recall(jmake(**kw), k=10)
    got = chip_smoke.popularity_recall(chip_smoke.make_synthetic_data(**kw), k=10)
    assert got == pytest.approx(want, rel=1e-6)


def test_per_call_ms_survives_lost_records():
    """Each kernel's mean recorded duration times its launches a call: 17 of
    20 records of a one-launch kernel and 37 of 40 of a two-launch one."""
    full = [("a", 20, 200.0), ("b", 40, 400.0)]
    lost = [("a", 17, 170.0), ("b", 37, 370.0)]
    assert chip_smoke.per_call_ms(full, 20) == chip_smoke.per_call_ms(lost, 20) == 0.03


def test_device_ms_raises_after_its_tries_record_no_kernel(monkeypatch):
    """A profile with no kernel recorded is taken again; after ``tries`` of
    them ``device_ms`` raises rather than report another clock."""
    profiles = []

    def empty(fn, reps):
        profiles.append(reps)
        return 0.0, []

    monkeypatch.setattr(chip_smoke, "profiled_kernels", empty)
    with pytest.raises(RuntimeError, match="recorded no CUDA kernel"):
        chip_smoke.device_ms(None, reps=7, tries=3)
    assert profiles == [7, 7, 7]
    records = iter([[], [("k", 14, 28.0)]])
    monkeypatch.setattr(chip_smoke, "profiled_kernels", lambda fn, reps: (0.0, next(records)))
    assert chip_smoke.device_ms(None, reps=7) == pytest.approx(0.004)


def test_kernel_row_times_the_library_on_the_kernels_clock(monkeypatch):
    """``ms``, ``plain_ms`` and ``library_ms`` are each the profiler's
    device time over 20 calls; CUDA events time only ``events_ms``."""
    calls = []

    def device(fn, reps=20):
        calls.append((fn, reps))
        return {"kernel": 1.0, "plain": 2.0, "library": 3.0}[fn]

    monkeypatch.setattr(chip_smoke, "device_ms", device)
    monkeypatch.setattr(chip_smoke, "time_ms", lambda fn: 9.0)
    row = chip_smoke.kernel_row([], True, "k", ("a.cu", "b.py"), 1, 0.0, "kernel", "plain",
                                "library", 1e9, 1e9)
    assert (row["ms"], row["plain_ms"], row["library_ms"], row["events_ms"]) == (1.0, 2.0, 3.0,
                                                                                9.0)
    assert calls == [("kernel", 20), ("plain", 20), ("library", 20)]


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


def _ptxas_lines(names):
    """``ptxas -v`` lines as ``build`` keeps them: (mangled piece, registers,
    spill bytes) per entry function."""
    lines = []
    for name, regs, spill in names:
        lines += [f"ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_115{name}' "
                  f"for 'sm_90a'",
                  f"{spill} bytes stack frame, {spill} bytes spill stores, "
                  f"{spill // 2} bytes spill loads",
                  f"ptxas info    : Used {regs} registers, used 1 barriers, 404 bytes cmem[0]"]
    return lines


def _leaf_lines(fwd_spill=0):
    return _ptxas_lines((("leaf_fwd_kernelIfLi8EEEvPKT_", 128, fwd_spill),
                         ("leaf_fwd_kernelIfLi16EEEvPKT_", 154, 0),
                         ("leaf_bwd_kernelIfLi8EEEvPKT_", 162, 0),
                         ("leaf_fwd_kernelI13__nv_bfloat16Li8EEEvPKT_", 127, 0),
                         ("leaf_bwd_kernelI13__nv_bfloat16Li8EEEvPKT_", 148, 0),
                         ("leaf_bwd_reduce_kernelEPKfS1_", 26, 0)))


def _gather_lines(bf16_spill=0, walk_spill=0):
    """The gather-mean instantiations: f32 and bf16, 16-byte and scalar
    paths; the warp-a-row kernels at K = 8, 4 and (the forward) any K <= 32,
    the forward at K > 32, the backward's walk and reduce, prep and scan."""
    names = [("gather_mean_bwd_prep_kernelEPKhPKiS3_S3_NS_4PlanEiiii", 30, 0),
             ("gather_mean_bwd_scan_kernelEPii", 18, 0)]
    for elem, vec in (("f", 4), ("f", 1), ("13__nv_bfloat16", 8), ("13__nv_bfloat16", 1)):
        for direction, regs, ks in (("fwd", 38, (8, 4, 0)), ("bwd", 40, (8, 4))):
            for k in ks:
                spill = bf16_spill if (elem, vec, k) == ("13__nv_bfloat16", 8, 8) else 0
                names.append((f"gather_mean_{direction}_kernelI{elem}Li{vec}ELi{k}EEEvPKT_",
                              regs, spill))
        spill = walk_spill if (elem, vec) == ("f", 1) else 0
        names += [(f"gather_mean_fwd_wide_kernelI{elem}Li{vec}EEEvPKT_PKiPKhiiiPS1_", 56, 0),
                  (f"gather_mean_bwd_walk_kernelI{elem}Li{vec}EEEvPKT_PKhPKiNS_4PlanEiiiiiPS1_",
                   62, spill),
                  (f"gather_mean_bwd_reduce_kernelI{elem}Li{vec}EEEvNS_4PlanEiiPT_", 48, 0)]
    return _ptxas_lines(names)


def test_leaf_ptxas_reads_registers_and_refuses_spills():
    summary = chip_smoke.build.ptxas_summary(_leaf_lines())
    assert len(summary) == 6
    assert {v["registers"] for v in summary.values()} == {128, 154, 162, 127, 148, 26}
    leaf = {name: v for name, v in chip_smoke.NO_SPILL.items() if v[0] == "leaf_agg"}
    got = chip_smoke.kernel_ptxas({"leaf_agg": {"ptxas": _leaf_lines()}}, leaf)
    assert got["leaf_mean_nn_fwd"] == {"leaf_fwd_kernelIfLi8EE": {"registers": 128,
                                                                 "spill_bytes": 0}}
    assert set(got["leaf_mean_nn_bwd"]) == {"leaf_bwd_kernelIfLi8EE", "leaf_bwd_reduce_kernel"}
    assert got["leaf_mean_nn_fwd:bf16"] == {
        "leaf_fwd_kernelI13__nv_bfloat16Li8EE": {"registers": 127, "spill_bytes": 0}}
    with pytest.raises(AssertionError, match="spills 12 bytes"):
        chip_smoke.kernel_ptxas({"leaf_agg": {"ptxas": _leaf_lines(fwd_spill=8)}}, leaf)


def test_gather_ptxas_rows_hold_the_dedup_steps_instantiations():
    """The gather-mean rows name the 16-byte paths at K = 8 and 4 (the dedup
    step's) and the full-fanout design's kernels (f32 also on the scalar
    path), f32 in one row and bf16 in the other; a spill in the bf16 K = 8
    forward or in the f32 scalar walk fails the run."""
    rows = {name: v for name, v in chip_smoke.NO_SPILL.items() if v[0] == "gather_mean"}
    got = chip_smoke.kernel_ptxas({"gather_mean": {"ptxas": _gather_lines()}}, rows)
    assert set(got["gather_mean_fwd"]) == {"gather_mean_fwd_kernelIfLi4ELi8EE",
                                           "gather_mean_fwd_kernelIfLi4ELi4EE",
                                           "gather_mean_fwd_wide_kernelIfLi4EE",
                                           "gather_mean_fwd_wide_kernelIfLi1EE"}
    assert set(got["gather_mean_bwd:bf16"]) == {
        "gather_mean_bwd_kernelI13__nv_bfloat16Li8ELi8EE",
        "gather_mean_bwd_kernelI13__nv_bfloat16Li8ELi4EE",
        "gather_mean_bwd_walk_kernelI13__nv_bfloat16Li8EE",
        "gather_mean_bwd_reduce_kernelI13__nv_bfloat16Li8EE",
        "gather_mean_bwd_prep_kernel", "gather_mean_bwd_scan_kernel"}
    assert got["gather_mean_bwd"]["gather_mean_bwd_walk_kernelIfLi1EE"] == {
        "registers": 62, "spill_bytes": 0}
    with pytest.raises(AssertionError, match="nv_bfloat16Li8ELi8EE spills 12 bytes"):
        chip_smoke.kernel_ptxas({"gather_mean": {"ptxas": _gather_lines(bf16_spill=8)}}, rows)
    with pytest.raises(AssertionError, match="walk_kernelIfLi1EE spills 12 bytes"):
        chip_smoke.kernel_ptxas({"gather_mean": {"ptxas": _gather_lines(walk_spill=8)}}, rows)


def test_topk_and_pool_mask_ptxas_rows():
    """Serving's f32 topk_kernel instantiations (the top-k and boost
    epilogues with lists in the shared buffer, the LSE epilogue), mlp_topk's
    with lists in the shared buffer, the pool mask and the head's tower in
    bf16 (its forward; its dW2 pass and sums, not its dA pass) get a row
    each; the other instantiations are reported by the build phase but hold
    no row; a spill in a row's kernel fails the run."""
    args = "EEEvPKT_S3_iiiiiiPKffS5_S5_PfPiS6_"
    bf16 = "I13__nv_bfloat16EEvPKfS3_"

    def info(topk_spill=0, boost_spill=0, dw2_spill=0):
        return {"leaf_agg": {"ptxas": _leaf_lines()}, "gather_mean": {"ptxas": _gather_lines()},
                "topk_mips": {"ptxas": _ptxas_lines((
                    (f"topk_kernelIfLb1ELi0{args}", 168, topk_spill),
                    (f"topk_kernelIfLb0ELi0{args}", 170, 0),
                    (f"topk_kernelIfLb1ELi1{args}", 172, boost_spill),
                    (f"topk_kernelIfLb0ELi1{args}", 174, 0),
                    (f"topk_kernelIfLb0ELi2{args}", 150, 0),
                    ("topk_kernelI13__nv_bfloat16Lb1ELi0EEEvPKT_S4_iiiiiiPKffS6_S6_PfPiS7_",
                     166, 0),
                    ("mlp_topk_kernelILb1EEEvPKfS2_S2_S2_S2_S2_iiiiPfPi", 214, 0),
                    ("mlp_topk_kernelILb0EEEvPKfS2_S2_S2_S2_S2_iiiiPfPi", 214, 0)))},
                "pool_mask": {"ptxas": _ptxas_lines((
                    ("pool_mask_kernelEPKiS1_iiiiPf", 40, 0),))},
                "pred_tower": {"ptxas": _ptxas_lines((
                    (f"pred_tower_fwd_kernel{bf16}PKT_S6_S6_S6_S6_iiPf", 77, 0),
                    (f"pred_tower_bwd_kernel{bf16}S3_S3_PKT_S6_S6_S6_iiPfS7_S7_", 255, 80),
                    (f"pred_tower_dw2_kernel{bf16}S3_S3_PKT_S6_S6_S6_iiPf", 227, dw2_spill),
                    ("pred_tower_fwd_kernelIfEEvPKfS2_PKT_S5_S5_S5_S5_iiPf", 80, 0),
                    ("pred_tower_sum_kernelEPKfixPf", 22, 0)))}}

    got = chip_smoke.kernel_ptxas(info())
    assert set(got) == {"leaf_mean_nn_fwd", "leaf_mean_nn_bwd", "leaf_mean_nn_fwd:bf16",
                        "leaf_mean_nn_bwd:bf16", "gather_mean_fwd", "gather_mean_bwd",
                        "gather_mean_fwd:bf16", "gather_mean_bwd:bf16", "mips_topk", "mips_lse",
                        "mips_boost", "mlp_topk", "pool_membership_mask", "pred_tower_fwd:bf16",
                        "pred_tower_bwd:bf16"}
    assert set(got["pred_tower_bwd:bf16"]) == {"pred_tower_dw2_kernelI13__nv_bfloat16E",
                                               "pred_tower_sum_kernel"}
    assert got["mips_topk"] == {"topk_kernelIfLb1ELi0EE": {"registers": 168, "spill_bytes": 0}}
    assert got["mips_boost"] == {"topk_kernelIfLb1ELi1EE": {"registers": 172, "spill_bytes": 0}}
    assert got["mips_lse"] == {"topk_kernelIfLb0ELi2EE": {"registers": 150, "spill_bytes": 0}}
    assert got["mlp_topk"] == {"mlp_topk_kernelILb1EE": {"registers": 214, "spill_bytes": 0}}
    assert got["pool_membership_mask"]["pool_mask_kernel"]["registers"] == 40
    with pytest.raises(AssertionError, match="topk_kernelIfLb1ELi0EE spills 12 bytes"):
        chip_smoke.kernel_ptxas(info(topk_spill=8))
    with pytest.raises(AssertionError, match="topk_kernelIfLb1ELi1EE spills 12 bytes"):
        chip_smoke.kernel_ptxas(info(boost_spill=8))
    with pytest.raises(AssertionError, match="dw2_kernelI13__nv_bfloat16E spills 12 bytes"):
        chip_smoke.kernel_ptxas(info(dw2_spill=8))


def test_kernel_probe_patches_apply_to_the_sources():
    """kernel_probe.py edits copies of the kernel sources by text: every
    edit must still find its one line."""
    import os

    import kernel_probe

    csrc = kernel_probe.build.CSRC_DIR
    topk = open(os.path.join(csrc, "topk_mips.cu")).read()
    pool = open(os.path.join(csrc, "pool_mask.cu")).read()
    for src, edits in ((topk, kernel_probe.SCORE_ONLY), (topk, kernel_probe.TOPK_PHASES),
                       (pool, kernel_probe.POOL_BLOCKS)):
        assert kernel_probe.patch(src, edits) != src
    with pytest.raises(RuntimeError, match="no longer has one"):
        kernel_probe.patch(pool, kernel_probe.SCORE_ONLY)


@pytest.mark.parametrize("agg,dtype,dedup", [("lstm", torch.bfloat16, False),
                                             ("lstm_edge", None, True)])
def test_train_lstm_rehearsal(data, capsys, agg, dtype, dedup):
    """Phases train_lstm (bf16, tree) and train_lstm_edge_dedup (f32, dedup'd
    forward) through the device epochs' eager body: the losses fall, the
    trained model beats its random weights, the served run ranks alike
    through both routes, no kernel launches on the CPU; the dedup phase's
    two steps from one state agree."""
    phase = "train_lstm_edge_dedup" if dedup else "train_lstm"
    launches = chip_smoke.phase_train_lstm(
        torch.device("cpu"), data, phase=phase, agg=agg, dtype=dtype, dedup=dedup, hidden=32,
        out=16, steps=16, valid_steps=2, batch_size=128, pool=48, check_steps=3,
        serve_users=16, on_card=False)
    assert not any(launches.values())
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert report["phase"] == phase and report["aggregator"] == agg
    # 112 cell updates a tree step at fanouts (8, 4); 48 a dedup'd step.
    cells = 48 if dedup else 112
    assert report["launches_per_step"] == {
        "leaf_mean_nn_fwd": 0, "leaf_mean_nn_bwd": 0, "pool_membership_mask": 2,
        "gather_mean_fwd": 0, "gather_mean_bwd": 0, "lstm_cell_fwd": cells,
        "lstm_cell_bwd": cells}
    assert report["cell_updates"] % cells == 0 and report["cell_updates"] > 0
    assert report["recall"] > report["random_weights_recall"]
    assert set(report["serve"]["routes"]) == {"plain", "boosted"}
    assert ("step_grads_twice" in report) == dedup
    if dedup:
        assert report["step_grads_twice"]["bit_identical"]


def test_remat_rehearsal(data, capsys):
    """Phase remat on the CPU: the remat step's loss and gradients are the
    plain step's bits, at dropout 0 and at the phase's dropout."""
    launches = chip_smoke.phase_remat(torch.device("cpu"), data, hidden=32, out=16,
                                      batch_size=128, pool=48, replays=3, on_card=False)
    assert launches == {"pool_membership_mask": 0, "lstm_cell_fwd": 0, "lstm_cell_bwd": 0}
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert report["phase"] == "remat" and report["bit_identical"]
    assert report["cell_updates"] == 3 * 112 < report["cell_updates_remat"]
    assert report["dropout"]["p"] == 0.5 and report["dropout"]["bit_identical"]
    assert report["dropout"]["loss"] != report["loss"]


def test_sharded_serving_rehearsal(data, capsys):
    """Phase sharded_serving on the CPU with meshes of 3 and 7 CPU entries
    (7 leaves a padded last shard): every ranking equals single-device
    ``get_recs`` (the boosted ones within the near-tie rule), the mesh
    request equals the single-device one, the sharded embeddings are within
    JAX's tolerance of the full-graph pass (the bench graph's rows are capped
    at 32: the pass reads them whole), ``main_inference --mesh 1`` in
    its own process prints what the run without it prints; no kernel
    launches on the CPU."""
    launches = chip_smoke.phase_sharded_serving(
        torch.device("cpu"), data, hidden=32, out=16, shard_counts=(3, 7), request_users=64,
        cli_users=8, node_chunk=32, on_card=False)
    assert launches == dict.fromkeys(chip_smoke.SHARDED_ROWS, 0)
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert report["phase"] == "sharded_serving" and report["node_chunk"] == 32
    ranks = report["rank_all_users"]
    assert [(r["shards"], r["boost"]) for r in ranks] == [(3, False), (3, True), (7, False),
                                                         (7, True)]
    assert all(r["users"] == 300 and not r["rows_differing"] for r in ranks)
    assert report["request"]["rows_differing"] == 0
    assert report["cli_mesh_1"]["identical"] and report["cli_mesh_1"]["users"] == 8
    for emb in report["embeddings"].values():
        assert emb["max_abs_err"] <= 1e-5 and emb["leaf_launches"] == 0
    g = data.graph
    assert any(int(rel.deg.sum()) < rel.num_edges for rel in g.rels.values())  # capped rows
    # 300 users over 3 shards: 100 ids a shard, 4 chunks of 32; 120 items: 40, 2 chunks.
    assert report["embeddings_expected_leaf_launches"] == 3 * (
        4 * chip_smoke.leaf_branches(g, "user", 2) + 2 * chip_smoke.leaf_branches(g, "item", 2))
    assert set(report["request_breakdown_s"]) == {"load_run", "build_model", "uncap", "embed",
                                                  "bought_table", "rank"}


def test_train_sharded_rehearsal(data, capsys):
    """Phase train_sharded on the CPU at a tiny width: the dp step over
    meshes of 1, 2 and 4 CPU entries (the loss falls), the kernel route
    against the plain one and the dedup'd dp step against the plain gather
    (same draws), the tp-dp step over a (2, 2) mesh with the hash-sharded
    item table and sharded item adjacency (equal to the dp step, no id
    lost), and ``train_minibatch(mesh=...)`` row-sharded against replicated;
    no kernel launches on the CPU."""
    launches = chip_smoke.phase_train_sharded(
        torch.device("cpu"), data, steps=16, tp_steps=3, on_card=False,
        shapes=(32, 16, 128, 48, (4, 3)), epoch_steps=4, adj_capacity=64)
    assert not any(launches.values())
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert report["phase"] == "train_sharded"
    for shards in (1, 2, 4):
        run = report[f"dp_{shards}"]
        assert run["shards"] == shards and run["edges_per_step"] == 128
        assert run["loss_last_mean"] < run["loss_first_mean"]
    checks = report["route_checks"]
    assert checks["kernels_vs_plain"]["grad_excess_over_rtol"] <= chip_smoke.STEP_GRAD_ATOL
    assert checks["dedup_vs_plain_gather"]["grad_excess_over_rtol"] <= chip_smoke.STEP_GRAD_ATOL
    # 2 shards x 8 gather-mean calls, in 4 shapes.
    assert sum(checks["dedup_calls_by_shape"].values()) == 2 * 8
    tp = report["tp_dp"]
    assert tp["drops_f32_step"] == {"features": 0, "adjacency": 0}
    assert tp["f32_vs_dp"]["grad_excess_over_rtol"] <= chip_smoke.STEP_GRAD_ATOL
    assert tp["exchange_bytes_per_step"]["request_bytes"] > 0
    mesh = report["train_minibatch_mesh"]
    assert len(mesh["train_loss_row_sharded"]) == 2
    assert "two_processes" not in report and "over_cards" not in report


def test_nn_over_cards_rehearsal(data):
    """The MLP head's dp step over two devices on the CPU (two CPU entries,
    the tower's plain version): the step over the devices equals the step
    over as many shards on one, bit for bit, in f32 and bf16, three more
    steps give finite losses, and no kernel launches."""
    cpu = torch.device("cpu")
    world = chip_smoke.sharded_world(cpu, data, 32, 16, 128, 48, (4, 3))
    report = chip_smoke.nn_over_cards(cpu, world, [cpu, cpu])
    assert report["shards"] == 2
    for tag in ("f32", "bf16"):
        run = report[tag]
        assert run["bit_identical"] and run["grad_excess_over_rtol"] <= 0.0
        assert len(run["captured_losses"]) == 3 and run["captured_launches"] == [0, 0]
