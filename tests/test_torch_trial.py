"""The port's user path from raw CSV logs against the JAX package:
``trial.run_trial`` (the ETL, the trial, the in-loop inference evaluation,
the qualitative checks, the plots), ``inference_eval.inference_fn`` with the
same weights as JAX's, ``inference_ondemand(rebuild_dataframes=...)``,
``evaluation/explore.py``, and the three CLIs end to end on the CPU with
what the JAX package's drill (``benchmarks/e2e_drift_cli.py``) asserts.

Tolerance: ``inference_fn``'s metrics equal JAX's within 1e-6 relative, the
f32 rounding of JAX's ratios (the port computes them in f64)."""

import argparse
import contextlib
import dataclasses
import io
import json
import os
import pickle
import shutil

import jax
import numpy as np
import pandas as pd
import pytest
import torch
from test_torch_etl import assert_same_graphdata
from test_torch_minibatch import one_torch_thread  # noqa: F401 (autouse)

from gnn_recsys_tpu import trial as jtrial
from gnn_recsys_tpu.cli import main_hp as jmain_hp
from gnn_recsys_tpu.cli import main_inference as jmain_inference
from gnn_recsys_tpu.cli import main_train as jmain_train
from gnn_recsys_tpu.config import FixedParams as JFixedParams
from gnn_recsys_tpu.config import HyperParams as JHyperParams
from gnn_recsys_tpu.data import etl as jetl
from gnn_recsys_tpu.evaluation import explore as jexplore
from gnn_recsys_tpu.inference_eval import inference_fn as jinference_fn
from gnn_recsys_tpu.train import full_batch as jfb
from gnn_recsys_tpu_torch import trial as ttrial
from gnn_recsys_tpu_torch.cli import main_hp, main_inference, main_train
from gnn_recsys_tpu_torch.config import ColumnConfig, FixedParams, HyperParams
from gnn_recsys_tpu_torch.data import etl
from gnn_recsys_tpu_torch.data.io import read_data, write_csv
from gnn_recsys_tpu_torch.data.presplit import presplit_data
from gnn_recsys_tpu_torch.data.table import Table
from gnn_recsys_tpu_torch.evaluation import explore
from gnn_recsys_tpu_torch.hpsearch import latest_checkpoint, load_checkpoint
from gnn_recsys_tpu_torch.inference import fetch_uids, inference_ondemand, postprocess_recs
from gnn_recsys_tpu_torch.inference_eval import inference_fn
from gnn_recsys_tpu_torch.models.convert import params_from_jax
from gnn_recsys_tpu_torch.utils.synthetic import make_drift_logs
from gnn_recsys_tpu_torch.utils.viz import plot_train_loss

C = ColumnConfig()
USERS, ITEMS = 150, 60
SMALL = dict(num_epochs=2, edge_batch_size=256)


@pytest.fixture(scope="module")
def logs(tmp_path_factory):
    """Drift logs at 150 users and 60 items and their 14-day presplit, as
    files: {name: path}."""
    d = str(tmp_path_factory.mktemp("logs"))
    paths, df = make_drift_logs(d, num_users=USERS, num_items=ITEMS)
    train, test = presplit_data(read_data(paths["item_feat"]), df)
    for name, table in (("train", train), ("test", test)):
        paths[name] = os.path.join(d, f"{name}.csv")
        write_csv(table, paths[name])
    return paths


def _inputs(logs):
    return dict(train=logs["train"], test=logs["test"], item_feat=logs["item_feat"],
                user_feat=logs["user_feat"])


def test_run_trial_from_dataframes(logs, tmp_path, capsys):
    """``run_trial(dataframes=...)`` on the CPU: the ETL equals JAX's, the
    stages come in order, both in-loop inference recalls are
    ``inference_fn``'s, the run directory's id maps are dicts of numpy
    columns, the qualitative checks print and the plots are drawn."""
    fixed = FixedParams(remove=0.3, include_sport=False, run_inference=2, **SMALL)
    hyper = HyperParams(embed_dim="small", popularity_importance="small")
    tables = {name: read_data(path) for name, path in _inputs(logs).items()}
    stages, runs = [], []

    def on_stage(stage, run):
        stages.append(stage)
        runs.append(run)

    result = ttrial.run_trial(fixed, hyper, dataframes=tables, save_dir=str(tmp_path / "run"),
                              save_threshold=-1.0, plots_dir=str(tmp_path / "plots"),
                              check_embedding=True, device="cpu", on_stage=on_stage)
    assert stages == ["split", "built", "trained", "evaluated", "inference_evaluated"]
    run = runs[-1]
    jgd = jetl.GraphData.from_dataframes(
        JFixedParams(remove=0.3, include_sport=False, **SMALL), **_inputs(logs),
        use_recency=hyper.use_recency, use_popularity=hyper.use_popularity,
        days_popularity=hyper.days_popularity)
    assert_same_graphdata(jgd, run.graph_data)
    for value, kw in ((result.inference_recall, {}),
                      (result.inference_recall_all_users,
                       dict(days_of_purchases=710, days_of_clicks=710, lifespan_of_items=710))):
        assert value == inference_fn(run.model, fixed, hyper, tables,
                                     remove_on_inference=fixed.remove_on_inference,
                                     device="cpu", **kw)[1]
    assert 0.0 <= result.recall <= 1.0 and result.train_time_s > 0
    with open(tmp_path / "run" / "id_maps.pkl", "rb") as f:
        id_maps = pickle.load(f)
    assert sorted(id_maps) == ["ctm_id", "pdt_id", "spt_id"]
    assert all(type(m) is dict and all(isinstance(v, np.ndarray) for v in m.values())
               for m in id_maps.values())
    assert list(id_maps["pdt_id"]) == [C.specific_item_id, "pdt_new_id"]
    assert sorted(os.listdir(tmp_path / "plots")) == ["train_loss.png", "train_metrics.png"]
    out = capsys.readouterr().out
    assert "recommended:" in out and "transactions:" in out and "recommendations:" in out


def _model_pair(logs, fixed_kw, hyper_kw):
    """Each package's model for the logs' graph, with JAX's initial weights
    loaded into the port's."""
    jfixed, fixed = JFixedParams(**fixed_kw), FixedParams(**fixed_kw)
    jhyper, hyper = JHyperParams(**hyper_kw), HyperParams(**hyper_kw)
    kw = dict(use_recency=hyper.use_recency, use_popularity=hyper.use_popularity,
              days_popularity=hyper.days_popularity)
    jgd = jetl.GraphData.from_dataframes(jfixed, **_inputs(logs), **kw)
    tgd = etl.GraphData.from_dataframes(fixed, **_inputs(logs), **kw)
    jm, tm = jtrial.build_model(jgd, jfixed, jhyper), ttrial.build_model(tgd, fixed, hyper)
    feats = {nt: jgd.graph.ndata[nt]["features"] for nt in jgd.graph.ntypes}
    params = jfb.init_model(jm, jgd.graph, feats, seed=0)
    tm.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    return (jm, params, jfixed, jhyper), (tm, fixed, hyper)


@pytest.mark.parametrize("case", ["remove", "all_windows_boosted", "node_batches"])
def test_inference_fn_matches_jax(logs, case):
    """``inference_fn`` with JAX's weights (``models/convert.py``) on the
    graph rebuilt with ``remove_on_inference``, or with 710-day windows and
    the popularity boost (a hinge-trained run with popularity on), or the
    reference's node-batch inference mode."""
    fixed_kw = dict(include_sport=False, **SMALL)
    hyper_kw = dict(embed_dim="small")
    over = dict(remove_on_inference=0.7)
    if case == "all_windows_boosted":
        hyper_kw.update(popularity_importance="large", n_layers=2)
        over.update(days_of_purchases=710, days_of_clicks=710, lifespan_of_items=710)
    if case == "node_batches":
        fixed_kw.update(inference_mode="node_batches", node_batch_size=64)
        hyper_kw.update(n_layers=2)
    (jm, params, jfixed, jhyper), (tm, fixed, hyper) = _model_pair(logs, fixed_kw, hyper_kw)
    assert hyper.serve_with_popularity_boost == (case == "all_windows_boosted")
    want = jinference_fn(params, jm, jfixed, jhyper, _inputs(logs), **over)
    got = inference_fn(tm, fixed, hyper, _inputs(logs), device="cpu", **over)
    # The same rankings: the ratios differ only by JAX's f32 rounding of them.
    assert got == pytest.approx(want, rel=1e-6, abs=1e-12)
    assert want[2] > 0


def _run_clis(logs, out, device="cpu", n_calls=2):
    """The drill's sequence through the port's CLIs: main_hp, the best
    hyperparameters to JSON, main_train, main_inference (named, --all)."""
    hp_dir = os.path.join(out, "hp")
    os.makedirs(hp_dir)
    common = ["--item-feat-path", logs["item_feat"], "--user-feat-path", logs["user_feat"],
              "--num-epochs", "2", "--edge-batch-size", "256", "--device", device]
    state = main_hp.main(["--train-path", logs["train"], "--test-path", logs["test"],
                          "--n-calls", str(n_calls), "--remove", "0.3", "--logdir", hp_dir,
                          "--result-filepath", os.path.join(hp_dir, "result_log.txt"),
                          *common])
    hyper_json = os.path.join(hp_dir, "best_hyper.json")
    with open(hyper_json, "w") as f:
        json.dump(dataclasses.asdict(load_checkpoint(latest_checkpoint(hp_dir)).best.hyper), f)
    run_dir = os.path.join(out, "run1")
    result = main_train.main(["--interactions-path", logs["interactions"], "--hyper-json",
                              hyper_json, "--patience", "3", "--out-dir", run_dir,
                              "--result-filepath", os.path.join(out, "train_log.txt"),
                              "--plots-dir", os.path.join(out, "plots"), *common])
    return state, result, run_dir


@pytest.fixture(scope="module")
def cli_run(logs, tmp_path_factory):
    out = str(tmp_path_factory.mktemp("cli"))
    with contextlib.redirect_stdout(io.StringIO()):
        state, result, run_dir = _run_clis(logs, out)
    return out, state, result, run_dir


def test_clis_end_to_end(logs, cli_run, capsys):
    """What the drill asserts: the search's log and checkpoint, the run's
    artifacts, k external item ids for each named user, and more than half
    the users under ``--all``."""
    out, state, result, run_dir = cli_run
    assert os.path.exists(os.path.join(out, "hp", "result_log.txt"))
    assert len(state.trials) == 2
    assert [f.startswith("checkpoint") for f in os.listdir(os.path.join(out, "hp"))].count(True)
    assert sorted(os.listdir(run_dir)) == ["extras.pkl", "fixed_params.json", "graph.npz",
                                           "hyper_params.json", "id_maps.pkl", "model.json",
                                           "params.npz"]
    assert result.saved_to == run_dir and os.listdir(os.path.join(out, "plots"))
    with open(os.path.join(out, "train_log.txt")) as f:
        assert f.read().startswith("FULL TRAIN recall=")
    ids = ["u7", "u42", "u123"]
    capsys.readouterr()
    recs = main_inference.main(["--run-dir", run_dir, "--k", "10", "--device", "cpu",
                                *[a for u in ids for a in ("--user-ids", u)]])
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("u")]
    assert len(lines) == len(ids)
    for ln in lines:
        uid, items = ln.split(":", 1)
        assert uid in ids and items.strip().startswith("['it")
        assert len(items.strip().strip("[]").split(",")) == 10
    assert sorted(recs) == sorted(ids)
    main_inference.main(["--run-dir", run_dir, "--all", "--k", "5", "--device", "cpu"])
    all_lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("u")]
    assert len(all_lines) > USERS // 2
    with pytest.raises(SystemExit) as err:
        main_inference.main(["--run-dir", run_dir, "--device", "cpu"])
    assert err.value.code == 2


def test_inference_ondemand_rebuilds_from_raw_data(logs, cli_run, tmp_path):
    """A run directory without ``graph.npz`` serves from the raw data
    rebuilt with the run's fixed parameters (the same tables ``main_train``
    built from: the same recommendations); without the data it refuses.
    ``fetch_uids`` and ``postprocess_recs`` take the port's dict id maps and
    pandas DataFrames alike."""
    _, _, _, run_dir = cli_run
    bare = str(tmp_path / "bare")
    shutil.copytree(run_dir, bare)
    os.remove(os.path.join(bare, "graph.npz"))
    ids = ["u7", "u42"]
    want = inference_ondemand(run_dir, ids, k=5, device="cpu")
    with pytest.raises(FileNotFoundError):
        inference_ondemand(bare, ids, k=5, device="cpu")
    interactions, item_feat = read_data(logs["interactions"]), read_data(logs["item_feat"])
    train, test = presplit_data(item_feat, interactions, test_size_days=1)
    got = inference_ondemand(bare, ids, k=5, device="cpu", rebuild_dataframes=dict(
        train=train, test=test, item_feat=item_feat, user_feat=logs["user_feat"]))
    assert got == want
    with open(os.path.join(run_dir, "id_maps.pkl"), "rb") as f:
        maps = pickle.load(f)
    frames = {k: pd.DataFrame(v) for k, v in maps.items()}
    nodes = fetch_uids(ids, maps["ctm_id"])
    np.testing.assert_array_equal(nodes, fetch_uids(ids, frames["ctm_id"]))
    recs = np.array([[0, 1], [2, 3]])
    assert postprocess_recs(recs, nodes, maps["pdt_id"], maps["ctm_id"]) == \
        postprocess_recs(recs, nodes, frames["pdt_id"], frames["ctm_id"])
    with pytest.raises(KeyError):
        fetch_uids(["nobody"], maps["ctm_id"])


def _click_options(command):
    """{option string: (default, required, flag)} of a click command (no
    default: None, whatever sentinel the click version uses)."""
    out = {}
    for p in command.params:
        default = p.default if isinstance(p.default, (bool, int, float, str, tuple)) else None
        for opt in p.opts + p.secondary_opts:
            out[opt] = (default, p.required, p.is_flag)
    return out


def _argparse_options(parser: argparse.ArgumentParser):
    out = {}
    for action in parser._actions:
        for opt in action.option_strings:
            if opt in ("-h", "--help"):
                continue
            flag = action.nargs == 0
            out[opt] = (action.default, action.required, flag)
    return out


@pytest.mark.parametrize("name", ["main_hp", "main_train", "main_inference"])
def test_cli_options_match_jax(name):
    """Every option of the JAX package's click command, with its default,
    requiredness and flag form, is the port's argparse option
    (``main_inference --mesh`` too, default 0); the port adds ``--device``
    (default cuda) and ``main_train --plots-dir`` (default ``plots``, JAX
    ``main_train.py:96``)."""
    jcmd = {"main_hp": jmain_hp, "main_train": jmain_train,
            "main_inference": jmain_inference}[name].main
    port = {"main_hp": main_hp, "main_train": main_train,
            "main_inference": main_inference}[name].build_parser()
    want, got = _click_options(jcmd), _argparse_options(port)
    added = {"--device": ("cuda", False, False)}
    if name == "main_train":
        added["--plots-dir"] = ("plots", False, False)
    if name == "main_inference":
        want["--use-popularity"] = want["--no-use-popularity"] = (None, False, True)
        got["--no-use-popularity"] = (None, False, True)
        want["--user-ids"] = ([], False, False)  # click's multiple=True: a tuple
    assert got == {**want, **added}


def test_explore_matches_jax(logs, capsys):
    """``explore_recs``, ``check_coverage`` and ``explore_sports`` print and
    return what the JAX package's do on the same GraphData and recs."""
    fixed = dict(include_sport=False)
    jgd = jetl.GraphData.from_dataframes(JFixedParams(**fixed), **_inputs(logs))
    tgd = etl.GraphData.from_dataframes(FixedParams(**fixed), **_inputs(logs))
    rng = np.random.default_rng(0)
    users = np.unique(tgd.ground_truth_test[0])[:12]
    recs = {int(u): rng.integers(-1, tgd.num_nodes["item"], 10).tolist() for u in users}
    gt = {int(u): [int(i)] for u, i in zip(*tgd.ground_truth_test)}
    out = {}
    for name, mod, gd in (("jax", jexplore, jgd), ("port", explore, tgd)):
        mod.explore_recs(recs, gd.user_item_train_grouped, gd.item_feat_df, gd.pdt_id,
                         gd.ctm_id, ground_truth=gt, num_choices=5)
        cov = mod.check_coverage(gd.user_item_train_grouped, gd.item_feat_df, gd.pdt_id, recs)
        out[name] = (capsys.readouterr().out, cov)
    assert out["port"] == out["jax"]
    assert "recommended:" in out["port"][0]
    emb = rng.normal(size=(7, 8)).astype(np.float32)
    spt = {C.spt_id: np.array([f"s{i}" for i in range(7)], dtype=object),
           "spt_new_id": np.arange(7)}
    feat = {C.spt_id: spt[C.spt_id], "name": np.array([f"n{i}" for i in range(7)], dtype=object)}
    want = jexplore.explore_sports(emb, pd.DataFrame(feat), pd.DataFrame(spt),
                                   num_choices=4, print_fn=lambda *a: None)
    assert explore.explore_sports(emb, Table(feat), spt, num_choices=4,
                                  print_fn=lambda *a: None) == want


def test_plot_train_loss_writes_both_plots(tmp_path):
    written = plot_train_loss("h", {"train_loss_list": [2.0, 1.0], "loss_list": [2.5, 1.5],
                                    "val_recall_list": [0.1, 0.2]}, out_dir=str(tmp_path))
    assert [os.path.basename(p) for p in written] == ["train_loss.png", "train_metrics.png"]
    assert all(os.path.getsize(p) > 0 for p in written)
    assert torch.get_num_threads() == 1  # the module's one-thread fixture
