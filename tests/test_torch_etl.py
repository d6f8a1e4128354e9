"""The port's numpy ETL against the JAX package's pandas ETL.

The same CSV files go to the JAX package (through pandas) and to the port
(through ``data/io.read_data``); the two ``GraphData`` must be equal field by
field: id maps, adjacency arrays (values and dtype kind), ground truths,
features, popularity (f32, exactly) and every relation of the graph (padded
CSC, eids, edata).  The ETL is integer and ordering work, so every check is
exact.  Also ``presplit_data``, ``read_data``'s type inference and
``make_drift_logs`` (the same bytes as ``make_drift_csvs``).
"""

import dataclasses
import gzip
import os
import pickle
import sys

import numpy as np
import pandas as pd
import pytest
import torch
from test_torch_graph import assert_graphs_equal

from gnn_recsys_tpu.config import FixedParams as JFixedParams
from gnn_recsys_tpu.data import etl as jetl
from gnn_recsys_tpu.data.io import read_data as jread_data
from gnn_recsys_tpu.data.presplit import presplit_data as jpresplit
from gnn_recsys_tpu_torch.config import GENERAL, SPECIFIC, ColumnConfig, DataPaths, FixedParams
from gnn_recsys_tpu_torch.data import etl
from gnn_recsys_tpu_torch.data.io import read_data, write_csv
from gnn_recsys_tpu_torch.data.presplit import presplit_data
from gnn_recsys_tpu_torch.data.table import Table
from gnn_recsys_tpu_torch.utils.synthetic import make_drift_logs

C = ColumnConfig()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPORT_FILES = ("item_sport", "user_sport", "sport_sportg", "sport_feat", "sport_onehot")


def assert_same_column(want, got, what=""):
    """A pandas column (or array) and the port's: the same dtype kind
    (strings: object), NaN at the same rows, the same values elsewhere."""
    want, got = np.asarray(want), np.asarray(got)
    assert want.dtype.kind == got.dtype.kind, (what, want.dtype, got.dtype)
    assert want.shape == got.shape, (what, want.shape, got.shape)
    wna, gna = pd.isna(want), pd.isna(got)
    np.testing.assert_array_equal(wna, gna, err_msg=what)
    assert want[~wna].tolist() == got[~gna].tolist(), what


def assert_same_table(df, table, what=""):
    assert list(df.columns) == table.columns, (what, list(df.columns), table.columns)
    for col in df.columns:
        assert_same_column(df[col].to_numpy(), table[col], f"{what}[{col}]")


def assert_same_graphdata(j, t):
    for name in ("ctm_id", "pdt_id", "spt_id"):
        assert_same_table(getattr(j, name), Table(getattr(t, name)), name)
        assert isinstance(getattr(t, name), dict)
    assert j.num_nodes == t.num_nodes
    assert sorted(j.adjacency_dict) == sorted(t.adjacency_dict)
    for key, arr in j.adjacency_dict.items():
        assert_same_column(arr, t.adjacency_dict[key], key)
    for name in ("ground_truth_test", "ground_truth_purchase_test"):
        for side in (0, 1):
            assert_same_column(getattr(j, name)[side], getattr(t, name)[side], f"{name}[{side}]")
    assert_same_table(j.user_item_train_grouped, t.user_item_train_grouped, "grouped")
    assert_same_table(j.item_feat_df, t.item_feat_df, "item_feat_df")
    assert_same_table(j.sport_feat_df, t.sport_feat_df, "sport_feat_df")
    assert_graphs_equal(j.graph, t.graph)
    assert all(x.dtype == torch.float32 for feats in t.graph.ndata.values()
               for x in feats.values())
    assert sorted(t.seconds) == ["build_graph", "create_ids", "df_to_adjacency_list",
                                 "format_dfs", "import_features"]


def interactions(rows):
    """rows: (user, specific item, buy, date, timestamp)."""
    return pd.DataFrame(rows, columns=[C.ctm_id, C.specific_item_id, C.buy, C.hit_date,
                                       C.hit_timestamp])


def item_feat_df(items, generals=None):
    n = len(items)
    return pd.DataFrame({
        C.specific_item_id: items, C.general_item_id: generals if generals is not None else items,
        "is_junior": np.arange(n) % 2, "is_male": (np.arange(n) + 1) % 2,
        "is_female": np.zeros(n, int), "eco_design": np.ones(n, int),
    })


def user_feat_df(users):
    n = len(users)
    return pd.DataFrame({C.ctm_id: users, "is_male": np.arange(n) % 2,
                         "is_female": (np.arange(n) + 1) % 2})


def toy_frames():
    """``tests/test_etl.py``'s toy data, with sports, a test item in neither
    the train data nor the catalog (its ground truth is NaN), and a
    duplicate purchase."""
    train = interactions([
        ("u1", "A", 1, "2021-01-01", 1), ("u1", "B", 0, "2021-01-02", 2),
        ("u2", "A", 1, "2021-01-03", 3), ("u2", "A", 1, "2021-01-04", 4),
        ("u3", "C", 0, "2021-01-05", 5), ("u1", "C", 1, "2021-01-06", 6),
        ("u3", "B", 1, "2021-01-07", 7),
    ])
    test = interactions([("u1", "B", 1, "2021-01-08", 8), ("u2", "C", 0, "2021-01-09", 9),
                         ("u3", "Z", 1, "2021-01-09", 10)])
    return dict(
        train=train, test=test,
        item_feat=item_feat_df(["A", "B", "C", "D"], generals=["gA", "gB", "gA", "gD"]),
        user_feat=user_feat_df(["u1", "u2", "u3"]),
        item_sport=pd.DataFrame({C.specific_item_id: ["A", "B", "C"],
                                 C.spt_id: ["s1", "s1", "s2"]}),
        user_sport=pd.DataFrame({C.ctm_id: ["u1", "u2"], C.spt_id: ["s1", "s2"]}),
        sport_sportg=pd.DataFrame({C.sports_id: ["s1", "s2"], C.sportsgroup_id: ["g1", "g1"]}),
        sport_feat=pd.DataFrame({C.spt_id: ["s1", "s2", "g1"], "name": ["a", "b", "c"]}),
        sport_onehot=pd.DataFrame({C.spt_id: ["s1", "s2", "g1"], "h0": [1, 0, 0],
                                   "h1": [0, 1, 0], "h2": [0, 0, 1]}),
    )


def random_frames(seed, n_rows=400, users=30, items=36, catalog=30, general=False):
    """Generated logs: duplicate (user, item, buy) rows, timestamps with many
    ties, items missing from the catalog (unless ``general``, where every
    item needs a general id), catalog items never interacted with, a
    repeated catalog row, test users absent from train, and sports."""
    rng = np.random.default_rng(seed)
    n_items = catalog if general else items

    def logs(n, user_hi):
        days = rng.integers(0, 60, n)
        return interactions(list(zip(
            [f"u{x}" for x in rng.integers(0, user_hi, n)],
            [f"it{x}" for x in rng.integers(0, n_items, n)], rng.integers(0, 2, n).tolist(),
            [str(np.datetime64("2021-01-01") + np.timedelta64(int(d), "D")) for d in days],
            (days * 3 + rng.integers(0, 3, n)).tolist())))

    train = logs(n_rows, users)
    train = pd.concat([train, train.iloc[rng.integers(0, n_rows, n_rows // 8)]],
                      ignore_index=True)
    test = logs(n_rows // 4, users + 5)
    cat = [f"it{i}" for i in range(catalog)] + ["it900", "it901"]
    itf = item_feat_df(cat, generals=[f"g{i // 2}" for i in range(len(cat))])
    itf = pd.concat([itf, itf.iloc[[3]]], ignore_index=True)
    sports = [f"s{i}" for i in range(8)]
    groups = [f"g{i}" for i in range(3)]
    return dict(
        train=train, test=test, item_feat=itf,
        user_feat=user_feat_df([f"u{i}" for i in range(users + 5)]),
        item_sport=pd.DataFrame({
            C.specific_item_id: [f"it{x}" for x in rng.integers(0, items + 3, 50)],
            C.spt_id: [sports[x] for x in rng.integers(0, 8, 50)]}),
        user_sport=pd.DataFrame({C.ctm_id: [f"u{x}" for x in rng.integers(0, users + 5, 40)],
                                 C.spt_id: [sports[x] for x in rng.integers(0, 6, 40)]}),
        sport_sportg=pd.DataFrame({C.sports_id: sports[:6],
                                   C.sportsgroup_id: [groups[i % 3] for i in range(6)]}),
        sport_feat=pd.DataFrame({C.spt_id: sports + groups,
                                 "name": [f"n{i}" for i in range(11)]}),
        sport_onehot=pd.DataFrame({C.spt_id: sports + groups,
                                   **{f"h{j}": (np.arange(11) % 4 == j).astype(int)
                                      for j in range(4)}}),
    )


def write_frames(tmp_path, frames, sports=True):
    """Each frame to ``<name>.csv``; the paths by name."""
    paths = {}
    for name, df in frames.items():
        if name in SPORT_FILES and not sports:
            continue
        paths[name] = os.path.join(tmp_path, f"{name}.csv")
        df.to_csv(paths[name], index=False)
    return paths


def both(tmp_path, frames, fixed_kw, sports=True, **kw):
    """The JAX package's GraphData and the port's of the same files."""
    paths = write_frames(tmp_path, frames, sports)
    j = jetl.GraphData.from_dataframes(JFixedParams(**fixed_kw), **paths, **kw)
    t = etl.GraphData.from_dataframes(FixedParams(**fixed_kw), **paths, **kw)
    return j, t


NO_WINDOWS = dict(days_of_purchases=710, days_of_clicks=710, lifespan_of_items=710)
TOY_CASES = {
    "keep_all": dict(duplicates="keep_all", include_sport=False, **NO_WINDOWS),
    "keep_last": dict(duplicates="keep_last", include_sport=False),
    "count_occurrence": dict(duplicates="count_occurrence", include_sport=False),
    "count_occurrence_no_clicks": dict(duplicates="count_occurrence", discern_clicks=False,
                                       include_sport=False),
    "keep_last_no_clicks": dict(duplicates="keep_last", discern_clicks=False),
    "general_ids": dict(item_id_type=GENERAL, include_sport=False),
    "general_ids_sports": dict(item_id_type=GENERAL, duplicates="count_occurrence"),
    "sports": dict(duplicates="keep_all"),
    "purchase_window": dict(days_of_purchases=3, days_of_clicks=710, lifespan_of_items=710),
    "click_window": dict(days_of_purchases=710, days_of_clicks=3, lifespan_of_items=710),
    "lifespan": dict(days_of_purchases=365, days_of_clicks=710, lifespan_of_items=4),
    "remove": dict(remove=0.4, duplicates="keep_last"),
}


@pytest.mark.parametrize("case", sorted(TOY_CASES))
@pytest.mark.parametrize("features", ["plain", "recency_popularity"])
def test_toy_graphdata_equals_jax(tmp_path, case, features):
    """``tests/test_etl.py``'s toy data under each duplicates policy,
    GENERAL ids, sports, each time window and user removal; with recency
    and popularity edges and features or without."""
    frames = toy_frames()
    if case.startswith("general"):
        frames["test"] = frames["test"].iloc[:2]  # every item needs a general id
    kw = dict(use_recency=True, use_popularity=True, days_popularity=3) \
        if features == "recency_popularity" else {}
    j, t = both(tmp_path, frames, TOY_CASES[case], **kw)
    assert_same_graphdata(j, t)
    if case == "sports":
        assert t.num_nodes["sport"] == 3
        assert np.isnan(t.ground_truth_test[1]).sum() == 1  # the test item in neither


PROPERTY_CASES = [
    # seed, sports, remove, duplicates, discern_clicks, item ids, max_fanout
    (0, False, 0.0, "keep_all", True, SPECIFIC, None),
    (1, True, 0.3, "count_occurrence", True, SPECIFIC, None),
    (2, False, 0.5, "keep_last", False, SPECIFIC, 4),
    (3, True, 0.0, "keep_all", False, GENERAL, None),
    (4, True, 0.2, "count_occurrence", False, GENERAL, 8),
    (5, False, 0.0, "keep_last", True, SPECIFIC, None),
    (6, True, 0.7, "keep_all", True, SPECIFIC, 8),
    (7, True, 0.0, "count_occurrence", True, SPECIFIC, None),
]


@pytest.mark.parametrize("seed,sports,remove,duplicates,discern,item_ids,max_fanout",
                         PROPERTY_CASES)
def test_generated_logs_graphdata_equals_jax(tmp_path, seed, sports, remove, duplicates,
                                             discern, item_ids, max_fanout):
    """Generated logs (duplicate triples, tied timestamps, items missing
    from the catalog, test users absent from train) through the default
    windows (365 / 30 / 180 days, so the click window drops rows), recency
    and popularity, with and without sports and user removal."""
    frames = random_frames(seed, general=item_ids == GENERAL)
    fixed_kw = dict(include_sport=sports, remove=remove, duplicates=duplicates,
                    discern_clicks=discern, item_id_type=item_ids, lifespan_of_items=40)
    j, t = both(tmp_path, frames, fixed_kw, sports=sports, use_recency=True,
                use_popularity=True, days_popularity=20, max_fanout=max_fanout)
    assert_same_graphdata(j, t)
    ts = t.user_item_train_grouped[C.hit_timestamp]
    assert len(np.unique(ts)) < len(ts)  # ties in the one-key sort
    if sports:
        assert t.graph.num_edges(("item", "utilized-for", "sport")) > 0


def test_from_paths_and_tables(tmp_path):
    """``from_paths`` reads the files of ``DataPaths``; Tables and
    DataFrames in place of paths give the same GraphData."""
    frames = random_frames(9)
    paths = write_frames(tmp_path, frames)
    fixed = FixedParams(duplicates="count_occurrence")
    dp = DataPaths(train_path=paths["train"], test_path=paths["test"],
                   item_feat_path=paths["item_feat"], user_feat_path=paths["user_feat"],
                   **{f"{name}_path": paths[name] for name in SPORT_FILES})
    t = etl.GraphData.from_paths(dp, fixed, use_recency=True)
    j = jetl.GraphData.from_dataframes(JFixedParams(duplicates="count_occurrence"), **paths,
                                       use_recency=True)
    assert_same_graphdata(j, t)
    for inputs in ({k: read_data(p) for k, p in paths.items()},
                   {k: pd.read_csv(p) for k, p in paths.items()}):
        assert_same_graphdata(j, etl.GraphData.from_dataframes(fixed, **inputs,
                                                               use_recency=True))


def _empty_sports():
    return (pd.DataFrame({C.specific_item_id: [], C.spt_id: []}),
            pd.DataFrame({C.ctm_id: [], C.spt_id: []}),
            pd.DataFrame({C.sports_id: [], C.sportsgroup_id: [], C.spt_id: []}))


@pytest.mark.parametrize("windows", [(3, 710, 710), (710, 2, 710), (365, 710, 3),
                                     (710, 710, 710)])
def test_format_dfs_windows_equal_jax(tmp_path, windows):
    """``format_dfs`` alone, each time window on the toy data."""
    frames = toy_frames()
    paths = write_frames(tmp_path, frames)
    dp, dc, life = windows
    kw = dict(days_of_purchases=dp, days_of_clicks=dc, lifespan_of_items=life)
    args = [paths[k] for k in ("train", "test", "item_sport", "user_sport", "sport_sportg",
                               "item_feat", "user_feat", "sport_feat", "sport_onehot")]
    jout = jetl.format_dfs(*args, **kw)
    tout = etl.format_dfs(*args, **kw)
    for jdf, tdf in zip(jout, tout):
        assert_same_table(jdf, tdf)


def test_report_model_coverage_prints_as_jax():
    """The coverage report's lines (``tests/test_etl.py``'s case: a user
    only in the test set, removed before the report; u1, u2 and u3 stay)."""
    frames = toy_frames()
    test = pd.concat([frames["test"], interactions([("u9", "A", 1, "2021-01-09", 10)])],
                     ignore_index=True)
    user_sport = pd.DataFrame({C.ctm_id: ["u2"], C.spt_id: ["s0"]})
    empty_is, _, empty_sg = _empty_sports()
    empty_sf = pd.DataFrame({C.spt_id: []})
    lines = {}
    for name, fn, conv in (("jax", jetl.format_dfs, lambda df: df),
                           ("port", etl.format_dfs, lambda df: Table(
                               {c: df[c].to_numpy() for c in df.columns}))):
        out = []
        fn(conv(frames["train"]), conv(test), conv(empty_is), conv(user_sport), conv(empty_sg),
           conv(frames["item_feat"]), conv(frames["user_feat"]), conv(empty_sf), conv(empty_sf),
           report_model_coverage=True, print_fn=out.append)
        lines[name] = out
    assert lines["port"] == lines["jax"] == ["There are 0 users with no interactions",
                                             "and 0 with also no sports associated",
                                             "out of 3"]


def test_create_ids_contiguous_and_unseen_appended(tmp_path):
    """Users in order of appearance, unseen catalog items appended, sports
    sorted, as JAX's ``create_ids``."""
    frames = toy_frames()
    paths = write_frames(tmp_path, frames)
    j = jetl.create_ids(*(jread_data(paths[k]) for k in ("train", "user_sport",
                                                          "sport_sportg", "item_feat")))
    t = etl.create_ids(*(read_data(paths[k]) for k in ("train", "user_sport", "sport_sportg",
                                                       "item_feat")))
    for jm, tm in zip(j, t):
        assert_same_table(jm, Table(tm))
    assert t[1][C.specific_item_id].tolist() == ["A", "B", "C", "D"]
    assert t[2][C.spt_id].tolist() == ["g1", "s1", "s2"]


@pytest.mark.parametrize("sort", [True, False])
@pytest.mark.parametrize("num_min,test_days", [(3, 14), (0, 5)])
def test_presplit_equals_jax(tmp_path, sort, num_min, test_days):
    """``presplit_data``: the temporal split (one-key sort on tied
    timestamps) and the random one (``df.sample(frac, random_state=200)``),
    rows in the same order."""
    frames = random_frames(11, n_rows=800)
    paths = write_frames(tmp_path, frames, sports=False)
    jtr, jte = jpresplit(pd.read_csv(paths["item_feat"]), pd.read_csv(paths["train"]),
                         num_min=num_min, sort=sort, test_size_days=test_days)
    ttr, tte = presplit_data(read_data(paths["item_feat"]), read_data(paths["train"]),
                             num_min=num_min, sort=sort, test_size_days=test_days)
    assert_same_table(jtr, ttr, "train")
    assert_same_table(jte, tte, "test")
    assert len(tte) > 0


def test_read_data_types_equal_pandas(tmp_path):
    """``read_data``'s columns and dtype kinds against pandas' on .csv, .gz
    (``;``-separated, quoted fields holding ``;``) and .pkl (a pickled
    DataFrame, read through duck typing): integers, floats with blank and NA
    cells, integers with a blank (float64), strings with blanks, quoted
    commas."""
    csv_path = os.path.join(tmp_path, "a.csv")
    with open(csv_path, "w") as f:
        f.write("id,x,n,s,all_na,neg\n"
                "1,0.5,3,foo,,-2\n"
                "2,,4,\"a,b\",,+3\n"
                "3,NA,,bar,,0\n"
                "4,1e3,7,,,11\n")
    gz_path = os.path.join(tmp_path, "b.gz")
    with gzip.open(gz_path, "wt") as f:
        f.write('k;v;w\n"x;y";1;2.5\nz;2;\n"q";3;4\n')
    pkl_path = os.path.join(tmp_path, "c.pkl")
    with open(pkl_path, "wb") as f:
        pickle.dump(pd.read_csv(csv_path), f)
    for path in (csv_path, gz_path, pkl_path):
        want, got = jread_data(path), read_data(path)
        assert isinstance(got, Table)
        assert_same_table(want, got, path)
    got = read_data(csv_path)
    assert [got[c].dtype.kind for c in got.columns] == ["i", "f", "f", "O", "f", "i"]
    with pytest.raises(KeyError):
        read_data(os.path.join(tmp_path, "a.txt"))


def test_write_csv_round_trips(tmp_path):
    """``write_csv`` writes what pandas' ``to_csv(index=False)`` writes, and
    ``read_data`` reads it back."""
    df = random_frames(3)["train"]
    a, b = os.path.join(tmp_path, "a.csv"), os.path.join(tmp_path, "b.csv")
    df.to_csv(a, index=False)
    table = Table({c: df[c].to_numpy() for c in df.columns})
    write_csv(table, b)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()
    assert_same_table(df, read_data(b))


def test_make_drift_logs_writes_make_drift_csvs_bytes(tmp_path):
    """``make_drift_logs`` at 60 users and 40 items writes the three files
    of ``benchmarks/e2e_drift_cli.py:make_drift_csvs`` byte for byte."""
    sys.path.insert(0, ROOT)
    from benchmarks.e2e_drift_cli import make_drift_csvs

    want, wdf = make_drift_csvs(os.path.join(tmp_path, "a"), num_users=60, num_items=40)
    got, tdf = make_drift_logs(os.path.join(tmp_path, "b"), num_users=60, num_items=40)
    assert sorted(want) == sorted(got) == ["interactions", "item_feat", "user_feat"]
    for name in want:
        with open(want[name], "rb") as fa, open(got[name], "rb") as fb:
            assert fa.read() == fb.read(), name
    assert_same_table(wdf, tdf)


def test_graphdata_already_bought_is_the_purchases(tmp_path):
    """``GraphData.already_bought``: the purchase pairs, or every
    user-item pair without ``discern_clicks`` (JAX ``trial.py:219-222``)."""
    for discern, key in ((True, "purchases"), (False, "user_item")):
        _, t = both(tmp_path, toy_frames(), dict(include_sport=False, discern_clicks=discern))
        src, dst = t.already_bought
        np.testing.assert_array_equal(src, t.adjacency_dict[f"{key}_src"])
        np.testing.assert_array_equal(dst, t.adjacency_dict[f"{key}_dst"])
    assert dataclasses.is_dataclass(t)
