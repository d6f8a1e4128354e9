"""Interaction logs -> HeteroGraph, in numpy (no pandas).

Port of ``gnn_recsys_tpu/data/etl.py`` (the reference's ``src/builder.py``
and ``DataLoader``) on :class:`~gnn_recsys_tpu_torch.data.table.Table`, with
the JAX package's row order, ids, dtypes and random stream, so that both
packages build the same graph from the same files:

* :func:`format_dfs`: time windows on purchases, clicks and item lifespan,
  random user removal, SPECIFIC -> GENERAL item ids, item-sport dedup;
* :func:`create_ids`: users and train items in order of appearance, unseen
  catalog items appended, sports sorted;
* :func:`df_to_adjacency_list`: id joins, the duplicates policy, the
  clicks / purchases split and the test ground truths (float64 with NaN
  where a test item is in neither the train data nor the catalog);
* :func:`import_features`: user, item and sport features, item popularity;
* :class:`GraphData`: the above in order, then the graph through
  :func:`~gnn_recsys_tpu_torch.graph.hetero.build_hetero_graph`.

Id maps are plain ``dict[str, np.ndarray]`` (the external id column, then
``ctm_new_id`` / ``pdt_new_id`` / ``spt_new_id``), so that a run directory's
``id_maps.pkl`` unpickles without pandas.  Every reverse relation is built
from the same rows as its forward one, so both share edge ids.
"""

from __future__ import annotations

import dataclasses
import time
from datetime import datetime, timedelta
from typing import Dict, Optional, Tuple

import numpy as np

from gnn_recsys_tpu_torch.config import GENERAL, SPECIFIC, ColumnConfig, DataPaths, FixedParams
from gnn_recsys_tpu_torch.data.io import as_table, read_data
from gnn_recsys_tpu_torch.data.table import Table, group_count, isin, isna, unique, value_counts
from gnn_recsys_tpu_torch.graph.hetero import HeteroGraph, build_hetero_graph

MAX_DAYS = 710  # the reference's "no filter" sentinel (src/builder.py:97-113)
IdMap = Dict[str, np.ndarray]


def _limit_date(df: Table, date_col: str, days: int) -> str:
    most_recent = datetime.strptime(max(df[date_col]), "%Y-%m-%d")
    return datetime.strftime(most_recent - timedelta(days=int(days)), "%Y-%m-%d")


def _as_df(path_or_df) -> Table:
    if isinstance(path_or_df, str):
        return read_data(path_or_df)
    return as_table(path_or_df)


def no_sport_tables(columns: Optional[ColumnConfig] = None) -> Dict[str, Table]:
    """:func:`format_dfs`'s sport inputs for a graph without sports: empty
    tables with the columns the ETL reads.  Item-sport files carry the
    SPECIFIC id only (``format_dfs`` merges the GENERAL one in).  Empty
    columns are float64, as pandas makes them."""
    c = columns or ColumnConfig()
    sport = Table({c.spt_id: []})
    return dict(item_sport=Table({c.specific_item_id: [], c.spt_id: []}),
                user_sport=Table({c.ctm_id: [], c.spt_id: []}),
                sport_sportg=Table({c.sports_id: [], c.sportsgroup_id: [], c.spt_id: []}),
                sport_feat=sport, sport_onehot=sport)


def format_dfs(
    train,
    test,
    item_sport,
    user_sport,
    sport_sportg,
    item_feat,
    user_feat,
    sport_feat,
    sport_onehot,
    remove: float = 0.0,
    item_id_type: str = SPECIFIC,
    days_of_purchases: int = MAX_DAYS,
    days_of_clicks: int = MAX_DAYS,
    lifespan_of_items: int = MAX_DAYS,
    report_model_coverage: bool = False,
    columns: Optional[ColumnConfig] = None,
    print_fn=print,
):
    """Time windows and user subsampling (JAX ``etl.py:67-191``).  Each
    input is a path, a Table or a DataFrame."""
    c = columns or ColumnConfig()
    user_item_train = _as_df(train)
    user_item_test = _as_df(test)
    item_feat_df = _as_df(item_feat)
    user_feat_df = _as_df(user_feat)
    sport_feat_df = _as_df(sport_feat)
    sport_onehot_df = _as_df(sport_onehot)

    item_list = None
    if days_of_purchases < MAX_DAYS:
        lim = _limit_date(user_item_train, c.hit_date, days_of_purchases)
        user_item_train = user_item_train[(user_item_train[c.hit_date] >= lim)
                                          | (user_item_train[c.buy] == 0)]
    if days_of_clicks < MAX_DAYS:
        lim = _limit_date(user_item_train, c.hit_date, days_of_clicks)
        user_item_train = user_item_train[(user_item_train[c.hit_date] >= lim)
                                          | (user_item_train[c.buy] == 1)]
    if lifespan_of_items < days_of_purchases:
        lim = _limit_date(user_item_train, c.hit_date, lifespan_of_items)
        item_list = unique(user_item_train[user_item_train[c.hit_date] >= lim][c.specific_item_id])
        user_item_train = user_item_train[isin(user_item_train[c.specific_item_id], item_list)]

    if remove > 0:
        # The JAX package seeds numpy's global generator with 11 and shuffles
        # the users in order of appearance: the same stream.
        ctm_list = unique(user_item_train[c.ctm_id])
        np.random.RandomState(11).shuffle(ctm_list)
        ctm_list = ctm_list[: int(len(ctm_list) * (1 - remove))]
        user_item_train = user_item_train[isin(user_item_train[c.ctm_id], ctm_list)]
        user_item_test = user_item_test[isin(user_item_test[c.ctm_id], ctm_list)]
    else:
        # No user is only in the test set (src/builder.py:131-133).
        user_item_test = user_item_test[isin(user_item_test[c.ctm_id],
                                             unique(user_item_train[c.ctm_id]))]

    if item_id_type == GENERAL:
        mapping = item_feat_df[[c.specific_item_id, c.general_item_id]].drop_duplicates()
        user_item_train = user_item_train.merge(mapping, how="left", on=c.specific_item_id)
        user_item_test = user_item_test.merge(mapping, how="left", on=c.specific_item_id)
        if isna(user_item_train[c.general_item_id]).any() or \
                isna(user_item_test[c.general_item_id]).any():
            raise ValueError("an interaction's item has no general id in the item features")

    item_sport_interaction = _as_df(item_sport)
    if item_list is not None:
        item_sport_interaction = item_sport_interaction[
            isin(item_sport_interaction[c.specific_item_id], item_list)]
    if item_id_type == GENERAL:
        # Without dedup: a one-to-many merge where item_feat repeats an item.
        item_sport_interaction = item_sport_interaction.merge(
            item_feat_df[[c.specific_item_id, c.general_item_id]], how="left",
            on=c.specific_item_id)
    item_sport_interaction = item_sport_interaction.drop_duplicates()

    user_sport_interaction = _as_df(user_sport)
    if remove > 0:
        user_sport_interaction = user_sport_interaction[
            isin(user_sport_interaction[c.ctm_id], ctm_list)]

    sport_sportg_interaction = _as_df(sport_sportg)

    if report_model_coverage:
        # Test users the windows leave coverable (reference src/builder.py:
        # 167-176): with no train interaction, and of those with no sport.
        train_users = set(unique(user_item_train[c.ctm_id]).tolist())
        test_users = unique(user_item_test[c.ctm_id]).tolist()
        sport_users = set(unique(user_sport_interaction[c.ctm_id]).tolist())
        no_interactions = [u for u in test_users if u not in train_users]
        print_fn(f"There are {len(no_interactions)} users with no interactions")
        covered = train_users | sport_users
        cold = [u for u in test_users if u not in covered]
        print_fn(f"and {len(cold)} with also no sports associated")
        print_fn(f"out of {len(test_users)}")

    return (user_item_train, user_item_test, item_sport_interaction, user_sport_interaction,
            sport_sportg_interaction, item_feat_df, user_feat_df, sport_feat_df,
            sport_onehot_df)


def create_ids(
    user_item_train: Table,
    user_sport_interaction: Table,
    sport_sportg_interaction: Table,
    item_feat_df: Table,
    item_id_type: str = SPECIFIC,
    columns: Optional[ColumnConfig] = None,
) -> Tuple[IdMap, IdMap, IdMap]:
    """Contiguous node ids (JAX ``etl.py:194-229``): users in train order;
    train items first, unseen catalog items appended; sports sorted."""
    c = columns or ColumnConfig()
    item_col = c.item_id(item_id_type)

    users = unique(user_item_train[c.ctm_id])
    train_pdt = unique(user_item_train[item_col])
    all_pdt = unique(item_feat_df[item_col])
    items = np.concatenate([train_pdt, all_pdt[~isin(all_pdt, train_pdt)]])
    sports = np.unique(np.concatenate([
        unique(sport_sportg_interaction[c.sports_id]),
        unique(sport_sportg_interaction[c.sportsgroup_id]),
        unique(user_sport_interaction[c.spt_id]),
    ]))
    return ({c.ctm_id: users, "ctm_new_id": np.arange(len(users), dtype=np.int64)},
            {item_col: items, "pdt_new_id": np.arange(len(items), dtype=np.int64)},
            {c.spt_id: sports, "spt_new_id": np.arange(len(sports), dtype=np.int64)})


def df_to_adjacency_list(
    user_item_train: Table,
    user_item_test: Table,
    item_sport_interaction: Table,
    user_sport_interaction: Table,
    sport_sportg_interaction: Table,
    ctm_id: IdMap,
    pdt_id: IdMap,
    spt_id: IdMap,
    item_id_type: str = SPECIFIC,
    discern_clicks: bool = False,
    duplicates: str = "keep_all",
    columns: Optional[ColumnConfig] = None,
):
    """Id joins, the duplicates policy and each edge type's src / dst
    arrays (JAX ``etl.py:232-347``)."""
    c = columns or ColumnConfig()
    item_col = c.item_id(item_id_type)
    ctm, pdt, spt = Table(ctm_id), Table(pdt_id), Table(spt_id)
    adjacency_dict = {}

    user_item_train = user_item_train.merge(ctm, how="left", on=c.ctm_id)
    user_item_train = user_item_train.merge(pdt, how="left", on=item_col)

    if duplicates in ("keep_last", "count_occurrence"):
        keys = [c.buy, "ctm_new_id", "pdt_new_id"]
        grouped = group_count(user_item_train, keys, c.specific_item_id)
        user_item_train = user_item_train.drop_duplicates(subset=keys, keep="last")
        user_item_train = user_item_train.sort_values(keys)
        if len(user_item_train) != len(grouped):
            raise AssertionError("duplicates: groups and kept rows differ in number")
        user_item_train["num_interaction"] = grouped["count"]
        # One key: pandas' quicksort, so tied timestamps come as JAX's do.
        user_item_train = user_item_train.sort_values(c.hit_timestamp)
        buy = user_item_train[c.buy]
        if discern_clicks:
            adjacency_dict["clicks_num"] = user_item_train["num_interaction"][buy == 0]
            adjacency_dict["purchases_num"] = user_item_train["num_interaction"][buy == 1]
        else:
            adjacency_dict["user_item_num"] = user_item_train["num_interaction"]

    if discern_clicks:
        clicks = user_item_train[user_item_train[c.buy] == 0]
        purchases = user_item_train[user_item_train[c.buy] == 1]
        adjacency_dict["clicks_src"] = clicks["ctm_new_id"]
        adjacency_dict["clicks_dst"] = clicks["pdt_new_id"]
        adjacency_dict["purchases_src"] = purchases["ctm_new_id"]
        adjacency_dict["purchases_dst"] = purchases["pdt_new_id"]
    else:
        adjacency_dict["user_item_src"] = user_item_train["ctm_new_id"]
        adjacency_dict["user_item_dst"] = user_item_train["pdt_new_id"]

    user_item_test = user_item_test.merge(ctm, how="left", on=c.ctm_id)
    user_item_test = user_item_test.merge(pdt, how="left", on=item_col)
    buys_test = user_item_test[user_item_test[c.buy] == 1]
    ground_truth_purchase_test = (buys_test["ctm_new_id"], buys_test["pdt_new_id"])
    ground_truth_test = (user_item_test["ctm_new_id"], user_item_test["pdt_new_id"])

    item_sport = item_sport_interaction.merge(spt, how="left", on=c.spt_id).merge(
        pdt, how="left", on=item_col).dropna(["spt_new_id", "pdt_new_id"])
    adjacency_dict["item_sport_src"] = item_sport["pdt_new_id"].astype(np.int64)
    adjacency_dict["item_sport_dst"] = item_sport["spt_new_id"].astype(np.int64)

    user_sport = user_sport_interaction.merge(spt, how="left", on=c.spt_id).merge(
        ctm, how="left", on=c.ctm_id).dropna(["spt_new_id", "ctm_new_id"])
    adjacency_dict["user_sport_src"] = user_sport["ctm_new_id"].astype(np.int64)
    adjacency_dict["user_sport_dst"] = user_sport["spt_new_id"].astype(np.int64)

    # No dropna here, as in the JAX package (float64 with NaN if a sport is
    # missing, which create_ids rules out).
    ss = sport_sportg_interaction.merge(spt, how="left", left_on=c.sports_id,
                                        right_on=c.spt_id).merge(
        spt, how="left", left_on=c.sportsgroup_id, right_on=c.spt_id)
    adjacency_dict["sport_sportg_src"] = ss["spt_new_id_x"]
    adjacency_dict["sport_sportg_dst"] = ss["spt_new_id_y"]

    return adjacency_dict, ground_truth_test, ground_truth_purchase_test, user_item_train


def import_features(
    num_nodes: Dict[str, int],
    user_feat_df: Table,
    item_feat_df: Table,
    sport_onehot_df: Optional[Table],
    ctm_id: IdMap,
    pdt_id: IdMap,
    spt_id: IdMap,
    user_item_train: Table,
    get_popularity: bool = False,
    num_days_pop: int = 0,
    item_id_type: str = SPECIFIC,
    columns: Optional[ColumnConfig] = None,
) -> Dict[str, np.ndarray]:
    """Zero-initialized, scatter-filled feature matrices and item
    popularity (JAX ``etl.py:350-417``)."""
    c = columns or ColumnConfig()
    item_col = c.item_id(item_id_type)
    out: Dict[str, np.ndarray] = {}

    uf = user_feat_df.merge(Table(ctm_id), how="inner", on=c.ctm_id)
    user_feat = np.zeros((num_nodes["user"], 2), dtype=np.float32)
    user_feat[uf["ctm_new_id"].astype(int)] = np.stack((uf["is_male"], uf["is_female"]), axis=1)
    out["user_feat"] = user_feat

    if item_id_type == SPECIFIC:
        itf = item_feat_df.merge(Table(pdt_id), how="left", on=item_col)
        with np.errstate(invalid="ignore"):
            itf = itf[itf["pdt_new_id"] < num_nodes["item"]]
        feats = np.stack([itf[name] for name in ("is_junior", "is_male", "is_female",
                                                 "eco_design")], axis=1)
        item_feat = np.zeros((num_nodes["item"], 4), dtype=np.float32)
        item_feat[itf["pdt_new_id"].astype(int)] = feats
    elif item_id_type == GENERAL:
        # General ids have no per-SKU features (src/builder.py:454-455).
        item_feat = np.zeros((num_nodes["item"], 4), dtype=np.float32)
    else:
        raise KeyError(f"Item ID {item_id_type} not recognized.")
    out["item_feat"] = item_feat

    if sport_onehot_df is not None and "sport" in num_nodes:
        sf = sport_onehot_df.merge(Table(spt_id), how="inner", on=c.spt_id)
        sf = sf.sort_values("spt_new_id").drop([c.spt_id, "spt_new_id"])
        feats = np.stack([sf[name] for name in sf.columns], axis=1) if sf.columns else \
            np.zeros((len(sf), 0))
        if feats.shape[0] != num_nodes["sport"]:
            raise ValueError(f"{feats.shape[0]} sport feature rows for {num_nodes['sport']} "
                             f"sports")
        out["sport_feat"] = feats.astype(np.float32)

    if get_popularity:
        pop = np.zeros((num_nodes["item"], 1), dtype=np.float32)
        pop_df = user_item_train
        if "pdt_new_id" not in pop_df:
            pop_df = pop_df.merge(Table(pdt_id), how="left", on=item_col)
        lim = _limit_date(pop_df, c.hit_date, num_days_pop)
        ids, counts = value_counts(pop_df[pop_df[c.hit_date] >= lim]["pdt_new_id"])
        pop[ids.astype(int), 0] = counts / counts.sum()
        out["item_pop"] = pop
    return out


def _recency_days(dates: np.ndarray) -> np.ndarray:
    """Whole days from each ``YYYY-MM-DD`` date to the latest, + 1."""
    latest = np.datetime64(max(dates), "D")
    return (latest - dates.astype("datetime64[D]")).astype(np.int64) + 1


@dataclasses.dataclass
class GraphData:
    """ETL output bundle: the graph, id maps and ground truths (the
    reference's ``DataLoader``, src/utils_data.py:119-238).  ``seconds``: the
    host time of each stage of :meth:`from_dataframes` (``format_dfs``,
    ``create_ids``, ``df_to_adjacency_list``, ``import_features``,
    ``build_graph``)."""

    graph: HeteroGraph
    ctm_id: IdMap
    pdt_id: IdMap
    spt_id: IdMap
    ground_truth_test: Tuple[np.ndarray, np.ndarray]
    ground_truth_purchase_test: Tuple[np.ndarray, np.ndarray]
    num_nodes: Dict[str, int]
    adjacency_dict: Dict[str, np.ndarray]
    user_item_train_grouped: Table
    item_feat_df: Optional[Table] = None
    sport_feat_df: Optional[Table] = None
    seconds: Dict[str, float] = dataclasses.field(default_factory=dict)

    @property
    def already_bought(self) -> Tuple[np.ndarray, np.ndarray]:
        """The purchase pairs, which recommendations leave out."""
        a = self.adjacency_dict
        return (a.get("purchases_src", a.get("user_item_src")),
                a.get("purchases_dst", a.get("user_item_dst")))

    @classmethod
    def from_dataframes(
        cls,
        fixed_params: FixedParams,
        train,
        test,
        item_sport=None,
        user_sport=None,
        sport_sportg=None,
        item_feat=None,
        user_feat=None,
        sport_feat=None,
        sport_onehot=None,
        use_recency: bool = False,
        use_popularity: bool = False,
        days_popularity: int = 0,
        columns: Optional[ColumnConfig] = None,
        max_fanout: Optional[int] = None,
    ) -> "GraphData":
        """The graph of the given tables or files (JAX ``etl.py:437-624``)."""
        c = columns or ColumnConfig()
        fp = fixed_params
        include_sport = fp.include_sport and item_sport is not None
        seconds: Dict[str, float] = {}
        t = time.perf_counter()

        def lap(stage):
            nonlocal t
            now = time.perf_counter()
            seconds[stage] = now - t
            t = now

        sports = dict(item_sport=item_sport, user_sport=user_sport, sport_sportg=sport_sportg,
                      sport_feat=sport_feat, sport_onehot=sport_onehot)
        (user_item_train, user_item_test, item_sport_interaction, user_sport_interaction,
         sport_sportg_interaction, item_feat_df, user_feat_df, sport_feat_df,
         sport_onehot_df) = format_dfs(
            train, test, item_feat=item_feat, user_feat=user_feat,
            **(sports if include_sport else no_sport_tables(c)),
            remove=fp.remove, item_id_type=fp.item_id_type,
            days_of_purchases=fp.days_of_purchases, days_of_clicks=fp.days_of_clicks,
            lifespan_of_items=fp.lifespan_of_items,
            report_model_coverage=fp.report_model_coverage, columns=c)
        lap("format_dfs")

        ctm_id, pdt_id, spt_id = create_ids(user_item_train, user_sport_interaction,
                                            sport_sportg_interaction, item_feat_df,
                                            item_id_type=fp.item_id_type, columns=c)
        lap("create_ids")

        a, ground_truth_test, ground_truth_purchase_test, grouped = df_to_adjacency_list(
            user_item_train, user_item_test, item_sport_interaction, user_sport_interaction,
            sport_sportg_interaction, ctm_id, pdt_id, spt_id, item_id_type=fp.item_id_type,
            discern_clicks=fp.discern_clicks, duplicates=fp.duplicates, columns=c)
        lap("df_to_adjacency_list")

        num_nodes = {"user": len(ctm_id["ctm_new_id"]), "item": len(pdt_id["pdt_new_id"])}
        if include_sport:
            num_nodes["sport"] = len(spt_id["spt_new_id"])
        buys, bought_by = ("user", "buys", "item"), ("item", "bought-by", "user")
        clicks, clicked_by = ("user", "clicks", "item"), ("item", "clicked-by", "user")
        if fp.discern_clicks:
            schema = {buys: (a["purchases_src"], a["purchases_dst"]),
                      bought_by: (a["purchases_dst"], a["purchases_src"]),
                      clicks: (a["clicks_src"], a["clicks_dst"]),
                      clicked_by: (a["clicks_dst"], a["clicks_src"])}
        else:
            schema = {buys: (a["user_item_src"], a["user_item_dst"]),
                      bought_by: (a["user_item_dst"], a["user_item_src"])}
        if include_sport:
            schema.update({
                ("item", "utilized-for", "sport"): (a["item_sport_src"], a["item_sport_dst"]),
                ("sport", "utilizes", "item"): (a["item_sport_dst"], a["item_sport_src"]),
                ("user", "practices", "sport"): (a["user_sport_src"], a["user_sport_dst"]),
                ("sport", "practiced-by", "user"): (a["user_sport_dst"], a["user_sport_src"]),
                ("sport", "belongs-to", "sport"): (a["sport_sportg_src"], a["sport_sportg_dst"]),
                ("sport", "includes", "sport"): (a["sport_sportg_dst"], a["sport_sportg_src"]),
            })

        features = import_features(num_nodes, user_feat_df, item_feat_df,
                                   sport_onehot_df if include_sport else None, ctm_id, pdt_id,
                                   spt_id, grouped, get_popularity=use_popularity,
                                   num_days_pop=days_popularity, item_id_type=fp.item_id_type,
                                   columns=c)
        lap("import_features")
        ndata: Dict[str, Dict[str, np.ndarray]] = {
            "user": {"features": features["user_feat"]},
            "item": {"features": features["item_feat"]},
        }
        if "sport_feat" in features:
            ndata["sport"] = {"features": features["sport_feat"]}
        if use_popularity:
            ndata["item"]["popularity"] = features["item_pop"]

        # Edge features, shared by each forward and reverse etype
        # (src/utils_data.py:287-315): recency and occurrence counts.
        edata: Dict[Tuple[str, str, str], Dict[str, np.ndarray]] = {}
        if use_recency:
            recency = _recency_days(grouped[c.hit_date])
            if fp.discern_clicks:
                buy = grouped[c.buy]
                for ets, rec in (((buys, bought_by), recency[buy == 1]),
                                 ((clicks, clicked_by), recency[buy == 0])):
                    for et in ets:
                        edata.setdefault(et, {})["recency"] = rec
            else:
                for et in (buys, bought_by):
                    edata.setdefault(et, {})["recency"] = recency
        if fp.duplicates == "count_occurrence":
            pairs = (((buys, bought_by), a["purchases_num"]),
                     ((clicks, clicked_by), a["clicks_num"])) if fp.discern_clicks else \
                (((buys, bought_by), a["user_item_num"]),)
            for ets, occurrence in pairs:
                for et in ets:
                    edata.setdefault(et, {})["occurrence"] = occurrence

        graph = build_hetero_graph(schema, num_nodes, edata=edata, ndata=ndata,
                                   max_fanout=max_fanout)
        lap("build_graph")
        return cls(graph=graph, ctm_id=ctm_id, pdt_id=pdt_id, spt_id=spt_id,
                   ground_truth_test=ground_truth_test,
                   ground_truth_purchase_test=ground_truth_purchase_test, num_nodes=num_nodes,
                   adjacency_dict=a, user_item_train_grouped=grouped,
                   item_feat_df=item_feat_df, sport_feat_df=sport_feat_df, seconds=seconds)

    @classmethod
    def from_paths(cls, paths: DataPaths, fixed_params: FixedParams, **kwargs) -> "GraphData":
        """:meth:`from_dataframes` of the files named in ``paths`` (empty
        sport paths: no sports)."""
        return cls.from_dataframes(fixed_params, **raw_inputs(paths), **kwargs)


def raw_inputs(paths: DataPaths) -> Dict[str, Optional[str]]:
    """The keyword arguments of :meth:`GraphData.from_dataframes` for the
    files of ``paths`` (JAX ``etl.py:633-645``, ``trial.py:306-316``)."""
    return dict(train=paths.train_path, test=paths.test_path,
                item_sport=paths.item_sport_path or None,
                user_sport=paths.user_sport_path or None,
                sport_sportg=paths.sport_sportg_path or None,
                item_feat=paths.item_feat_path, user_feat=paths.user_feat_path,
                sport_feat=paths.sport_feat_path or None,
                sport_onehot=paths.sport_onehot_path or None)
