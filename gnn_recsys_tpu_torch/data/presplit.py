"""Raw-data pre-splitting, without pandas.

Port of ``gnn_recsys_tpu/data/presplit.py`` (the reference's
``presplit.py:10-84``) on :class:`~gnn_recsys_tpu_torch.data.table.Table`:
drop users with fewer than ``num_min`` interactions, optionally drop items
absent from the feature file, split by the last ``test_size_days`` days (or
at random when ``sort=False``), and keep only train-set users in the test
set.  Rows come in the JAX package's order: the temporal split sorts by
``hit_timestamp`` with pandas' one-key sort (quicksort, not stable), and the
random split draws the test rows as ``df.sample(frac, random_state=200)``
draws them.
"""

from __future__ import annotations

from datetime import datetime, timedelta
from typing import Optional, Tuple

import numpy as np

from gnn_recsys_tpu_torch.config import ColumnConfig
from gnn_recsys_tpu_torch.data.io import as_table
from gnn_recsys_tpu_torch.data.table import Table, factorize, isin, unique


def presplit_data(
    item_feature_data,
    user_item_interaction_data,
    num_min: int = 3,
    remove_unk: bool = True,
    sort: bool = True,
    test_size_days: int = 14,
    item_id_col: Optional[str] = None,
    ctm_id_col: Optional[str] = None,
    columns: Optional[ColumnConfig] = None,
) -> Tuple[Table, Table]:
    """(train, test) interaction tables (JAX ``presplit.py:19-63``)."""
    columns = columns or ColumnConfig()
    item_id_col = item_id_col or columns.specific_item_id
    ctm_id_col = ctm_id_col or columns.ctm_id
    df = as_table(user_item_interaction_data)

    if num_min > 0:
        # Each row's user's interaction count (value_counts mapped back).
        codes, n = factorize(df[ctm_id_col])
        df = df[np.bincount(codes, minlength=n)[codes] >= num_min]

    if remove_unk:
        df = df[isin(df[item_id_col], unique(as_table(item_feature_data)[item_id_col]))]

    dates = df[columns.hit_date]
    most_recent = datetime.strptime(max(dates), "%Y-%m-%d")
    if sort:
        df = df.sort_values(columns.hit_timestamp)
        limit_date = datetime.strftime(
            most_recent - timedelta(days=int(test_size_days)), "%Y-%m-%d")
        in_train = df[columns.hit_date] <= limit_date
        train_set, test_set = df[in_train], df[~in_train]
    else:
        oldest = datetime.strptime(min(dates), "%Y-%m-%d")
        total_days = max((most_recent - oldest).days, 1)
        test_size = min(test_size_days / total_days, 1.0)
        # pandas' df.sample(frac=test_size, random_state=200).
        n = len(df)
        picked = np.random.RandomState(200).choice(n, size=round(test_size * n),
                                                   replace=False).astype(np.intp)
        test_set = df.take(picked)
        in_train = np.ones(n, dtype=bool)
        in_train[picked] = False
        train_set = df[in_train]

    test_set = test_set[isin(test_set[ctm_id_col], unique(train_set[ctm_id_col]))]
    return train_set, test_set
