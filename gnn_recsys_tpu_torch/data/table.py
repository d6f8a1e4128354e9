"""The smallest columnar table the ETL needs, in numpy.

An ordered mapping of equal-length numpy columns with the operations of the
JAX package's pandas ETL (``data/etl.py``, ``data/presplit.py``), each giving
the rows in pandas' order:

* :func:`unique` in order of first appearance (not ``np.unique``'s sorted
  order);
* :meth:`Table.merge`, left or inner: the left order is kept, a left row
  repeats in right order where the right side repeats its key, and where a
  left join finds no key the right columns hold NaN (integer columns become
  float64, as pandas upcasts them);
* :meth:`Table.drop_duplicates` (``keep="first"`` / ``"last"``), kept rows
  in their order;
* :meth:`Table.sort_values`: on one key ``np.argsort(kind="quicksort")``,
  which is not stable and is what pandas' ``sort_values`` runs on a numeric
  column; on several keys a stable lexicographic sort, as pandas';
* :func:`group_count` (``groupby(keys)[col].count()``, groups in key
  order) and :func:`value_counts` (``value_counts().sort_index()``).

Strings are object arrays of Python ``str``; NaN marks a missing value in
any column.
"""

from __future__ import annotations

from typing import Dict, Iterable, Mapping, Optional, Sequence, Tuple, Union

import numpy as np

_NAN_KEY = object()  # one key for every NaN, as pandas groups them


def column(values) -> np.ndarray:
    """A column from ``values``: strings become an object array of ``str``."""
    arr = np.asarray(values)
    if arr.dtype.kind in "US":
        arr = arr.astype(object)
    if arr.ndim != 1:
        raise ValueError(f"a column must be one-dimensional, got shape {arr.shape}")
    return arr


def isna(arr: np.ndarray) -> np.ndarray:
    """NaN (or None) positions of a column."""
    if arr.dtype.kind == "f":
        return np.isnan(arr)
    if arr.dtype == object:
        return np.fromiter((v is None or (isinstance(v, float) and v != v) for v in arr),
                           dtype=bool, count=len(arr))
    return np.zeros(len(arr), dtype=bool)


def factorize(arr: np.ndarray) -> Tuple[np.ndarray, int]:
    """``(codes, n)``: each value's code, numbered in order of first
    appearance (every NaN one code), and the number of distinct values."""
    if arr.dtype == object:
        seen: Dict = {}
        codes = np.fromiter(
            (seen.setdefault(_NAN_KEY if (v is None or (isinstance(v, float) and v != v)) else v,
                             len(seen)) for v in arr),
            dtype=np.int64, count=len(arr))
        return codes, len(seen)
    if len(arr) == 0:
        return np.zeros(0, dtype=np.int64), 0
    _, first, inverse = np.unique(arr, return_index=True, return_inverse=True)
    rank = np.empty(len(first), dtype=np.int64)
    rank[np.argsort(first, kind="stable")] = np.arange(len(first))
    return rank[inverse.reshape(-1)], len(first)


def unique(arr: np.ndarray) -> np.ndarray:
    """The distinct values of a column in order of first appearance
    (pandas' ``Series.unique``)."""
    codes, n = factorize(arr)
    first = np.full(n, len(arr), dtype=np.int64)
    np.minimum.at(first, codes, np.arange(len(arr)))
    return arr[first]


def isin(arr: np.ndarray, values) -> np.ndarray:
    """Rows of ``arr`` whose value is among ``values`` (pandas' ``isin``)."""
    values = column(values) if not isinstance(values, np.ndarray) else values
    if arr.dtype != object and values.dtype != object:
        return np.isin(arr, values)
    wanted = set(values.tolist())
    return np.fromiter((v in wanted for v in arr.tolist()), dtype=bool, count=len(arr))


def _joint_codes(arrays: Sequence[np.ndarray]) -> Tuple[np.ndarray, int]:
    """One factorization of several columns' rows taken as tuples."""
    codes, n = factorize(arrays[0])
    for arr in arrays[1:]:
        more, m = factorize(arr)
        codes, n = factorize(codes * m + more)
    return codes, n


def _sort_codes(arr: np.ndarray) -> np.ndarray:
    """Codes that sort as the values do (NaN last)."""
    na = isna(arr)
    codes = np.zeros(len(arr), dtype=np.int64)
    if (~na).any():
        _, inv = np.unique(arr[~na], return_inverse=True)
        codes[~na] = inv.reshape(-1)
        codes[na] = inv.max() + 1
    return codes


def _missing(arr: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """``arr[idx]`` with NaN where ``idx`` is -1 (integer and bool columns
    upcast as pandas upcasts them: to float64, and to object)."""
    hit = idx >= 0
    if hit.all():
        return arr[idx]
    out = np.full(len(idx), np.nan, dtype=np.float64 if arr.dtype.kind in "iuf" else object)
    out[hit] = arr[idx[hit]]
    return out


class Table:
    """Ordered, equal-length numpy columns."""

    def __init__(self, columns: Optional[Mapping[str, Iterable]] = None):
        self._cols: Dict[str, np.ndarray] = {}
        for name, values in (columns or {}).items():
            self[name] = values

    @property
    def columns(self) -> list:
        return list(self._cols)

    def __len__(self) -> int:
        return len(next(iter(self._cols.values()))) if self._cols else 0

    def __contains__(self, name) -> bool:
        return name in self._cols

    def __getitem__(self, key: Union[str, list, np.ndarray]):
        """A column by name; a Table of the named columns for a list; the
        rows where a boolean array is True."""
        if isinstance(key, str):
            return self._cols[key]
        if isinstance(key, list):
            return Table({name: self._cols[name] for name in key})
        return self.take(np.flatnonzero(np.asarray(key, dtype=bool)))

    def __setitem__(self, name: str, values) -> None:
        arr = column(values)
        if self._cols and len(arr) != len(self):
            raise ValueError(f"column {name!r} has {len(arr)} rows, the table {len(self)}")
        self._cols[name] = arr

    def __repr__(self) -> str:
        return f"Table({len(self)} rows, columns={self.columns})"

    def take(self, idx) -> "Table":
        """The rows at positions ``idx``, in that order."""
        idx = np.asarray(idx, dtype=np.int64)
        return Table({name: arr[idx] for name, arr in self._cols.items()})

    def copy(self) -> "Table":
        return Table(self._cols)

    def drop(self, names: Sequence[str]) -> "Table":
        return Table({n: a for n, a in self._cols.items() if n not in names})

    def dropna(self, subset: Sequence[str]) -> "Table":
        keep = np.ones(len(self), dtype=bool)
        for name in subset:
            keep &= ~isna(self._cols[name])
        return self[keep]

    def drop_duplicates(self, subset: Optional[Sequence[str]] = None,
                        keep: str = "first") -> "Table":
        """Rows whose values in ``subset`` (all columns by default) came
        before (``keep="first"``) or come after (``"last"``) in no other
        row; the kept rows stay in order."""
        names = list(subset) if subset is not None else self.columns
        if not len(self):
            return self.copy()
        codes, n = _joint_codes([self._cols[name] for name in names])
        rows = np.arange(len(self))
        pick = np.full(n, -1 if keep == "last" else len(self), dtype=np.int64)
        if keep == "first":
            np.minimum.at(pick, codes, rows)
        elif keep == "last":
            np.maximum.at(pick, codes, rows)
        else:
            raise ValueError(f"keep must be 'first' or 'last', got {keep!r}")
        return self.take(np.sort(pick))

    def sort_values(self, by: Union[str, Sequence[str]]) -> "Table":
        """Rows sorted by ``by``: one numeric key by ``np.argsort`` with
        ``kind="quicksort"`` (pandas' order, ties included: not stable),
        several keys (or a non-numeric one) by a stable sort."""
        by = [by] if isinstance(by, str) else list(by)
        if len(by) == 1 and self._cols[by[0]].dtype.kind in "iuf":
            arr = self._cols[by[0]]
            na = isna(arr)
            idx = np.flatnonzero(~na)
            order = np.concatenate([idx[np.argsort(arr[idx], kind="quicksort")],
                                    np.flatnonzero(na)])
        else:
            order = np.lexsort([_sort_codes(self._cols[name]) for name in reversed(by)])
        return self.take(order)

    def merge(self, right: "Table", how: str = "left", on: Optional[str] = None,
              left_on: Optional[str] = None, right_on: Optional[str] = None) -> "Table":
        """pandas' ``merge`` on one key, ``how`` ``"left"`` or ``"inner"``:
        the left rows in order, each repeated once for every right row with
        its key (in right order); a left row with none kept once with NaN on
        the right (``"left"``) or dropped (``"inner"``).  An inner merge
        takes a right side whose keys are unique (pandas orders an inner
        merge's repeated rows otherwise, and the ETL never needs it).  Columns: the left
        ones, then the right ones but the key when both sides call it ``on``;
        other names on both sides take the suffixes ``_x`` and ``_y``."""
        if how not in ("left", "inner"):
            raise ValueError(f"how must be 'left' or 'inner', got {how!r}")
        lk, rk = (on, on) if on is not None else (left_on, right_on)
        lkey, rkey = self._cols[lk], right._cols[rk]
        codes, n = factorize(np.concatenate([lkey, rkey]))
        lc, rc = codes[:len(lkey)], codes[len(lkey):]
        r_order = np.argsort(rc, kind="stable")
        r_count = np.bincount(rc, minlength=n)
        if how == "inner" and (r_count > 1).any():
            raise ValueError(f"an inner merge needs unique keys on the right ({rk!r})")
        r_start = np.cumsum(r_count) - r_count
        matches = r_count[lc]
        reps = np.maximum(matches, 1) if how == "left" else matches
        left_idx = np.repeat(np.arange(len(lkey)), reps)
        offset = np.arange(len(left_idx)) - np.repeat(np.cumsum(reps) - reps, reps)
        found = np.repeat(matches > 0, reps)
        right_idx = np.full(len(left_idx), -1, dtype=np.int64)
        right_idx[found] = r_order[(np.repeat(r_start[lc], reps) + offset)[found]]

        right_names = [name for name in right.columns if not (on is not None and name == on)]
        both = set(self.columns) & set(right_names)
        out = Table()
        for name, arr in self._cols.items():
            out[name + "_x" if name in both else name] = arr[left_idx]
        for name in right_names:
            out[name + "_y" if name in both else name] = _missing(right._cols[name], right_idx)
        return out


def group_count(table: Table, keys: Sequence[str], col: str) -> Table:
    """pandas' ``groupby(keys)[col].count().reset_index()``: one row a
    group in key order (rows with a NaN key dropped), the key columns and
    ``count``, the non-NaN values of ``col`` in the group."""
    keep = np.ones(len(table), dtype=bool)
    for name in keys:
        keep &= ~isna(table[name])
    t = table[keep]
    order = np.lexsort([_sort_codes(t[name]) for name in reversed(keys)])
    codes, _ = _joint_codes([t[name][order] for name in keys])
    starts = np.flatnonzero(np.concatenate([[True], codes[1:] != codes[:-1]])) if len(t) else \
        np.zeros(0, dtype=np.int64)
    valid = (~isna(t[col][order])).astype(np.int64)
    counts = np.add.reduceat(valid, starts) if len(starts) else np.zeros(0, dtype=np.int64)
    out = Table({name: t[name][order][starts] for name in keys})
    out["count"] = counts
    return out


def value_counts(arr: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """pandas' ``value_counts().sort_index()``: the distinct non-NaN values
    in order and how often each occurs."""
    vals, counts = np.unique(arr[~isna(arr)], return_counts=True)
    return vals, counts
