"""Reading data files and writing results, without pandas.

Port of ``gnn_recsys_tpu/data/io.py`` (the reference's ``src/utils.py:7-50``).
``read_data`` gives a :class:`~gnn_recsys_tpu_torch.data.table.Table` with
the column types pandas' ``read_csv`` infers for integer, float and string
columns.
"""

from __future__ import annotations

import csv
import gzip
import io
import os
import pickle
import re
from typing import Dict, List

import numpy as np

from gnn_recsys_tpu_torch.data.table import Table

# pandas' default NA strings (``read_csv``'s ``na_values``).
NA_VALUES = frozenset({
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan", "1.#IND",
    "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a", "nan", "null"})
_INT = re.compile(r"[+-]?\d+")


def save_txt(data_to_save: str, filepath: str, mode: str = "a") -> None:
    """Append text to a result log file (reference src/utils.py:7-12)."""
    os.makedirs(os.path.dirname(filepath) or ".", exist_ok=True)
    with open(filepath, mode) as f:
        f.write(data_to_save + "\n")


def save_outputs(files_to_save: Dict[str, object], folder_path: str) -> None:
    """Pickle objects into a folder (reference src/utils.py:15-22)."""
    os.makedirs(folder_path, exist_ok=True)
    for name, obj in files_to_save.items():
        with open(os.path.join(folder_path, name + ".pkl"), "wb") as f:
            pickle.dump(obj, f)


def get_last_checkpoint(logdir: str = ".", prefix: str = "checkpoint") -> str:
    """Most recent checkpoint file by name sort (reference src/utils.py:25-32)."""
    logfiles = sorted(f for f in os.listdir(logdir) if f.startswith(prefix))
    if not logfiles:
        raise FileNotFoundError(f"no {prefix}* files in {logdir}")
    return os.path.join(logdir, logfiles[-1])


def _infer(cells: List[str]) -> np.ndarray:
    """One CSV column with pandas' type: int64 where every cell is an
    integer, float64 where every cell is a number or NA (NA as NaN), else
    strings (NA cells as NaN)."""
    if cells and all(_INT.fullmatch(c) for c in cells):
        return np.array([int(c) for c in cells], dtype=np.int64)
    try:
        return np.array([np.nan if c in NA_VALUES else float(c) for c in cells],
                        dtype=np.float64)
    except ValueError:
        return np.array([np.nan if c in NA_VALUES else c for c in cells], dtype=object)


def read_csv(f, sep: str = ",", quotechar: str = '"') -> Table:
    """A header row, then one row a record, from the text stream ``f``."""
    rows = csv.reader(f, delimiter=sep, quotechar=quotechar)
    header = next(rows)
    cols = list(zip(*rows)) or [()] * len(header)
    if len(cols) != len(header):
        raise ValueError(f"{len(header)} column names for rows of {len(cols)} cells")
    return Table({name: _infer(list(cells)) for name, cells in zip(header, cols)})


def as_table(obj) -> Table:
    """A Table of ``obj``'s columns: a Table (copied) or a pandas DataFrame
    (read through ``.columns`` and ``.to_numpy()``, so that pandas is never
    imported here)."""
    if isinstance(obj, Table):
        return obj.copy()
    if hasattr(obj, "columns") and hasattr(obj, "to_numpy"):
        return Table({name: obj[name].to_numpy() for name in obj.columns})
    raise TypeError(f"Type of {obj!r} not recognized.")


def read_data(file_path: str) -> Table:
    """Read .csv / .gz (``;``-separated, ``"``-quoted, gzip) / .pkl
    (reference src/utils.py:35-50).  A pickled DataFrame becomes a Table;
    unpickling one needs pandas where it was written with pandas."""
    if file_path.endswith(".gz"):
        with gzip.open(file_path, "rt", newline="") as f:
            return read_csv(f, sep=";", quotechar='"')
    if file_path.endswith(".csv"):
        with open(file_path, newline="") as f:
            return read_csv(f)
    if file_path.endswith(".pkl"):
        with open(file_path, "rb") as f:
            return as_table(pickle.load(f))
    raise KeyError(f"File extension of {file_path} not recognized.")


def write_csv(table: Table, path: str) -> None:
    """Write ``table`` as pandas' ``to_csv(path, index=False)`` writes
    integer and string columns (NaN as an empty cell)."""
    buf = io.StringIO()
    w = csv.writer(buf, lineterminator="\n")
    w.writerow(table.columns)
    for row in zip(*(table[name].tolist() for name in table.columns)):
        w.writerow("" if (isinstance(v, float) and v != v) else v for v in row)
    with open(path, "w", newline="") as f:
        f.write(buf.getvalue())
