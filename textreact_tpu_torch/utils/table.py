"""CSV tables without pandas.

The JAX package reads its CSVs with `pandas.read_csv(path,
keep_default_na=False)`; the port reads them with the `csv` module and
repeats the part of pandas' type inference that shows in its outputs: a
column whose every cell is an integer literal becomes ints, one whose every
cell is a decimal literal becomes floats, anything else (an empty cell
included) stays strings. So an all-digit `id` column is written to JSON as
numbers and `year` compares as a number, as they do there. A blank line
is skipped and a cell that a short line leaves out is the empty string, as
pandas reads them under `keep_default_na=False`.

The datasets and metrics read a table where the JAX package reads a
DataFrame: a column by name (`table["id"]`), the row count (`len`), one row
as a dict (`table.row(i)`, for `df.iloc[i]` and `df.loc[i, cols]`), the
first n rows (`table.head(n)`, for `df.iloc[:n].reset_index(drop=True)`). A
table built from columns in memory carries its cells as they are, a NaN
included: a gold label read from one equals no prediction, as there.
"""

from __future__ import annotations

import csv
import re
from typing import Dict, List, Sequence

_INT = re.compile(r"\s*[+-]?\d+\s*\Z")
_FLOAT = re.compile(r"\s*[+-]?(\d+\.?\d*|\.\d+)([eE][+-]?\d+)?\s*\Z")


def _infer(cells: List[str]) -> list:
    if cells and all(_INT.match(c) for c in cells):
        return [int(c) for c in cells]
    if cells and all(_FLOAT.match(c) for c in cells):
        return [float(c) for c in cells]
    return cells


class Table:
    """Columns of equal length, by name."""

    def __init__(self, columns: Dict[str, list]):
        self.columns = columns

    def __len__(self) -> int:
        return len(next(iter(self.columns.values()), []))

    def __getitem__(self, name: str) -> list:
        return self.columns[name]

    def row(self, i: int) -> dict:
        return {name: col[i] for name, col in self.columns.items()}

    def head(self, n: int) -> "Table":
        """The first n rows."""
        return Table({name: col[:n] for name, col in self.columns.items()})

    def take(self, keep: Sequence[bool]) -> "Table":
        """The rows whose flag is true, in order."""
        return Table({name: [v for v, k in zip(col, keep) if k]
                      for name, col in self.columns.items()})


def read_csv(path: str) -> Table:
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    header, body = rows[0], [r for r in rows[1:] if r]
    return Table({name: _infer([r[j] if j < len(r) else "" for r in body])
                  for j, name in enumerate(header)})
