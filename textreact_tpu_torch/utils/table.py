"""CSV tables without pandas.

The JAX package reads its CSVs with `pandas.read_csv(path,
keep_default_na=False)`; the port reads them with the `csv` module and
repeats the part of pandas' type inference that shows in its outputs: a
column whose every cell is an integer literal becomes ints, one whose every
cell is a decimal literal or an infinity becomes floats, one whose every
cell is `True`/`TRUE`/`true` or `False`/`FALSE`/`false` becomes bools,
anything else (an empty cell included) stays strings. So an all-digit `id`
column is written to JSON as numbers and `year` compares as a number, as
they do there. A blank line is skipped and a cell that a short line leaves
out is the empty string, as pandas reads them under `keep_default_na=False`.

The datasets and metrics read a table where the JAX package reads a
DataFrame: a column by name (`table["id"]`), the row count (`len`), one row
as a dict (`table.row(i)`, for `df.iloc[i]` and `df.loc[i, cols]`), the
first n rows (`table.head(n)`, for `df.iloc[:n].reset_index(drop=True)`). A
table built from columns in memory carries its cells as they are, a NaN
included: a gold label read from one equals no prediction, as there.

The curation modules also write tables: `to_csv` writes what
`DataFrame.to_csv` writes (QUOTE_MINIMAL, `\\n` line ends, floats by
`repr`, NaN and None as an empty cell, containers by `repr`, the unnamed
index column on request), and `concat`, `from_records`, `select`, `take`
and `drop_duplicates` stand for the frame operations they use, every row
label being the row's position (a fresh index).
"""

from __future__ import annotations

import csv
import math
import re
from typing import Dict, Iterable, List, Sequence

import numpy as np

_WS = r"[ \t\n\v\f\r]*"
_INT = re.compile(_WS + r"[+-]?[0-9]+" + _WS + r"\Z")
_DECIMAL = re.compile(_WS + r"([+-]?)([0-9]*)(?:\.([0-9]*))?(?:[eE]([+-]?[0-9]+))?"
                      + _WS + r"\Z")
_INFINITY = re.compile(r"[+-]?(?i:inf|infinity)\Z")
_BOOL = {"True": True, "TRUE": True, "true": True,
         "False": False, "FALSE": False, "false": False}
_I64, _U64 = 2 ** 63, 2 ** 64
_POW10 = [float(f"1e{i}") for i in range(309)]


def _is_float(cell: str) -> bool:
    m = _DECIMAL.match(cell)
    return bool(m and (m.group(2) or m.group(3))) or bool(_INFINITY.match(cell))


def _parse_float(cell: str) -> float:
    """A cell as pandas' C reader parses it (`precise_xstrtod`): at most 17
    significant digits, leading zeros counted, summed in a double, then one
    product or quotient by a power of ten. So `0.30000000000000004` reads
    as 0.3, where `float()` keeps every digit."""
    m = _DECIMAL.match(cell)
    if m is None:
        return float(cell)                      # an infinity
    sign, whole, frac, exp = m.groups()
    number, exponent, digits = 0.0, 0, 0
    for ch in whole:
        if digits < 17:
            number = number * 10.0 + int(ch)
            digits += 1
        else:
            exponent += 1
    for ch in (frac or "")[:max(17 - digits, 0)]:
        number = number * 10.0 + int(ch)
        exponent -= 1
    if sign == "-":
        number = -number
    exponent += int(exp) if exp else 0
    if exponent > 308:
        return math.copysign(math.inf, number)
    if exponent >= 0:
        return number * _POW10[exponent]
    if exponent < -616:
        return 0.0
    if exponent < -308:
        return number / _POW10[-308 - exponent] / _POW10[308]
    return number / _POW10[-exponent]


def _past_uint64_first(cells: List[str]) -> bool:
    """pandas tries int64 and uint64 first, cell by cell: an integer past
    uint64 met before the first cell that is no integer leaves the column
    strings, one met after it is read as a float."""
    for c in cells:
        if not _INT.match(c):
            return False
        if int(c) >= _U64:
            return True
    return False


def _infer(cells: List[str]) -> list:
    if cells and all(_INT.match(c) for c in cells):
        ints = [int(c) for c in cells]
        # int64, else uint64, else Python ints where a cell lies past both;
        # a column past int64 that also holds a negative stays strings
        if (all(-_I64 <= v < _I64 for v in ints)
                or all(0 <= v < _U64 for v in ints)
                or any(v >= _U64 or v < -_I64 for v in ints)):
            return ints
        return cells
    if cells and all(_is_float(c) for c in cells) \
            and not _past_uint64_first(cells):
        return [_parse_float(c) for c in cells]
    if cells and all(c in _BOOL for c in cells):
        return [_BOOL[c] for c in cells]
    return cells


def isna(value) -> bool:
    """None or a float NaN: a missing cell, as `pd.isna` sees a scalar."""
    return value is None or (isinstance(value, float) and math.isnan(value))


def fillna(values: Iterable, fill) -> list:
    return [fill if isna(v) else v for v in values]


def _with_missing(values: list, missing: bool) -> list:
    """A column that gained missing cells: ints become floats, as int64
    becomes float64 where pandas fills NaN."""
    if missing and all(isinstance(v, int) and not isinstance(v, bool)
                       for v in values if not isna(v)):
        return [v if isna(v) else float(v) for v in values]
    return values


class Table:
    """Columns of equal length, by name."""

    def __init__(self, columns: Dict[str, list]):
        self.columns = columns

    def __len__(self) -> int:
        return len(next(iter(self.columns.values()), []))

    def __getitem__(self, name: str) -> list:
        return self.columns[name]

    def __setitem__(self, name: str, values: list) -> None:
        self.columns[name] = list(values)

    def row(self, i: int) -> dict:
        return {name: col[i] for name, col in self.columns.items()}

    def head(self, n: int) -> "Table":
        """The first n rows."""
        return Table({name: col[:n] for name, col in self.columns.items()})

    def take(self, keep: Sequence[bool]) -> "Table":
        """The rows whose flag is true, in order."""
        return Table({name: [v for v, k in zip(col, keep) if k]
                      for name, col in self.columns.items()})

    def select(self, positions: Sequence[int]) -> "Table":
        """The rows at these positions, in this order (`df.iloc[positions]`)."""
        return Table({name: [col[i] for i in positions]
                      for name, col in self.columns.items()})

    def copy(self) -> "Table":
        return Table({name: list(col) for name, col in self.columns.items()})

    def drop_duplicates(self, subset: Sequence[str]) -> "Table":
        """The first row of each distinct `subset` tuple (NaN equals NaN)."""
        seen, keep = set(), []
        for key in zip(*(self.columns[c] for c in subset)):
            key = tuple(None if isna(v) else v for v in key)
            keep.append(key not in seen)
            seen.add(key)
        return self.take(keep)

    @classmethod
    def from_records(cls, rows: Sequence[dict]) -> "Table":
        """`pd.DataFrame(rows)`: the keys in order of first appearance, a
        key a row lacks as NaN."""
        names = list(dict.fromkeys(k for r in rows for k in r))
        return cls({n: _with_missing([r.get(n, math.nan) for r in rows],
                                     any(n not in r for r in rows))
                    for n in names})

    def to_csv(self, path: str, index: bool = False) -> None:
        """What `DataFrame.to_csv(path, index=index)` writes."""
        names = list(self.columns)
        with open(path, "w", newline="", encoding="utf-8") as f:
            w = csv.writer(f, lineterminator="\n")
            w.writerow([""] * index + names)
            for i in range(len(self)):
                w.writerow([i] * index + ["" if isna(self.columns[n][i])
                                          else self.columns[n][i]
                                          for n in names])


def concat(tables: Sequence[Table]) -> Table:
    """`pd.concat(tables, ignore_index=True)`: the columns in order of first
    appearance, a column a table lacks as NaN over its rows (a table with
    no column at all is left out, as pandas leaves it)."""
    tables = [t for t in tables if t.columns]
    names = list(dict.fromkeys(n for t in tables for n in t.columns))
    return Table({n: _with_missing(
        [v for t in tables for v in t.columns.get(n, [math.nan] * len(t))],
        any(n not in t.columns for t in tables)) for n in names})


def shuffled_positions(n: int, seed: int) -> List[int]:
    """The row order of `df.sample(frac=1, random_state=seed)`."""
    return np.random.RandomState(seed).permutation(n).tolist()


def read_csv(path: str) -> Table:
    with open(path, newline="", encoding="utf-8") as f:
        rows = list(csv.reader(f))
    header, body = rows[0], [r for r in rows[1:] if r]
    return Table({name: _infer([r[j] if j < len(r) else "" for r in body])
                  for j, name in enumerate(header)})
