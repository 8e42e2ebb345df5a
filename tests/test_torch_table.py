"""`textreact_tpu_torch/utils/table.py` against pandas: the reader against
`pandas.read_csv(keep_default_na=False)`, the writer against
`DataFrame.to_csv` byte for byte, and the frame operations the curation
modules use (`concat`, `DataFrame(records)`, `drop_duplicates`, `iloc`,
`sample(frac=1)`) against pandas' own. The port does not import pandas;
these tests do, to hold it to the JAX package's reader and writer."""

import math

import numpy as np
import pandas as pd
import pytest

from textreact_tpu_torch.utils.table import (Table, concat, fillna, isna,
                                             read_csv, shuffled_positions)

READ_CASES = {
    "leading_zeros": "id,n\n007,1\n0100,2\n",
    "mixed_int_float": "confidence,year\n1,2005\n0.98,2006\n",
    "bool": "flag,other\nTrue,x\nFALSE,y\ntrue,z\n",
    "bool_and_empty": "flag\nTrue\n\"\"\n",
    "bool_and_int": "flag\nTrue\n1\n",
    "inf": "v,w\ninf,-Infinity\n1.5,2\n",
    "inf_alone": "v\n+inf\n-inf\n",
    "nan_is_a_string": "v\nnan\n1.5\n",
    "int_24_digits": "big\n123456789012345678901234\n1\n",
    "uint64": "big\n18446744073709551615\n1\n",
    "big_and_float": "big\n123456789012345678901234\n1.5\n",
    "float_and_big": "big\n1.5\n123456789012345678901234\n",
    "uint64_and_float": "big\n18446744073709551615\n1.5\n",
    "uint64_and_negative": "big\n9223372036854775808\n-1\n",
    "below_int64_and_float": "big\n-9223372036854775809\n1.5\n",
    "below_int64_and_int": "big\n-9223372036854775809\n1\n",
    "past_uint64_and_negative": "big\n18446744073709551616\n-1\n",
    "quoted": 'id,text\n1,"a, b"\n2,"say ""hi"""\n3,"two\nlines"\n',
    "blank_lines": "a,b\n1,x\n\n2,y\n\n",
    "short_rows": "a,b,c\n1,x\n2,y,z\n3\n",
    "all_empty": "a,b\n,1\n,2\n",
    "exponents": "v\n1e5\n2E-3\n.5\n1.\n",
    "signs_and_spaces": "v,w\n+3, 4\n-0,5 \n",
    "floats": ("v\n0.1\n0.30000000000000004\n1.7976931348623157e308\n5e-324\n"
               "123456.789e3\n-0.0\n1e400\n2.2250738585072014e-308\n"),
    "not_numbers": "v\n0x10\n1_000\n1.5e\n.\n",
    "unicode_digits": "v\n۱\n2\n",
    "header_only": "a,b\n",
    "split_token": "s\nCCO分ClCCl\n分\n",
}


@pytest.mark.parametrize("name", sorted(READ_CASES))
def test_reader_reads_what_pandas_reads(tmp_path, name):
    path = tmp_path / "t.csv"
    path.write_bytes(READ_CASES[name].encode("utf-8"))
    df = pd.read_csv(path, keep_default_na=False)
    table = read_csv(str(path))
    assert list(table.columns) == list(df.columns)
    assert len(table) == len(df)
    for col in df.columns:
        want = df[col].tolist()
        got = table[col]
        assert [type(v) for v in got] == [type(v) for v in want], col
        assert [repr(v) for v in got] == [repr(v) for v in want], col


def test_reader_parses_decimals_as_pandas_does(tmp_path):
    """Decimal cells of 1 to 25 digits, a point anywhere, exponents to
    +-330 (integers without either of up to 18 digits): pandas' C reader
    keeps 17 significant digits and scales once, so its doubles are not
    always `float()`'s; the port's are pandas'."""
    rng = np.random.default_rng(0)
    cells = []
    for _ in range(4000):
        digits = "".join(map(str, rng.integers(0, 10, rng.integers(1, 26))))
        point = int(rng.integers(0, len(digits) + 1))
        cell = digits[:point] + "." + digits[point:] if rng.random() < 0.8 \
            else digits[:18]
        if rng.random() < 0.5:
            cell += f"e{int(rng.integers(-330, 331))}"
        cells.append(("-" if rng.random() < 0.3 else "") + cell)
    path = tmp_path / "f.csv"
    path.write_text("v\n" + "\n".join(cells) + "\n1.5\n")
    want = pd.read_csv(path, keep_default_na=False)["v"].tolist()
    got = read_csv(str(path))["v"]
    assert [repr(v) for v in got] == [repr(v) for v in want]
    assert sum(float(c) != v for c, v in zip(cells, got)) > 100


FLOATS = [0.1, 2.0, 0.30000000000000004, 1e-05, 1e16, 1.5e-7, 123456789.0,
          float("inf"), -0.0, math.nan, 1e22, 5e-324]
OBJECTS = [[("a", 3, 5)], ("b", (1, 2), 7), {"A": [1], "B": [(1, 3)]},
           {(0, 1), (1, 0), (2, 5)}, None, math.nan, [], set(), "plain", 3,
           2.5, True]
STRINGS = ["a,b", 'say "hi"', "two\nlines", "", "分", " lead", "x\ry"]


def _frames():
    """Pairs of a DataFrame and a Table built from the same lists, one dtype
    a column as pandas infers it from them."""
    cols = {"f": FLOATS, "o": OBJECTS,
            "s": STRINGS + ["z"] * (len(FLOATS) - len(STRINGS)),
            "b": [i % 3 == 0 for i in range(len(FLOATS))],
            "i": list(range(-3, len(FLOATS) - 3))}
    yield pd.DataFrame(cols), Table({k: list(v) for k, v in cols.items()})
    yield pd.DataFrame({"e": [""]}), Table({"e": [""]})
    yield pd.DataFrame({"e": []}), Table({"e": []})
    yield pd.DataFrame([]), Table({})


@pytest.mark.parametrize("index", [False, True])
def test_writer_writes_what_pandas_writes(tmp_path, index):
    for k, (df, table) in enumerate(_frames()):
        df.to_csv(tmp_path / f"pd{k}.csv", index=index)
        table.to_csv(str(tmp_path / f"port{k}.csv"), index=index)
        want = (tmp_path / f"pd{k}.csv").read_bytes()
        assert (tmp_path / f"port{k}.csv").read_bytes() == want, (k, want)


def test_written_tables_read_back_as_pandas_reads_them(tmp_path):
    df, table = next(_frames())
    table.to_csv(str(tmp_path / "t.csv"))
    back = read_csv(str(tmp_path / "t.csv"))
    ref = pd.read_csv(tmp_path / "t.csv", keep_default_na=False)
    for col in ref.columns:
        assert [repr(v) for v in back[col]] \
            == [repr(v) for v in ref[col].tolist()], col


@pytest.mark.parametrize("n", [0, 1, 7, 60, 1000])
@pytest.mark.parametrize("seed", [0, 123, 2 ** 31 - 1])
def test_shuffle_is_the_order_of_sample(n, seed):
    df = pd.DataFrame({"x": range(n)})
    assert shuffled_positions(n, seed) \
        == df.sample(frac=1, random_state=seed).index.tolist()


def _same(table: Table, df: pd.DataFrame, tmp_path):
    assert list(table.columns) == list(df.columns)
    for col in df.columns:
        assert [repr(v) for v in table[col]] \
            == [repr(v) for v in df[col].tolist()], col
    df.to_csv(tmp_path / "pd.csv", index=False)
    table.to_csv(str(tmp_path / "port.csv"))
    assert (tmp_path / "port.csv").read_bytes() \
        == (tmp_path / "pd.csv").read_bytes()


def test_concat_and_records_fill_what_is_missing_as_pandas_does(tmp_path):
    a = {"x": [1, 2], "f": [3, 4], "s": ["p", "q"], "b": [True, False]}
    b = {"x": [3], "t": ["r"]}
    empty_with_column = {"Split": []}
    for parts in ([a, b], [a, empty_with_column], [{}, a], [a, a], [b, a]):
        got = concat([Table({k: list(v) for k, v in p.items()})
                      for p in parts])
        want = pd.concat([pd.DataFrame(p) if p else pd.DataFrame([])
                          for p in parts], ignore_index=True)
        _same(got, want, tmp_path)
    records = [{"a": 1, "b": 2.5}, {"a": 3, "c": True}, {"b": [1]}]
    _same(Table.from_records(records), pd.DataFrame(records), tmp_path)
    _same(Table.from_records([]), pd.DataFrame([]), tmp_path)


def test_row_operations_match_pandas(tmp_path):
    cols = {"r": ["a", "b", "a", "c", "a", "b"], "c": ["x", "y", "x", "x",
                                                       "z", "y"],
            "n": [1, 2, 3, 4, 5, 6]}
    df, table = pd.DataFrame(cols), Table({k: list(v) for k, v in cols.items()})
    _same(table.drop_duplicates(["r", "c"]),
          df.drop_duplicates(subset=["r", "c"], keep="first")
          .reset_index(drop=True), tmp_path)
    _same(table.select([4, 0, 2]), df.iloc[[4, 0, 2]], tmp_path)
    keep = [v % 2 == 0 for v in cols["n"]]
    _same(table.take(keep), df[keep].reset_index(drop=True), tmp_path)
    nan = Table({"r": [math.nan, math.nan, None, "a"]})
    assert nan.drop_duplicates(["r"])["r"][1:] == ["a"]
    assert fillna([math.nan, None, "x", 0], "") == ["", "", "x", 0]
    assert [isna(v) for v in (np.float64("nan"), None, "", 0.0)] \
        == [True, True, False, False]
