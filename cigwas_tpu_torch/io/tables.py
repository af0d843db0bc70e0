"""Delimited tables read and written without pandas: the result tables of
`mvivw` (`_iv_candidates.csv`, `_mvivw_results.tsv`), the phenotype files
and merged `.phen` of `phen_prep` and the `.bim` columns of `analysis`.

`read_columns(path, sep)` types each column as pandas' ``read_csv`` does:
integers (int64; uint64 or Python ints beyond that) when every entry is an
integer (``007`` is 7), else floats when every entry is a float or one of
pandas' missing-value tokens (``NA``, ``nan``, empty...), else strings
(object, NaN where missing). Floats are parsed as pandas' default C parser
parses them (:func:`_xstrtod`), which for 17 significant digits is not
always the correctly rounded double.

`write_table(path, rows, sep)` writes what
``pandas.DataFrame(rows).to_csv(path, sep=sep, index=False)`` writes for
these tables, byte for byte, and `write_columns` what ``to_csv`` writes for
a table given by its columns: a header line, then one line per row, every
line ending in ``\\n``; ints and strings as they are, bools as
``True``/``False``, floats as their shortest round-trip repr (``1e-05``,
``0.30000000000000004``, ``1.0``), NaN as ``na_rep`` (pandas' default: the
empty string). A table without rows is the single byte ``\\n``. Nothing
beyond what these tables hold is supported: a value pandas would quote is
refused.
"""

from __future__ import annotations

import math
import numbers
import re

import numpy as np

# pandas' default missing-value tokens (`pandas.io.parsers`' STR_NA_VALUES)
NA_TOKENS = frozenset({
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan", "1.#IND",
    "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a", "nan", "null",
})
_INT = re.compile(r"[+-]?[0-9]+\Z")
_INF = {"inf": math.inf, "+inf": math.inf, "-inf": -math.inf, "infinity": math.inf,
        "+infinity": math.inf, "-infinity": -math.inf}
# the powers of ten of pandas' float parser, as the C literals 1e0 .. 1e308
_POW10 = [float(f"1e{k}") for k in range(309)]
_DIGITS = "0123456789"
_MAX_DIGITS = 17


def _xstrtod(s: str) -> float | None:
    """A float token as pandas' default C parser reads it (its
    ``precise_xstrtod``): at most 17 significant digits accumulated in a
    double, then one multiplication or division by a power of ten. None if
    the token is not a float."""
    p, n = 0, len(s)
    negative = False
    if p < n and s[p] in "+-":
        negative = s[p] == "-"
        p += 1
    number, exponent, num_digits, num_decimals = 0.0, 0, 0, 0
    while p < n and s[p] in _DIGITS:
        if num_digits < _MAX_DIGITS:
            number = number * 10.0 + (ord(s[p]) - 48)
            num_digits += 1
        else:
            exponent += 1
        p += 1
    if p < n and s[p] == ".":
        p += 1
        while num_digits < _MAX_DIGITS and p < n and s[p] in _DIGITS:
            number = number * 10.0 + (ord(s[p]) - 48)
            num_digits += 1
            num_decimals += 1
            p += 1
        while p < n and s[p] in _DIGITS:
            p += 1
        exponent -= num_decimals
    if num_digits == 0:
        return None
    if negative:
        number = -number
    if p < n and s[p] in "eE":
        q, e_negative, e_digits, e = p + 1, False, 0, 0
        if q < n and s[q] in "+-":
            e_negative = s[q] == "-"
            q += 1
        while e_digits < _MAX_DIGITS and q < n and s[q] in _DIGITS:
            e = e * 10 + (ord(s[q]) - 48)
            e_digits += 1
            q += 1
        if e_digits:
            exponent += -e if e_negative else e
            p = q
    if p != n:
        return None
    if exponent > 308:
        return math.copysign(math.inf, number)
    if exponent > 0:
        return number * _POW10[exponent]
    if exponent < -308:
        if exponent < -616:
            return 0.0
        return number / _POW10[-308 - exponent] / _POW10[308]
    return number / _POW10[-exponent]


def _parse_float(tok: str) -> float | None:
    value = _xstrtod(tok)
    if value is None:
        value = _INF.get(tok.lower())
    return value


def _column(tokens: list[str]) -> np.ndarray:
    """A column of tokens as pandas infers it: int64 (or wider ints), float64
    or strings (object, NaN where missing)."""
    missing = [t in NA_TOKENS for t in tokens]
    if not any(missing) and tokens and all(_INT.match(t) for t in tokens):
        ints = [int(t) for t in tokens]
        for dtype in (np.int64, np.uint64):
            info = np.iinfo(dtype)
            if all(info.min <= v <= info.max for v in ints):
                return np.array(ints, dtype=dtype)
        return np.array(ints, dtype=object)
    floats = []
    for t, m in zip(tokens, missing):
        value = math.nan if m else _parse_float(t)
        if value is None:  # a string column
            return np.array([math.nan if m else t for t, m in zip(tokens, missing)],
                            dtype=object)
        floats.append(value)
    return np.array(floats, dtype=np.float64)


def read_columns(path: str, sep: str, names: list | None = None) -> dict:
    """A delimited file as {column name: column}, typed as pandas'
    ``read_csv(path, sep=sep)`` types it (see the module's docstring). The
    first line is the header unless names are given; duplicate header names
    get ``.1``, ``.2``... as pandas gives them. Blank lines are skipped; a
    short row is filled with missing values, a long one refused."""
    with open(path) as f:
        lines = [ln.rstrip("\r\n").rstrip("\r") for ln in f]
    lines = [ln for ln in lines if ln]
    if names is None:
        header, lines = lines[0].split(sep), lines[1:]
        names, seen = [], {}
        for h in header:
            k = seen.get(h, 0)
            seen[h] = k + 1
            names.append(h if k == 0 else f"{h}.{k}")
    rows = [ln.split(sep) for ln in lines]
    width = len(names)
    for i, r in enumerate(rows):
        if len(r) > width:
            raise ValueError(f"{path}: expected {width} fields in row {i + 1}, saw {len(r)}")
    cols = [[r[j] if j < len(r) else "" for r in rows] for j in range(width)]
    return {name: _column(c) for name, c in zip(names, cols)}


def _cell(value, sep: str, na_rep: str) -> str:
    if isinstance(value, (bool, str)):
        text = str(value)
        if sep in text or '"' in text or "\n" in text or "\r" in text:
            raise ValueError(f"table value {value!r} would need quoting")
        return text
    if isinstance(value, numbers.Integral):
        return str(int(value))
    if isinstance(value, float):
        return na_rep if math.isnan(value) else repr(float(value))
    raise TypeError(f"unsupported table value {value!r} of type {type(value).__name__}")


def write_columns(path: str, names: list[str], columns: list, sep: str = ",",
                  na_rep: str = "") -> None:
    """Equal-length columns under their names, as pandas' ``to_csv(sep=sep,
    index=False, na_rep=na_rep)`` writes the table."""
    with open(path, "w", newline="") as f:
        f.write(sep.join(names) + "\n")
        for row in zip(*columns):
            f.write(sep.join(_cell(v, sep, na_rep) for v in row) + "\n")


def write_table(path: str, rows: list[dict], sep: str = ",") -> None:
    """Rows (dicts with the same keys in the same order) as a delimited
    table, as pandas' ``to_csv(sep=sep, index=False)`` writes it."""
    if not rows:
        with open(path, "w", newline="") as f:
            f.write("\n")
        return
    columns = list(rows[0])
    for row in rows:
        if list(row) != columns:
            raise ValueError(f"row keys {list(row)} differ from the header {columns}")
    write_columns(path, columns, [[row[c] for row in rows] for c in columns], sep)
