"""The delimited result tables of `mvivw` (`_iv_candidates.csv`,
`_mvivw_results.tsv`), written without pandas.

`write_table(path, rows, sep)` writes what
``pandas.DataFrame(rows).to_csv(path, sep=sep, index=False)`` writes for
these tables, byte for byte: a header line of the first row's keys, then one
line per row, every line ending in ``\\n``; ints and strings as they are,
bools as ``True``/``False``, floats as their shortest round-trip repr
(``1e-05``, ``0.30000000000000004``, ``1.0``), NaN as the empty string. A
table without rows is the single byte ``\\n``. Nothing beyond what these
tables hold is supported: a value pandas would quote is refused.
"""

from __future__ import annotations

import math
import numbers


def _cell(value, sep: str) -> str:
    if isinstance(value, (bool, str)):
        text = str(value)
        if sep in text or '"' in text or "\n" in text or "\r" in text:
            raise ValueError(f"table value {value!r} would need quoting")
        return text
    if isinstance(value, numbers.Integral):
        return str(int(value))
    if isinstance(value, float):
        return "" if math.isnan(value) else repr(float(value))
    raise TypeError(f"unsupported table value {value!r} of type {type(value).__name__}")


def write_table(path: str, rows: list[dict], sep: str = ",") -> None:
    """Rows (dicts with the same keys in the same order) as a delimited
    table, as pandas' ``to_csv(sep=sep, index=False)`` writes it."""
    with open(path, "w", newline="") as f:
        if not rows:
            f.write("\n")
            return
        columns = list(rows[0])
        f.write(sep.join(columns) + "\n")
        for row in rows:
            if list(row) != columns:
                raise ValueError(f"row keys {list(row)} differ from the header {columns}")
            f.write(sep.join(_cell(row[c], sep) for c in columns) + "\n")
