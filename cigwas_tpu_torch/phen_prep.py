"""Phenotype file preparation: merge, reorder and validate trait files
(`cigwas_tpu.phen_prep`; `cusk/scripts/phen_prep.py`), without pandas.

Aligns one or more space-separated phenotype files (FID/IID or IID/FID
headers, "EID" accepted as IID) to the sample order of a .fam file,
validates that traits are standardized, and writes the merged tab-separated
.phen consumed by cusk. The written file is byte for byte the one the JAX
package writes through pandas, so the reading and writing follow pandas'
rules for these files:

* columns are typed as pandas types them
  (:func:`cigwas_tpu_torch.io.tables.read_columns`: ``007`` is the integer 7
  unless the column holds a string);
* IDs match by value (an integer ID column never matches a string one);
* an integer trait column that the alignment leaves with missing samples
  becomes a float column (written ``1.0``), missing values are written
  ``nan``, floats as their shortest round-trip repr.

Not supported (refused or not reproduced): quoted fields, rows with more
fields than the header, boolean columns (read as strings).

`merge_phenos` returns the merged table as columns and ID lists
(:class:`MergedPhenotypes`), where the JAX function returns a DataFrame.
"""

from __future__ import annotations

import math
import warnings
from dataclasses import dataclass

import numpy as np

from cigwas_tpu_torch.io.tables import read_columns, write_columns

def _is_iid(col: str) -> bool:
    return str(col).upper() in ("IID", "EID")


def _is_fid(col: str) -> bool:
    return str(col).upper() == "FID"


def _reindex(col: np.ndarray, rows: np.ndarray) -> np.ndarray:
    """col[rows] with row -1 as missing: NaN, integer columns turned float."""
    if (rows >= 0).all():
        return col[rows]
    if col.dtype == object:
        out = col[np.maximum(rows, 0)].copy()
        out[rows < 0] = math.nan
        return out
    out = col.astype(np.float64)[np.maximum(rows, 0)]
    out[rows < 0] = np.nan
    return out


@dataclass
class PhenotypesFile:
    filepath: str
    columns: list[str]

    def load_aligned(self, fam: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
        """This file's selected trait columns in the .fam's sample order
        ({name: column}); samples the file lacks are missing."""
        table = read_columns(self.filepath, " ")
        names = list(table)
        c0, c1 = names[0], names[1]
        if _is_fid(c0) and _is_iid(c1):
            renamed = {c0: "FID", c1: "IID"}
        elif _is_iid(c0) and _is_fid(c1):
            renamed = {c0: "IID", c1: "FID"}
        else:
            raise ValueError(f"Header of {self.filepath} is invalid")
        if len(names) == 3 and self.columns:
            renamed[names[-1]] = self.columns[0]
        table = {renamed.get(k, k): v for k, v in table.items()}
        missing = [c for c in self.columns if c not in table]
        if missing:
            raise KeyError(f"{missing} not in the columns of {self.filepath}")
        ids = table["IID"].tolist()
        at = {}
        for i, key in enumerate(ids):
            if key in at:
                raise ValueError("cannot reindex on an axis with duplicate labels")
            at[key] = i
        rows = np.array([at.get(key, -1) for key in fam["IID"].tolist()], dtype=np.int64)
        return {c: _reindex(table[c], rows) for c in self.columns}


def load_fam(filepath: str) -> dict[str, np.ndarray]:
    """The .fam's six columns by name, typed as pandas reads them."""
    return read_columns(filepath, " ", ["FID", "IID", "Father", "Mother", "Sex", "Phen"])


def is_standardized(columns: dict[str, np.ndarray]) -> bool:
    """Every column has |mean| < 0.1 and |std - 1| < 0.1, NaN skipped, std
    with ddof=1 (pandas' ``DataFrame.std``)."""
    for name, col in columns.items():
        if col.dtype == object:
            raise TypeError(f"column {name!r} is not numeric")
    with warnings.catch_warnings():  # an all-missing column: NaN, not standardized
        warnings.simplefilter("ignore", RuntimeWarning)
        std = np.array([np.nanstd(c.astype(np.float64), ddof=1) for c in columns.values()])
        mean = np.array([np.nanmean(c.astype(np.float64)) for c in columns.values()])
    return bool(np.all(np.abs(std - 1) < 0.1) and np.all(np.abs(mean) < 0.1))


@dataclass
class MergedPhenotypes:
    """The merged table: the .fam's FID and IID columns, then every file's
    trait columns in order (int64, float64 or object arrays, one entry per
    .fam sample; a name may repeat if two files share it)."""

    fid: list
    iid: list
    names: list[str]
    columns: list[np.ndarray]


def merge_phenos(phenos: list[PhenotypesFile], fam_path: str) -> MergedPhenotypes:
    """The files' traits aligned to the .fam (the JAX function returns the
    same table as a DataFrame); raises if a file is not standardized."""
    fam = load_fam(fam_path)
    names, columns = [], []
    for p in phenos:
        cur = p.load_aligned(fam)
        if not is_standardized(cur):
            raise ValueError(
                f"data in {p.filepath} seems not precisely standardized"
            )
        names += list(cur)
        columns += list(cur.values())
    return MergedPhenotypes(fam["FID"].tolist(), fam["IID"].tolist(), names, columns)


def make_merged_pheno_file(
    phenos: list[PhenotypesFile], fam_path: str, outfile: str
) -> None:
    """Write the merged, tab-separated .phen (header FID, IID, traits)."""
    merged = merge_phenos(phenos, fam_path)
    write_columns(
        outfile, ["FID", "IID", *merged.names],
        [merged.fid, merged.iid, *(c.tolist() for c in merged.columns)],
        sep="\t", na_rep="nan",
    )
