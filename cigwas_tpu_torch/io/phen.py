"""Phenotype .phen TSV loading (`phen.cpp:9-74`).

Format: header line (skipped), then one row per sample with two leading ID
columns followed by one float per trait; "NA" becomes NaN. Stored
column-major: data[p] is the vector of trait p over samples.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class Phen:
    data: np.ndarray  # (num_phen, num_samples) float32
    num_samples: int
    num_phen: int


def load_phen(path: str) -> Phen:
    rows = []
    with open(path) as fin:
        next(fin)  # skip header
        for line in fin:
            fields = line.split()
            if not fields:
                continue
            vals = [np.nan if f == "NA" else float(f) for f in fields[2:]]
            if rows and len(vals) != len(rows[0]):
                raise ValueError(f"Inconsistent row width in .phen file: {line!r}")
            rows.append(vals)
    arr = np.array(rows, dtype=np.float32)  # (samples, phen)
    return Phen(data=arr.T.copy(), num_samples=arr.shape[0], num_phen=arr.shape[1])
