"""Summary-statistic input loaders for the cuskss paths.

Equivalents of `trait_summary_stats.cpp`, `marker_summary_stats.cpp` and
`marker_trait_summary_stats.cpp`. Standard errors are converted to per-entry
effective sample sizes via N = ((1 - rho^2) / se)^2
(`trait_summary_stats.cpp:150-152`).
"""

from __future__ import annotations

import numpy as np

_NA_STRINGS = {"NA", "NaN", "nan", "NAN"}


def _ess_from_se(rho: float, se: float) -> float:
    s = (1.0 - rho * rho) / se
    return s * s


class TraitSummaryStats:
    """Trait x trait correlation table (pxp).

    Whitespace table with a trait-name header row and a leading row-name
    column; only the upper triangle is read, then symmetrized
    (`trait_summary_stats.cpp:5-47`).
    """

    def __init__(
        self,
        path: str,
        sample_size: float | None = None,
        se_path: str | None = None,
    ):
        with open(path) as fin:
            header = fin.readline().split()
            if not header:
                raise ValueError("trait summary stat file seems to be empty")
            self.header = header
            self.num_phen = len(header)
            p = self.num_phen
            corrs = np.ones((p, p), dtype=np.float32)
            rows = [fin_line.split() for fin_line in fin if fin_line.split()]

        se_rows = None
        if se_path is not None:
            with open(se_path) as fin:
                fin.readline()
                se_rows = [l.split() for l in fin if l.split()]
            sample_sizes = np.zeros((p, p), dtype=np.float32)
        else:
            sample_sizes = np.full(
                (p, p), np.nan if sample_size is None else sample_size, dtype=np.float32
            )

        for i, fields in enumerate(rows):
            for j in range(p):
                raw = fields[j + 1]
                val = float(raw) if raw not in _NA_STRINGS else np.nan
                if se_rows is not None:
                    if np.isnan(val):
                        corrs[i, j] = 0.0
                        sample_sizes[i, j] = np.nan
                    else:
                        corrs[i, j] = val
                        sample_sizes[i, j] = _ess_from_se(val, float(se_rows[i][j + 1]))
                else:
                    corrs[i, j] = 0.0 if np.isnan(val) else val

        # symmetrize from the upper triangle
        iu = np.triu_indices(p, k=1)
        corrs[(iu[1], iu[0])] = corrs[iu]
        sample_sizes[(iu[1], iu[0])] = sample_sizes[iu]
        self.corrs = corrs
        self.sample_sizes = sample_sizes

    def get_num_phen(self) -> int:
        return self.num_phen

    def get_corrs(self) -> np.ndarray:
        return self.corrs

    def get_sample_sizes(self) -> np.ndarray:
        return self.sample_sizes


class MarkerSummaryStats:
    """Marker x marker correlations (mxm): binary float32, row-major lower
    triangular including the diagonal (`marker_summary_stats.cpp:8-24`)."""

    def __init__(self, path: str):
        tril = np.fromfile(path, dtype=np.float32)
        m = int((np.sqrt(8 * tril.size + 1) - 1) / 2)
        self.num_markers = m
        corrs = np.ones((m, m), dtype=np.float32)
        ix = 0
        for i in range(m):
            row = np.nan_to_num(tril[ix : ix + i + 1])
            corrs[i, : i + 1] = row
            corrs[: i + 1, i] = row
            ix += i + 1
        self.corrs = corrs

    def get_num_markers(self) -> int:
        return self.num_markers

    def get_corrs(self) -> np.ndarray:
        return self.corrs


class MarkerTraitSummaryStats:
    """Marker x trait correlations (mxp): whitespace table with header
    `chr snp ref <trait...>`, selected either by block line range or explicit
    row indices (`marker_trait_summary_stats.cpp`)."""

    def __init__(
        self,
        path: str,
        se_path: str | None = None,
        block=None,
        marker_ixs=None,
    ):
        with open(path) as fin:
            header = fin.readline().split()
            if not header:
                raise ValueError("marker-trait summary stat file seems to be empty")
            if header[:3] != ["chr", "snp", "ref"]:
                raise ValueError("marker-trait summary stat file has bad header")
            self.header = header
            self.num_phen = len(header) - 3
            lines = fin.readlines()

        se_lines = None
        if se_path is not None:
            with open(se_path) as fin:
                fin.readline()
                se_lines = fin.readlines()

        if block is not None:
            first = block.get_first_marker_global_ix()
            last = block.get_last_marker_global_ix()
            selected = range(first, min(last + 1, len(lines)))
        elif marker_ixs is not None:
            selected = [int(i) for i in marker_ixs]
        else:
            selected = range(len(lines))

        corrs = []
        sample_sizes = []
        for line_num in selected:
            fields = lines[line_num].split()
            se_fields = se_lines[line_num].split() if se_lines is not None else None
            for j in range(3, self.num_phen + 3):
                raw = fields[j]
                if raw in _NA_STRINGS:
                    corrs.append(0.0)
                    sample_sizes.append(np.nan)
                else:
                    rho = float(raw)
                    corrs.append(rho)
                    if se_fields is not None:
                        sample_sizes.append(_ess_from_se(rho, float(se_fields[j])))
        self.num_markers = len(selected)
        self.corrs = np.array(corrs, dtype=np.float32).reshape(self.num_markers, self.num_phen)
        self.sample_sizes = (
            np.array(sample_sizes, dtype=np.float32).reshape(self.num_markers, self.num_phen)
            if se_path is not None
            else None
        )

    def get_num_markers(self) -> int:
        return self.num_markers

    def get_num_phen(self) -> int:
        return self.num_phen

    def get_corrs(self) -> np.ndarray:
        return self.corrs

    def get_sample_sizes(self) -> np.ndarray:
        return self.sample_sizes
