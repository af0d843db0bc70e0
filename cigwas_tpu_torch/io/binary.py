"""Binary / text scalar-array IO in the reference's formats.

Covers the readers/writers of `cusk/src/io.cpp:103-310` — little-endian
float32/int32 binary dumps, one-value-per-line text columns, and the
MatrixMarket coordinate files produced by the Python post-processing.
"""

from __future__ import annotations

import os

import numpy as np


def make_path(out_dir: str, file_stem: str, suffix: str) -> str:
    """Join out_dir / (file_stem + suffix), tolerating empty out_dir (`io.cpp:52-70`)."""
    filename = file_stem + suffix
    if not out_dir:
        return filename
    return os.path.join(out_dir, filename)


def read_floats_from_binary(path: str) -> np.ndarray:
    return np.fromfile(path, dtype=np.float32)


def read_ints_from_binary(path: str) -> np.ndarray:
    return np.fromfile(path, dtype=np.int32)


def write_floats_to_binary(data, path: str) -> None:
    np.asarray(data, dtype=np.float32).tofile(path)


def write_ints_to_binary(data, path: str) -> None:
    np.asarray(data, dtype=np.int32).tofile(path)


def read_floats_from_lines(path: str) -> np.ndarray:
    with open(path) as fin:
        return np.array([float(line) for line in fin if line.strip()], dtype=np.float32)


def read_ints_from_lines(path: str) -> list[int]:
    with open(path) as fin:
        return [int(line) for line in fin if line.strip()]


def read_floats_from_line_range(path: str, first: int, last: int) -> np.ndarray:
    """Read float lines with index in [first, last] (inclusive; `io.cpp:137-158`)."""
    vals = []
    with open(path) as fin:
        for ix, line in enumerate(fin):
            if ix > last:
                break
            if ix >= first:
                vals.append(float(line))
    return np.array(vals, dtype=np.float32)


def write_single_column_file(data, path: str) -> None:
    """One value per line, C++ default float formatting (`io.cpp:342-361`).

    std::ofstream << float prints with 6 significant digits — matched here via
    %g so that .means/.stds files are interchangeable with the reference.
    """
    with open(path, "w") as fout:
        for v in np.asarray(data).ravel():
            if isinstance(v, (np.floating, float)):
                fout.write(f"{float(v):g}\n")
            else:
                fout.write(f"{int(v)}\n")


def read_correlations_from_mtx(path: str) -> np.ndarray:
    """Dense symmetric matrix from a MatrixMarket coordinate file (`io.cpp:174-214`).

    Mirrors the reference reader: both (i,j) and (j,i) are set from each entry.
    """
    corrs = None
    nj = 0
    expect_dims = False
    with open(path) as fin:
        for line in fin:
            line = line.strip()
            if not line:
                break
            if line.startswith("%"):
                expect_dims = True
                continue
            fields = line.split()
            if expect_dims:
                expect_dims = False
                ni, nj = int(fields[0]), int(fields[1])
                corrs = np.zeros((ni, nj), dtype=np.float32)
                continue
            i, j = int(fields[0]) - 1, int(fields[1]) - 1
            c = np.float32(float(fields[2]))
            corrs[i, j] = c
            corrs[j, i] = c
    return corrs


def write_coo_mtx(path: str, mat: np.ndarray, integer: bool = False) -> None:
    """Write a dense matrix as MatrixMarket coordinate (nonzeros only).

    Matches the layout of `scipy.io.mmwrite(coo_matrix(...))` used by
    `sepselect.py:542-550` (1-based indices, column-major nonzero order).
    """
    import scipy.sparse
    from scipy.io import mmwrite

    mat = np.asarray(mat)
    if integer:
        mat = mat.astype(np.int32)
    mmwrite(path, scipy.sparse.coo_matrix(mat))
