"""PLINK .bed / .bim / .fam fileset handling.

Host-side equivalents of the reference's `BfilesBase` (`bfiles_base.h:11-53`),
`BedDims` (`io.h:18-65`), `BimInfo` (`bim.cpp:20-48`), the random-access .bed
readers (`io.cpp:238-264`), and the 2-bit genotype decode tables
(`bed_lut.h`). The decode here is vectorized numpy; the on-device decode used
by the correlation engine lives in :mod:`cigwas_tpu_torch.ops.decode`.

PLINK .bed 2-bit codes (one marker column = ceil(n/4) bytes, LSB-first pairs):
    00 -> genotype 2 (hom. minor)     valid
    01 -> missing                     invalid (decoded value 2.0, validity 0)
    10 -> genotype 1 (het)            valid
    11 -> genotype 0 (hom. major)     valid
"""

from __future__ import annotations

import os

import numpy as np

from cigwas_tpu_torch.constants import BED_PREFIX_BYTES, BED_PREFIX_COL_MAJ

# value per 2-bit code; missing (code 1) decodes to 2.0 with validity 0,
# matching bed_lut_a / bed_lut_b in the reference (`bed_lut.h:3-40`).
_CODE_VALUE = np.array([2.0, 2.0, 1.0, 0.0], dtype=np.float32)
_CODE_VALID = np.array([1.0, 0.0, 1.0, 1.0], dtype=np.float32)
# genotype value -> 2-bit code (`bed_lut.h:3`, gt_to_bed_value)
GT_TO_BED_CODE = np.array([3, 2, 0], dtype=np.uint8)


def bed_bytes_to_codes(bed_bytes: np.ndarray, num_samples: int) -> np.ndarray:
    """(num_markers, bytes_per_col) uint8 -> (num_markers, num_samples) 2-bit codes."""
    bed_bytes = np.asarray(bed_bytes, dtype=np.uint8)
    if bed_bytes.ndim == 1:
        bed_bytes = bed_bytes[None, :]
    shifts = np.array([0, 2, 4, 6], dtype=np.uint8)
    codes = (bed_bytes[:, :, None] >> shifts[None, None, :]) & 0x3
    codes = codes.reshape(bed_bytes.shape[0], -1)[:, :num_samples]
    return codes


def decode_bed_values(bed_bytes: np.ndarray, num_samples: int):
    """Decode to (values f32, validity f32) arrays of shape (num_markers, num_samples)."""
    codes = bed_bytes_to_codes(bed_bytes, num_samples)
    return _CODE_VALUE[codes], _CODE_VALID[codes]


def encode_bed_values(genotypes: np.ndarray) -> np.ndarray:
    """(num_markers, num_samples) genotypes {0,1,2, nan} -> packed .bed bytes.

    Used to build test fixtures and synthetic data; inverse of decode.
    """
    genotypes = np.asarray(genotypes, dtype=np.float32)
    m, n = genotypes.shape
    codes = np.where(
        np.isnan(genotypes), np.uint8(1), GT_TO_BED_CODE[np.nan_to_num(genotypes).astype(np.int64)]
    ).astype(np.uint8)
    pad = (-n) % 4
    if pad:
        codes = np.concatenate([codes, np.zeros((m, pad), dtype=np.uint8)], axis=1)
    codes = codes.reshape(m, -1, 4)
    shifts = np.array([0, 2, 4, 6], dtype=np.uint8)
    return (codes << shifts[None, None, :]).sum(axis=2).astype(np.uint8)


def decode_bed_column_stats(bedcol: np.ndarray, num_samples: int):
    """Per-marker mean/std/mode skipping missing genotypes.

    Equivalent of `prep.cpp:15-77` (compute_bed_col_stats_no_impute): the std
    is the population std over the non-missing entries, the mean divides by
    the non-missing count, and the mode is the most frequent genotype (ties
    broken toward the smaller genotype value).
    """
    vals, valid = decode_bed_values(np.atleast_2d(bedcol), num_samples)
    vals, valid = vals[0], valid[0]
    counts = np.array([np.sum((vals == g) & (valid == 1.0)) for g in (0.0, 1.0, 2.0)])
    n_valid = counts.sum()
    mode = int(np.argmax(counts))
    mean = float((vals * valid).sum() / n_valid)
    sum_sq = float((((vals - mean) ** 2) * valid).sum())
    std = float(np.sqrt(sum_sq / n_valid))
    return mean, std, mode


class BfilesBase:
    """Path bundle around a PLINK fileset stem (`bfiles_base.h:11-53`)."""

    def __init__(self, base: str):
        self.base = base

    def dim(self) -> str:
        return self.base + ".dim"

    def bed(self) -> str:
        return self.base + ".bed"

    def means(self) -> str:
        return self.base + ".means"

    def stds(self) -> str:
        return self.base + ".stds"

    def bim(self) -> str:
        return self.base + ".bim"

    def fam(self) -> str:
        return self.base + ".fam"

    def modes(self) -> str:
        return self.base + ".modes"

    def blocks(self, size: int | None = None) -> str:
        if size is None:
            return self.base + ".blocks"
        return f"{self.base}_m{size}.blocks"

    def has_valid_bed_prefix(self) -> bool:
        with open(self.bed(), "rb") as fin:
            return fin.read(BED_PREFIX_BYTES) == BED_PREFIX_COL_MAJ


def count_lines(path: str) -> int:
    with open(path) as fin:
        return sum(1 for _ in fin)


class BedDims:
    """num_samples / num_markers pair, text `.dim` format (`io.h:18-65`)."""

    def __init__(self, num_samples: int, num_markers: int):
        self.num_samples = int(num_samples)
        self.num_markers = int(num_markers)

    @classmethod
    def from_file(cls, path: str) -> "BedDims":
        with open(path) as fin:
            fields = fin.readline().split()
        return cls(int(fields[0]), int(fields[1]))

    @classmethod
    def from_bfiles(cls, bfiles: BfilesBase) -> "BedDims":
        return cls(count_lines(bfiles.fam()), count_lines(bfiles.bim()))

    def __eq__(self, other) -> bool:
        return (
            self.num_samples == other.num_samples and self.num_markers == other.num_markers
        )

    def bytes_per_col(self) -> int:
        return (self.num_samples + 3) // 4

    def to_file(self, path: str) -> None:
        with open(path, "w") as fout:
            fout.write(f"{self.num_samples}\t{self.num_markers}\n")


BIM_NUM_COLS = 6


class BimInfo:
    """Chromosome index over a .bim file (`bim.cpp:20-48`)."""

    def __init__(self, path: str):
        self.number_of_lines = 0
        self.chr_ids: list[str] = []
        self.num_markers_on_chr: list[int] = []
        self.chr_id2ix: dict[str, int] = {}
        self.global_chr_start: list[int] = []

        with open(path) as fin:
            for line in fin:
                fields = line.split()
                chr_id = fields[0]
                if self.number_of_lines == 0 or chr_id != self.chr_ids[-1]:
                    self.global_chr_start.append(self.number_of_lines)
                    self.chr_id2ix[chr_id] = len(self.chr_ids)
                    self.chr_ids.append(chr_id)
                    self.num_markers_on_chr.append(0)
                self.num_markers_on_chr[-1] += 1
                self.number_of_lines += 1

    def get_num_markers_on_chr(self, chr_id: str) -> int:
        return self.num_markers_on_chr[self.chr_id2ix[chr_id]]

    def get_global_chr_start(self, chr_id: str) -> int:
        return self.global_chr_start[self.chr_id2ix[chr_id]]

    def get_global_chr_end(self, chr_id: str) -> int:
        ix = self.chr_id2ix[chr_id]
        return self.global_chr_start[ix] + self.num_markers_on_chr[ix] - 1


def read_block_from_bed(path: str, block, dims: BedDims, bim: BimInfo) -> np.ndarray:
    """Packed bytes for one marker block, shape (block_size, bytes_per_col).

    Seek-based random access like `io.cpp:238-249`.
    """
    bpc = dims.bytes_per_col()
    chr_start = bim.get_global_chr_start(block.chr_id)
    with open(path, "rb") as fin:
        fin.seek(BED_PREFIX_BYTES + (chr_start + block.first_marker_ix) * bpc)
        raw = fin.read(bpc * block.block_size())
    return np.frombuffer(raw, dtype=np.uint8).reshape(block.block_size(), bpc)


def read_chr_from_bed(path: str, chr_id: str, bim: BimInfo, dims: BedDims) -> np.ndarray:
    """Packed bytes for a whole chromosome (`io.cpp:251-264`)."""
    bpc = dims.bytes_per_col()
    first = bim.get_global_chr_start(chr_id)
    last = bim.get_global_chr_end(chr_id)
    n_markers = last - first + 1
    with open(path, "rb") as fin:
        fin.seek(BED_PREFIX_BYTES + first * bpc)
        raw = fin.read(bpc * n_markers)
    return np.frombuffer(raw, dtype=np.uint8).reshape(n_markers, bpc)


def check_path(path: str) -> None:
    if not os.path.exists(path):
        raise FileNotFoundError(f"file or directory not found: {path}")


def check_bed_path(basepath: str) -> None:
    for suffix in (".bed", ".bim", ".fam"):
        check_path(basepath + suffix)


def check_prepped_bed_path(basepath: str) -> None:
    for suffix in (".bed", ".dim", ".means", ".stds", ".bim", ".fam"):
        check_path(basepath + suffix)


def num_markers_within_distance(bim_path: str, distance_threshold: int) -> int:
    """Median number of markers within a base-pair distance window.

    Equivalent of `bim.cpp:60-84` (assumes a single-chromosome .bim). The
    window count for the marker entering at position b is the number of
    strictly-interior markers once the left edge slides past the threshold.
    """
    positions = []
    with open(bim_path) as fin:
        for line in fin:
            fields = line.split()
            if len(fields) >= 4:
                positions.append(int(fields[3]))
    marker_nums = []
    pa = 0
    for pb in range(len(positions)):
        while positions[pb] - positions[pa] > distance_threshold:
            marker_nums.append(pb - pa - 1)
            pa += 1
    n = len(marker_nums) // 2
    return int(np.partition(np.array(marker_nums), n)[n])
