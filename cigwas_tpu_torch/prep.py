"""`prep-bed`: per-marker statistics for a PLINK fileset.

Equivalent of `prep_bed_no_impute` (`prep.cpp:157-201`): streams the .bed
column blocks, computes per-marker mean/std/mode over non-missing genotypes
and writes the `.dim/.means/.stds/.modes` sidecar files the cusk stage needs.

The per-byte LUT loop of the reference is replaced by a vectorized decode
over whole column batches (numpy on the host; this stage is IO bound).
"""

from __future__ import annotations

import numpy as np

from cigwas_tpu_torch.constants import BED_PREFIX_BYTES
from cigwas_tpu_torch.io.bed import (
    BedDims,
    BfilesBase,
    BimInfo,
    count_lines,
    decode_bed_values,
)
from cigwas_tpu_torch.io.binary import write_single_column_file

# markers per streamed batch
BATCH = 4096


def compute_bed_stats(
    bed_bytes: np.ndarray, num_samples: int
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Vectorized mean/std/mode for a batch of packed marker columns."""
    vals, valid = decode_bed_values(bed_bytes, num_samples)
    n_valid = valid.sum(axis=1)
    counts = np.stack(
        [((vals == g) & (valid == 1.0)).sum(axis=1) for g in (0.0, 1.0, 2.0)], axis=1
    )
    # ties break toward the smaller genotype, like the reference's `>` scan
    # (`prep.cpp:46-55`)
    modes = np.argmax(counts, axis=1).astype(np.int32)
    # the reference accumulates genotype sums in integers and divides once
    means = ((vals * valid).sum(axis=1) / n_valid).astype(np.float32)
    sq = ((vals - means[:, None]) ** 2 * valid).sum(axis=1)
    stds = np.sqrt(sq / n_valid).astype(np.float32)
    return means, stds, modes


def prep_bed(bed_base_path: str) -> BedDims:
    bfiles = BfilesBase(bed_base_path)
    if not bfiles.has_valid_bed_prefix():
        raise ValueError("Invalid prefix bytes in bed")
    num_individuals = count_lines(bfiles.fam())
    bim = BimInfo(bfiles.bim())
    dims = BedDims(num_individuals, bim.number_of_lines)
    dims.to_file(bfiles.dim())

    # native streamed pass (native/bedops.cpp) with a numpy fallback
    from cigwas_tpu_torch.native import bed_file_col_stats

    native = bed_file_col_stats(
        bfiles.bed(), num_individuals, dims.num_markers
    )
    if native is not None:
        all_means, all_stds, all_modes = native
    else:
        bpc = dims.bytes_per_col()
        means, stds, modes = [], [], []
        with open(bfiles.bed(), "rb") as fin:
            fin.seek(BED_PREFIX_BYTES)
            while True:
                raw = fin.read(bpc * BATCH)
                if not raw:
                    break
                n_cols = len(raw) // bpc
                batch = np.frombuffer(raw[: n_cols * bpc], dtype=np.uint8).reshape(
                    n_cols, bpc
                )
                m, s, md = compute_bed_stats(batch, num_individuals)
                means.append(m)
                stds.append(s)
                modes.append(md)
        all_means = np.concatenate(means)
        all_stds = np.concatenate(stds)
        all_modes = np.concatenate(modes)

    write_single_column_file(all_means, bfiles.means())
    write_single_column_file(all_stds, bfiles.stds())
    write_single_column_file(np.asarray(all_modes, dtype=np.int64), bfiles.modes())
    return dims


def compute_bed_stats_impute(
    bed_bytes: np.ndarray, num_samples: int
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Mode-imputing variant: missing genotypes are replaced by the mode and
    statistics divide by the full sample count.

    Equivalent of `compute_bed_col_stats_impute` (`prep.cpp:79-155`; defined
    but unused in the reference's pipeline). Returns (means, stds, modes,
    imputed genotype values).
    """
    from cigwas_tpu_torch.io.bed import decode_bed_values

    vals, valid = decode_bed_values(bed_bytes, num_samples)
    counts = np.stack(
        [((vals == g) & (valid == 1.0)).sum(axis=1) for g in (0.0, 1.0, 2.0)], axis=1
    )
    modes = np.argmax(counts, axis=1).astype(np.int32)
    imputed = np.where(valid == 1.0, vals, modes[:, None].astype(np.float32))
    means = imputed.mean(axis=1).astype(np.float32)
    stds = imputed.std(axis=1).astype(np.float32)
    return means, stds, modes, imputed
