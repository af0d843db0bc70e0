"""The numpy-only host modules of :mod:`cigwas_tpu` that the port reuses.

These import no jax (``cigwas_tpu_torch/__init__`` sets
``CIGWAS_TPU_NO_COMPILE_CACHE`` so the JAX package's own ``__init__`` does
not either). Everything the port takes from the JAX package passes through
this module, which keeps that boundary in one place.
"""

from cigwas_tpu.constants import BED_PREFIX_COL_MAJ, ML, PANEL_ALIGN
from cigwas_tpu.io import (
    BedDims,
    BfilesBase,
    BimInfo,
    MarkerBlock,
    ReducedGCS,
    load_phen,
    make_path,
    read_blocks_from_file,
    read_floats_from_line_range,
    write_marker_blocks_to_file,
)
from cigwas_tpu.io.bed import (
    check_path,
    check_prepped_bed_path,
    encode_bed_values,
    read_block_from_bed,
)
from cigwas_tpu.prep import prep_bed
from cigwas_tpu.utils.combinatorics import colex_combinations_chunk, colex_unrank
from cigwas_tpu.utils.stats import fisher_z, threshold_array

__all__ = [
    "BED_PREFIX_COL_MAJ",
    "ML",
    "PANEL_ALIGN",
    "BedDims",
    "BfilesBase",
    "BimInfo",
    "MarkerBlock",
    "ReducedGCS",
    "check_path",
    "check_prepped_bed_path",
    "colex_combinations_chunk",
    "colex_unrank",
    "encode_bed_values",
    "fisher_z",
    "load_phen",
    "make_path",
    "prep_bed",
    "read_block_from_bed",
    "read_blocks_from_file",
    "read_floats_from_line_range",
    "threshold_array",
    "write_marker_blocks_to_file",
]
