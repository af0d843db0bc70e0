from cigwas_tpu_torch.io.bed import BfilesBase, BedDims, BimInfo, decode_bed_column_stats
from cigwas_tpu_torch.io.blocks import MarkerBlock, read_blocks_from_file, write_marker_blocks_to_file
from cigwas_tpu_torch.io.phen import Phen, load_phen
from cigwas_tpu_torch.io.binary import (
    read_floats_from_binary,
    read_ints_from_binary,
    write_floats_to_binary,
    write_ints_to_binary,
    read_floats_from_lines,
    read_ints_from_lines,
    read_floats_from_line_range,
    read_correlations_from_mtx,
    write_single_column_file,
    make_path,
)
from cigwas_tpu_torch.io.sumstats import (
    TraitSummaryStats,
    MarkerSummaryStats,
    MarkerTraitSummaryStats,
)
from cigwas_tpu_torch.io.results import ReducedGCS, ReducedGC

__all__ = [
    "BfilesBase",
    "BedDims",
    "BimInfo",
    "decode_bed_column_stats",
    "MarkerBlock",
    "read_blocks_from_file",
    "write_marker_blocks_to_file",
    "Phen",
    "load_phen",
    "read_floats_from_binary",
    "read_ints_from_binary",
    "write_floats_to_binary",
    "write_ints_to_binary",
    "read_floats_from_lines",
    "read_ints_from_lines",
    "read_floats_from_line_range",
    "read_correlations_from_mtx",
    "write_single_column_file",
    "make_path",
    "TraitSummaryStats",
    "MarkerSummaryStats",
    "MarkerTraitSummaryStats",
    "ReducedGCS",
    "ReducedGC",
]
