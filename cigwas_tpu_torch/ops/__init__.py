"""Device ops of the port: 2-bit decode, correlation panels, CI tests
(`cigwas_tpu.ops`); the same exports as the JAX package's."""

from cigwas_tpu_torch.ops.decode import geno_onehot, unpack_bed_codes
from cigwas_tpu_torch.ops.corr import (
    kendall_npn_corr,
    kendall_npn_corr_banded,
    marker_phen_corr,
    pack_square_corr,
    phen_phen_corr,
)

__all__ = [
    "unpack_bed_codes",
    "geno_onehot",
    "kendall_npn_corr",
    "kendall_npn_corr_banded",
    "marker_phen_corr",
    "phen_phen_corr",
    "pack_square_corr",
]
