from cigwas_tpu_torch.utils.stats import (
    fisher_z,
    threshold_array,
    hetcor_threshold,
    alpha_threshold,
)
from cigwas_tpu_torch.utils.combinatorics import binom, colex_combinations_chunk

__all__ = [
    "fisher_z",
    "threshold_array",
    "hetcor_threshold",
    "alpha_threshold",
    "binom",
    "colex_combinations_chunk",
]
