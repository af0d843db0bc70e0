from cigwas_tpu_torch.skeleton.cupc import (
    SkeletonResult,
    hetcor_skeleton,
    panel_from_numpy,
    skeleton,
)
from cigwas_tpu_torch.skeleton.reduce import reduce_gc, reduce_gcs, subset_variables

__all__ = [
    "SkeletonResult",
    "hetcor_skeleton",
    "panel_from_numpy",
    "reduce_gc",
    "reduce_gcs",
    "skeleton",
    "subset_variables",
]
