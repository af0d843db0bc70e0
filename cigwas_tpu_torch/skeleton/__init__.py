from cigwas_tpu_torch.skeleton.cupc import SkeletonResult, panel_from_numpy, skeleton
from cigwas_tpu_torch.skeleton.reduce import reduce_gcs, subset_variables

__all__ = [
    "SkeletonResult",
    "panel_from_numpy",
    "reduce_gcs",
    "skeleton",
    "subset_variables",
]
