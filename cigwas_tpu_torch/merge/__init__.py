"""Merge of per-block outputs, separation sets and v-structures on the merged
skeleton (`cigwas_tpu.merge`): host numpy and scipy only, no pandas."""

from cigwas_tpu_torch.merge.merge_blocks import (
    BlockOutput,
    GlobalMergeResult,
    block_stems_from_blockfile,
    merge_block_outputs,
    reformat_cuskss_merged_output,
)
from cigwas_tpu_torch.merge.sepselect import (
    MergedSkeleton,
    orient_v_structures_merged,
    sepselect_merged,
)

__all__ = [
    "BlockOutput",
    "GlobalMergeResult",
    "block_stems_from_blockfile",
    "merge_block_outputs",
    "reformat_cuskss_merged_output",
    "MergedSkeleton",
    "sepselect_merged",
    "orient_v_structures_merged",
]
