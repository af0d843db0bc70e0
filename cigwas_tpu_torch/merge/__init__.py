"""Merge of per-block outputs, separation sets and v-structures on the merged
skeleton, and the MR instrument checks (`cigwas_tpu.merge`): host numpy and
scipy only, no pandas."""

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
from cigwas_tpu_torch.merge.mr_assumptions import check_ivs, get_iv_candidates

__all__ = [
    "BlockOutput",
    "GlobalMergeResult",
    "block_stems_from_blockfile",
    "merge_block_outputs",
    "reformat_cuskss_merged_output",
    "MergedSkeleton",
    "sepselect_merged",
    "orient_v_structures_merged",
    "get_iv_candidates",
    "check_ivs",
]
