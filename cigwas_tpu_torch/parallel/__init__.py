from cigwas_tpu_torch.parallel.block_scheduler import block_cost, partition_blocks
from cigwas_tpu_torch.parallel.runner import run_all_blocks

__all__ = ["block_cost", "partition_blocks", "run_all_blocks"]
