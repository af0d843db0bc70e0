from cigwas_tpu_torch.parallel.block_scheduler import block_cost, partition_blocks
from cigwas_tpu_torch.parallel.distributed import init_distributed, process_partition
from cigwas_tpu_torch.parallel.mesh import Mesh, make_mesh
from cigwas_tpu_torch.parallel.runner import partition_mesh, run_all_blocks
from cigwas_tpu_torch.parallel.sharded import RowShardedEngine, ShardedEngine, make_engine
from cigwas_tpu_torch.parallel.spmd import build_multichip_cusk_step

__all__ = [
    "Mesh",
    "RowShardedEngine",
    "ShardedEngine",
    "block_cost",
    "build_multichip_cusk_step",
    "init_distributed",
    "make_engine",
    "make_mesh",
    "partition_blocks",
    "partition_mesh",
    "process_partition",
    "run_all_blocks",
]
