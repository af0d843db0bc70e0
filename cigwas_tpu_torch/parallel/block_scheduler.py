"""Block scheduling across processes (`cigwas_tpu.parallel.block_scheduler`).

The reference distributes work by launching one `mps cusk <block>` process
per block on a cluster (`ci-gwas.py:100-104`, `README.md:57`). Here blocks
are partitioned programmatically: each process takes a load-balanced share
of the block list, weighted by block size squared (the skeleton's
correlation cost is quadratic in block size). The partition defaults to the
process's place in its ``torch.distributed`` world
(:func:`cigwas_tpu_torch.parallel.distributed.process_partition`).
"""

from __future__ import annotations

from cigwas_tpu_torch.parallel.distributed import process_partition

# fixed per-block cost (launches + host IO + pre-screen), expressed in
# block_size^2 units: roughly the compute of a 128-marker block. Dominates
# for small blocks, vanishes against genome-scale blocks.
BLOCK_OVERHEAD_COST = 128 * 128


def block_cost(block) -> int:
    """Wall-cost model for one block: quadratic skeleton work + fixed
    per-block overhead (the reference pays the same shape of cost per `mps
    cusk` process launch, `ci-gwas.py:100-104`)."""
    return block.block_size() ** 2 + BLOCK_OVERHEAD_COST


def partition_blocks(blocks: list, num_partitions: int | None = None,
                     index: int | None = None) -> list:
    """Blocks assigned to partition `index` of `num_partitions`.

    Defaults to this process's (world size, rank) when a process group is
    initialized, else (1, 0): one process runs every block. Greedy
    longest-processing-time assignment on `block_cost` keeps the partitions'
    walls balanced within ~the largest single block.
    """
    world, rank = process_partition()
    num_partitions = world if num_partitions is None else num_partitions
    index = rank if index is None else index
    if not 0 <= index < num_partitions:
        raise ValueError(f"partition index {index} outside [0, {num_partitions})")
    loads = [0] * num_partitions
    assign: list[list] = [[] for _ in range(num_partitions)]
    order = sorted(range(len(blocks)), key=lambda i: -block_cost(blocks[i]))
    for i in order:
        tgt = loads.index(min(loads))
        assign[tgt].append(i)
        loads[tgt] += block_cost(blocks[i])
    return [blocks[i] for i in sorted(assign[index])]
