"""Multi-block cusk runner (`cigwas_tpu.parallel.runner`).

The reference leaves block-level data parallelism to the user ("run mps cusk
once for each block", `README.md:57`). This runner makes it first class:
one process iterates its partition of the block list, on one device or
sharding every block over a mesh; several processes, one per partition
(`num_partitions`, `partition_index`, or their process group's world and
rank), each take their load-balanced share via
:func:`cigwas_tpu_torch.parallel.block_scheduler.partition_blocks`, and the
merge step reads all block outputs from the shared file system, so no
communication between them is needed. :func:`partition_mesh` gives each
partition its own group of devices: block parallelism across the groups,
panel sharding inside each.
"""

from __future__ import annotations

import torch

from cigwas_tpu_torch.io import read_blocks_from_file
from cigwas_tpu_torch.parallel.block_scheduler import partition_blocks
from cigwas_tpu_torch.parallel.distributed import process_partition
from cigwas_tpu_torch.parallel.mesh import flat_mesh, visible_devices
from cigwas_tpu_torch.pipelines.cusk import CuskContext
from cigwas_tpu_torch.utils.timing import span


def partition_mesh(devices_per_partition: int, partition_index: int | None = None,
                   axis: str = "marker", device="cuda"):
    """1-D mesh over THIS partition's group of devices
    (`cigwas_tpu.parallel.runner.partition_mesh`): partition p gets the cards
    [p g, (p + 1) g) (g = devices_per_partition), so concurrent partition
    workers each shard their blocks over a disjoint group; on ``cpu``, g
    entries of the CPU. partition_index defaults to this process's rank (0
    without a process group). Raises if the range does not fit the visible
    cards."""
    if partition_index is None:
        partition_index = process_partition()[1]
    if torch.device(device).type == "cpu":
        return flat_mesh(visible_devices(devices_per_partition, "cpu"), axis)
    lo = devices_per_partition * partition_index
    hi = lo + devices_per_partition
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if hi > have:
        raise ValueError(
            f"partition {partition_index} needs devices [{lo}, {hi}) but only "
            f"{have} are visible"
        )
    return flat_mesh(visible_devices(hi, "cuda")[lo:hi], axis)


def run_all_blocks(
    phen_path: str,
    bed_base_path: str,
    block_path: str,
    alpha: float,
    max_level: int,
    max_level_two: int,
    depth: int,
    outdir: str,
    num_partitions: int | None = None,
    partition_index: int | None = None,
    verbose: bool = True,
    device="cuda",
    mesh=None,
    panel_mode: str = "replicated",
    stats: dict | None = None,
) -> dict:
    """Run cusk for every block assigned to this partition.

    mesh / panel_mode: shard each block over the mesh (see
    :class:`~cigwas_tpu_torch.pipelines.cusk.CuskContext`); with
    :func:`partition_mesh` each partition uses its own device group.

    Returns {block_file_string: num_markers_retained | None (skipped)}.
    stats, if given, receives {block_file_string: the block's stats}: its
    ``prepare_s`` and ``finish_s`` and the keys of
    :meth:`~cigwas_tpu_torch.pipelines.cusk.CuskContext.finish`. With
    verbose, each block ends with one line: its retained markers, the walls
    of its prepare and finish, and the card's allocated memory now and at
    most (since the process began or the last reset of the peak
    statistics).
    """
    blocks = read_blocks_from_file(block_path)
    mine = partition_blocks(blocks, num_partitions, partition_index)
    index_of = {b.to_file_string(): i for i, b in enumerate(blocks)}
    per_block = {b.to_file_string(): {} for b in mine}
    results: dict = {}
    ctx = CuskContext(
        phen_path, bed_base_path, block_path, alpha, max_level, max_level_two,
        depth, outdir, verbose=verbose, device=device, mesh=mesh, panel_mode=panel_mode,
    )

    def prepare(b):
        stem = b.to_file_string()
        return ctx.prepare(index_of[stem], stats=per_block[stem])

    # software pipeline: block i+1's host IO and the launch of its pre-screen
    # sums happen before block i's finish, so the disk read queues device
    # work behind the previous block's and waits for no result
    prepared = prepare(mine[0]) if mine else None
    for i, b in enumerate(mine):
        stem = b.to_file_string()
        cur, prepared = prepared, (prepare(mine[i + 1]) if i + 1 < len(mine) else None)
        walls = per_block[stem]
        with span(walls, "finish_s", "cigwas.pipeline.finish"):
            res = ctx.finish(cur, stats=walls)
        results[stem] = None if res is None else res.num_markers()
        if verbose:
            now, most = ((torch.cuda.memory_allocated(ctx.device),
                          torch.cuda.max_memory_allocated(ctx.device))
                         if ctx.device.type == "cuda" else (0, 0))
            kept = "no" if res is None else results[stem]
            print(f"[run_all_blocks] [{stem}] retained {kept} markers, "
                  f"prepare {walls['prepare_s']:.3f} s, finish {walls['finish_s']:.3f} s, "
                  f"device memory {now / 2**30:.3f} GiB now, {most / 2**30:.3f} GiB at most",
                  flush=True)
    if verbose:
        total = sum(w["prepare_s"] + w["finish_s"] for w in per_block.values())
        print(f"[run_all_blocks] processed {len(mine)} blocks in {total:.2f}s")
    if stats is not None:
        stats.update(per_block)
    return results
