"""Multi-process wiring (`cigwas_tpu.parallel.distributed`).

The reference scales across hosts by having the user submit one `mps cusk`
job per block to a cluster (`ci-gwas.py:100-104`) and merging the per-block
outputs from the shared file system
(`cusk_postprocessing/merge_blocks.py:361-395`). That contract is kept: block
outputs are self-describing files and the merge never needs communication
between processes. What a process needs is its place in the world:

* :func:`init_distributed` joins a ``torch.distributed`` process group
  (backend gloo: only host-side coordination is needed, and gloo runs any
  number of processes on one card) from its arguments or the environment,
* :func:`process_partition` reports this process's (num_partitions, index),
  which :func:`cigwas_tpu_torch.parallel.block_scheduler.partition_blocks`
  takes as its default, so `run_all_blocks` / `cusk-all` need no partition
  flags under a launcher,
* :func:`run_partition_process` is one partition worker, run as
  ``python -m cigwas_tpu_torch.parallel.distributed``: it runs its partition
  on ``--device`` (default the card, which concurrent workers share) and
  prints one JSON line with its wall time.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch.distributed as dist

from cigwas_tpu_torch.utils.timing import span


def _env(*names, cast=str):
    for name in names:
        val = os.environ.get(name)
        if val is not None:
            return cast(val)
    return None


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None) -> None:
    """Join the gloo process group of this run (idempotent).

    coordinator_address is ``host:port`` of process 0 (a ``tcp://`` prefix
    is accepted). Defaults come from ``CIGWAS_COORDINATOR_ADDRESS``,
    ``CIGWAS_NUM_PROCESSES`` and ``CIGWAS_PROCESS_ID``, or from torchrun's
    ``MASTER_ADDR``/``MASTER_PORT``, ``WORLD_SIZE`` and ``RANK``. After this
    call ``process_partition()`` is (world size, rank)."""
    if dist.is_initialized():
        return
    if coordinator_address is None:
        coordinator_address = _env("CIGWAS_COORDINATOR_ADDRESS")
    if coordinator_address is None and os.environ.get("MASTER_ADDR"):
        coordinator_address = f"{os.environ['MASTER_ADDR']}:{os.environ.get('MASTER_PORT', 29500)}"
    if num_processes is None:
        num_processes = _env("CIGWAS_NUM_PROCESSES", "WORLD_SIZE", cast=int)
    if process_id is None:
        process_id = _env("CIGWAS_PROCESS_ID", "RANK", cast=int)
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError(
            "init_distributed needs the coordinator address, the number of processes "
            "and this process's id (arguments, CIGWAS_* or torchrun's environment)")
    addr = coordinator_address.removeprefix("tcp://")
    dist.init_process_group("gloo", init_method=f"tcp://{addr}",
                            world_size=int(num_processes), rank=int(process_id))


def process_partition() -> tuple[int, int]:
    """(num_partitions, partition_index) of this process: the process
    group's (world size, rank) if one is initialized, else (1, 0)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def run_partition_process(argv=None) -> int:
    """One partition worker.

    Usage: python -m cigwas_tpu_torch.parallel.distributed <phen> <bfiles>
      <blocks> <alpha> <max_level> <max_level_two> <depth> <outdir>
      <num_partitions> <partition_index> [--device cuda|cpu]

    Runs `run_all_blocks` for the given partition and prints one JSON line:
    {"partition": i, "wall_s": w, "walls_s": [...], "results": {...}}. With
    CIGWAS_WORKER_STEADY=k it first runs one pass to warm up, then k passes
    (the outputs are byte-identical reruns), and reports the least wall."""
    ap = argparse.ArgumentParser(prog="python -m cigwas_tpu_torch.parallel.distributed")
    for name in ("phen", "bfiles", "blocks", "alpha", "max_level", "max_level_two", "depth",
                 "outdir", "num_partitions", "partition_index"):
        ap.add_argument(name)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    a = ap.parse_args(sys.argv[1:] if argv is None else argv)
    from cigwas_tpu_torch.parallel.runner import run_all_blocks

    def one_pass():
        walls: dict = {}
        with span(walls, "wall_s", "cigwas.pipeline.partition"):
            res = run_all_blocks(
                a.phen, a.bfiles, a.blocks, float(a.alpha), int(a.max_level),
                int(a.max_level_two), int(a.depth), a.outdir,
                num_partitions=int(a.num_partitions), partition_index=int(a.partition_index),
                verbose=False, device=a.device,
            )
        return res, walls["wall_s"]

    if os.environ.get("CIGWAS_WORKER_STEADY"):
        k = max(1, int(os.environ["CIGWAS_WORKER_STEADY"]))
        one_pass()  # warm-up: kernel builds and first allocations
        passes = [one_pass() for _ in range(k)]
        walls = [w for _, w in passes]
        results, wall = min(passes, key=lambda rw: rw[1])
    else:
        results, wall = one_pass()
        walls = [wall]
    print(json.dumps({"partition": int(a.partition_index), "wall_s": wall, "walls_s": walls,
                      "results": dict(results)}))
    return 0


if __name__ == "__main__":
    sys.exit(run_partition_process())
