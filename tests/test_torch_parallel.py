"""The port's block partitions, partition workers, process group and device
meshes (`cigwas_tpu_torch.parallel`) against the JAX package's, on the CPU:
the counterparts of the non-`spmd` tests of tests/test_parallel.py (the
`spmd` step's are in tests/test_torch_spmd.py).

Merged outputs of partitioned runs are compared byte for byte with the
one-partition run; the partition assignment and the mesh rules with the JAX
package's.
"""

import hashlib
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from torch_parity import set_threads, std, write_plink

from cigwas_tpu_torch.io.blocks import MarkerBlock
from cigwas_tpu_torch.parallel import make_mesh, partition_blocks, run_all_blocks

set_threads()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MERGED = ("_sam.mtx", "_scm.mtx", ".mdim", ".ixs")


def _child_env() -> dict:
    return dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")


def test_partition_blocks_balances_cost():
    """LPT on size^2: the giant block sits alone, the ten small ones share
    the other partition (a contiguous split would fail this)."""
    blocks = [MarkerBlock("1", 0, 999)] + [
        MarkerBlock("1", 1000 + i * 10, 1000 + i * 10 + 9) for i in range(10)
    ]
    parts = [partition_blocks(blocks, 2, i) for i in range(2)]
    assert sorted((len(parts[0]), len(parts[1]))) == [1, 10]
    costs = sorted(sum(b.block_size() ** 2 for b in p) for p in parts)
    assert costs == [10 * 10**2, 1000**2]


def test_partition_blocks_lpt_near_optimal_balance():
    """Equal blocks split exactly; mixed ones within the LPT bound, nothing
    lost or duplicated; every partition the JAX package's."""
    from cigwas_tpu.io.blocks import MarkerBlock as JaxBlock
    from cigwas_tpu.parallel import partition_blocks as jax_partition

    equal = [MarkerBlock("1", i * 10, i * 10 + 9) for i in range(12)]
    assert [len(partition_blocks(equal, 4, i)) for i in range(4)] == [3, 3, 3, 3]

    rng = np.random.default_rng(3)
    sizes = rng.integers(10, 200, size=23)
    start = np.concatenate([[0], np.cumsum(sizes)])
    spans = [(int(start[i]), int(start[i] + sizes[i] - 1)) for i in range(len(sizes))]
    mixed = [MarkerBlock("1", a, b) for a, b in spans]
    parts = [partition_blocks(mixed, 4, i) for i in range(4)]
    costs = [sum(b.block_size() ** 2 for b in p) for p in parts]
    assert max(costs) <= sum(costs) / 4 + max(b.block_size() ** 2 for b in mixed)
    seen = sorted(b.to_file_string() for p in parts for b in p)
    assert seen == sorted(b.to_file_string() for b in mixed)
    jax_mixed = [JaxBlock("1", a, b) for a, b in spans]
    for i in range(4):
        assert ([b.to_file_string() for b in parts[i]]
                == [b.to_file_string() for b in jax_partition(jax_mixed, 4, i)])


def test_partition_blocks_defaults_to_one_partition_without_a_world():
    """Without a process group the default partition is (1, 0): every block."""
    from cigwas_tpu_torch.parallel import process_partition

    blocks = [MarkerBlock("1", i * 10, i * 10 + 9) for i in range(5)]
    assert process_partition() == (1, 0)
    assert partition_blocks(blocks) == blocks
    with pytest.raises(ValueError, match="outside"):
        partition_blocks(blocks, 2, 2)


@pytest.fixture(scope="module")
def sim_dataset(tmp_path_factory):
    """The dataset of tests/test_parallel.py (seed 17, n = 2500, m = 96, two
    traits), blocked by the port at 32 markers, and its one-partition merge."""
    from cigwas_tpu_torch.cli import main

    tmp = tmp_path_factory.mktemp("torch_parallel")
    rng = np.random.default_rng(17)
    n, m = 2500, 96
    maf = rng.uniform(0.1, 0.5, m)
    G = (rng.random((m, n)) < maf[:, None]).astype(np.float32) + (
        rng.random((m, n)) < maf[:, None]
    )
    y0 = sum(0.4 * std(G[i]) for i in (5, 40, 70)) + rng.normal(size=n)
    y1 = 0.4 * std(G[20]) + 0.5 * y0 + rng.normal(size=n)
    Y = np.stack([y0, y1])
    Y = (Y - Y.mean(1, keepdims=True)) / Y.std(1, keepdims=True)
    stem = str(tmp / "sim")
    write_plink(stem, G, Y)
    main(["prep-bed", stem])
    main(["block", stem, "32", "10", "16", "--device", "cpu"])
    blockfile = stem + "_m32.blocks"
    n_blocks = sum(1 for _ in open(blockfile))
    assert n_blocks >= 3
    out = tmp / "out_1"
    out.mkdir()
    run_all_blocks(stem + ".phen", stem, blockfile, 0.001, 3, 14, 1, str(out),
                   num_partitions=1, partition_index=0, verbose=False, device="cpu")
    flat = _block_hashes(out)
    assert sum(f.endswith(".sep") for f in flat) >= 2, sorted(flat)
    return tmp, stem, blockfile, n_blocks, _merged(blockfile, out), flat


def _merged(blockfile, outdir) -> dict:
    from cigwas_tpu_torch.merge import merge_block_outputs

    stem = str(outdir / "merged_blocks")
    merge_block_outputs(blockfile, str(outdir)).write_mm(stem)
    return {s: hashlib.md5(open(stem + s, "rb").read()).hexdigest() for s in MERGED}


def _block_hashes(outdir) -> dict:
    return {f: hashlib.md5(open(os.path.join(outdir, f), "rb").read()).hexdigest()
            for f in sorted(os.listdir(outdir)) if not f.startswith("merged_blocks")}


@pytest.mark.parametrize("num_partitions", [2, 3])
def test_multi_partition_run_matches_single_partition(sim_dataset, num_partitions):
    """`run_all_blocks` split over 2 and 3 partitions covers every block once
    and merges to the one-partition run's bytes."""
    tmp, stem, blockfile, n_blocks, ref, _ = sim_dataset
    out = tmp / f"out_p{num_partitions}"
    out.mkdir()
    covered = []
    for pi in range(num_partitions):
        covered += run_all_blocks(stem + ".phen", stem, blockfile, 0.001, 3, 14, 1, str(out),
                                  num_partitions=num_partitions, partition_index=pi,
                                  verbose=False, device="cpu")
    assert sorted(covered) == sorted(set(covered)) and len(covered) == n_blocks
    assert _merged(blockfile, out) == ref


def test_two_os_processes_match_single_process(sim_dataset):
    """Two concurrent OS processes (`python -m
    cigwas_tpu_torch.parallel.distributed ... --device cpu`), one per
    partition, write block files that merge to the one-process run's bytes;
    each prints its JSON line."""
    tmp, stem, blockfile, n_blocks, ref, _ = sim_dataset
    out = tmp / "out_2proc"
    out.mkdir()
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "cigwas_tpu_torch.parallel.distributed", stem + ".phen",
             stem, blockfile, "0.001", "3", "14", "1", str(out), "2", str(pi),
             "--device", "cpu"],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=_child_env(), text=True,
        )
        for pi in range(2)
    ]
    covered = []
    for pi, p in enumerate(procs):
        got, err = p.communicate(timeout=300)
        assert p.returncode == 0, err[-2000:]
        line = json.loads(got.strip().splitlines()[-1])
        assert line["partition"] == pi and line["wall_s"] > 0
        covered += list(line["results"])
    assert sorted(covered) == sorted(set(covered)) and len(covered) == n_blocks
    assert _merged(blockfile, out) == ref


_WORLD_CHILD = """
import sys
from cigwas_tpu_torch.parallel import init_distributed, process_partition, run_all_blocks
port, rank, phen, stem, blocks, out = sys.argv[1:]
init_distributed(f"127.0.0.1:{port}", 2, int(rank))
init_distributed()  # idempotent
print("PARTITION", *process_partition())
res = run_all_blocks(phen, stem, blocks, 0.001, 3, 14, 1, out, verbose=False, device="cpu")
print("BLOCKS", *sorted(res))
import torch.distributed as dist
dist.barrier()
dist.destroy_process_group()
"""


def test_init_distributed_two_process_world(sim_dataset):
    """`init_distributed` wires a 2-process gloo world on the CPU: each
    process sees (num_partitions, partition_index) = (2, its rank),
    `run_all_blocks` takes its partition from that by default, and the two
    cover the block list disjointly and merge to the one-process bytes."""
    tmp, stem, blockfile, n_blocks, ref, _ = sim_dataset
    out = tmp / "out_world"
    out.mkdir()
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", _WORLD_CHILD, str(port), str(rank), stem + ".phen", stem,
             blockfile, str(out)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=_child_env(), text=True,
        )
        for rank in range(2)
    ]
    seen, covered = set(), []
    for p in procs:
        got, err = p.communicate(timeout=300)
        assert p.returncode == 0, err[-2000:]
        lines = {ln.split()[0]: ln.split()[1:] for ln in got.splitlines()}
        assert lines["PARTITION"][0] == "2"
        seen.add(int(lines["PARTITION"][1]))
        covered += lines["BLOCKS"]
    assert seen == {0, 1}
    assert sorted(covered) == sorted(set(covered)) and len(covered) == n_blocks
    assert _merged(blockfile, out) == ref


@pytest.mark.parametrize("panel_mode", ["replicated", "rowsharded"])
def test_block_dp_times_panel_tp_byte_identical(sim_dataset, panel_mode):
    """Two partitions, each sharding its blocks over its own 4-entry CPU
    group (`partition_mesh(4, p, device="cpu")`), write the block files of
    the flat one-device run byte for byte."""
    from cigwas_tpu_torch.parallel import partition_mesh

    tmp, stem, blockfile, n_blocks, _, flat = sim_dataset
    out = tmp / f"out_dp_tp_{panel_mode}"
    out.mkdir()
    covered = []
    for pi in range(2):
        mesh = partition_mesh(4, pi, device="cpu")
        assert mesh.axis_names == ("marker",) and mesh.shape == {"marker": 4}
        covered += run_all_blocks(stem + ".phen", stem, blockfile, 0.001, 3, 14, 1, str(out),
                                  num_partitions=2, partition_index=pi, verbose=False,
                                  mesh=mesh, panel_mode=panel_mode)
    assert len(covered) == n_blocks
    assert _block_hashes(out) == flat


def test_partition_mesh_refuses_what_does_not_fit():
    """On cuda a partition's device range must fit the visible cards: here
    there are none, so it raises; it never shrinks."""
    import torch

    from cigwas_tpu_torch.parallel import partition_mesh

    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(ValueError, match="visible"):
        partition_mesh(1, have)


MESH_CASES = {
    "flat": dict(n_devices=8),
    "block2": dict(n_devices=8, block=2),
    "block2-marker2": dict(n_devices=8, block=2, marker=2),
    "first4": dict(n_devices=4, marker=2),
    "sample-given": dict(n_devices=8, block=2, marker=2, sample=2),
}
MESH_ERRORS = {
    "not-divisible": dict(n_devices=8, block=3),
    "bad-sample": dict(n_devices=8, block=2, marker=2, sample=3),
}


@pytest.mark.parametrize("name", sorted(MESH_CASES))
def test_make_mesh_shape_rules_match_jax(name):
    """The same axis names and shapes as the JAX package's make_mesh over 8
    devices (here 8 CPU entries)."""
    import jax

    from cigwas_tpu.parallel import make_mesh as jax_make_mesh

    kw = MESH_CASES[name]
    got = make_mesh(devices=["cpu"] * 8, **kw)
    exp = jax_make_mesh(devices=jax.devices(), **kw)
    assert got.axis_names == exp.axis_names
    assert got.shape == dict(exp.shape)
    assert got.devices.shape == exp.devices.shape


@pytest.mark.parametrize("name", sorted(MESH_ERRORS))
def test_make_mesh_errors_match_jax(name):
    """The same errors, with the same messages, as the JAX package's."""
    import jax

    from cigwas_tpu.parallel import make_mesh as jax_make_mesh

    kw = MESH_ERRORS[name]
    with pytest.raises(ValueError) as jax_err:
        jax_make_mesh(devices=jax.devices(), **kw)
    with pytest.raises(ValueError) as err:
        make_mesh(devices=["cpu"] * 8, **kw)
    assert str(err.value) == str(jax_err.value)


def test_make_mesh_never_shrinks():
    """More devices than given, or cards than visible, raise; the CPU needs
    a count."""
    with pytest.raises(ValueError, match="asked for"):
        make_mesh(9, devices=["cpu"] * 8)
    with pytest.raises(ValueError, match="explicit"):
        make_mesh(device="cpu")
    assert make_mesh(3, device="cpu").shape == {"block": 1, "marker": 1, "sample": 3}
    with pytest.raises((RuntimeError, ValueError)):
        make_mesh(64, device="cuda")
