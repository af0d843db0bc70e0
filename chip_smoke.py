"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing one JSON line with its wall time; any failure raises
and the script exits non-zero:

1. environment: versions, the card's name and power limit (nvidia-smi);
   fails without a CUDA device;
2. build: compiles the three CUDA sources under ``cigwas_tpu_torch/csrc`` in
   parallel and prints ptxas' registers and spills per kernel; then reads
   each sweep kernel's inner loop out of ``cuobjdump -sass`` (instructions
   per test, for ``issue_ms``);
3. kernels, each against its plain PyTorch version on the card, on seeded
   8192-variable panels with NaNs, LD-clustered and scattered neighbour
   lists, ragged degrees (one node with level + 1 neighbours, one with
   level: no test) on both sides of every route's shared-memory limit, and
   on panels of repeated variables, whose tied minima must resolve to the
   lowest colex rank:
   the levels 1-3 sweep (``local_sweep``; rho and positions bit-identical),
   the one- and two-panel gathers (``panel_gather``; int32 views equal, with
   the lists staged and read through the cache), with the main paths'
   8-node launches and bucket-sized launches (2048 nodes at widths 128, 48
   and 50) timed beside their bound, the sectors their lists address, the
   indexing call and an empty kernel's launch;
   the hetcor levels 1-3 sweep (``hetcor_sweep``; margins bit-identical,
   both ``ess_mode``s, a time index), with one launch the size of a
   level-2 and level-3 bucket (1024 nodes x width 48) timed beside its
   bound and beside the one-thread-per-slot route it replaced;
4. the ``cusk`` slice: a small block on the card and on the CPU (plain
   versions) must write the same decisions, with every kernel launch of the
   card's run held bitwise to its plain version; then the reference's default
   block (11,000 markers x 16,384 individuals x 8 traits, AR(1) LD, planted
   marker->trait effects) on the card with the kernel launches counted, and
   its largest launch per kernel re-run through the plain version;
5. the ``cuskss`` slice: the fixture inputs on the card and on the CPU must
   write the same files (every launch checked likewise); then a 10,000-marker x 8-trait summary-statistic
   input (AR(1) mxm as a binary triangle, planted mxp effects, SE files for
   a per-entry ESS in [3e5, 5e5]) through ``cuskss`` on the card, both
   stages, with the launches counted and the largest launch per kernel
   re-run through the plain version;
6. a second, warm run of each slice under torch.profiler for the device
   time by kernel, the idle share, and ``total_ms``: the device time of all
   launches of each sweep level on its slice;
7. the shell entry points, each through ``cigwas_tpu_torch.cli.main``:
   ``prep-bed``, ``block``, ``cusk-all``, ``merge-block-outputs``,
   ``sepselect``, ``orient-v-structs``, ``srfci``, ``mvivw`` and ``mvivw
   -s`` over a small fileset (600 markers on 3 chromosomes x 2,000
   individuals, one planted trait edge) with ``--device cuda`` and with
   ``--device cpu``, which must leave the same ``.blocks`` bytes, block
   decision files, merged files, PAG and IV candidates (correlations within
   1e-6, the MVIVW tables' effects and p within 1e-5), every kernel launch
   checked; then the first five over one
   chromosome of 50,000 markers x 16,384 individuals x 8 traits with the
   CLI's defaults (the streaming route of ``block``, every block through
   ``cusk-all``), with each command's wall, the blocks, the int8 products'
   device time beside their bound, per-block walls and device memory, the
   launches of every kernel over the whole path, the files' sha256, and how
   many of the 40 planted markers are adjacent to their trait. With the
   planted markers uniform over the chromosome, as the generator gives
   them, no trait has the five marker neighbours that take stage 2 to level
   4, so ``cusk-all``, ``merge-block-outputs`` and ``sepselect`` then run
   again over the same blocks with a phenotype file whose planted markers
   share a locus per trait (a coverage input, shaped to reach the gather):
   that run's launches are counted apart, and the largest launch of each
   kernel on it is held bitwise to its plain version and timed beside its
   bound, as on the older slices;
8. the genome: four such chromosomes (200,000 markers, an 819.2 MB
   ``.bed``) x 16,384 individuals x 8 traits with a planted trait DAG, made
   and packed on the card from a seeded ``torch.Generator``, through all
   nine commands with the CLI's defaults and then ``estimate_ace``,
   ``check_ivs`` and ``run_mvivw_filtered`` through the Python API: walls
   per command and per block, device memory per block, launches, planted
   markers and trait edges recovered, the PAG's trait marks, each planted
   edge's MVIVW effect and p (positive and below 1e-3, or the run fails) and
   ACE, the files' sha256; then ``cusk-all`` again under torch.profiler for
   the device's idle share.

Both older slices print the sha256 of their decision files beside those of
the commit before the gather's redesign, so two versions of the kernels can
be held to the same decisions.

Every kernel's line gives its time beside ``bound_ms``, the least time the
card could take for the same work: the larger of the bytes the function must
move (every distinct panel entry that the launch's lists address read once,
however many nodes share it; the lists read once; outputs written once) over
3.35 TB/s and its float32 operations over 67 TFLOP/s (NVIDIA's H100 SXM data
sheet). ``max_abs_err`` is the NaN-aware largest |kernel - plain| measured on
that launch. The sweeps also carry ``issue_ms``, a second yardstick that an
IEEE sqrt and division can be held to: tests x SASS instructions of the
inner loop per test over 132 SMs x 128 lanes x the maximum SM clock. The
gathers carry ``sector_ms`` (the distinct 32-byte sectors their lists
address, since a 4-byte read moves a sector, plus lists and outputs, over
3.35 TB/s), ``launch_floor_ms`` (an empty kernel timed the same way) and
``device_ms`` (the kernel's own time from the profiler's records, with how
many of the timed launches it kept a record of). The kernels of the
chromosome's path carry its launches (``launches_chr50k``, and
``launches_chr50k_uniform`` for the uniform phenotypes) and, under
``chr50k``, the same measurements on its largest launch; they and the
one-panel gather also carry the genome's (``launches_genome``, 0 allowed for
the gather).

``--kernels-only`` stops after phase 3.

The last lines are the kernel summary (JSON), the ``nvidia-smi`` name and
power limit, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import io
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
from scipy.io import mmread

from cigwas_tpu_torch import require_cuda
from cigwas_tpu_torch.cli import main as cli_main
from cigwas_tpu_torch.constants import BED_PREFIX_COL_MAJ
from cigwas_tpu_torch.io import (
    MarkerBlock,
    ReducedGC,
    ReducedGCS,
    read_blocks_from_file,
    write_marker_blocks_to_file,
)
from cigwas_tpu_torch.io.bed import encode_bed_values
from cigwas_tpu_torch.ops import pcorr
from cigwas_tpu_torch.ops.corr import PANEL_ROW_TILE as ROW_TILE
from cigwas_tpu_torch.ops.kernels import build
from cigwas_tpu_torch.ops.kernels import hetcor_sweep as hs
from cigwas_tpu_torch.ops.kernels import local_sweep as ls
from cigwas_tpu_torch.ops.kernels import panel_gather as pg
from cigwas_tpu_torch.merge import check_ivs, merge_block_outputs
from cigwas_tpu_torch.mr import run_mvivw_filtered
from cigwas_tpu_torch.pag.davs import estimate_ace
from cigwas_tpu_torch.pipelines import CuskssArgs, cusk, cuskss, make_blocks
from cigwas_tpu_torch.prep import prep_bed
from cigwas_tpu_torch.skeleton import cupc
from cigwas_tpu_torch.utils.stats import fisher_z, hetcor_threshold, threshold_array

# file:line of the function that reaches pl.pallas_call, per kernel
PALLAS = "cigwas_tpu/ops/pallas/panel_gather.py"
REPLACES = {"local_sweep": f"{PALLAS}:671", "panel_gather": f"{PALLAS}:138",
            "panel_gather2": f"{PALLAS}:615", "hetcor_sweep": f"{PALLAS}:615"}
# the reference's default block and CLI parameters
M11K, N11K, P11K = 11000, 16384, 8
ALPHA, MAX_LEVEL, MAX_LEVEL_TWO, DEPTH = 1e-4, 3, 14, 1
# the summary-statistic input (the configuration of bench.py's cuskss phase)
MSS, PSS, NSS = 10000, 8, 5.0e5
FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "data",
                        "test_files")
# the chromosome of the shell entry points: `block`'s defaults (`cli.py`)
MCHR, MAX_BLOCK, CORR_WIDTH = 50000, 11000, 2000
# markers within which a trait's five planted markers lie in that chromosome's
# coverage phenotypes (`sim_locus.phen`)
LOCUS = 3000
# NVIDIA H100 SXM data sheet: HBM3 bytes/s, float32 FLOP/s outside the tensor
# cores, dense int8 operations/s in them
PEAK_BYTES, PEAK_F32, PEAK_INT8, SMS = 3.35e12, 67e12, 1979e12, 132
# sha256 of the two older slices' decision files at the commit before the
# gather's redesign (NVIDIA H100 80GB HBM3, 700.00 W), printed beside this run's
PARENT_SHA256 = {
    "cusk": {".adj": "0410412a33cf945cf2085f27ef12932869a5bc06e543b27ae07883b146ee4086",
             ".ixs": "bd4c8da12abf1ca6c689b4dd11c644879b526286c3cd4b4cc4bc191909a8e407",
             ".mdim": "e5e89faa00a9fa70b58ecb32b13b7a24ce8c24894af0f17d4d184f4ec53714de",
             ".sep": "7e6802f0c0b69bf3335c367a034bbc080c2f7eb4f9ead6284d983d6815d42021"},
    "cuskss": {".adj": "dd8726c43ce6c5a1eda98c9f5ecf5c64be0ac670db861a4fbf02bca59c8b0ed6",
               ".ixs": "ae50a24e2dd5ea43fa670fa68b3797d26f8889bb6de3e380a01abf85bef7bd3a",
               ".mdim": "780b845574304e5b44ffde556510b7a81ddba11354bb7d315a9ed20dbe547ab2"},
}
# float32 operations per test, read off the kernels' inner loops (a sqrt, a
# division and a tanh count as one each): the rho recursion and the compare
# for local_sweep; plus validity and time checks, the ESS sums and counts
# (four per term), the threshold (six) and the margin for hetcor_sweep
SWEEP_OPS = {1: 12, 2: 15, 3: 19}
HETCOR_OPS = {1: 29, 2: 49, 3: 69}


def emit(phase: str, t0: float, **kw) -> None:
    print(json.dumps({"phase": phase, "wall_s": time.perf_counter() - t0, **kw}), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def ptxas_summary(log: str) -> list:
    """[{kernel, registers, spill_stores, spill_loads}] from nvcc -Xptxas=-v."""
    out = []
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = re.search(r"\d((?:h?sweep|panel)\w*?_kernel(?:I(?:L[ib]\d+E)+)?)", m.group(1))
            out.append({"kernel": name.group(1) if name else m.group(1)})
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and out:
            out[-1].update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and out:
            out[-1]["registers"] = int(m.group(1))
    return out


def sass_of(lib) -> str:
    """The machine code of a built library, as `cuobjdump -sass` prints it
    (the CUDA toolkit's tool, beside nvcc)."""
    tool = os.path.join(os.path.dirname(build.nvcc()), "cuobjdump")
    return subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout


_SASS_INSTR = re.compile(r"^\s+/\*([0-9a-f]{4,})\*/\s+(.*?);")
_SASS_BRANCH = re.compile(r"\bBRA\s+(?:\w+,\s*)?0x([0-9a-f]+)")


def sass_functions(text: str) -> dict:
    """{mangled kernel name: [(address, instruction), ...]} of a SASS dump."""
    out: dict = {}
    cur = None
    for line in text.splitlines():
        if "Function :" in line:
            cur = out.setdefault(line.split("Function :")[1].strip(), [])
        elif cur is not None:
            m = _SASS_INSTR.match(line)
            if m:
                cur.append((int(m.group(1), 16), m.group(2).strip()))
    return out


def test_loop(instrs: list, load_op: str) -> dict:
    """The loop over the conditioning sets of one kernel, found in its SASS:
    the innermost loop (a backward branch with no other inside it) that takes
    square roots (MUFU.RSQ) and stores, synchronises and reduces nothing;
    where the compiler made several copies, the one with the most roots.
    Every test makes exactly one load of kind load_op (its panel entry from
    global memory at level 1, its 128-bit table entry at levels 2-3), which
    counts the tests of one pass. Returns the static count of instructions
    in the loop's body (the rarely taken fallbacks for operands outside the
    fast paths of sqrt and division included) and the instructions per
    test."""
    loops = []
    for addr, text in instrs:
        m = _SASS_BRANCH.search(text)
        if m and int(m.group(1), 16) <= addr:
            loops.append((int(m.group(1), 16), addr))
    best = None
    for lo, hi in loops:
        if any(lo <= a and b <= hi and (a, b) != (lo, hi) for a, b in loops):
            continue
        body = [t for a, t in instrs if lo <= a <= hi]
        ops = [re.sub(r"^@!?U?P\d+\s+", "", t).split()[0] for t in body]
        roots = sum(o.startswith("MUFU.RSQ") for o in ops)
        if roots and not any(o.startswith(("STS", "STG", "ST.", "BAR", "ATOM", "RED"))
                             for o in ops) and (best is None or roots > best["roots"]):
            tests = sum(o.startswith(load_op) for o in ops)
            assert tests > 0, f"no {load_op} in the loop at {lo:#x}"
            best = {"roots": roots, "loop_instructions": len(body), "loop": f"{lo:#x}-{hi:#x}",
                    "tests_per_pass": tests, "instructions_per_test": len(body) / tests}
    assert best is not None, "no test loop found in the SASS"
    return best


def inner_loops(libs: dict) -> dict:
    """{(kernel, level): test_loop} of the kernels the main-path widths run:
    the level-1 direct kernels and the level 2-3 table kernels."""
    out = {}
    for kernel, prefix in (("local_sweep", "sweep"), ("hetcor_sweep", "hsweep")):
        fns = sass_functions(sass_of(libs[kernel]))
        for l in (1, 2, 3):
            want = f"{prefix}1_direct_kernelE" if l == 1 else f"{prefix}_table_kernelILi{l}E"
            (name,) = [n for n in fns if re.search(rf"\d{want}", n)]
            out[(kernel, l)] = {"function": name,
                                **test_loop(fns[name], "LDG" if l == 1 else "LDS.128")}
    return out


def sm_clock_hz() -> float:
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    return float(out.stdout.split()[0]) * 1e6


def issue_bound(tests: int, loop: dict, clock_hz: float) -> dict:
    """The second yardstick: the time to issue the inner loop's instructions
    for every test at one instruction per lane and cycle on 132 SMs x 128
    lanes, at the card's maximum SM clock."""
    return {"issue_ms": tests * loop["instructions_per_test"] / (SMS * 128 * clock_hz) * 1e3,
            "instructions_per_test": loop["instructions_per_test"],
            "loop_instructions": loop["loop_instructions"],
            "tests_per_pass": loop["tests_per_pass"], "sm_clock_mhz": clock_hz / 1e6}


def level_totals(totals: dict, prefix: str) -> dict:
    """{level: (device ms of all launches, launches)} of the sweep kernels
    named <prefix>1_direct_kernel, <prefix>_table_kernel<L> and
    <prefix>_rows_kernel<L, ..> in a profiled run."""
    out = {1: [0.0, 0], 2: [0.0, 0], 3: [0.0, 0]}
    for key, v in totals.items():
        m = re.search(r"::(\w+_kernel)(?:<(\d))?", key)
        if not m:
            continue
        if m.group(1) == f"{prefix}1_direct_kernel":
            l = 1
        elif m.group(1) in (f"{prefix}_table_kernel", f"{prefix}_rows_kernel"):
            l = int(m.group(2))
        else:
            continue
        out[l][0] += v["total_ms"]
        out[l][1] += v["launches"]
    return out


def cuda_ms(fn, reps: int) -> float:
    """Mean device milliseconds of fn() over reps runs, after one warm-up."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def kernel_device_ms(fn, reps: int, pattern: str) -> dict:
    """Mean device milliseconds of the kernels whose name matches pattern
    over reps runs of fn(), from torch.profiler's kernel records: the time
    on the card alone, where `cuda_ms` of a short kernel measures how fast
    the host can enqueue it. `device_records` is how many of the reps
    launches the profiler kept a record of: the mean is over those, and
    device_ms is None where it kept none."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and re.search(pattern, e.key)]
    # the profiler drops some records of launches this close together (2 of 20
    # were seen kept late in a run, and none after the genome's profiled
    # run): the mean is over those it kept
    count = sum(e.count for e in events)
    assert count <= reps, (pattern, [(e.key, e.count) for e in events])
    return {"device_ms": sum(e.self_device_time_total for e in events) / 1e3 / count
            if count else None, "device_records": count, "device_reps": reps}


def bound(n_bytes: float, n_ops: float) -> dict:
    """The least time the card could take: bytes over the memory rate or
    operations over the float32 rate, whichever is larger."""
    b_ms, o_ms = n_bytes / PEAK_BYTES * 1e3, n_ops / PEAK_F32 * 1e3
    return {"bound_ms": max(b_ms, o_ms), "bound_by": "bytes" if b_ms >= o_ms else "operations",
            "bytes": n_bytes, "operations": n_ops}


def addressed(node_ixs, nbrs, deg, vp: int, pads_read_node: bool) -> tuple[int, int, int]:
    """What a launch's lists address in a (vp, vp) panel, counted on the card:
    the distinct (row, col) entries among every node's (nb_j, nb_k) and
    (x, nb_k), the distinct variables, and the distinct 32-byte sectors
    (runs of 8 entries from the panel's start) that hold those entries. An
    entry, variable or sector that many nodes share (overlapping LD
    neighbourhoods) counts once. Slots j >= deg are left out (the sweeps
    never read them) or read as the node itself (the gathers)."""
    dev = nbrs.device
    nt, d = nbrs.shape
    entry = torch.zeros(vp * vp, dtype=torch.bool, device=dev)
    var = torch.zeros(vp, dtype=torch.bool, device=dev)
    slot = torch.arange(d, device=dev)[None, :]
    step = max(1, (1 << 25) // (d * d))
    for i in range(0, nt, step):
        x = node_ixs[i : i + step].long()[:, None]
        nb = nbrs[i : i + step].long()
        live = slot < deg[i : i + step, None]
        if pads_read_node:
            nb, live = torch.where(live, nb, x), torch.ones_like(live)
        pair = live[:, :, None] & live[:, None, :]
        entry[(nb[:, :, None] * vp + nb[:, None, :])[pair]] = True
        entry[(x * vp + nb)[live]] = True
        var[nb[live]] = True
        var[x[:, 0]] = True
    whole = entry.numel() // 8 * 8
    sectors = int(entry[:whole].view(-1, 8).any(1).sum()) + int(entry[whole:].any())
    return int(entry.sum()), int(var.sum()), sectors


def sweep_bound(node_ixs, nbrs, deg, vp: int, l: int, panels: int, ops: dict) -> dict:
    """Bound of a levels 1-3 launch from its real lists: every slot y of a
    node meets each conditioning set of its other deg - 1 neighbours once;
    the distinct panel entries the lists address are read once from each
    panel (and, for hetcor, the time index of each distinct variable), the
    index lists once, the (nt, d) outputs written once."""
    dg = deg.cpu().numpy().astype(np.int64)
    nt, d = nbrs.shape
    tests = int(sum(int(g) * math.comb(int(g) - 1, l) for g in dg))
    entries, variables, _ = addressed(node_ixs, nbrs, deg, vp, pads_read_node=False)
    n_in = 4 * panels * entries + 4 * (nt * d + 2 * nt) + (4 * variables if panels == 2 else 0)
    n_out = 4 * nt * d * ((1 + l) if panels == 1 else 1)
    return {**bound(n_in + n_out, tests * ops[l]), "tests": tests, "distinct_entries": entries}


def gather_bound(node_ixs, nbrs, deg, vp: int, panels: int) -> dict:
    """Bound of a gather launch: nothing but bytes, the distinct panel
    entries the lists address read once from each panel, the index lists
    once, and (d^2 + d) entries per node and panel written once. sector_ms
    counts 32 bytes for every distinct sector instead of 4 for every entry:
    what the memory system moves for scattered 4-byte reads."""
    nt, d = nbrs.shape
    entries, _, sectors = addressed(node_ixs, nbrs, deg, vp, pads_read_node=True)
    rest = 4 * panels * nt * (d * d + d) + 4 * (nt * d + 2 * nt)
    return {**bound(4 * panels * entries + rest, 0), "distinct_entries": entries,
            "distinct_sectors": sectors,
            "sector_ms": (32 * panels * sectors + rest) / PEAK_BYTES * 1e3}


def max_abs_diff(a: torch.Tensor, b: torch.Tensor) -> float:
    """NaN-aware largest |a - b|: elements with equal bits or equal values
    count 0 (a NaN against the same NaN, a sentinel against itself), a NaN
    against anything else counts inf."""
    if a.numel() == 0:
        return 0.0
    same = (a.view(torch.int32) == b.view(torch.int32)) | (a == b)
    diff = torch.where(same, torch.zeros_like(a), (a - b).abs())
    return float(torch.nan_to_num(diff, nan=math.inf, posinf=math.inf).max())


def compare(tag: str, rho_k, pos_k, rho_p, pos_p, deg, rho_th: float) -> float:
    """Require bit-identical rho and identical positions; returns the
    measured max |rho_k - rho_p|."""
    if torch.equal(rho_k, rho_p) and torch.equal(pos_k, pos_p):
        return max_abs_diff(rho_k, rho_p)
    diff = (rho_k != rho_p) | (pos_k != pos_p).any(-1)
    i, j = (int(v) for v in torch.nonzero(diff)[0])
    rk, rp = float(rho_k[i, j]), float(rho_p[i, j])
    raise AssertionError(
        f"{tag}: kernel != plain at node {i} slot {j} (deg {int(deg[i])}): "
        f"rho {rk!r} vs {rp!r}, pos {pos_k[i, j].tolist()} vs {pos_p[i, j].tolist()}, "
        f"margins to tanh(th) {rk - rho_th:.3e} / {rp - rho_th:.3e}"
    )


def compare_bits(tag: str, got, exp) -> float:
    """Require equal int32 views of every tensor (NaN payloads included);
    returns the measured max |got - exp| over all of them."""
    for i, (g, e) in enumerate(zip(got, exp)):
        if g.shape != e.shape or not torch.equal(g.view(torch.int32), e.view(torch.int32)):
            raise AssertionError(f"{tag}: output {i} differs from the plain gather")
    return max(max_abs_diff(g, e) for g, e in zip(got, exp))


def compare_margin(tag: str, m_k, m_p) -> tuple[int, float]:
    """Require bit-identical margins (and so identical hit bits, margin < 0);
    returns the number compared and the measured max |m_k - m_p|."""
    same = m_k.view(torch.int32) == m_p.view(torch.int32)
    if m_k.shape != m_p.shape or not bool(same.all()):
        i, j = (int(v) for v in torch.nonzero(~same)[0])
        raise AssertionError(
            f"{tag}: kernel != plain margin at node {i} slot {j}: {float(m_k[i, j])!r} vs "
            f"{float(m_p[i, j])!r}; {int((~same).sum())} of {same.numel()} differ, "
            f"{int(((m_k < 0) != (m_p < 0)).sum())} hit bits among them"
        )
    return same.numel(), max_abs_diff(m_k, m_p)


def check_panels():
    """The 8192-variable panels of the kernel checks: a symmetric C with 1%
    NaNs, a matched per-pair ESS with 15% NaNs, a time index in {0, 1, 2}."""
    rng = np.random.default_rng(0)
    vp = 8192
    C = (0.3 * rng.standard_normal((vp, vp), dtype=np.float32))
    C = (C + C.T) * np.float32(0.5)
    C[rng.random((vp, vp), dtype=np.float32) < 0.01] = np.nan
    np.fill_diagonal(C, 1.0)
    N = rng.uniform(3e3, 1.2e4, (vp, vp)).astype(np.float32)
    N = (N + N.T) * np.float32(0.5)
    hole = np.triu(rng.random((vp, vp), dtype=np.float32) < 0.15, 1)
    N[hole | hole.T] = np.nan
    t_ix = rng.integers(0, 3, vp).astype(np.int32)
    return (rng, vp, torch.from_numpy(C).cuda(), torch.from_numpy(N).cuda(),
            torch.from_numpy(t_ix).cuda())


def neighbour_lists(rng, vp: int, nt: int, d: int, clustered: bool, distinct: bool = True,
                    level: int | None = None, lo: int | None = None):
    """Ragged ascending neighbour lists on the card: clustered in a window of
    2d + 1 variables around the node, or scattered over the panel. Degrees
    are uniform in [lo, d] (lo = d // 2 unless given), the first node's is d;
    with a level, the second node has level + 1 neighbours (one set per slot)
    and the third has level (no test: every slot returns the sentinel)."""
    node_ixs = rng.choice(vp, nt, replace=False).astype(np.int32)
    deg = rng.integers(max(1, d // 2) if lo is None else lo, d + 1, nt).astype(np.int32)
    deg[0] = d
    if level is not None and nt >= 3:
        deg[1], deg[2] = min(d, level + 1), min(d, level)
    nbrs = np.zeros((nt, d), np.int32)
    for i, x in enumerate(node_ixs):
        if clustered:
            lo = max(0, min(int(x) - d, vp - 2 * d - 1))
            pool = np.arange(lo, min(vp, lo + 2 * d + 1))
        else:
            pool = np.arange(vp)
        pool = pool[pool != x]
        nbrs[i, : deg[i]] = np.sort(rng.choice(pool, deg[i], replace=not distinct))
    return [torch.from_numpy(a).cuda() for a in (node_ixs, nbrs, deg)]


def tied_panels(Cd, Nd, td):
    """1024-variable panels in which every variable stands four times
    (variable i is variable i // 4 of the source panels): conditioning sets
    that differ only in which copy they hold give bitwise equal statistics,
    so a minimum is attained by several sets at once and the one of lowest
    colex rank has to win."""
    ix = torch.arange(1024, device=Cd.device) // 4
    return Cd[ix][:, ix].contiguous(), Nd[ix][:, ix].contiguous(), td[ix].contiguous()


def scratch_plan(module, d: int) -> dict:
    """The plan of the route that keeps its per-slot rows in global scratch,
    forced at a width the card can hold against the plain version (the
    wrappers' own plans reach it only past d = 19370 / 10777 at level 1)."""
    threads, per_node = ls.split_slots(d)
    return {"route": ls.ROUTE_ROWS_SCRATCH, "threads": threads, "nodes_per_cta": 1,
            "ctas_per_node": per_node, "smem_bytes": 0,
            "scratch_floats_per_node": per_node * module.WORK_ROWS * d}


def rows_plan(module, l: int, d: int, panels: int) -> dict:
    """The plan of the one-thread-per-slot route with the panel(s) staged in
    shared memory, forced at a width whose own plan is the table route: the
    design the table route replaced, timed beside it."""
    threads, per_node = ls.split_slots(d)
    return {"route": ls.ROUTE_ROWS_STAGED, "threads": threads, "nodes_per_cta": 1,
            "ctas_per_node": per_node,
            "smem_bytes": 4 * (module.WORK_ROWS * d + panels * d * (d + 1)),
            "scratch_floats_per_node": 0}


def phase_kernels(rho_th: dict, panels) -> None:
    """local_sweep vs plain, levels 1-3, clustered and scattered lists, ragged
    degrees with a node of level + 1 and a node of level neighbours, at d in
    {8, 40, 64, 112, 120, 136, 144, 232, 240, 256, 300}: both sides of the
    table route's limits (d = 138 at level 2, 119 at level 3) and of the
    staged panel's (d = 236); level-1 nodes of width 6600 (52 CTAs a node),
    the same through the global-scratch route; and panels of repeated
    variables, where tied minima must resolve to the lowest colex rank."""
    t0 = time.perf_counter()
    rng, vp, Cd, Nd, td = panels
    cases = [(d, l, None) for d in (8, 40, 64, 112, 120, 136, 144, 232, 240, 256, 300)
             for l in (1, 2, 3)]
    cases += [(6600, 1, None), (6600, 1, scratch_plan(ls, 6600))]
    n_cmp, max_err, routes = 0, 0.0, set()
    for clustered in (True, False):
        for d, l, forced in cases:
            if clustered and 2 * d + 1 > vp:
                continue
            args = neighbour_lists(rng, vp, 2 if d > 1000 else (3 if d > 144 else 6), d,
                                   clustered, level=l)
            rho_k, pos_k = ls.local_sweep(Cd, *args, l, launch_plan=forced)
            rho_p, pos_p = pcorr.local_sweep_plain(Cd, *args, l)
            torch.cuda.synchronize()
            tag = f"{'clustered' if clustered else 'scattered'} d={d} l={l}"
            max_err = max(max_err, compare(tag, rho_k, pos_k, rho_p, pos_p, args[2], rho_th[l]))
            routes.add((l, (forced or ls.plan(l, d))["route"]))
            n_cmp += 1
    Ct = tied_panels(Cd, Nd, td)[0]
    n_tied = 0
    for d, l in [(d, l) for d in (8, 24, 48) for l in (1, 2, 3)] + [(144, 2), (120, 3)]:
        args = neighbour_lists(rng, 1024, 6, d, False, level=l)
        rho_k, pos_k = ls.local_sweep(Ct, *args, l)
        rho_p, pos_p = pcorr.local_sweep_plain(Ct, *args, l)
        max_err = max(max_err, compare(f"ties d={d} l={l}", rho_k, pos_k, rho_p, pos_p,
                                       args[2], rho_th[l]))
        n_tied += int((rho_p < pcorr.RHO_BIG).sum())
        n_cmp += 1
    assert n_tied > 0, "the panels of repeated variables gave no valid test"
    emit("kernels_local_sweep", t0, cases=n_cmp, bit_identical=True, max_abs_err=max_err,
         routes=sorted(routes), tied_slots=n_tied)


def launch_floor_ms() -> float:
    """Device milliseconds between launches of a kernel that does nothing,
    timed as every kernel here is: what a launch alone costs."""
    return cuda_ms(pg.launch_empty, reps=200)


def gather_timing(tag: str, panels_d: tuple, args: list, vp: int, reps: int) -> dict:
    """One gather launch, bit-identical to the plain version, timed as the
    skeleton launches it, beside the bound, the sectors and the
    advanced-indexing call that computes the same panels. `ms` is by CUDA
    events around the calls, so for a launch shorter than the wrapper's host
    work it is the enqueue rate; `device_ms` is the kernel's own time from
    the profiler's records."""
    two = len(panels_d) == 2
    kern = pg.gather_local_panels2 if two else pg.gather_local_panels
    plain = pg.gather_local_panels2_plain if two else pg.gather_local_panels_plain
    node_ixs, nbrs, deg = args
    nt, d = nbrs.shape
    err = compare_bits(tag, kern(*panels_d, *args), plain(*panels_d, *args))
    nb = pg.remap_pad_slots(*args).long()
    x = node_ixs.long()[:, None]
    run = lambda: kern(*panels_d, *args, index_range_checked=True)  # noqa: E731
    return {
        "nodes": int(nt), "width": int(d), "panels": len(panels_d), "max_abs_err": err,
        "plan": pg.plan(d, len(panels_d)), **gather_bound(*args, vp, len(panels_d)),
        "ms": cuda_ms(run, reps), **kernel_device_ms(run, 20, "panel_rows_kernel"),
        "library_ms": cuda_ms(
            lambda: [(P[nb[:, :, None], nb[:, None, :]], P[x, nb]) for P in panels_d], reps),
    }


def phase_gather_kernel(panels) -> None:
    """panel_gather vs plain, one and two panels, at d in {1, 3, 8, 40, 50,
    136, 256, 300, 1000}, clustered and scattered, ragged degrees, in the
    row design and the same with its lists read through the cache; one node
    of width 13000 with repeated neighbours
    (a 52 KB list: shared memory by opt-in, and through the cache). Then the
    timed launches: the main paths' 8 x 8 one-panel and 8 x 16 two-panel
    launches and bucket-sized two-panel launches of 2048 nodes at widths
    128, 48 and 50 (d % 4 != 0: scalar stores)."""
    t0 = time.perf_counter()
    rng, vp, Cd, Nd, _ = panels
    n_cmp, max_err = 0, 0.0

    def unstaged(d, n_panels):
        return {**pg.plan(d, n_panels), "staged": 0, "smem_bytes": 0}

    for clustered in (True, False):
        for d in (1, 3, 8, 40, 50, 136, 256, 300, 1000):
            args = neighbour_lists(rng, vp, 3 if d >= 1000 else 6, d, clustered)
            tag = f"{'clustered' if clustered else 'scattered'} d={d}"
            one, two = (pg.gather_local_panels_plain(Cd, *args),
                        pg.gather_local_panels2_plain(Cd, Nd, *args))
            for name, plan1, plan2 in (("rows", None, None),
                                       ("unstaged", unstaged(d, 1), unstaged(d, 2))):
                max_err = max(
                    max_err,
                    compare_bits(f"{tag} one panel {name}",
                                 pg.gather_local_panels(Cd, *args, launch_plan=plan1), one),
                    compare_bits(f"{tag} two panels {name}",
                                 pg.gather_local_panels2(Cd, Nd, *args, launch_plan=plan2), two))
                torch.cuda.synchronize()
                n_cmp += 2
    args = neighbour_lists(rng, vp, 1, 13000, False, distinct=False)
    expect = pg.gather_local_panels_plain(Cd, *args)
    for name, forced in (("rows", None), ("unstaged", unstaged(13000, 1))):
        max_err = max(max_err, compare_bits(
            f"scattered d=13000 {name}", pg.gather_local_panels(Cd, *args, launch_plan=forced),
            expect))
        torch.cuda.synchronize()
        n_cmp += 1
    del expect
    timed = [
        gather_timing("8 x 8 one panel", (Cd,), neighbour_lists(rng, vp, 8, 8, True), vp, 200),
        gather_timing("8 x 16 two panels", (Cd, Nd), neighbour_lists(rng, vp, 8, 16, True),
                      vp, 200),
    ]
    # beyond the main paths' few-node tiles: launches the size of a bucket
    for d in (128, 48, 50):
        timed.append(gather_timing(f"2048 x {d} two panels", (Cd, Nd),
                                   neighbour_lists(rng, vp, 2048, d, True), vp, 20))
    emit("kernels_panel_gather", t0, cases=n_cmp + len(timed), bit_identical=True,
         max_abs_err=max_err, launch_floor_ms=launch_floor_ms(), timed=timed)


def phase_hetcor_kernel(panels) -> list:
    """hetcor_sweep vs plain, levels 1-3, clustered and scattered lists,
    ragged degrees with a node of level + 1 and a node of level neighbours,
    ESS with 15% NaNs as it is ("float") and truncated ("reference"), time
    indices in {0, 1, 2}, at d in {8, 40, 64, 104, 112, 120} and {160, 168,
    240, 300}: both sides of the table route's limits (d = 119 at level 2,
    106 at level 3) and of the staged panels' (d = 166); the four widest
    sizes alternate the ESS mode between the clustered and the scattered
    lists. Level-1 nodes of width 4600 (36 CTAs a node), the same through the
    global-scratch route, and panels of repeated variables (tied margins).
    Then one launch the size of a level-2 or level-3 bucket, 1024 nodes x
    width 48 with degrees 24-48, the whole launch against the plain version,
    timed beside its bound and beside the one-thread-per-slot route."""
    t0 = time.perf_counter()
    rng, vp, Cd, Nd, td = panels
    N_mode = {"float": Nd, "reference": pcorr.trunc_ref_ess(Nd)}
    th = hetcor_threshold(ALPHA)
    n_cmp, n_all, n_hits, max_err, routes = 0, 0, 0, 0.0, set()

    def check(tag, C, N, t, args, l, forced=None):
        nonlocal n_cmp, n_all, n_hits, max_err
        m_k = hs.hetcor_local_sweep(C, N, t, *args, th, l, launch_plan=forced)
        m_p = pcorr.hetcor_local_sweep_plain(C, N, t, *args, th, l)
        torch.cuda.synchronize()
        count, err = compare_margin(tag, m_k, m_p)
        n_all, max_err = n_all + count, max(max_err, err)
        n_hits += int((m_k < 0).sum())
        routes.add((l, (forced or hs.plan(l, args[1].shape[1]))["route"]))
        n_cmp += 1

    for clustered in (True, False):
        cases = [(d, l, m, None) for d in (8, 40, 64, 104, 112, 120) for l in (1, 2, 3)
                 for m in ("float", "reference")]
        cases += [(d, l, "float" if clustered else "reference", None)
                  for d in (160, 168, 240, 300) for l in (1, 2, 3)]
        if not clustered:
            cases += [(4600, 1, "float", None), (4600, 1, "float", scratch_plan(hs, 4600))]
        for d, l, mode, forced in cases:
            args = neighbour_lists(rng, vp, 2 if d > 1000 else (3 if d > 120 else 4), d,
                                   clustered, level=l)
            check(f"{'clustered' if clustered else 'scattered'} d={d} l={l} {mode}",
                  Cd, N_mode[mode], td, args, l, forced)
    Ct, Nt, tt = tied_panels(Cd, Nd, td)
    for d, l in [(d, l) for d in (8, 24, 48) for l in (1, 2, 3)]:
        check(f"ties d={d} l={l}", Ct, Nt, tt,
              neighbour_lists(rng, 1024, 6, d, False, level=l), l)
    assert 0 < n_hits < n_all, f"degenerate cases: {n_hits} hits of {n_all} margins"

    bucket = []
    for l in (2, 3):
        args = neighbour_lists(rng, vp, 1024, 48, True, lo=24)
        full = (Cd, Nd, td, *args, th, l)
        count, err = compare_margin(f"bucket-sized l={l}", hs.hetcor_local_sweep(*full),
                                    pcorr.hetcor_local_sweep_plain(*full))
        bucket.append({
            "level": l, "nodes": 1024, "width": 48, "margins_bit_identical": count,
            "max_abs_err": err, **sweep_bound(*args, vp, l, 2, HETCOR_OPS),
            "ms": cuda_ms(lambda: hs.hetcor_local_sweep(
                *full, index_range_checked=True), reps=5),
            "rows_route_ms": cuda_ms(lambda: hs.hetcor_local_sweep(
                *full, index_range_checked=True, launch_plan=rows_plan(hs, l, 48, 2)), reps=5),
        })
    emit("kernels_hetcor_sweep", t0, cases=n_cmp, bit_identical=True, max_abs_err=max_err,
         margins=n_all, hits=n_hits, routes=sorted(routes), bucket_sized=bucket)
    return bucket


def write_block(d: str, G: np.ndarray, Y: np.ndarray) -> tuple[str, str]:
    """PLINK files + prep + a one-block `.blocks` file; returns (stem, blocks)."""
    m, n = G.shape
    stem = os.path.join(d, "sim")
    with open(stem + ".bed", "wb") as f:
        f.write(BED_PREFIX_COL_MAJ)
        f.write(encode_bed_values(G).tobytes())
    with open(stem + ".bim", "w") as f:
        f.writelines(f"1\trs{i}\t0\t{100 * i}\tA\tG\n" for i in range(m))
    with open(stem + ".fam", "w") as f:
        f.writelines(f"F{i} I{i} 0 0 0 -9\n" for i in range(n))
    write_phen(stem + ".phen", Y)
    prep_bed(stem)
    blocks = stem + ".blocks"
    write_marker_blocks_to_file([MarkerBlock("1", 0, m - 1)], blocks)
    return stem, blocks


def ar1_block(m: int, n: int, p: int, seed: int):
    """The 11k generator of bench.py: AR(1) LD (ar 0.92), genotypes from a
    logistic allele frequency, 5 planted markers per trait at effect 0.2."""
    rng = np.random.default_rng(seed)
    noise = rng.normal(size=(m, n)).astype(np.float32)
    ar = 0.92
    prev = np.empty((m, n), dtype=np.float32)
    acc = noise[0]
    prev[0] = acc
    scale = np.sqrt(1 - ar**2)
    for i in range(1, m):
        acc = ar * acc + scale * noise[i]
        prev[i] = acc
    del noise
    pfreq = 1 / (1 + np.exp(-prev * 0.8))
    del prev
    u1 = rng.random((m, n)).astype(np.float32)
    u2 = rng.random((m, n)).astype(np.float32)
    G = (u1 < pfreq).astype(np.float32) + (u2 < pfreq)
    del u1, u2, pfreq
    Y = rng.normal(size=(p, n)).astype(np.float32)
    planted = []
    for t in range(p):
        for k in rng.integers(0, m, 5):
            Y[t] += 0.2 * (G[k] - G[k].mean()) / G[k].std()
            planted.append(int(k))
    Y = (Y - Y.mean(1, keepdims=True)) / Y.std(1, keepdims=True)
    return G, Y, planted


def file_hashes(base: str, exts) -> dict:
    """sha256 of the decision files base + ext: two runs that decide alike
    print the same digests."""
    return {ext: hashlib.sha256(open(base + ext, "rb").read()).hexdigest() for ext in exts}


def hashes_beside_parent(which: str, got: dict) -> dict:
    """This run's digests, the parent's, and whether they are equal."""
    return {"sha256": got, "parent_sha256": PARENT_SHA256[which],
            "sha256_equal_to_parent": got == PARENT_SHA256[which]}


def block_files(outdir: str) -> dict:
    return {f: open(os.path.join(outdir, f), "rb").read() for f in sorted(os.listdir(outdir))}


def assert_same_outputs(tag: str, cuda: dict, cpu: dict) -> float:
    """Decision files byte-identical, .corr within 1e-6; returns the largest
    |difference| of the .corr files. The decision files are held first, so
    that a run that kept other variables says so and not that their
    correlations differ; a .corr beyond the tolerance says where and by how
    much."""
    assert cuda.keys() == cpu.keys() and cpu, (tag, sorted(cuda), sorted(cpu))
    differ = [f for f, data in cpu.items() if not f.endswith(".corr") and cuda[f] != data]
    assert not differ, f"{tag}: {differ} differ between cuda and cpu"
    worst = 0.0
    for f, data in cpu.items():
        if f.endswith(".corr"):
            a, b = np.frombuffer(cuda[f], np.float32), np.frombuffer(data, np.float32)
            assert a.shape == b.shape, f"{tag}: {f} holds {a.size} values on cuda, {b.size} on cpu"
            diff = np.abs(a - b)
            k = int(np.argmax(np.where(np.isnan(diff), np.inf, diff)))
            assert np.allclose(a, b, rtol=0, atol=1e-6), (
                f"{tag}: {f} entry {k} of {a.size}: cuda {float(a[k])!r}, cpu {float(b[k])!r}; "
                f"{int((~(diff <= 1e-6)).sum())} entries beyond 1e-6, "
                f"NaNs {int(np.isnan(a).sum())} / {int(np.isnan(b).sum())}")
            worst = max(worst, float(diff.max()))
    return worst


# the kernel wrappers the skeleton calls through `cupc`
WRAPPED = ("local_sweep", "hetcor_local_sweep", "gather_local_panels",
                  "gather_local_panels2")


class EveryLaunchChecked:
    """While it is open, every levels 1-3 launch and every gather launch the
    skeleton makes on the card is held bitwise against its plain version on
    the same tensors (the small runs are cheap enough for that), so that a
    cuda run that decides otherwise than the cpu run is traced to the launch
    at fault, if one is. `names` narrows the check to those wrappers (the
    genome's gathers)."""

    def __init__(self, names: tuple = WRAPPED):
        self.checked = 0
        self.names = names
        self.saved = {n: getattr(cupc, n) for n in WRAPPED}

    def __enter__(self):
        saved = self.saved

        def local_sweep(C, node_ixs, nbrs, deg, l, **kw):
            rho, pos = saved["local_sweep"](C, node_ixs, nbrs, deg, l, **kw)
            if C.is_cuda:
                rho_p, pos_p = pcorr.local_sweep_plain(C, node_ixs, nbrs, deg, l)
                compare(f"launch {self.checked}: local_sweep l={l} {tuple(nbrs.shape)}",
                        rho, pos, rho_p, pos_p, deg, math.nan)
                self.checked += 1
            return rho, pos

        def hetcor_local_sweep(C, N, t_ix, node_ixs, nbrs, deg, th, l, **kw):
            m = saved["hetcor_local_sweep"](C, N, t_ix, node_ixs, nbrs, deg, th, l, **kw)
            if C.is_cuda:
                compare_margin(f"launch {self.checked}: hetcor_sweep l={l} {tuple(nbrs.shape)}", m,
                               pcorr.hetcor_local_sweep_plain(C, N, t_ix, node_ixs, nbrs, deg, th, l))
                self.checked += 1
            return m

        def gather_local_panels(C, node_ixs, nbrs, deg, **kw):
            out = saved["gather_local_panels"](C, node_ixs, nbrs, deg, **kw)
            if C.is_cuda:
                compare_bits(f"launch {self.checked}: panel_gather {tuple(nbrs.shape)}", out,
                             pg.gather_local_panels_plain(C, node_ixs, nbrs, deg))
                self.checked += 1
            return out

        def gather_local_panels2(C, N, node_ixs, nbrs, deg, **kw):
            out = saved["gather_local_panels2"](C, N, node_ixs, nbrs, deg, **kw)
            if C.is_cuda:
                compare_bits(f"launch {self.checked}: panel_gather2 {tuple(nbrs.shape)}", out,
                             pg.gather_local_panels2_plain(C, N, node_ixs, nbrs, deg))
                self.checked += 1
            return out

        for n, fn in (("local_sweep", local_sweep), ("hetcor_local_sweep", hetcor_local_sweep),
                      ("gather_local_panels", gather_local_panels),
                      ("gather_local_panels2", gather_local_panels2)):
            if n in self.names:
                setattr(cupc, n, fn)
        return self

    def __exit__(self, *exc):
        for n, fn in self.saved.items():
            setattr(cupc, n, fn)


def phase_small_reference(tmp: str) -> None:
    """A 1,500-marker block through cusk on the card and on the CPU (plain
    versions throughout): identical decisions, .corr within 1e-6; every
    kernel launch of the card's run bit-identical to its plain version."""
    t0 = time.perf_counter()
    G, Y, _ = ar1_block(1500, 2000, 3, seed=1)
    small = os.path.join(tmp, "small")
    os.makedirs(small)
    stem, blocks = write_block(small, G, Y)
    outs = {}
    with EveryLaunchChecked() as chk:
        for dev in ("cuda", "cpu"):
            out = os.path.join(tmp, f"small_{dev}")
            os.makedirs(out)
            cusk(stem + ".phen", stem, blocks, ALPHA, MAX_LEVEL, MAX_LEVEL_TWO, DEPTH,
                 out, 0, verbose=False, device=dev)
            outs[dev] = block_files(out)
    assert chk.checked > 0, "the small block launched no kernel"
    worst = assert_same_outputs("small block", outs["cuda"], outs["cpu"])
    emit("small_reference", t0, files=sorted(outs["cpu"]), cuda_equals_cpu=True,
         corr_max_abs_diff=worst, launches_bit_identical=chk.checked)


class Recorder:
    """Wraps the kernel wrappers the skeleton calls so that the largest
    launch of each kernel (by work) is kept for the kernel-vs-plain re-run.
    The wrappers themselves count the launches. The re-runs are timed as the
    skeleton launches them, with the lists' range already checked."""

    def __init__(self):
        self.largest: dict = {}
        self.saved = {n: getattr(cupc, n) for n in WRAPPED}

    def _keep(self, key, work, args):
        if work > self.largest.get(key, (0,))[0]:
            self.largest[key] = (work, args)

    def __enter__(self):
        saved = self.saved

        def local_sweep(C, node_ixs, nbrs, deg, l, **kw):
            self._keep(("local_sweep", l), nbrs.shape[0] * nbrs.shape[1] ** (l + 1),
                       (C, node_ixs, nbrs, deg, l))
            return saved["local_sweep"](C, node_ixs, nbrs, deg, l, **kw)

        def hetcor_local_sweep(C, N, t_ix, node_ixs, nbrs, deg, th, l, **kw):
            self._keep(("hetcor_sweep", l), nbrs.shape[0] * nbrs.shape[1] ** (l + 1),
                       (C, N, t_ix, node_ixs, nbrs, deg, th, l))
            return saved["hetcor_local_sweep"](C, N, t_ix, node_ixs, nbrs, deg, th, l, **kw)

        def gather_local_panels(C, node_ixs, nbrs, deg, **kw):
            self._keep(("panel_gather",), nbrs.shape[0] * nbrs.shape[1] ** 2,
                       (C, node_ixs, nbrs, deg))
            return saved["gather_local_panels"](C, node_ixs, nbrs, deg, **kw)

        def gather_local_panels2(C, N, node_ixs, nbrs, deg, **kw):
            self._keep(("panel_gather2",), nbrs.shape[0] * nbrs.shape[1] ** 2,
                       (C, N, node_ixs, nbrs, deg))
            return saved["gather_local_panels2"](C, N, node_ixs, nbrs, deg, **kw)

        for n, fn in (("local_sweep", local_sweep), ("hetcor_local_sweep", hetcor_local_sweep),
                      ("gather_local_panels", gather_local_panels),
                      ("gather_local_panels2", gather_local_panels2)):
            setattr(cupc, n, fn)
        return self

    def __exit__(self, *exc):
        for n, fn in self.saved.items():
            setattr(cupc, n, fn)


def reset_all_launches() -> None:
    ls.reset_launches()
    hs.reset_launches()
    pg.reset_launches()


def all_launches() -> dict:
    """The launch count of every kernel entry, sweeps by level."""
    return {**{f"local_sweep_l{l}": n for l, n in ls.launches.items()}, **pg.launches,
            **{f"hetcor_sweep_l{l}": n for l, n in hs.launches.items()}}


def kernel_entry(name: str, module, replaces: str, launches: int, err: float, ms: float,
                 plain_ms: float, bnd: dict, library_ms, shape: dict, **more) -> dict:
    return {
        **more,
        "name": name, "route": "cuda", "source": module.SOURCE, "replaces": REPLACES[replaces],
        "launches": launches, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bnd["bound_ms"], "bound_by": bnd["bound_by"], "library_ms": library_ms,
        "shape": {**shape, **{k: v for k, v in bnd.items()
                              if k in ("tests", "bytes", "operations", "distinct_entries",
                                       "distinct_sectors")}},
    }


def sweep_entries(tag: str, rec: Recorder, launches: dict, rho_th: dict, loops: dict,
                  clock_hz: float) -> list:
    """The largest local_sweep launch of a run at each level 1-3, kernel vs
    plain (bit-identical) on the same tensors, timed beside its bound, its
    issue bound and, at levels 2-3, the one-thread-per-slot route."""
    kernels = []
    for l in (1, 2, 3):
        C, node_ixs, nbrs, deg, _ = rec.largest[("local_sweep", l)][1]
        rho_k, pos_k = ls.local_sweep(C, node_ixs, nbrs, deg, l)
        rho_p, pos_p = pcorr.local_sweep_plain(C, node_ixs, nbrs, deg, l)
        err = compare(f"{tag} level {l}", rho_k, pos_k, rho_p, pos_p, deg, rho_th[l])
        bnd = sweep_bound(node_ixs, nbrs, deg, C.shape[0], l, 1, SWEEP_OPS)
        more = {"plan": ls.plan(l, nbrs.shape[1]),
                **issue_bound(bnd["tests"], loops[("local_sweep", l)], clock_hz)}
        if l > 1:  # the design the table route replaced, in the same call
            forced = rows_plan(ls, l, nbrs.shape[1], 1)
            more["rows_route_ms"] = cuda_ms(lambda: ls.local_sweep(
                C, node_ixs, nbrs, deg, l, index_range_checked=True, launch_plan=forced), reps=5)
        kernels.append(kernel_entry(
            f"local_sweep_l{l}", ls, "local_sweep", launches[f"local_sweep_l{l}"], err,
            cuda_ms(lambda: ls.local_sweep(C, node_ixs, nbrs, deg, l,
                                           index_range_checked=True), reps=5),
            cuda_ms(lambda: pcorr.local_sweep_plain(C, node_ixs, nbrs, deg, l), reps=2),
            bnd, None, {"nodes": int(nbrs.shape[0]), "width": int(nbrs.shape[1])}, **more,
        ))
    return kernels


def gather_entries(tag: str, rec: Recorder, launches: dict) -> list:
    """The largest gather launch of a run, kernel vs plain (bit-identical)
    and vs the advanced-indexing call that computes the same panels."""
    out = []
    for name, panels in (("panel_gather", 1), ("panel_gather2", 2)):
        if (name,) not in rec.largest:
            continue
        args = rec.largest[(name,)][1]
        kern = pg.gather_local_panels if panels == 1 else pg.gather_local_panels2
        plain = pg.gather_local_panels_plain if panels == 1 else pg.gather_local_panels2_plain
        err = compare_bits(f"{tag} largest {name}", kern(*args), plain(*args))
        node_ixs, nbrs, deg = args[-3:]
        nb = pg.remap_pad_slots(node_ixs, nbrs, deg).long()
        x = node_ixs.long()[:, None]

        def indexing():
            return [(P[nb[:, :, None], nb[:, None, :]], P[x, nb]) for P in args[:panels]]

        nt, d = nbrs.shape
        bnd = gather_bound(node_ixs, nbrs, deg, args[0].shape[0], panels)
        run = lambda: kern(*args, index_range_checked=True)  # noqa: E731
        out.append(kernel_entry(
            name, pg, name, launches[name], err, cuda_ms(run, reps=200),
            cuda_ms(lambda: plain(*args), reps=20), bnd,
            cuda_ms(indexing, reps=20), {"nodes": int(nt), "width": int(d)},
            plan=pg.plan(int(d), panels), sector_ms=bnd["sector_ms"],
            launch_floor_ms=launch_floor_ms(),
            **kernel_device_ms(run, 20, "panel_rows_kernel"),
        ))
    return out


def phase_slice(tmp: str, rho_th: dict, loops: dict, clock_hz: float):
    t0 = time.perf_counter()
    G, Y, planted = ar1_block(M11K, N11K, P11K, seed=0)
    b11k = os.path.join(tmp, "b11k")
    os.makedirs(b11k)
    stem, blocks = write_block(b11k, G, Y)
    del G
    emit("slice_data", t0, markers=M11K, individuals=N11K, traits=P11K)

    out = os.path.join(tmp, "out11k")
    os.makedirs(out)
    stats: dict = {}
    torch.cuda.reset_peak_memory_stats()
    with Recorder() as rec:
        reset_all_launches()
        t1 = time.perf_counter()
        res = cusk(stem + ".phen", stem, blocks, ALPHA, MAX_LEVEL, MAX_LEVEL_TWO,
                   DEPTH, out, 0, verbose=False, device="cuda", stats=stats)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        launches = {**{f"local_sweep_l{l}": n for l, n in ls.launches.items()}, **pg.launches}

    s1, s2 = stats["stage1"], stats["stage2"]
    ran = set(s1.get("level_wall_s", {})) | set(s2.get("level_wall_s", {}))
    assert stats["final_level"] == 3, f"stage 1 stopped at level {stats['final_level']}"
    for l in (1, 2, 3):
        if l in ran:
            assert launches[f"local_sweep_l{l}"] > 0, f"level {l} ran without a kernel launch"
    assert max(ran) >= 4 and launches["panel_gather"] > 0, (
        f"levels {sorted(ran)} ran with {launches['panel_gather']} gather launches")
    assert res is not None
    base = os.path.join(out, "1_0_10999")
    for ext in (".mdim", ".ixs", ".adj", ".corr", ".sep"):
        assert os.path.getsize(base + ext) > 0, base + ext
    back = ReducedGCS.from_file(base)
    k = back.num_var
    assert back.G.shape == (k, k) and back.S.shape == (k, k, 14)
    assert np.array_equal(back.G, back.G.T) and not back.G.diagonal().any()
    assert np.all(np.isfinite(back.C)) and np.all(np.abs(back.C) <= 1.0 + 1e-6)
    kept = set(back.new_to_old_indices[: back.num_markers()].tolist())
    recovered = float(np.mean([k in kept for k in planted]))
    assert recovered >= 0.5, f"only {recovered:.2f} of the planted markers retained"
    emit(
        "slice_cusk", t0, cusk_wall_s=wall, prepare_s=stats["prepare_s"],
        prescreen_s=stats["prescreen_s"], panel_s=stats["panel_s"],
        l0_s=s1["l0_wall_s"], sepset_alloc_s=s1["sepset_alloc_s"],
        level_wall_s=s1["level_wall_s"], level_detail=s1["level_detail"],
        reduce_s=stats["reduce_s"], stage2_s=stats["stage2_s"],
        stage2_level_wall_s=s2.get("level_wall_s", {}),
        launches=launches, buckets={l: len(v) for l, v in s1["launches"].items()},
        retained_markers=stats["retained_markers"], final_level=stats["final_level"],
        final_level_two=stats["final_level_two"], planted_recovered=recovered,
        peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30,
        **hashes_beside_parent("cusk", file_hashes(base, (".adj", ".ixs", ".mdim", ".sep"))),
    )

    # the largest launch of each kernel, kernel vs plain on the card
    t0 = time.perf_counter()
    kernels = sweep_entries("11k", rec, launches, rho_th, loops, clock_hz)
    kernels += gather_entries("11k", rec, launches)
    emit("largest_launch_cusk", t0, kernels=kernels)

    def again():
        out2 = os.path.join(tmp, "out11k_profiled")
        os.makedirs(out2)
        cusk(stem + ".phen", stem, blocks, ALPHA, MAX_LEVEL, MAX_LEVEL_TWO, DEPTH,
             out2, 0, verbose=False, device="cuda")

    return kernels, again, wall


def write_sumstats(d: str) -> tuple[dict, list]:
    """The summary-statistic input as files: a binary lower triangle of the
    AR(1) marker correlations 0.92^|i-j|, an mxp table with 5 planted markers
    per trait at 0.03 (smeared over their LD neighbourhood) plus N(0, 1/5e5)
    noise, a pxp table at 0.1, SE tables that give every mxp and pxp entry an
    ESS uniform in [3e5, 5e5], and one block over all markers. Returns the
    `CuskssArgs.from_paths` keywords and the planted markers."""
    rng = np.random.default_rng(2)
    m, p = MSS, PSS
    r, c = np.tril_indices(m)
    (0.92 ** np.arange(m)).astype(np.float32)[r - c].tofile(os.path.join(d, "mxm.bin"))
    del r, c
    ii = np.arange(m)
    mxp = rng.normal(size=(m, p)) / np.sqrt(NSS)
    planted = []
    for t in range(p):
        for k in rng.integers(0, m, 5):
            mxp[:, t] += 0.03 * 0.92 ** np.abs(ii - k)
            planted.append(int(k))
    mxp_se = (1.0 - mxp**2) / np.sqrt(rng.uniform(3e5, 5e5, size=(m, p)))
    pxp = np.full((p, p), 0.1) + 0.9 * np.eye(p)
    pxp_se = (1.0 - pxp**2) / np.sqrt(rng.uniform(3e5, 5e5, size=(p, p)))
    pxp_se = np.triu(pxp_se) + np.triu(pxp_se, 1).T
    np.fill_diagonal(pxp_se, 1.0)  # rho = 1 has no SE; the diagonal's ESS is never read
    traits = [f"T{t}" for t in range(p)]
    for name, tab in (("mxp", mxp), ("mxp_se", mxp_se)):
        with open(os.path.join(d, name + ".txt"), "w") as f:
            f.write("chr snp ref " + " ".join(traits) + "\n")
            body = np.char.mod("%.9e", tab)
            f.writelines(f"1 rs{i} A " + " ".join(body[i]) + "\n" for i in range(m))
    for name, tab in (("pxp", pxp), ("pxp_se", pxp_se)):
        with open(os.path.join(d, name + ".txt"), "w") as f:
            f.write(" ".join(traits) + "\n")
            body = np.char.mod("%.9e", tab)
            f.writelines(f"{traits[i]} " + " ".join(body[i]) + "\n" for i in range(p))
    write_marker_blocks_to_file([MarkerBlock("1", 0, m - 1)], os.path.join(d, "ss.blocks"))
    kw = dict(
        mxm=os.path.join(d, "mxm.bin"), mxp=os.path.join(d, "mxp.txt"),
        mxp_se=os.path.join(d, "mxp_se.txt"), pxp=os.path.join(d, "pxp.txt"),
        pxp_se=os.path.join(d, "pxp_se.txt"), blockfile=os.path.join(d, "ss.blocks"),
        block_index=0, alpha=ALPHA, max_level_one=MAX_LEVEL, max_level_two=MAX_LEVEL_TWO,
        max_depth=DEPTH, num_samples=NSS,
    )
    return kw, planted


def phase_small_cuskss(tmp: str) -> None:
    """The fixture inputs through cuskss on the card and on the CPU, Pearson
    and hetcor (SE files), both stages: same files."""
    t0 = time.perf_counter()
    p = lambda name: os.path.join(FIXTURES, name)  # noqa: E731
    se = {}
    for key, src, lead in (("mxp_se", "marker_trait_summary_stats.txt", 3),
                           ("pxp_se", "trait_summary_stats.txt", 1)):
        lines = open(p(src)).read().splitlines()
        se[key] = os.path.join(tmp, key + "_small.txt")
        with open(se[key], "w") as f:
            f.write(lines[0] + "\n")
            for line in lines[1:]:
                fields = line.split()
                f.write(" ".join(fields[:lead] + ["0.00001"] * (len(fields) - lead)) + "\n")
    worst, checked = {}, {}
    for tag, extra in (("pearson", {}), ("hetcor", se)):
        outs = {}
        with EveryLaunchChecked() as chk:
            for dev in ("cuda", "cpu"):
                out = os.path.join(tmp, f"ss_small_{tag}_{dev}")
                os.makedirs(out)
                cuskss(CuskssArgs.from_paths(
                    mxm=p("small_mxm.bin"), mxp=p("marker_trait_summary_stats.txt"),
                    pxp=p("trait_summary_stats.txt"), marker_indices=p("marker_indices.bin"),
                    alpha=ALPHA, num_samples=500000, max_level_one=3, max_level_two=1,
                    max_depth=1, outdir=out, **extra), verbose=False, device=dev)
                outs[dev] = block_files(out)
        worst[tag] = assert_same_outputs(f"small cuskss {tag}", outs["cuda"], outs["cpu"])
        checked[tag] = chk.checked
    emit("small_cuskss", t0, files=sorted(outs["cpu"]), cuda_equals_cpu=True,
         corr_max_abs_diff=worst, launches_bit_identical=checked)


def phase_cuskss(tmp: str, loops: dict, clock_hz: float, bucket: list):
    t0 = time.perf_counter()
    ss = os.path.join(tmp, "ss")
    out = os.path.join(tmp, "out_ss")
    os.makedirs(ss)
    os.makedirs(out)
    kw, planted = write_sumstats(ss)
    emit("cuskss_data", t0, markers=MSS, traits=PSS, num_samples=NSS,
         mxm_bytes=os.path.getsize(kw["mxm"]))

    stats: dict = {}
    torch.cuda.reset_peak_memory_stats()
    with Recorder() as rec:
        reset_all_launches()
        t1 = time.perf_counter()
        res = cuskss(CuskssArgs.from_paths(outdir=out, **kw), verbose=False, device="cuda",
                     stats=stats)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        launches = {**{f"hetcor_sweep_l{l}": n for l, n in hs.launches.items()}, **pg.launches}

    s1, s2 = stats["stage1"], stats["stage2"]
    ran = set(s1.get("level_wall_s", {})) | set(s2.get("level_wall_s", {}))
    for l in (1, 2, 3):
        assert l in ran and launches[f"hetcor_sweep_l{l}"] > 0, (
            f"level {l}: ran {l in ran}, {launches[f'hetcor_sweep_l{l}']} kernel launches")
    assert max(ran) >= 4 and launches["panel_gather2"] > 0, (
        f"levels {sorted(ran)} ran with {launches['panel_gather2']} two-panel gather launches")
    base = os.path.join(out, f"1_0_{MSS - 1}")
    for ext in (".mdim", ".ixs", ".adj", ".corr"):
        assert os.path.getsize(base + ext) > 0, base + ext
    back = ReducedGC.from_file(base)
    k = back.num_var
    assert k == res.num_var and back.num_phen == PSS and back.G.shape == (k, k)
    assert np.array_equal(back.G, res.G) and np.array_equal(back.C, res.C)
    assert np.array_equal(back.G, back.G.T) and not back.G.diagonal().any()
    assert np.all(np.isfinite(back.C)) and np.all(np.abs(back.C) <= 1.0 + 1e-6)
    assert np.all(np.isfinite(res.S)) and res.S.shape == (k, k)
    kept = set(back.new_to_old_indices[: back.num_markers()].tolist())
    recovered = float(np.mean([k in kept for k in planted]))
    assert recovered >= 0.5, f"only {recovered:.2f} of the planted markers retained"
    emit(
        "slice_cuskss", t0, cuskss_wall_s=wall, load_s=stats["load_s"],
        assemble_s=stats["assemble_s"], l0_s=s1["l0_wall_s"],
        level_wall_s=s1["level_wall_s"], level_detail=s1["level_detail"],
        reduce_s=s1["reduce_s"], stage2_l0_s=s2["l0_wall_s"],
        stage2_level_wall_s=s2["level_wall_s"], stage2_reduce_s=s2["reduce_s"],
        launches=launches, buckets={l: len(v) for l, v in s1["launches"].items()},
        final_level=s1["final_level"], final_level_two=s2["final_level"],
        retained_markers=res.num_markers(), planted_recovered=recovered,
        peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30,
        **hashes_beside_parent("cuskss", file_hashes(base, (".adj", ".ixs", ".mdim"))),
    )

    # the largest launch of each kernel, kernel vs plain on the card
    t0 = time.perf_counter()
    kernels = []
    for l in (1, 2, 3):
        args = rec.largest[("hetcor_sweep", l)][1]
        C, node_ixs, nbrs, deg = args[0], args[3], args[4], args[5]
        count, err = compare_margin(f"cuskss level {l}", hs.hetcor_local_sweep(*args),
                                    pcorr.hetcor_local_sweep_plain(*args))
        bnd = sweep_bound(node_ixs, nbrs, deg, C.shape[0], l, 2, HETCOR_OPS)
        loop = loops[("hetcor_sweep", l)]
        more = {"plan": hs.plan(l, nbrs.shape[1]), **issue_bound(bnd["tests"], loop, clock_hz)}
        if l > 1:
            # this input's launches at levels 2-3 are a few nodes wide: the
            # bucket-sized launch of the kernel checks stands beside them
            more["bucket_sized"] = [
                {**b, **issue_bound(b["tests"], loop, clock_hz)} for b in bucket
                if b["level"] == l][0]
        kernels.append(kernel_entry(
            f"hetcor_sweep_l{l}", hs, "hetcor_sweep", launches[f"hetcor_sweep_l{l}"], err,
            cuda_ms(lambda: hs.hetcor_local_sweep(*args, index_range_checked=True), reps=5),
            cuda_ms(lambda: pcorr.hetcor_local_sweep_plain(*args), reps=2),
            bnd, None, {"nodes": int(nbrs.shape[0]), "width": int(nbrs.shape[1]),
                        "margins_bit_identical": count}, **more,
        ))
    kernels += gather_entries("10k input", rec, launches)
    emit("largest_launch_cuskss", t0, kernels=kernels)

    def again():
        out2 = os.path.join(tmp, "out_ss_profiled")
        os.makedirs(out2)
        cuskss(CuskssArgs.from_paths(outdir=out2, **kw), verbose=False, device="cuda")

    return kernels, again, wall


def pack_bed_rows(G: np.ndarray) -> np.ndarray:
    """(rows, n) uint8 genotypes in {0, 1, 2} -> packed .bed bytes, the
    layout of `encode_bed_values` without its float and int64 passes."""
    codes = np.array([3, 2, 0], np.uint8)[G]
    pad = (-codes.shape[1]) % 4
    if pad:
        codes = np.concatenate([codes, np.zeros((len(codes), pad), np.uint8)], axis=1)
    c = codes.reshape(len(codes), -1, 4)
    return c[:, :, 0] | (c[:, :, 1] << 2) | (c[:, :, 2] << 4) | (c[:, :, 3] << 6)


def write_ar1_fileset(d: str, chr_sizes: list, n: int, p: int, seed: int, chunk: int = 2000,
                      locus: int | None = None, trait_dag: dict | None = None):
    """The generator of `ar1_block` (AR(1) LD 0.92, genotypes from a logistic
    allele frequency, 5 planted markers per trait at effect 0.2) in row
    chunks that carry the AR(1) state and write the `.bed` as they go, so
    that no (m, n) array is ever held; markers spread over the chromosomes
    of chr_sizes. The planted markers are uniform over all markers
    (`sim.phen`). With a locus, a second phenotype file over the same
    genotypes and the same trait noise (`sim_locus.phen`) plants each trait's
    five markers within one window of that many markers whose start is
    uniform, so that they mostly share a block, as all planted markers of
    the 11k block do: a trait with five marker neighbours is what takes
    stage 2 to level 4, and so to the gather. That file is a coverage input,
    shaped for the kernel; the uniform one is what the generator gives.
    trait_dag ({child: [(parent, beta)]}, parents before children) adds
    trait -> trait effects on the standardised parents (`add_trait_dag`).
    Returns (stem, {"uniform" | "locus": (phen path, planted [(trait,
    marker)], Y)}, the planted markers' genotype rows)."""
    m = sum(chr_sizes)
    rng = np.random.default_rng(seed)
    noise_y = rng.normal(size=(p, n)).astype(np.float32)
    if locus is None:
        planted = {"uniform": [(t, int(k)) for t in range(p) for k in rng.integers(0, m, 5)]}
    else:  # the uniform set from a generator of its own: the genotypes do not depend on it
        planted = {"locus": [(t, int(k)) for t in range(p) for k in
                             rng.integers(0, m - locus) + rng.choice(locus, 5, replace=False)]}
        rng_u = np.random.default_rng([seed, 1])
        planted["uniform"] = [(t, int(k)) for t in range(p) for k in rng_u.integers(0, m, 5)]
    wanted = {k for pairs in planted.values() for _, k in pairs}
    rows_of = {}
    ar, scale = np.float32(0.92), np.float32(np.sqrt(1 - 0.92**2))
    stem = os.path.join(d, "sim")
    acc = None
    with open(stem + ".bed", "wb") as f:
        f.write(BED_PREFIX_COL_MAJ)
        for r0 in range(0, m, chunk):
            noise = rng.standard_normal((min(chunk, m - r0), n), dtype=np.float32)
            for i in range(len(noise)):
                acc = noise[i] if acc is None else ar * acc + scale * noise[i]
                noise[i] = acc
            pfreq = 1 / (1 + np.exp(-noise * np.float32(0.8)))
            G = (rng.random(noise.shape, dtype=np.float32) < pfreq).astype(np.uint8)
            G += rng.random(noise.shape, dtype=np.float32) < pfreq
            for k in wanted:
                if r0 <= k < r0 + len(G):
                    rows_of[k] = G[k - r0].astype(np.float32)
            f.write(pack_bed_rows(G).tobytes())
    write_bim_fam(stem, chr_sizes, n)
    sets = {}
    for name, pairs in planted.items():
        Y = noise_y.copy()
        for t, k in pairs:
            Y[t] += 0.2 * (rows_of[k] - rows_of[k].mean()) / rows_of[k].std()
        Y = add_trait_dag(Y, trait_dag or {})
        Y = (Y - Y.mean(1, keepdims=True)) / Y.std(1, keepdims=True)
        phen = stem + (".phen" if name == "uniform" else f"_{name}.phen")
        write_phen(phen, Y)
        sets[name] = (phen, pairs, Y)
    return stem, sets, rows_of


def write_bim_fam(stem: str, chr_sizes: list, n: int) -> None:
    """`.bim` of the markers over chromosomes "1", "2", ... (chr_sizes) and
    `.fam` of n individuals."""
    chrom = np.repeat(np.arange(1, len(chr_sizes) + 1), chr_sizes)
    with open(stem + ".bim", "w") as f:
        f.writelines(f"{chrom[i]}\trs{i}\t0\t{100 * i}\tA\tG\n" for i in range(len(chrom)))
    with open(stem + ".fam", "w") as f:
        f.writelines(f"F{i} I{i} 0 0 0 -9\n" for i in range(n))


def add_trait_dag(Y, trait_dag: dict):
    """Y[t] += beta * standardised Y[s] for every edge s -> t of the trait
    DAG {t: [(s, beta)]}, children after their parents."""
    for t in sorted(trait_dag):
        for s, beta in trait_dag[t]:
            Y[t] = Y[t] + beta * (Y[s] - Y[s].mean()) / Y[s].std()
    return Y


def write_phen(path: str, Y: np.ndarray) -> None:
    """A `.phen` of traits Y (p, n): header, two ID columns, %.6f values."""
    p, n = Y.shape
    with open(path, "w") as f:
        f.write("FID\tIID\t" + "\t".join(f"T{t}" for t in range(p)) + "\n")
        body = np.char.mod("%.6f", Y.T)
        f.writelines(f"F{i}\tI{i}\t" + "\t".join(body[i]) + "\n" for i in range(n))


COMMANDS = ("prep-bed", "block", "cusk-all", "merge-block-outputs", "sepselect")
# the host chain after sepselect: orient-v-structs rewrites max_sep_min_pc
# with the v-structures (sepselect alone leaves its PAG empty), srfci orients
# the trait PAG, mvivw writes the MR tables (plain, then -s)
CHAIN = COMMANDS + ("orient-v-structs", "srfci", "mvivw", "mvivw -s")
PLAIN_MVIVW = "merged_blocks_mvivw_results_plain.tsv"


def run_commands(stem: str, out: str, max_block: int, corr_width: int, alpha: float, n: int,
                 device: str, phen: str | None = None,
                 only: tuple = COMMANDS) -> tuple[dict, str, str]:
    """The commands of CHAIN that `only` names, in CHAIN's order, through
    the CLI with its defaults for the levels and `stem.phen` unless another
    phenotype file is given; the plain mvivw table, which `mvivw -s`
    overwrites, is kept as PLAIN_MVIVW in out. Returns each command's wall
    (ending in a device synchronisation), the `.blocks` path and what
    cusk-all printed."""
    blocks = f"{stem}_m{max_block}.blocks"
    dev = ["--device", device]
    merged, pag = os.path.join(out, "merged_blocks"), os.path.join(out, "max_sep_min_pc")
    argv_of = {
        "prep-bed": ["prep-bed", stem],
        "block": ["block", stem, str(max_block), "10", str(corr_width), *dev],
        "cusk-all": ["cusk-all", blocks, stem, phen or stem + ".phen", str(alpha),
                     str(MAX_LEVEL), str(MAX_LEVEL_TWO), str(DEPTH), out, *dev],
        "merge-block-outputs": ["merge-block-outputs", out, blocks],
        "sepselect": ["sepselect", merged, str(alpha), str(n)],
        "orient-v-structs": ["orient-v-structs", merged, str(alpha), str(n)],
        "srfci": ["srfci", pag, str(alpha), str(n)],
        "mvivw": ["mvivw", merged, str(n)],
        "mvivw -s": ["mvivw", merged, str(n), "-s"],
    }
    walls, printed = {}, io.StringIO()
    for name in CHAIN:
        if name not in only:
            continue
        t = time.perf_counter()
        with contextlib.redirect_stdout(printed if name == "cusk-all" else sys.stdout):
            cli_main(argv_of[name])
        if device == "cuda":
            torch.cuda.synchronize()
        walls[name] = time.perf_counter() - t
        if name == "mvivw":
            shutil.copy(merged + "_mvivw_results.tsv", os.path.join(out, PLAIN_MVIVW))
    return walls, blocks, printed.getvalue()


def read_tsv(data: bytes) -> tuple[list, list]:
    """(header, rows as lists of strings) of a tab-separated table."""
    lines = data.decode().splitlines()
    return lines[0].split("\t"), [line.split("\t") for line in lines[1:]]


def assert_same_mvivw(tag: str, a: bytes, b: bytes, tol: float = 1e-5) -> float:
    """Two `_mvivw_results.tsv`: the same header and rows, equal integer and
    TRUE/FALSE columns, effect and p within tol; returns the largest
    |difference|."""
    (ha, ra), (hb, rb) = read_tsv(a), read_tsv(b)
    assert ha == hb == ["source", "sink", "effect", "p", "sk_adj", "num_snps"], (tag, ha, hb)
    assert len(ra) == len(rb) and ra, f"{tag}: {len(ra)} rows against {len(rb)}"
    worst = 0.0
    for x, y in zip(ra, rb):
        assert [x[i] for i in (0, 1, 4, 5)] == [y[i] for i in (0, 1, 4, 5)], (tag, x, y)
        for i in (2, 3):
            u, v = float(x[i] or "nan"), float(y[i] or "nan")
            same_nan = math.isnan(u) and math.isnan(v)
            assert same_nan or abs(u - v) <= tol, f"{tag}: {x} against {y}"
            worst = max(worst, 0.0 if same_nan else abs(u - v))
    return worst


def assert_same_text_matrix(tag: str, a: bytes, b: bytes) -> float:
    """Two MatrixMarket files of correlations: the same header, the same
    (row, col) in the same order, values within 1e-6; returns the largest
    |difference|."""
    la, lb = a.decode().splitlines(), b.decode().splitlines()
    assert la[:2] == lb[:2] and len(la) == len(lb), f"{tag}: headers or lengths differ"
    worst = 0.0
    for x, y in zip(la[2:], lb[2:]):
        (i, j, u), (k, l, v) = x.split(), y.split()
        assert (i, j) == (k, l), f"{tag}: entry {x!r} against {y!r}"
        diff = abs(float(u) - float(v))
        assert diff <= 1e-6, f"{tag}: entry ({i}, {j}): {u} against {v}"
        worst = max(worst, diff)
    return worst


SMALL_TRAIT_DAG = {1: [(0, 0.5)]}  # T0 -> T1, as the verify drive plants it


def phase_small_commands(tmp: str) -> None:
    """The whole chain (CHAIN: prep-bed to mvivw -s) over 600 markers on 3
    chromosomes x 2,000 individuals x 3 traits with one planted trait edge
    T0 -> T1 (blocks of at most 64 markers, band width 16: the two-step
    route of `block`) with --device cuda and with --device cpu, each on its
    own copy of the fileset: the same `.blocks` bytes, block decision files,
    merged and sepselect files, PAG and IV candidates, every correlation
    within 1e-6 and both mvivw tables' effects and p within 1e-5 (the merged
    correlations may already differ by 1e-6); every kernel launch of the
    card's run bit-identical to its plain version."""
    t0 = time.perf_counter()
    src = os.path.join(tmp, "cmd_small")
    os.makedirs(src)
    write_ar1_fileset(src, [250, 200, 150], 2000, 3, seed=13, chunk=256,
                      trait_dag=SMALL_TRAIT_DAG)
    files, walls, blocks_bytes = {}, {}, {}
    with EveryLaunchChecked() as chk:
        for dev in ("cuda", "cpu"):
            d = os.path.join(tmp, f"cmd_small_{dev}")
            shutil.copytree(src, d)
            out = os.path.join(d, "out")
            os.makedirs(out)
            walls[dev], blocks, _ = run_commands(os.path.join(d, "sim"), out, 64, 16, ALPHA,
                                                  2000, dev, only=CHAIN)
            blocks_bytes[dev] = open(blocks, "rb").read()
            files[dev] = block_files(out)
    assert chk.checked > 0, "the small fileset launched no kernel"
    assert blocks_bytes["cuda"] == blocks_bytes["cpu"], ".blocks differ between cuda and cpu"
    n_blocks = blocks_bytes["cpu"].count(b"\n")
    assert n_blocks >= 9 and len({line.split()[0] for line in
                                  blocks_bytes["cpu"].decode().splitlines()}) == 3
    text = [f for f in files["cpu"] if f.endswith("_scm.mtx")]
    assert sorted(text) == ["max_sep_min_pc_scm.mtx", "merged_blocks_scm.mtx"], sorted(files["cpu"])
    tables = ["merged_blocks_mvivw_results.tsv", PLAIN_MVIVW]
    for f in ("max_sep_min_pc_estimated_pag.mtx", "merged_blocks_iv_candidates.csv", *tables):
        assert f in files["cpu"], (f, sorted(files["cpu"]))
    worst = assert_same_outputs(
        "small commands", {f: b for f, b in files["cuda"].items() if f not in text + tables},
        {f: b for f, b in files["cpu"].items() if f not in text + tables})
    for f in text:
        worst = max(worst, assert_same_text_matrix(f, files["cuda"][f], files["cpu"][f]))
    mr_worst = max(assert_same_mvivw(f, files["cuda"][f], files["cpu"][f]) for f in tables)
    _, rows = read_tsv(files["cpu"][PLAIN_MVIVW])
    planted = [r for r in rows if r[:2] == ["1", "2"]][0]
    pag = mmread(io.BytesIO(files["cpu"]["max_sep_min_pc_estimated_pag.mtx"])).toarray()
    emit("small_commands", t0, blocks=n_blocks, files=len(files["cpu"]), cuda_equals_cpu=True,
         corr_max_abs_diff=worst, mvivw_max_abs_diff=mr_worst,
         launches_bit_identical=chk.checked, wall_s_by_command=walls,
         planted_edge_mvivw={"effect": float(planted[2]), "p": float(planted[3])},
         trait_pag=pag[:3, :3].astype(int).tolist())


def profile_block(stem: str, blocks: str, out_path: str, unprofiled_wall_s: float) -> dict:
    """A second run of `block`'s work (`make_blocks` into another file, which
    must come out the same) under torch.profiler: device time of the int8
    products beside their bound, and the idle share against the unprofiled
    wall of the command."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        make_blocks(stem, MAX_BLOCK, CORR_WIDTH, out_path=out_path, verbose=False, device="cuda")
        torch.cuda.synchronize()
    assert open(out_path, "rb").read() == open(blocks, "rb").read(), "a second block run differs"
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    rows = sorted(((e.key, e.self_device_time_total, e.count) for e in events),
                  key=lambda r: -r[1])
    busy_s = sum(us for _, us, _ in rows) / 1e6
    gemm = [r for r in rows if re.search(r"(?i)gemm|cutlass|xmma|cublas|imma|i8", r[0])]
    tiles = -(-MCHR // ROW_TILE)
    ops = tiles * 9 * ROW_TILE * (ROW_TILE + CORR_WIDTH) * N11K * 2
    # what the band alone needs: every marker against the `width` after it;
    # the rest of each tile's rectangle, and the last tile's pad rows, are
    # computed and thrown away
    band_ops = MCHR * CORR_WIDTH * 9 * N11K * 2
    return {
        "int8_products": {"kernels": [{"name": k[:80], "ms": us / 1e3, "launches": c}
                                      for k, us, c in gemm],
                          "device_ms": sum(us for _, us, _ in gemm) / 1e3,
                          "bound_ms": ops / PEAK_INT8 * 1e3, "operations": ops, "tiles": tiles,
                          "band_operations": band_ops,
                          "band_bound_ms": band_ops / PEAK_INT8 * 1e3,
                          "bound_source": "NVIDIA H100 SXM data sheet, 1,979 TOP/s dense int8"},
        "device_busy_s": busy_s, "device_idle_share": 1.0 - busy_s / unprofiled_wall_s,
        "top": [{"name": k[:80], "ms": us / 1e3, "launches": c} for k, us, c in rows[:8]],
    }


_BLOCK_LINE = re.compile(
    r"\[run_all_blocks\] \[(\S+)\] retained (\d+|no) markers, prepare ([\d.]+) s, "
    r"finish ([\d.]+) s, device memory ([\d.]+) GiB now, ([\d.]+) GiB at most")


def block_lines(printed: str) -> list:
    """The per-block lines `cusk-all` printed: retained markers (None for a
    block its pre-screen skipped), prepare and finish walls, device memory
    after the block and at most."""
    return [
        {"block": g[0], "retained_markers": None if g[1] == "no" else int(g[1]),
         "prepare_s": float(g[2]), "finish_s": float(g[3]), "device_memory_gib": float(g[4]),
         "max_device_memory_gib": float(g[5])} for g in _BLOCK_LINE.findall(printed)]


def chromosome_run(tag: str, stem: str, out: str, phen_set: tuple, rows_of: dict, only: tuple,
                   held: bool) -> tuple[dict, str, dict]:
    """The commands `only` names over the 50,000-marker chromosome with one
    phenotype file, the launch counts set to 0 just before and read just
    after; checks the blocks, the per-block lines, the device memory (unless
    the launches' tensors are held for the comparison afterwards) and the
    merged skeleton, and prints the phase's line. Returns the launches of
    every kernel, the `.blocks` path and the commands' walls."""
    t0 = time.perf_counter()
    phen, planted, Y = phen_set
    os.makedirs(out)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_all_launches()
    walls, blocks, printed = run_commands(stem, out, MAX_BLOCK, CORR_WIDTH, ALPHA, N11K, "cuda",
                                           phen=phen, only=only)
    launches = all_launches()
    sys.stdout.write(printed)
    per_block = block_lines(printed)

    sizes = [b.block_size() for b in read_blocks_from_file(blocks)]
    assert sum(sizes) == MCHR and max(sizes) <= MAX_BLOCK and len(sizes) >= 5, sizes
    assert len(per_block) == len(sizes), (len(per_block), printed[-2000:])
    # a block without a significant marker-trait correlation is skipped by design
    assert sum(b["retained_markers"] is not None for b in per_block) >= 5, per_block
    for name in ("local_sweep_l1", "local_sweep_l2", "local_sweep_l3"):
        assert launches[name] > 0, f"{name} was never launched over the chromosome: {launches}"
    if not held:  # the allocation must not grow from block to block
        grown = per_block[-1]["device_memory_gib"] - per_block[0]["device_memory_gib"]
        assert grown < 0.25, f"device memory grew by {grown} GiB over the blocks: {per_block}"

    gm = merge_block_outputs(blocks, out)
    sparse_of = {row: ix for ix, row in gm.gmi.items()}
    adjacent = sum(
        k in sparse_of and ((sparse_of[k], t + 1) in gm.sam or (t + 1, sparse_of[k]) in gm.sam)
        for t, k in planted)
    # what a plain threshold screen of the planted pairs' correlations gives
    th0 = threshold_array(N11K, ALPHA)[0]
    screen = sum(fisher_z(np.corrcoef(rows_of[k], Y[t])[0, 1]) >= th0 for t, k in planted)
    assert adjacent > 0, "no planted marker is adjacent to its trait"
    assert gm.num_phen == P11K and gm.num_var == P11K + sum(
        b["retained_markers"] or 0 for b in per_block)
    merged = {f: hashlib.sha256(data).hexdigest() for f, data in block_files(out).items()
              if f.startswith(("merged_blocks", "max_sep_min_pc"))}
    assert len(merged) >= 8, sorted(merged)
    emit("chr50k_commands_" + tag, t0, phen=os.path.basename(phen), wall_s_by_command=walls,
         blocks=len(sizes), block_sizes=sizes,
         largest_block_within_tol=MAX_BLOCK - max(sizes) <= 100, per_block=per_block,
         launches=launches, merged_variables=gm.num_var, merged_edges=len(gm.sam),
         planted_adjacent=int(adjacent), planted=len(planted), planted_pass_plain_screen=int(screen),
         peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30,
         sha256={"blocks": hashlib.sha256(open(blocks, "rb").read()).hexdigest(), **merged})
    return launches, blocks, walls


def phase_chromosome(tmp: str, rho_th: dict, loops: dict, clock_hz: float) -> dict:
    """One chromosome of 50,000 markers x 16,384 individuals x 8 traits
    through the shell entry points on the card, with the CLI's defaults.
    First the five commands with the generator's own phenotypes (planted
    markers uniform over the chromosome): the walls, the blocks and the
    launches as they come. Then `cusk-all`, `merge-block-outputs` and
    `sepselect` again over the same blocks with the phenotypes whose planted
    markers share a locus, the input that takes stage 2 to level 4 and so to
    the gather: its launches are counted apart, `local_sweep` and
    `panel_gather` must both be launched, and the largest launch of each is
    held bitwise to its plain version on the same tensors and timed beside
    its bound. Returns, per kernel name, what the `kernels` line carries
    under the chromosome's keys."""
    t0 = time.perf_counter()
    d = os.path.join(tmp, "chr50k")
    os.makedirs(d)
    stem, sets, rows_of = write_ar1_fileset(d, [MCHR], N11K, P11K, seed=4, locus=LOCUS)
    emit("chr50k_data", t0, markers=MCHR, individuals=N11K, traits=P11K,
         bed_bytes=os.path.getsize(stem + ".bed"), locus=LOCUS)

    uniform, blocks, walls = chromosome_run("uniform", stem, os.path.join(d, "out"),
                                            sets["uniform"], rows_of, COMMANDS, held=False)
    with Recorder() as rec:
        locus, _, _ = chromosome_run("locus", stem, os.path.join(d, "out_locus"), sets["locus"],
                                     rows_of, COMMANDS[2:], held=True)
    assert locus["panel_gather"] > 0, f"the gather was never launched over the chromosome: {locus}"

    # the largest launch of each kernel on this path, kernel vs plain on the card
    t0 = time.perf_counter()
    entries = (sweep_entries("chr50k", rec, locus, rho_th, loops, clock_hz)
               + gather_entries("chr50k", rec, locus))
    del rec
    torch.cuda.empty_cache()
    emit("largest_launch_chr50k", t0, kernels=entries)

    t0 = time.perf_counter()
    emit("profile_block", t0, unprofiled_wall_s=walls["block"],
         **profile_block(stem, blocks, os.path.join(d, "again.blocks"), walls["block"]))
    drop = ("name", "route", "source", "replaces", "launches")
    return {k["name"]: {"launches_chr50k": k["launches"],
                        "launches_chr50k_uniform": uniform[k["name"]],
                        "chr50k": {key: v for key, v in k.items() if key not in drop}}
            for k in entries}


# the genome: four chromosomes of the 50k chromosome's size, and a planted
# trait DAG: a collider T0 -> T2 <- T1, then T2 -> T3, and T4 -> T5 (T6 and
# T7 have no trait parent), each at 0.3 on the standardised parent
GENOME_CHRS = [MCHR] * 4
GENOME_DAG = {2: [(0, 0.3), (1, 0.3)], 3: [(2, 0.3)], 5: [(4, 0.3)]}
GENOME_EDGES = [(s, t) for t in sorted(GENOME_DAG) for s, _ in GENOME_DAG[t]]
# seed 5 plants a marker at row 203, in the genome's first block: merge takes
# the trait-trait edges from the first block alone (the reference's
# behaviour, `merge/merge_blocks.py`), and the pre-screen skips a block that
# holds no marker associated with a trait
GENOME_SEED = 5
GENOME_MIN_BLOCKS = 20


def pack_bed_rows_device(G: torch.Tensor) -> torch.Tensor:
    """`pack_bed_rows` on the tensor's device: (rows, n) uint8 genotypes in
    {0, 1, 2} -> packed `.bed` bytes (codes 3, 2, 0, four to a byte)."""
    codes = 3 - G - (G == 2).to(torch.uint8)
    pad = (-codes.shape[1]) % 4
    if pad:
        codes = torch.cat([codes, codes.new_zeros(len(codes), pad)], dim=1)
    c = codes.view(len(codes), -1, 4)
    return c[:, :, 0] | (c[:, :, 1] << 2) | (c[:, :, 2] << 4) | (c[:, :, 3] << 6)


def write_genome_fileset(d: str):
    """The generator of `write_ar1_fileset` (AR(1) LD 0.92, genotypes from a
    logistic allele frequency, 5 planted markers per trait at effect 0.2,
    uniform over all markers) over GENOME_CHRS x N11K individuals x P11K
    traits with GENOME_DAG, made on the card from a `torch.Generator` seeded
    with GENOME_SEED and packed there, so that only the packed rows cross to
    the host. Each chromosome starts its AR(1) chain from a stationary
    state; within a chunk of rows the chain is one product with the
    lower-triangular matrix of the AR weights. The planted markers come from
    numpy's generator of the same seed. Returns (stem, planted [(trait,
    marker)], Y (p, n) as written, the planted markers' genotype rows on the
    card)."""
    dev, n, p, chunk = torch.device("cuda"), N11K, P11K, 1024
    gen = torch.Generator(device=dev)
    gen.manual_seed(GENOME_SEED)
    rng = np.random.default_rng(GENOME_SEED)
    planted = [(t, int(k)) for t in range(p) for k in rng.integers(0, sum(GENOME_CHRS), 5)]
    wanted = sorted({k for _, k in planted})
    ar = 0.92
    i = torch.arange(chunk, dtype=torch.float64, device=dev)
    W = (math.sqrt(1 - ar**2) * ar ** (i[:, None] - i[None, :]).clamp(min=0)).tril().float()
    carry = (ar ** (i + 1)).float()
    rows_of = {}
    stem = os.path.join(d, "sim")
    with open(stem + ".bed", "wb") as f:
        f.write(BED_PREFIX_COL_MAJ)
        r0 = 0
        for size in GENOME_CHRS:
            acc = torch.randn(n, generator=gen, device=dev)
            for c0 in range(0, size, chunk):
                k = min(chunk, size - c0)
                z = torch.randn((k, n), generator=gen, device=dev)
                X = torch.addmm(carry[:k, None] * acc[None, :], W[:k, :k], z)
                acc = X[-1]
                pfreq = torch.sigmoid(0.8 * X)
                G = (torch.rand((k, n), generator=gen, device=dev) < pfreq).to(torch.uint8)
                G += (torch.rand((k, n), generator=gen, device=dev) < pfreq).to(torch.uint8)
                for j in wanted:
                    if r0 <= j < r0 + k:
                        rows_of[j] = G[j - r0].float()
                f.write(pack_bed_rows_device(G).cpu().numpy().tobytes())
                r0 += k
    write_bim_fam(stem, GENOME_CHRS, n)
    Y = torch.randn((p, n), generator=gen, device=dev)
    for t, j in planted:
        g = rows_of[j]
        Y[t] += 0.2 * (g - g.mean()) / g.std(unbiased=False)
    Y = add_trait_dag(Y.cpu().numpy(), GENOME_DAG)
    Y = (Y - Y.mean(1, keepdims=True)) / Y.std(1, keepdims=True)
    write_phen(stem + ".phen", Y)
    return stem, planted, Y, rows_of


def mvivw_rows(path: str) -> dict:
    """{(source, sink) 0-based: (effect, p)} of an `_mvivw_results.tsv`."""
    _, rows = read_tsv(open(path, "rb").read())
    return {(int(r[0]) - 1, int(r[1]) - 1): (float(r[2] or "nan"), float(r[3] or "nan"))
            for r in rows}


def phase_genome(tmp: str, rho_th: dict, loops: dict, clock_hz: float) -> dict:
    """A genome of four 50,000-marker chromosomes x 16,384 individuals x 8
    traits with the planted trait DAG, made on the card, through the whole
    chain of commands (CHAIN) with the CLI's defaults, then through the
    Python API: `estimate_ace` for every planted trait edge, `check_ivs`
    and `run_mvivw_filtered` on its instruments. The launch counts are set
    to 0 just before the commands and read just after. Checks (loose on
    purpose): at least GENOME_MIN_BLOCKS blocks, every one with a line of
    its own from cusk-all and the first one skeletonised, device memory flat
    over the blocks, every sweep level launched, every planted trait edge in
    the merged skeleton and a positive plain-mvivw effect at p < 1e-3 on
    each. Prints the walls of the data, each command and the API calls,
    per-block walls and memory, launches, the merged skeleton, planted
    markers adjacent to their traits beside a plain threshold screen, the
    PAG's trait marks beside the planted DAG, each planted edge's MVIVW
    (plain, -s, filtered) and ACE estimates, the false positives at
    p < 1e-3 and the sha256 of every merged, PAG and MR file. Then cusk-all
    again under torch.profiler for the device's idle share, its launches
    equal to the first run's: every gather launch of it is held bitwise to
    its plain version as it comes, and the largest launch of each kernel is
    kept, held bitwise to plain afterwards and timed beside its bound.
    Returns, per kernel name, what the `kernels` line carries under the
    genome's keys."""
    t0 = time.perf_counter()
    d = os.path.join(tmp, "genome")
    os.makedirs(d)
    stem, planted, Y, rows_of = write_genome_fileset(d)
    torch.cuda.synchronize()
    emit("genome_data", t0, markers=sum(GENOME_CHRS), chromosomes=len(GENOME_CHRS),
         individuals=N11K, traits=P11K, bed_bytes=os.path.getsize(stem + ".bed"),
         planted_markers=planted,
         trait_dag=[f"T{s}->T{t} {b}" for t, ps in sorted(GENOME_DAG.items()) for s, b in ps])

    t0 = time.perf_counter()
    out = os.path.join(d, "out")
    os.makedirs(out)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_all_launches()
    walls, blocks, printed = run_commands(stem, out, MAX_BLOCK, CORR_WIDTH, ALPHA, N11K, "cuda",
                                          only=CHAIN)
    launches = all_launches()
    sys.stdout.write(printed)
    per_block = block_lines(printed)
    sizes = [b.block_size() for b in read_blocks_from_file(blocks)]
    assert sum(sizes) == sum(GENOME_CHRS) and max(sizes) <= MAX_BLOCK, sizes
    assert len(sizes) >= GENOME_MIN_BLOCKS, f"{len(sizes)} blocks, fewer than {GENOME_MIN_BLOCKS}"
    assert len(per_block) == len(sizes), (len(per_block), printed[-2000:])
    for name in ("local_sweep_l1", "local_sweep_l2", "local_sweep_l3"):
        assert launches[name] > 0, f"{name} was never launched over the genome: {launches}"
    grown = per_block[-1]["device_memory_gib"] - per_block[0]["device_memory_gib"]
    assert grown < 0.25, f"device memory grew by {grown} GiB over the blocks: {per_block}"
    assert per_block[0]["retained_markers"] is not None, (
        f"data: the pre-screen skipped the first block ({per_block[0]['block']}), which holds "
        f"none of the planted markers {planted}, and merge takes the trait-trait edges from "
        "the first block alone: choose a GENOME_SEED that plants a marker there")

    gm = merge_block_outputs(blocks, out)
    sparse_of = {row: ix for ix, row in gm.gmi.items()}
    adjacent = sum(
        k in sparse_of and ((sparse_of[k], t + 1) in gm.sam or (t + 1, sparse_of[k]) in gm.sam)
        for t, k in planted)
    th0 = threshold_array(N11K, ALPHA)[0]
    screen = sum(fisher_z(np.corrcoef(rows_of[k].cpu().numpy(), Y[t])[0, 1]) >= th0
                 for t, k in planted)
    in_skeleton = {f"T{s}->T{t}": (s + 1, t + 1) in gm.sam or (t + 1, s + 1) in gm.sam
                   for s, t in GENOME_EDGES}
    assert all(in_skeleton.values()), f"planted trait edges missing: {in_skeleton}"
    pag_stem, merged = os.path.join(out, "max_sep_min_pc"), os.path.join(out, "merged_blocks")
    pag = mmread(pag_stem + "_estimated_pag.mtx").toarray().astype(int)
    plain = mvivw_rows(os.path.join(out, PLAIN_MVIVW))
    skel = mvivw_rows(merged + "_mvivw_results.tsv")
    for s, t in GENOME_EDGES:
        effect, p = plain[(s, t)]
        assert effect > 0 and p < 1e-3, f"mvivw T{s}->T{t}: effect {effect}, p {p}"
    false_pos = sorted(f"T{s}->T{t}" for (s, t), (_, p) in plain.items()
                       if p < 1e-3 and (s, t) not in GENOME_EDGES)

    t1 = time.perf_counter()
    ace = {f"T{s}->T{t}": estimate_ace(pag_stem, pag_stem + "_estimated_pag.mtx", s, t, N11K,
                                       ALPHA)
           for s, t in GENOME_EDGES}
    ivs = check_ivs(merged, N11K, ALPHA, ALPHA)
    filt_dir = os.path.join(d, "filtered")
    os.makedirs(filt_dir)
    for ext in ("_sam.mtx", "_scm.mtx", ".mdim", ".ixs"):
        shutil.copy(merged + ext, os.path.join(filt_dir, "cuskss_merged" + ext))
    filtered = {(r["source"] - 1, r["sink"] - 1): (r["effect"], r["p"])
                for r in run_mvivw_filtered(filt_dir, N11K, ivs)}
    api_wall = time.perf_counter() - t1
    hashes = {f: hashlib.sha256(data).hexdigest() for f, data in block_files(out).items()
              if f.startswith(("merged_blocks", "max_sep_min_pc"))}
    emit("genome_commands", t0, wall_s_by_command=walls, api_wall_s=api_wall,
         blocks=len(sizes), block_sizes=sizes, per_block=per_block,
         blocks_without_retained_markers=sum(b["retained_markers"] is None for b in per_block),
         launches=launches, merged_variables=gm.num_var, merged_edges=len(gm.sam),
         planted_adjacent=int(adjacent), planted=len(planted),
         planted_pass_plain_screen=int(screen), trait_edges_in_skeleton=in_skeleton,
         trait_pag=pag[:P11K, :P11K].tolist(),
         planted_pag_marks={f"T{s}->T{t}": [int(pag[s, t]), int(pag[t, s])]
                            for s, t in GENOME_EDGES},
         mvivw={f"T{s}->T{t}": {"plain": plain[(s, t)], "s": skel[(s, t)],
                                 "filtered": filtered[(s, t)]} for s, t in GENOME_EDGES},
         mvivw_false_positives_p_1e3=false_pos, iv_rows=len(ivs), ace=ace,
         peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30,
         sha256={"blocks": hashlib.sha256(open(blocks, "rb").read()).hexdigest(), **hashes})

    def again():
        out2 = os.path.join(d, "out_profiled")
        os.makedirs(out2)
        with contextlib.redirect_stdout(io.StringIO()):
            run_commands(stem, out2, MAX_BLOCK, CORR_WIDTH, ALPHA, N11K, "cuda",
                         only=("cusk-all",))

    reset_all_launches()
    with EveryLaunchChecked(("gather_local_panels",)) as chk, Recorder() as rec:
        profile_run("genome_cusk_all", again, walls["cusk-all"], cpu=False)
    assert all_launches() == launches, (all_launches(), launches)
    assert chk.checked == launches["panel_gather"], (chk.checked, launches)

    # the largest launch of each kernel on the genome, kernel vs plain on the card
    t0 = time.perf_counter()
    entries = (sweep_entries("genome", rec, launches, rho_th, loops, clock_hz)
               + gather_entries("genome", rec, launches))
    del rec
    torch.cuda.empty_cache()
    emit("largest_launch_genome", t0, gather_launches_bit_identical=chk.checked, kernels=entries)
    drop = ("name", "route", "source", "replaces", "launches")
    of_entry = {k["name"]: {key: v for key, v in k.items() if key not in drop} for k in entries}
    return {name: {"launches_genome": launches[name],
                   **({"genome": of_entry[name]} if name in of_entry else {})}
            for name in ("local_sweep_l1", "local_sweep_l2", "local_sweep_l3", "panel_gather")}


def profile_run(tag: str, run, unprofiled_wall_s: float, cpu: bool = True) -> dict:
    """A second (warm) run of a slice under torch.profiler: device time by
    kernel name. The profiler slows the host, not the device, so the idle
    share is taken against the unprofiled run's wall. cpu=False records the
    device's activity alone, for runs long enough that the host's records
    would weigh on the run."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    activities = [ProfilerActivity.CPU] if cpu else []
    with profile(activities=activities + [ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    rows = sorted(((e.key, e.self_device_time_total) for e in events), key=lambda r: -r[1])
    busy_s = sum(us for _, us in rows) / 1e6
    # device time of all launches of each hand-written kernel on the slice
    totals = {e.key[:80]: {"total_ms": e.self_device_time_total / 1e3, "launches": e.count}
              for e in events if re.search(r"sweep\w*_kernel|panel_\w+_kernel", e.key)}
    emit("profile_" + tag, t0, profiled_wall_s=wall, unprofiled_wall_s=unprofiled_wall_s,
         device_busy_s=busy_s, device_idle_share=1.0 - busy_s / unprofiled_wall_s,
         top=[{"name": k[:80], "ms": us / 1e3} for k, us in rows[:10]], kernel_totals=totals)
    return totals


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernels-only", action="store_true",
                    help="stop after the build and the kernel checks (prints no result line)")
    opts = ap.parse_args()
    t0 = time.perf_counter()
    require_cuda()
    smi = nvidia_smi()
    emit("environment", t0, python=sys.version.split()[0], torch=torch.__version__,
         cuda=torch.version.cuda, device=torch.cuda.get_device_name(0),
         device_count=torch.cuda.device_count(), nvidia_smi=smi)

    t0 = time.perf_counter()
    names = ("local_sweep", "panel_gather", "hetcor_sweep")
    with ThreadPoolExecutor(len(names)) as pool:  # one nvcc per source, together
        libs = list(pool.map(build.build, names))
    for name, lib in zip(names, libs):
        log = lib.with_suffix(".log").read_text() if lib.with_suffix(".log").exists() else ""
        emit("build", t0, source=name, library=lib.name, ptxas=ptxas_summary(log))
    t0 = time.perf_counter()
    loops = inner_loops(dict(zip(names, libs)))
    clock_hz = sm_clock_hz()
    emit("inner_loops", t0, sm_clock_mhz=clock_hz / 1e6,
         loops={f"{k}_l{l}": v for (k, l), v in loops.items()})

    th = threshold_array(N11K, ALPHA)
    rho_th = {l: float(np.float32(np.tanh(float(th[l])))) for l in (1, 2, 3)}
    panels = check_panels()
    phase_kernels(rho_th, panels)
    phase_gather_kernel(panels)
    bucket = phase_hetcor_kernel(panels)
    if opts.kernels_only:
        return 1
    del panels
    torch.cuda.empty_cache()

    expected = [f"local_sweep_l{l}" for l in (1, 2, 3)] + ["panel_gather"] + [
        f"hetcor_sweep_l{l}" for l in (1, 2, 3)] + ["panel_gather2"]
    tmp = tempfile.mkdtemp(prefix="cigwas_chip_smoke_")
    try:
        phase_small_reference(tmp)
        kernels, cusk_again, wall = phase_slice(tmp, rho_th, loops, clock_hz)
        phase_small_cuskss(tmp)
        kernels_ss, cuskss_again, wall_ss = phase_cuskss(tmp, loops, clock_hz, bucket)
        kernels += kernels_ss
        # device time of all launches of each sweep level on its slice, from
        # the profiled second run, whose launches must repeat the first's
        totals = {"cusk": profile_run("cusk", cusk_again, wall),
                  "cuskss": profile_run("cuskss", cuskss_again, wall_ss)}
        per_level = {"local_sweep": level_totals(totals["cusk"], "sweep"),
                     "hetcor_sweep": level_totals(totals["cuskss"], "hsweep")}
        # each slice launches one gather entry only: all its panel_rows_kernel records
        gathers = {name: [v for key, v in totals[run].items() if "panel_rows_kernel" in key]
                   for name, run in (("panel_gather", "cusk"), ("panel_gather2", "cuskss"))}
        for k in kernels:
            m = re.fullmatch(r"(local_sweep|hetcor_sweep)_l(\d)", k["name"])
            if m:
                k["total_ms"], n = per_level[m.group(1)][int(m.group(2))]
                assert n == k["launches"], (k["name"], n, k["launches"])
            else:  # the profiler may miss a record of a kernel this short: say how many
                k["total_ms"] = sum(v["total_ms"] for v in gathers[k["name"]])
                k["total_records"] = sum(v["launches"] for v in gathers[k["name"]])
                assert 0 < k["total_records"] <= k["launches"], (k["name"], k["total_records"])
        phase_small_commands(tmp)
        of_chr = phase_chromosome(tmp, rho_th, loops, clock_hz)
        for k in kernels:  # the chromosome's launches and checks under keys of their own
            k.update(of_chr.get(k["name"], {}))
        assert sorted(of_chr) == sorted(expected[:4]), sorted(of_chr)
        shutil.rmtree(os.path.join(tmp, "chr50k"))
        of_genome = phase_genome(tmp, rho_th, loops, clock_hz)
        for k in kernels:  # the sweep levels and the one-panel gather (0 launches allowed)
            k.update(of_genome.get(k["name"], {}))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    bad = sorted(k for k in sys.modules if k.split(".")[0] in ("jax", "cigwas_tpu"))
    assert not bad, bad
    assert [k["name"] for k in kernels] == expected, [k["name"] for k in kernels]
    assert all(k["launches"] > 0 for k in kernels)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                   "count": torch.cuda.device_count()},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
