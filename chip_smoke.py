"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing one JSON line with its wall time; any failure raises
and the script exits non-zero:

1. environment: versions, the card's name and power limit (nvidia-smi);
   fails without a CUDA device;
2. build: compiles the CUDA kernels from ``cigwas_tpu_torch/csrc``;
3. kernels: the levels 1-3 sweep kernel against its plain PyTorch version on
   the card, on seeded panels with 1% NaNs, LD-clustered and scattered
   neighbour lists, ragged degrees across the shared-memory limit; results
   must be bit-identical;
4. slice: a small block through the port's ``cusk`` on the card and on the
   CPU (plain versions) must write the same decisions; then the reference's
   default block (11,000 markers x 16,384 individuals x 8 traits, AR(1) LD,
   planted marker->trait effects) through ``cusk`` on the card, with the
   kernel launches counted per level, and its largest launch per level
   re-run through the plain version on the card (identical hits and
   positions required, both times printed); last, a second, warm run of the
   block under torch.profiler for the device time by kernel and the idle
   share.

The last lines are the kernel summary (JSON), the ``nvidia-smi`` name and
power limit, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

import cigwas_tpu_torch  # noqa: F401  (sets the no-jax import guard first)
from cigwas_tpu_torch import require_cuda
from cigwas_tpu_torch.host import (
    BED_PREFIX_COL_MAJ,
    MarkerBlock,
    ReducedGCS,
    encode_bed_values,
    prep_bed,
    threshold_array,
    write_marker_blocks_to_file,
)
from cigwas_tpu_torch.ops import pcorr
from cigwas_tpu_torch.ops.kernels import build
from cigwas_tpu_torch.ops.kernels import local_sweep as ls
from cigwas_tpu_torch.pipelines import cusk
from cigwas_tpu_torch.skeleton import cupc

REPLACES = "cigwas_tpu/ops/pallas/panel_gather.py:280"
# the reference's default block and CLI parameters
M11K, N11K, P11K = 11000, 16384, 8
ALPHA, MAX_LEVEL, MAX_LEVEL_TWO, DEPTH = 1e-4, 3, 14, 1


def emit(phase: str, t0: float, **kw) -> None:
    print(json.dumps({"phase": phase, "wall_s": time.perf_counter() - t0, **kw}), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


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


def compare(tag: str, rho_k, pos_k, rho_p, pos_p, deg, rho_th: float) -> float:
    """Require bit-identical rho and identical positions; returns max |diff|."""
    if torch.equal(rho_k, rho_p) and torch.equal(pos_k, pos_p):
        return 0.0
    diff = (rho_k != rho_p) | (pos_k != pos_p).any(-1)
    i, j = (int(v) for v in torch.nonzero(diff)[0])
    rk, rp = float(rho_k[i, j]), float(rho_p[i, j])
    raise AssertionError(
        f"{tag}: kernel != plain at node {i} slot {j} (deg {int(deg[i])}): "
        f"rho {rk!r} vs {rp!r}, pos {pos_k[i, j].tolist()} vs {pos_p[i, j].tolist()}, "
        f"margins to tanh(th) {rk - rho_th:.3e} / {rp - rho_th:.3e}"
    )


def phase_kernels(rho_th: dict) -> dict:
    """Kernel vs plain at d in {8, 40, 64, 136, 240, 256, 300} (both sides of
    the shared-memory limit), levels 1-3, clustered and scattered lists;
    plus level-1 nodes of width 6600 (per-slot rows in global scratch)."""
    t0 = time.perf_counter()
    rng = np.random.default_rng(0)
    vp = 8192
    C = (0.3 * rng.standard_normal((vp, vp), dtype=np.float32))
    C = (C + C.T) * np.float32(0.5)
    C[rng.random((vp, vp), dtype=np.float32) < 0.01] = np.nan
    np.fill_diagonal(C, 1.0)
    Cd = torch.from_numpy(C).cuda()
    cases = [(d, l) for d in (8, 40, 64, 136, 240, 256, 300) for l in (1, 2, 3)]
    cases.append((6600, 1))
    n_cmp, max_err = 0, 0.0
    for clustered in (True, False):
        for d, l in cases:
            nt = 2 if d > 1000 else 6
            node_ixs = rng.choice(vp, nt, replace=False).astype(np.int32)
            deg = rng.integers(max(2, d // 2), d + 1, nt).astype(np.int32)
            deg[0] = d
            nbrs = np.zeros((nt, d), np.int32)
            for i, x in enumerate(node_ixs):
                if clustered:  # a window of 2d + 1 variables around the node
                    lo = max(0, min(int(x) - d, vp - 2 * d - 1))
                    pool = np.arange(lo, min(vp, lo + 2 * d + 1))
                else:
                    pool = np.arange(vp)
                pool = pool[pool != x]
                nbrs[i, : deg[i]] = np.sort(rng.choice(pool, deg[i], replace=False))
            args = [torch.from_numpy(a).cuda() for a in (node_ixs, nbrs, deg)]
            rho_k, pos_k = ls.local_sweep(Cd, *args, l)
            rho_p, pos_p = pcorr.local_sweep_plain(Cd, *args, l)
            torch.cuda.synchronize()
            tag = f"{'clustered' if clustered else 'scattered'} d={d} l={l}"
            max_err = max(max_err, compare(tag, rho_k, pos_k, rho_p, pos_p, deg, rho_th[l]))
            n_cmp += 1
    emit("kernels", t0, cases=n_cmp, bit_identical=True, max_abs_err=max_err)
    return {"max_abs_err": max_err}


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
    with open(stem + ".phen", "w") as f:
        f.write("FID\tIID\t" + "\t".join(f"T{t}" for t in range(len(Y))) + "\n")
        body = np.char.mod("%.6f", Y.T)
        f.writelines(f"F{i}\tI{i}\t" + "\t".join(body[i]) + "\n" for i in range(n))
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


def block_files(outdir: str) -> dict:
    return {f: open(os.path.join(outdir, f), "rb").read() for f in sorted(os.listdir(outdir))}


def phase_small_reference(tmp: str) -> None:
    """A 1,500-marker block through cusk on the card and on the CPU (plain
    versions throughout): identical decisions, .corr within 1e-6."""
    t0 = time.perf_counter()
    G, Y, _ = ar1_block(1500, 2000, 3, seed=1)
    small = os.path.join(tmp, "small")
    os.makedirs(small)
    stem, blocks = write_block(small, G, Y)
    outs = {}
    for dev in ("cuda", "cpu"):
        out = os.path.join(tmp, f"small_{dev}")
        os.makedirs(out)
        cusk(stem + ".phen", stem, blocks, ALPHA, MAX_LEVEL, MAX_LEVEL_TWO, DEPTH,
             out, 0, verbose=False, device=dev)
        outs[dev] = block_files(out)
    assert outs["cuda"].keys() == outs["cpu"].keys() and outs["cuda"], outs["cpu"].keys()
    for f, data in outs["cpu"].items():
        got = outs["cuda"][f]
        if f.endswith(".corr"):
            a, b = np.frombuffer(got, np.float32), np.frombuffer(data, np.float32)
            assert np.allclose(a, b, rtol=0, atol=1e-6), f
        else:
            assert got == data, f"small block: {f} differs between cuda and cpu"
    emit("small_reference", t0, files=sorted(outs["cpu"]), cuda_equals_cpu=True)


def phase_slice(tmp: str, rho_th: dict) -> list:
    t0 = time.perf_counter()
    G, Y, planted = ar1_block(M11K, N11K, P11K, seed=0)
    b11k = os.path.join(tmp, "b11k")
    os.makedirs(b11k)
    stem, blocks = write_block(b11k, G, Y)
    del G
    emit("slice_data", t0, markers=M11K, individuals=N11K, traits=P11K)

    # record the largest launch per level (nodes x width^(l+1)) for the
    # kernel-vs-plain re-run; the wrapper itself counts the launches
    largest: dict = {}

    def recording(C, node_ixs, nbrs, deg, l):
        out = sweep(C, node_ixs, nbrs, deg, l)
        work = nbrs.shape[0] * nbrs.shape[1] ** (l + 1)
        if work > largest.get(l, (0,))[0]:
            largest[l] = (work, C, node_ixs, nbrs, deg)
        return out

    sweep = cupc.local_sweep
    cupc.local_sweep = recording
    out = os.path.join(tmp, "out11k")
    os.makedirs(out)
    stats: dict = {}
    ls.reset_launches()
    t1 = time.perf_counter()
    try:
        res = cusk(stem + ".phen", stem, blocks, ALPHA, MAX_LEVEL, MAX_LEVEL_TWO,
                   DEPTH, out, 0, verbose=False, device="cuda", stats=stats)
        torch.cuda.synchronize()
    finally:
        cupc.local_sweep = sweep
    wall = time.perf_counter() - t1
    launches = dict(ls.launches)

    s1, s2 = stats["stage1"], stats["stage2"]
    ran = set(s1.get("level_wall_s", {})) | set(s2.get("level_wall_s", {}))
    assert stats["final_level"] == 3, f"stage 1 stopped at level {stats['final_level']}"
    for l in (1, 2, 3):
        if l in ran:
            assert launches[l] > 0, f"level {l} ran without a kernel launch"
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
        "slice", t0, cusk_wall_s=wall, prepare_s=stats["prepare_s"],
        prescreen_s=stats["prescreen_s"], panel_s=stats["panel_s"],
        l0_s=s1["l0_wall_s"], sepset_alloc_s=s1["sepset_alloc_s"],
        level_wall_s=s1["level_wall_s"], level_detail=s1["level_detail"],
        reduce_s=stats["reduce_s"], stage2_s=stats["stage2_s"],
        stage2_level_wall_s=s2.get("level_wall_s", {}),
        launches=launches, buckets={l: len(v) for l, v in s1["launches"].items()},
        retained_markers=stats["retained_markers"], final_level=stats["final_level"],
        final_level_two=stats["final_level_two"], planted_recovered=recovered,
        peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30,
    )

    # the largest launch of each level, kernel vs plain on the card
    t0 = time.perf_counter()
    kernels = []
    for l in sorted(largest):
        _, C, node_ixs, nbrs, deg = largest[l]
        rho_k, pos_k = ls.local_sweep(C, node_ixs, nbrs, deg, l)
        rho_p, pos_p = pcorr.local_sweep_plain(C, node_ixs, nbrs, deg, l)
        err = compare(f"11k level {l}", rho_k, pos_k, rho_p, pos_p, deg, rho_th[l])
        ms = cuda_ms(lambda: ls.local_sweep(C, node_ixs, nbrs, deg, l), reps=5)
        plain_ms = cuda_ms(lambda: pcorr.local_sweep_plain(C, node_ixs, nbrs, deg, l), reps=2)
        kernels.append({
            "name": f"local_sweep_l{l}", "route": "cuda", "source": ls.SOURCE,
            "replaces": REPLACES, "launches": launches[l], "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms,
            "shape": {"nodes": int(nbrs.shape[0]), "width": int(nbrs.shape[1])},
        })
    emit("largest_launch", t0, kernels=kernels)
    profile_cusk(stem, blocks, os.path.join(tmp, "out11k_profiled"), wall)
    return kernels


def profile_cusk(stem: str, blocks: str, out: str, unprofiled_wall_s: float) -> None:
    """A second (warm) cusk run under torch.profiler: device time by kernel
    name. The profiler slows the host, not the device, so the idle share is
    taken against the unprofiled run's wall."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(out)
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        cusk(stem + ".phen", stem, blocks, ALPHA, MAX_LEVEL, MAX_LEVEL_TWO, DEPTH,
             out, 0, verbose=False, device="cuda")
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rows = sorted(
        ((e.key, e.self_device_time_total) for e in prof.key_averages()
         if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0),
        key=lambda r: -r[1],
    )
    busy_s = sum(us for _, us in rows) / 1e6
    emit("profile", t0, profiled_wall_s=wall, device_busy_s=busy_s,
         device_idle_share=1.0 - busy_s / unprofiled_wall_s,
         top=[{"name": k[:80], "ms": us / 1e3} for k, us in rows[:10]])


def main() -> int:
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args()
    t0 = time.perf_counter()
    require_cuda()
    smi = nvidia_smi()
    emit("environment", t0, python=sys.version.split()[0], torch=torch.__version__,
         cuda=torch.version.cuda, device=torch.cuda.get_device_name(0),
         device_count=torch.cuda.device_count(), nvidia_smi=smi)

    t0 = time.perf_counter()
    lib = build.build("local_sweep")
    log = lib.with_suffix(".log").read_text() if lib.with_suffix(".log").exists() else ""
    emit("build", t0, library=lib.name,
         ptxas=[ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln])

    th = threshold_array(N11K, ALPHA)
    rho_th = {l: float(np.float32(np.tanh(float(th[l])))) for l in (1, 2, 3)}
    phase_kernels(rho_th)

    tmp = tempfile.mkdtemp(prefix="cigwas_chip_smoke_")
    try:
        phase_small_reference(tmp)
        kernels = phase_slice(tmp, rho_th)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    assert "jax" not in sys.modules
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
