"""Look for run-to-run differences that one pass of ``chip_smoke.py`` cannot see.

    python3 -m cigwas_tpu_torch.tools.repeat_checks            # one NVIDIA card
    python3 -m cigwas_tpu_torch.tools.repeat_checks --perturb  # CPU only

From the root of the checkout. On the card it prints one JSON line each for

* ``launches``: the two sweep kernels launched again and again on fixed lists
  at main-path widths (the kernel checks' random panels and an LD panel),
  while a second stream keeps the card busy; every launch is held bitwise to
  the plain version. ``mismatches`` must be 0;
* ``small_block``: the 1,500-marker block of ``chip_smoke.py`` through
  ``cusk`` on the card many times and on the CPU once per seed: the decision
  files must be the same bytes every time, and ``corr_max_abs_diff`` is the
  largest |cuda - cpu| of ``.corr`` over all runs.

``--perturb`` needs no card: it runs the same block on the CPU with every
entry of the correlation panel moved by up to ``--ulps`` units in the last
place (symmetrically, another draw each run) and counts the runs whose files
differ from the unperturbed run's. It says how far last-bit differences
between two devices' panels can change a decision.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile

import numpy as np
import torch

from cigwas_tpu_torch.ops import pcorr
from cigwas_tpu_torch.ops.kernels import hetcor_sweep as hs
from cigwas_tpu_torch.ops.kernels import local_sweep as ls
from cigwas_tpu_torch.utils.stats import hetcor_threshold

# (level, width, nodes): the widths the two slices launch most work at
CASES = [(1, 120, 2048), (1, 128, 2048), (1, 24, 2048), (2, 64, 1024), (2, 40, 1024),
         (2, 136, 256), (3, 48, 512), (3, 24, 1024), (3, 112, 64)]


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def repeat_launches(cs, reps: int, hetcor_reps: int) -> dict:
    rng, vp, Cd, Nd, td = cs.check_panels()
    G, Y, _ = cs.ar1_block(4088, 2000, 8, seed=3)
    Z = (G - G.mean(1, keepdims=True)) / G.std(1, keepdims=True)
    R = torch.from_numpy(np.concatenate([Z, Y]).astype(np.float32)).cuda()
    Cl = (R @ R.T / 2000).contiguous()
    Cl.fill_diagonal_(1.0)
    panels = {"random": (Cd, Nd, td, vp),
              "ld": (Cl, Nd[:4096, :4096].contiguous(), td[:4096].contiguous(), 4096)}
    th = hetcor_threshold(cs.ALPHA)
    side, A = torch.cuda.Stream(), torch.randn(4096, 4096, device="cuda")
    n_local = n_hetcor = bad = 0
    for C, N, t, v in panels.values():
        for l, d, nt in CASES:
            lists = cs.neighbour_lists(rng, v, nt, d, True, level=l)
            rho_p, pos_p = pcorr.local_sweep_plain(C, *lists, l)
            # the plain hetcor sweep at levels 2-3 is held to the narrower widths
            m_p = (pcorr.hetcor_local_sweep_plain(C, N, t, *lists, th, l)
                   if l == 1 or d <= 64 else None)
            for rep in range(reps):
                if rep % 3 == 0:
                    with torch.cuda.stream(side):
                        A @ A
                rho, pos = ls.local_sweep(C, *lists, l, index_range_checked=True)
                bad += not (same_bits(rho, rho_p) and torch.equal(pos, pos_p))
                n_local += 1
                if m_p is not None and rep < hetcor_reps:
                    m = hs.hetcor_local_sweep(C, N, t, *lists, th, l, index_range_checked=True)
                    bad += not same_bits(m, m_p)
                    n_hetcor += 1
    torch.cuda.synchronize()
    return {"check": "launches", "local_sweep": n_local, "hetcor_sweep": n_hetcor,
            "mismatches": int(bad)}


def small_block(cs, tmp: str, seed: int):
    from cigwas_tpu_torch.pipelines import cusk

    G, Y, _ = cs.ar1_block(1500, 2000, 3, seed=seed)
    src = os.path.join(tmp, f"small{seed}")
    os.makedirs(src)
    stem, blocks = cs.write_block(src, G, Y)
    count = [0]

    def run(device: str) -> dict:
        out = os.path.join(tmp, f"out{seed}_{count[0]}")
        count[0] += 1
        os.makedirs(out)
        cusk(stem + ".phen", stem, blocks, cs.ALPHA, cs.MAX_LEVEL, cs.MAX_LEVEL_TWO, cs.DEPTH,
             out, 0, verbose=False, device=device)
        return cs.block_files(out)

    return run


def repeat_small_block(cs, tmp: str, seeds, reps: int) -> dict:
    worst, other = 0.0, 0
    for seed in seeds:
        run = small_block(cs, tmp, seed)
        cpu = run("cpu")
        for _ in range(reps):
            cuda = run("cuda")
            for f, data in cpu.items():
                if f.endswith(".corr") and len(cuda[f]) == len(data):
                    worst = max(worst, float(np.abs(
                        np.frombuffer(cuda[f], np.float32) - np.frombuffer(data, np.float32)).max()))
                else:
                    other += cuda[f] != data
    return {"check": "small_block", "seeds": list(seeds), "cuda_runs": len(seeds) * reps,
            "files_that_differ": int(other), "corr_max_abs_diff": worst}


def perturbed_small_block(cs, tmp: str, runs: int, ulps: int) -> dict:
    cusk_module = sys.modules["cigwas_tpu_torch.pipelines.cusk"]
    build_panel = cusk_module.corr_panel_device
    rng = [None]

    def moved(*args, **kw):
        C, v = build_panel(*args, **kw)
        if rng[0] is None:
            return C, v
        step = np.triu(rng[0].integers(-ulps, ulps + 1, size=tuple(C.shape)), 1)
        step = (step + step.T).astype(np.int32)
        step[np.abs(C.numpy()) < 1e-4] = 0  # the zeros of the pad variables stay zeros
        return torch.from_numpy((C.numpy().view(np.int32) + step).view(np.float32).copy()), v

    cusk_module.corr_panel_device = moved
    try:
        run = small_block(cs, tmp, 1)
        ref = run("cpu")
        changed = 0
        for i in range(runs):
            rng[0] = np.random.default_rng(100 + i)
            out = run("cpu")
            changed += any(out[f] != ref[f] for f in ref if not f.endswith(".corr"))
    finally:
        cusk_module.corr_panel_device = build_panel
    return {"check": "perturbed_small_block", "runs": runs, "ulps": ulps,
            "runs_that_decide_otherwise": int(changed)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--perturb", action="store_true", help="the CPU-only perturbation check")
    ap.add_argument("--runs", type=int, default=40)
    ap.add_argument("--ulps", type=int, default=4)
    ap.add_argument("--reps", type=int, default=150, help="launches per case and panel")
    opts = ap.parse_args()
    import chip_smoke as cs  # its panels, lists, block maker and constants, at the root

    tmp = tempfile.mkdtemp(prefix="cigwas_repeat_checks_")
    try:
        if opts.perturb:
            print(json.dumps(perturbed_small_block(cs, tmp, opts.runs, opts.ulps)), flush=True)
            return 0
        cs.require_cuda()
        smi = cs.nvidia_smi()
        found = repeat_launches(cs, opts.reps, 60)
        print(json.dumps({**found, "nvidia_smi": smi}), flush=True)
        again = repeat_small_block(cs, tmp, (1, 2, 3), 8)
        print(json.dumps({**again, "nvidia_smi": smi}), flush=True)
        return int(found["mismatches"] > 0 or again["files_that_differ"] > 0)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
