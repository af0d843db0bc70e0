"""Time the table route of the two sweep kernels over threads per CTA, and
the levels 1-3 sweep's chunk sizes on the device-resident loop's launches.

    python3 -m cigwas_tpu_torch.tools.tune_sweeps          # from the root of the checkout,
    python3 -m cigwas_tpu_torch.tools.tune_sweeps --loop   # on a machine with one NVIDIA card

For bucket-sized launches on the kernel checks' panels of ``chip_smoke.py``
(clustered lists, degrees within 7 of the width, as a degree bucket holds
them) it launches ``local_sweep`` and ``hetcor_sweep`` with the wrapper's own
plan and, at levels 2 and 3, with the plan's threads replaced by each of a
few counts and with the one-thread-per-slot route, checks every variant
against the first bit for bit, and prints one JSON line per case with the device
milliseconds of each (CUDA events, mean of 5 after a warm-up) beside the
card's name and power limit. ``plan()`` in ``ops/kernels/local_sweep.py``
and ``hetcor_sweep.py`` takes its thread counts from these numbers.

``--loop`` builds ``csrc/local_sweep.cu`` with each pair of its tunables in
CHUNKS (``SWEEP_CHUNK``, the tests of a chunk at levels 2-3, and
``SWEEP_L1_CHUNK``, at level 1), drives the 11k block of ``chip_smoke.py``
through ``cusk`` to keep the device-resident loop's three launches, and
times each launch with every build (CUDA events, mean of 5 after a warm-up),
every output bitwise equal to the default build's. The level-3 launch is
also timed in launch order (``_launch_order``: the wrapper's degree order
left out) and with its order sorted beforehand (``_order_given``: what a
caller that held the degrees on the host would save, the sort on the
device). The defaults in the source come from these numbers.
"""

from __future__ import annotations

import json
import sys

import torch

from cigwas_tpu_torch import require_cuda
from cigwas_tpu_torch.ops.kernels import hetcor_sweep as hs
from cigwas_tpu_torch.ops.kernels import local_sweep as ls
from cigwas_tpu_torch.utils.stats import hetcor_threshold

THREADS = (64, 128, 192, 256, 320, 384, 512, 768)
CASES = [("local_sweep", 1, 120, 3838), ("hetcor_sweep", 1, 128, 4096),
         ("local_sweep", 2, 64, 5480), ("local_sweep", 3, 48, 5909), ("local_sweep", 2, 128, 512),
         ("local_sweep", 3, 96, 256), ("local_sweep", 3, 24, 8192), ("hetcor_sweep", 2, 48, 2048),
         ("hetcor_sweep", 3, 48, 1024), ("hetcor_sweep", 2, 96, 512)]


# (SWEEP_CHUNK, SWEEP_L1_CHUNK) builds of --loop; the first is the default
CHUNKS = ((2, 24), (1, 8), (2, 8), (4, 8), (2, 16), (4, 16), (2, 32))


def loop_launches(cs) -> dict:
    """{level: (C, node_ixs, nbrs, deg)} of the 11k block's device-resident
    loop (stage 1's, the first at each level), kept from a `cusk` run."""
    import os
    import tempfile

    from cigwas_tpu_torch.pipelines import cusk
    from cigwas_tpu_torch.skeleton import cupc

    tmp = tempfile.mkdtemp()
    G, Y, _ = cs.ar1_block(cs.M11K, cs.N11K, cs.P11K, seed=0)
    stem, blocks = cs.write_block(tmp, G, Y)
    del G
    kept, saved = {}, cupc.local_sweep

    def keep(C, node_ixs, nbrs, deg, l, **kw):
        if l not in kept:
            kept[l] = (C, node_ixs, nbrs, deg)
        return saved(C, node_ixs, nbrs, deg, l, **kw)

    out = os.path.join(tmp, "out")
    os.makedirs(out)
    cupc.local_sweep = keep
    try:
        cusk(stem + ".phen", stem, blocks, cs.ALPHA, cs.MAX_LEVEL, cs.MAX_LEVEL_TWO, cs.DEPTH,
             out, 0, verbose=False, device="cuda")
    finally:
        cupc.local_sweep = saved
    return kept


def tune_loop(cs, smi: str) -> None:
    import ctypes
    from concurrent.futures import ThreadPoolExecutor

    from cigwas_tpu_torch.ops.kernels import build

    defs = [(f"SWEEP_CHUNK={a}", f"SWEEP_L1_CHUNK={b}") for a, b in CHUNKS]
    with ThreadPoolExecutor(len(defs)) as pool:  # one nvcc per build, together
        libs = [ctypes.CDLL(str(p)) for p in pool.map(lambda d: build.build("local_sweep", d),
                                                         defs)]
    kept = loop_launches(cs)
    work_order = ls.work_order
    for l in (1, 2, 3):
        C, node_ixs, nbrs, deg = kept[l]
        d = int(nbrs.shape[1])
        given = work_order(l, deg, d, ls.plan(l, d))
        orders = {"": work_order}
        if given is not None:
            orders.update(_launch_order=lambda *args: None, _order_given=lambda *args: given)
        ms, ref = {}, None
        try:
            for (a, b), lib in zip(CHUNKS, libs):
                build._loaded["local_sweep"] = lib
                for tag, fn in orders.items():
                    ls.work_order = fn
                    run = lambda: ls.local_sweep(  # noqa: E731
                        C, node_ixs, nbrs, deg, l, index_range_checked=True)
                    out = run()
                    ref = out if ref is None else ref
                    assert torch.equal(out[0], ref[0]) and torch.equal(out[1], ref[1]), (l, a, b)
                    ms[f"chunk{a}_l1chunk{b}{tag}"] = cs.cuda_ms(run, reps=5)
        finally:
            ls.work_order = work_order
            build._loaded.pop("local_sweep", None)
        print(json.dumps({"kernel": "local_sweep", "level": l, "nodes": int(nbrs.shape[0]),
                          "width": int(nbrs.shape[1]), "ms": ms, "nvidia_smi": smi}), flush=True)


def main() -> int:
    import chip_smoke as cs  # the kernel checks' panels, lists and timer, at the root

    require_cuda()
    if "--loop" in sys.argv[1:]:
        tune_loop(cs, cs.nvidia_smi())
        return 0
    smi = cs.nvidia_smi()
    rng, vp, Cd, Nd, td = cs.check_panels()
    th = hetcor_threshold(cs.ALPHA)
    for kernel, l, d, nt in CASES:
        lists = cs.neighbour_lists(rng, vp, nt, d, True, lo=d - 7)
        if kernel == "local_sweep":
            module, panels = ls, 1
            run = lambda plan: ls.local_sweep(  # noqa: E731
                Cd, *lists, l, index_range_checked=True, launch_plan=plan)[0]
        else:
            module, panels = hs, 2
            run = lambda plan: hs.hetcor_local_sweep(  # noqa: E731
                Cd, Nd, td, *lists, th, l, index_range_checked=True, launch_plan=plan)
        own = module.plan(l, d)
        ref = run(own)
        variants = {"plan": own}
        if l > 1:
            variants["rows_route"] = cs.rows_plan(module, l, d, panels)
            variants.update({f"threads_{t}": {**own, "threads": t} for t in THREADS})
        ms = {}
        for name, plan in variants.items():
            assert torch.equal(run(plan).view(torch.int32), ref.view(torch.int32)), (kernel, name)
            ms[name] = cs.cuda_ms(lambda: run(plan), reps=5)
        print(json.dumps({"kernel": kernel, "level": l, "width": d, "nodes": nt,
                          "plan_threads": own["threads"], "smem_bytes": own["smem_bytes"],
                          "ms": ms, "nvidia_smi": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
