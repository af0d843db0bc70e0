"""Time the table route of the two sweep kernels over threads per CTA.

    python3 -m cigwas_tpu_torch.tools.tune_sweeps   # from the root of the checkout,
                                                    # on a machine with one NVIDIA card

For bucket-sized launches on the kernel checks' panels of ``chip_smoke.py``
(clustered lists, degrees within 7 of the width, as a degree bucket holds
them) it launches ``local_sweep`` and ``hetcor_sweep`` with the wrapper's own
plan and, at levels 2 and 3, with the plan's threads replaced by each of a
few counts and with the one-thread-per-slot route, checks every variant
against the first bit for bit, and prints one JSON line per case with the device
milliseconds of each (CUDA events, mean of 5 after a warm-up) beside the
card's name and power limit. ``plan()`` in ``ops/kernels/local_sweep.py``
and ``hetcor_sweep.py`` takes its thread counts from these numbers.
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


def main() -> int:
    import chip_smoke as cs  # the kernel checks' panels, lists and timer, at the root

    require_cuda()
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
