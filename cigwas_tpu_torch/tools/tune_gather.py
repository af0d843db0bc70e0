"""Time the gather kernel's row design over the shape of its launch.

    python3 -m cigwas_tpu_torch.tools.tune_gather   # from the root of the checkout,
                                                    # on a machine with one NVIDIA card

For bucket-sized launches on the kernel checks' panels of ``chip_smoke.py``
(2048 nodes, clustered lists) it launches ``panel_gather`` with the wrapper's
own plan and with the plan's rows per CTA, threads and nodes per CTA
replaced by each of a few values, checks every
variant against the first bit for bit, and prints one JSON line per case with
the kernel's device milliseconds (torch.profiler's kernel records, mean of
20) beside the card's name and power limit. ``plan()`` in
``ops/kernels/panel_gather.py`` takes CTA_ELEMS, MAX_WARPS and MIN_ROWS from
these numbers.
"""

from __future__ import annotations

import json
import sys

import torch

from cigwas_tpu_torch import require_cuda
from cigwas_tpu_torch.ops.kernels import panel_gather as pg

# (width, panels)
CASES = [(128, 2), (128, 1), (48, 2), (50, 2), (16, 2), (256, 2)]
ROWS = (8, 13, 17, 26, 33, 43, 65, 129, 257)
THREADS = (64, 128, 256, 512, 1024)
NODES = (2, 4, 8, 16, 32)


def variants(d: int, panels: int) -> dict:
    own = pg.plan(d, panels)
    out = {"plan": own}
    if own["nodes_per_cta"] == 1:
        out.update({f"rows_{r}": {**own, "rows_per_cta": r} for r in ROWS if r <= d + 1})
        out.update({f"whole_node_threads_{t}": {**own, "rows_per_cta": d + 1, "threads": t}
                    for t in THREADS})
    d4 = -(-d // 4) * 4
    out.update({f"threads_{t}": {**own, "threads": t} for t in THREADS})
    if (d + 1) * d * panels <= 8192:
        out.update({f"nodes_{n}": {**own, "nodes_per_cta": n, "rows_per_cta": d + 1,
                                   "threads": 32 * min(n, 8), "smem_bytes": 4 * n * d4}
                    for n in NODES})
    return out


def main() -> int:
    import chip_smoke as cs  # the kernel checks' panels, lists and timers, at the root

    require_cuda()
    smi = cs.nvidia_smi()
    rng, vp, Cd, Nd, _ = cs.check_panels()
    for d, panels in CASES:
        lists = cs.neighbour_lists(rng, vp, 2048, d, True)
        tensors = (Cd, Nd) if panels == 2 else (Cd,)
        kern = pg.gather_local_panels2 if panels == 2 else pg.gather_local_panels
        run = lambda plan: kern(*tensors, *lists, index_range_checked=True,  # noqa: E731
                                launch_plan=plan)
        ref = run(None)
        ms = {}
        for name, plan in variants(d, panels).items():
            for got, exp in zip(run(plan), ref):
                assert torch.equal(got.view(torch.int32), exp.view(torch.int32)), (d, panels, name)
            ms[name] = cs.kernel_device_ms(lambda: run(plan), 20,
                                             "panel_rows_kernel")["device_ms"]
        print(json.dumps({"width": d, "panels": panels, "nodes": 2048,
                          "plan": pg.plan(d, panels), **cs.gather_bound(*lists, vp, panels),
                          "device_ms": ms, "nvidia_smi": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
