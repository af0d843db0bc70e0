"""Wrapper of the hetcor levels 1-3 kernel ``csrc/hetcor_sweep.cu``.

:func:`hetcor_local_sweep` launches the CUDA kernel for CUDA tensors and runs
the plain version (:func:`cigwas_tpu_torch.ops.pcorr.hetcor_local_sweep_plain`)
for CPU tensors; nothing else. The kernel is built at its first launch
(:mod:`cigwas_tpu_torch.ops.kernels.build`), never at import.
"""

from __future__ import annotations

import ctypes

import torch

from cigwas_tpu_torch.ops import pcorr
from cigwas_tpu_torch.ops.kernels import build
from cigwas_tpu_torch.ops.kernels.local_sweep import (
    ROUTE_DIRECT,
    ROUTE_ROWS_L2,
    ROUTE_ROWS_SCRATCH,
    ROUTE_ROWS_STAGED,
    ROUTE_TABLE,
    SLOTS_PER_CTA,
    SMEM_OPT_IN,
    ceil32,
    split_slots,
    table_threads,
)
from cigwas_tpu_torch.ops.kernels.checks import (
    check_index_range,
    check_int32,
    check_panels,
)

SOURCE = "cigwas_tpu_torch/csrc/hetcor_sweep.cu"
# float rows per node: DIRECT (list, Rq, Pq, raw N[x, .], time index); ROWS
# (list, q, N[x, .], time index, 9 aux rows); TABLE at levels 2 / 3 (list, q,
# rinv(q), N[x, .], time index, keys; plus five rows per u)
DIRECT_ROWS, WORK_ROWS, TABLE_ROWS = 5, 13, {2: 6, 3: 11}
# floats of one warp's transposing tile of N at level 1
TILE = 32 * 33
# threads an SM can hold of the table kernels at their register counts
# (65,536 registers over 46 / 55 a thread at levels 2 / 3)
TABLE_THREADS_SM = {2: 1408, 3: 1152}
# kernel launches per level since the last reset; the CPU path adds nothing
launches = {1: 0, 2: 0, 3: 0}


def reset_launches() -> None:
    for l in launches:
        launches[l] = 0


def table_bytes(l: int, d: int) -> int:
    """Shared memory of ROUTE_TABLE: d (d - 1) / 2 float4 entries, the panels
    of C and N (and at level 3 the conditioned one) of row stride d + 1, the
    rows."""
    return 4 * (2 * d * (d - 1) + l * d * (d + 1) + TABLE_ROWS[l] * d)


def plan(l: int, d: int) -> dict:
    """The launch plan of level l at bucket width d, as the C launcher takes
    it: route, threads per CTA, nodes per CTA, CTAs per node, dynamic shared
    memory bytes, and floats of global scratch per node.

    Level 1 runs ROUTE_DIRECT (no panel in shared memory, one transposing
    tile per warp; nodes of a narrow bucket share a CTA) while rows and tiles
    fit, d <= 10777. Levels 2-3 run ROUTE_TABLE while its tables fit (d <= 119
    at level 2, d <= 106 at level 3), then one thread per slot with both
    panels in shared memory (d <= 166), then the panels through L2. Past
    d = 4470 the per-slot rows of the ROWS routes go to global scratch."""
    if l not in (1, 2, 3) or d < 1:
        raise ValueError(f"hetcor_local_sweep: no plan for level {l}, width {d}")
    threads, per_node = split_slots(d)
    out = {"route": ROUTE_ROWS_SCRATCH, "threads": threads, "nodes_per_cta": 1,
           "ctas_per_node": per_node, "smem_bytes": 0, "scratch_floats_per_node": 0}
    rows = 4 * WORK_ROWS * d
    npc = max(1, SLOTS_PER_CTA // d)
    direct_threads = ceil32(npc * d) if npc > 1 else threads
    direct = 4 * (DIRECT_ROWS * d * npc + direct_threads // 32 * TILE)
    if l == 1 and direct <= SMEM_OPT_IN:
        out.update(route=ROUTE_DIRECT, nodes_per_cta=npc, threads=direct_threads,
                   smem_bytes=direct)
    elif l > 1 and table_bytes(l, d) <= SMEM_OPT_IN:
        out.update(route=ROUTE_TABLE, ctas_per_node=1, smem_bytes=table_bytes(l, d),
                   threads=table_threads(d, table_bytes(l, d), TABLE_THREADS_SM[l]))
    elif l > 1 and rows + 8 * d * (d + 1) <= SMEM_OPT_IN:
        out.update(route=ROUTE_ROWS_STAGED, smem_bytes=rows + 8 * d * (d + 1))
    elif rows <= SMEM_OPT_IN:
        out.update(route=ROUTE_ROWS_L2, smem_bytes=rows)
    else:
        out.update(scratch_floats_per_node=per_node * WORK_ROWS * d)
    return out


def _lib() -> ctypes.CDLL:
    lib = build.load("hetcor_sweep")
    p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    lib.hetcor_sweep_launch.argtypes = [p, p, p, ll, p, p, p, i, i, i, f,
                                        i, i, i, i, i, p, p, p]
    lib.hetcor_sweep_launch.restype = i
    return lib


def hetcor_local_sweep(C: torch.Tensor, N: torch.Tensor, t_ix: torch.Tensor,
                       node_ixs: torch.Tensor, nbrs: torch.Tensor,
                       deg: torch.Tensor, th: float, l: int, *,
                       index_range_checked: bool = False,
                       launch_plan: dict | None = None) -> torch.Tensor:
    """Min hetcor margin |pcorr(x, y | S)| - tanh(th / sqrt(mean_ess - l - 3))
    over |S| = l for every node x and neighbour slot y.

    C, N (vp, vp) f32 correlation and per-pair ESS panels (N raw or truncated,
    NaN = no estimate); t_ix (vp,), node_ixs (nt,), nbrs (nt, d) ascending
    neighbour lists (pad slots hold any valid index), deg (nt,) <= d, all
    int32; th the scalar |Phi^-1(alpha / 2)|. Returns margin (nt, d) f32:
    negative where some allowed S separates x and y; 3.0e38 at pad slots
    y >= deg and where no test is valid.

    index_range_checked: the caller has held these lists to
    :func:`~cigwas_tpu_torch.ops.kernels.checks.check_index_range` on the
    host, so the launch does not wait for the device to check them again.
    launch_plan: a plan to launch with instead of ``plan(l, d)`` (a route
    forced at a width it does not own, for comparisons on the card).
    """
    if l not in (1, 2, 3):
        raise ValueError(f"hetcor_local_sweep serves levels 1-3, got {l}")
    if C.device.type == "cpu":
        return pcorr.hetcor_local_sweep_plain(C, N, t_ix, node_ixs, nbrs, deg, th, l)
    if C.device.type != "cuda":
        raise ValueError(f"hetcor_local_sweep: unsupported device {C.device}")
    nt, d = nbrs.shape
    vp = check_panels("hetcor_local_sweep", C, N=N)
    check_int32("hetcor_local_sweep", C.device, t_ix=(t_ix, (vp,)),
                node_ixs=(node_ixs, (nt,)), nbrs=(nbrs, (nt, d)), deg=(deg, (nt,)))
    C, N, t_ix, node_ixs, nbrs, deg = (
        t.contiguous() for t in (C, N, t_ix, node_ixs, nbrs, deg))
    margin = torch.empty((nt, d), dtype=torch.float32, device=C.device)
    if nt == 0 or d == 0:
        return margin
    if not index_range_checked:
        check_index_range("hetcor_local_sweep", vp, d, node_ixs, nbrs, deg)
    lib = _lib()
    pl = launch_plan or plan(l, d)
    n_scratch = nt * pl["scratch_floats_per_node"]
    scratch = (
        torch.empty(n_scratch, dtype=torch.float32, device=C.device)
        if n_scratch else None
    )
    with torch.cuda.device(C.device):
        err = lib.hetcor_sweep_launch(
            C.data_ptr(), N.data_ptr(), t_ix.data_ptr(), vp, node_ixs.data_ptr(),
            nbrs.data_ptr(), deg.data_ptr(), nt, d, l, float(th), pl["route"],
            pl["threads"], pl["nodes_per_cta"], pl["ctas_per_node"], pl["smem_bytes"],
            scratch.data_ptr() if scratch is not None else None,
            margin.data_ptr(), torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"hetcor_sweep kernel launch failed: cudaError {err}, plan {pl}")
    launches[l] += 1
    return margin
