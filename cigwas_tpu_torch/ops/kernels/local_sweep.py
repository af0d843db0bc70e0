"""Wrapper of the levels 1-3 sweep kernel ``csrc/local_sweep.cu``.

:func:`local_sweep` launches the CUDA kernel for CUDA tensors and runs the
plain version (:func:`cigwas_tpu_torch.ops.pcorr.local_sweep_plain`) for CPU
tensors; nothing else. The kernel is built at its first launch
(:mod:`cigwas_tpu_torch.ops.kernels.build`), never at import.

A level-3 launch on ROUTE_TABLE takes its nodes by degree, largest first,
in an order sorted on the device from ``deg`` (:func:`work_order`).
"""

from __future__ import annotations

import ctypes

import torch

from cigwas_tpu_torch.ops import pcorr
from cigwas_tpu_torch.ops.kernels import build
from cigwas_tpu_torch.ops.kernels.checks import (
    check_index_range,
    check_int32,
    check_panels,
)

SOURCE = "cigwas_tpu_torch/csrc/local_sweep.cu"
# routes of csrc/sweep_common.cuh
ROUTE_DIRECT, ROUTE_TABLE, ROUTE_ROWS_STAGED, ROUTE_ROWS_L2, ROUTE_ROWS_SCRATCH = range(5)
# dynamic shared memory a CTA may opt in to on sm_90
SMEM_OPT_IN = 232448
# slots of one node a CTA serves at most (DIRECT and ROWS routes)
SLOTS_PER_CTA = 128
# float rows per node: DIRECT (list, Rq, Pq); ROWS (list, q, 7 aux rows);
# TABLE at levels 2 / 3 (list, q, rinv(q); plus four rows per u)
DIRECT_ROWS, WORK_ROWS, TABLE_ROWS = 3, 9, {2: 3, 3: 7}
# kernel launches per level since the last reset; the CPU path adds nothing
launches = {1: 0, 2: 0, 3: 0}


def reset_launches() -> None:
    for l in launches:
        launches[l] = 0


def ceil32(n: int) -> int:
    return -(-n // 32) * 32


def split_slots(d: int) -> tuple[int, int]:
    """(threads, CTAs per node) with one thread per slot y: at most
    SLOTS_PER_CTA slots a CTA, split evenly, rounded up to whole warps."""
    n = -(-d // SLOTS_PER_CTA)
    return ceil32(-(-d // n)), n


def table_bytes(l: int, d: int) -> int:
    """Shared memory of ROUTE_TABLE: d (d - 1) / 2 float4 entries, d 64-bit
    keys, l - 1 panels of row stride d + 1, the rows."""
    return 4 * (2 * d * (d - 1) + 2 * d + (l - 1) * d * (d + 1) + TABLE_ROWS[l] * d)


# shared memory of an SM and what a resident CTA reserves beside its own
SMEM_SM, SMEM_CTA_RESERVED = 233472, 1024
# threads an SM can hold of the table kernels at their register counts
# (65,536 registers over 40 / 48 a thread at levels 2 / 3)
TABLE_THREADS_SM = {2: 1536, 3: 1280}


def table_threads(d: int, smem_bytes: int, threads_sm: int) -> int:
    """Threads of a ROUTE_TABLE CTA. The test loop is a chain of dependent
    IEEE operations, so what counts is resident warps: as many threads as the
    SM's registers hold, shared out over the CTAs that its shared memory
    admits (measured with tools/tune_sweeps.py: 384 at level 2, d = 64, and
    256 at level 3, d = 48, against 128, are 1.8x and 1.4x faster); not more
    than the (t, y) pairs of half a node, not fewer than 128."""
    ctas = max(1, min(32, SMEM_SM // (smem_bytes + SMEM_CTA_RESERVED)))
    threads = max(128, min(1024, threads_sm // ctas // 32 * 32))
    return max(32, min(threads, ceil32(d * d // 2)))


def plan(l: int, d: int) -> dict:
    """The launch plan of level l at bucket width d, as the C launcher takes
    it: route, threads per CTA, nodes per CTA, CTAs per node, dynamic shared
    memory bytes, and floats of global scratch per node.

    Level 1 runs ROUTE_DIRECT (no panel in shared memory; nodes of a narrow
    bucket share a CTA) while the rows fit, d <= 19370. Levels 2-3 run
    ROUTE_TABLE while its tables fit (d <= 138 at level 2, d <= 119 at level
    3), then one thread per slot with the panel in shared memory (d <= 236),
    then the panel through L2. Past d = 6457 the per-slot rows of the ROWS
    routes go to global scratch."""
    if l not in (1, 2, 3) or d < 1:
        raise ValueError(f"local_sweep: no plan for level {l}, width {d}")
    threads, per_node = split_slots(d)
    out = {"route": ROUTE_ROWS_SCRATCH, "threads": threads, "nodes_per_cta": 1,
           "ctas_per_node": per_node, "smem_bytes": 0, "scratch_floats_per_node": 0}
    rows = 4 * WORK_ROWS * d
    if l == 1 and 4 * DIRECT_ROWS * d <= SMEM_OPT_IN:
        npc = max(1, SLOTS_PER_CTA // d)
        out.update(route=ROUTE_DIRECT, nodes_per_cta=npc, smem_bytes=4 * DIRECT_ROWS * d * npc)
        if npc > 1:
            out.update(threads=ceil32(npc * d))
    elif l > 1 and table_bytes(l, d) <= SMEM_OPT_IN:
        out.update(route=ROUTE_TABLE, ctas_per_node=1, smem_bytes=table_bytes(l, d),
                   threads=table_threads(d, table_bytes(l, d), TABLE_THREADS_SM[l]))
    elif l > 1 and rows + 4 * d * (d + 1) <= SMEM_OPT_IN:
        out.update(route=ROUTE_ROWS_STAGED, smem_bytes=rows + 4 * d * (d + 1))
    elif rows <= SMEM_OPT_IN:
        out.update(route=ROUTE_ROWS_L2, smem_bytes=rows)
    else:
        out.update(scratch_floats_per_node=per_node * WORK_ROWS * d)
    return out


def work_order(l: int, deg: torch.Tensor, d: int, pl: dict) -> torch.Tensor | None:
    """The rows' order of a level-3 launch on ROUTE_TABLE, sorted on deg's
    device from the degrees clipped to [0, d] as the kernel clips them: one
    CTA a row, by degree, largest first (equal degrees in launch order),
    those without a test (degree <= 3) last, where their CTA writes only the
    sentinels. A node's work grows as its degree to the fourth, so the CTAs
    that take longest start first and the launch ends on short ones. None
    (launch order) for other levels and routes: at level 2 the degree order
    was slower on the card (PERF.md §6)."""
    if l != 3 or pl["route"] != ROUTE_TABLE:
        return None
    return torch.argsort(deg.clamp(0, d), descending=True, stable=True).to(torch.int32)


def _lib() -> ctypes.CDLL:
    lib = build.load("local_sweep")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.local_sweep_launch.argtypes = [p, ll, p, p, p, i, i, i, i, i, i, i, i, p, p, p, p, p]
    lib.local_sweep_launch.restype = i
    return lib


def local_sweep(C: torch.Tensor, node_ixs: torch.Tensor, nbrs: torch.Tensor,
                deg: torch.Tensor, l: int, *, index_range_checked: bool = False,
                launch_plan: dict | None = None):
    """Min |pcorr(x, y | S)| over |S| = l for every node x and neighbour
    slot y, with the minimizing positions.

    C (vp, vp) f32 panel; node_ixs (nt,), nbrs (nt, d) ascending neighbour
    lists (pad slots hold any valid index), deg (nt,) <= d, all int32.
    Returns rho (nt, d) f32 and pos (nt, d, l) int32 ascending positions
    into the neighbour list; pad slots y >= deg come back as (2.0, 0).

    index_range_checked: the caller has held these lists to
    :func:`~cigwas_tpu_torch.ops.kernels.checks.check_index_range` on the
    host, so the launch does not wait for the device to check them again.
    launch_plan: a plan to launch with instead of ``plan(l, d)`` (a route
    forced at a width it does not own, for comparisons on the card).
    """
    if l not in (1, 2, 3):
        raise ValueError(f"local_sweep serves levels 1-3, got {l}")
    if C.device.type == "cpu":
        return pcorr.local_sweep_plain(C, node_ixs, nbrs, deg, l)
    if C.device.type != "cuda":
        raise ValueError(f"local_sweep: unsupported device {C.device}")
    nt, d = nbrs.shape
    vp = check_panels("local_sweep", C)
    check_int32("local_sweep", C.device, node_ixs=(node_ixs, (nt,)),
                nbrs=(nbrs, (nt, d)), deg=(deg, (nt,)))
    C, node_ixs, nbrs, deg = (t.contiguous() for t in (C, node_ixs, nbrs, deg))
    rho = torch.empty((nt, d), dtype=torch.float32, device=C.device)
    pos = torch.empty((nt, d, l), dtype=torch.int32, device=C.device)
    if nt == 0 or d == 0:
        return rho, pos
    if not index_range_checked:
        check_index_range("local_sweep", vp, d, node_ixs, nbrs, deg)
    lib = _lib()
    pl = launch_plan or plan(l, d)
    n_scratch = nt * pl["scratch_floats_per_node"]
    scratch = (
        torch.empty(n_scratch, dtype=torch.float32, device=C.device)
        if n_scratch else None
    )
    with torch.cuda.device(C.device):
        order = work_order(l, deg, d, pl)
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.local_sweep_launch(
            C.data_ptr(), vp, node_ixs.data_ptr(), nbrs.data_ptr(),
            deg.data_ptr(), nt, d, l, pl["route"], pl["threads"],
            pl["nodes_per_cta"], pl["ctas_per_node"], pl["smem_bytes"],
            scratch.data_ptr() if scratch is not None else None,
            order.data_ptr() if order is not None else None,
            rho.data_ptr(), pos.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"local_sweep kernel launch failed: cudaError {err}, plan {pl}")
    launches[l] += 1
    return rho, pos
