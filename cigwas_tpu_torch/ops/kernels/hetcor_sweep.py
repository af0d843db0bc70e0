"""Wrappers of the hetcor kernels: the levels 1-3 sweep ``csrc/hetcor_sweep.cu``
and the combinatorial scan ``csrc/hetcor_scan.cu``.

:func:`hetcor_local_sweep` and :func:`hetcor_scan` launch their CUDA kernels
for CUDA tensors and run the plain versions
(:func:`cigwas_tpu_torch.ops.pcorr.hetcor_local_sweep_plain`,
:func:`cigwas_tpu_torch.ops.pcorr.level_scan_hetcor_pre`) for CPU tensors;
nothing else. The kernels are built at their first launch
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
SCAN_SOURCE = "cigwas_tpu_torch/csrc/hetcor_scan.cu"
# float rows per node: DIRECT (list, Rq, Pq, raw N[x, .], time index); ROWS
# (list, q, N[x, .], time index, 9 aux rows); TABLE at levels 2 / 3 (list, q,
# rinv(q), N[x, .], time index, keys; plus five rows per u)
DIRECT_ROWS, WORK_ROWS, TABLE_ROWS = 5, 13, {2: 6, 3: 11}
# floats of one warp's transposing tile of N at level 1
TILE = 32 * 33
# threads an SM can hold of the table kernels at their register counts
# (65,536 registers over 46 / 55 a thread at levels 2 / 3)
TABLE_THREADS_SM = {2: 1408, 3: 1152}
# the scan's threads per CTA (it launches with __launch_bounds__(256))
SCAN_THREADS = 256
# dynamic shared memory up to which the scan stages its node's panels, rows
# and minima: two CTAs an SM; wider panels are read through L2
SCAN_PANEL_SMEM = 100 * 1024
# CTAs a scan launch aims at (four an SM), and the sets a warp takes at least
SCAN_CTAS, SCAN_MIN_SETS = 4 * 132, 4
# kernel launches since the last reset: the sweep's per level, the scan's
# under "hetcor_scan"; the CPU path adds nothing
launches = {1: 0, 2: 0, 3: 0, "hetcor_scan": 0}


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


def _scan_smem_floats(l: int, d: int, warps: int, staged: bool) -> int:
    """Floats of the scan's shared memory (``scan_smem_floats`` in the
    source): per warp the inverse's l x l tile; staged, also both panels at
    row stride d + 1, three rows and per warp a row of running minima."""
    return warps * l * l + (2 * d * (d + 1) + 3 * d + warps * d if staged else 0)


def scan_plan(l: int, d: int) -> dict:
    """The launch plan of the scan at level l and bucket width d: threads
    per CTA, whether the node's panels, rows and the warps' minima are
    staged in shared memory, and the dynamic shared memory bytes. They are
    staged while that stays within SCAN_PANEL_SMEM (d <= 106 at level 14,
    109 at level 4); wider, the panels and rows are read through L2 and the
    minima kept in global scratch, so every width has a plan."""
    if not 1 <= l <= 14 or d < 1:
        raise ValueError(f"hetcor_scan: no plan for level {l}, width {d}")
    warps = SCAN_THREADS // 32
    staged = 4 * _scan_smem_floats(l, d, warps, True) <= SCAN_PANEL_SMEM
    return {"threads": SCAN_THREADS, "staged": staged,
            "smem_bytes": 4 * _scan_smem_floats(l, d, warps, staged)}


def scan_ctas_per_node(nt: int, nsets: int) -> int:
    """CTAs that share a node's sets: enough that the launch has about
    SCAN_CTAS of them, never so many that a warp gets fewer than
    SCAN_MIN_SETS sets, within the grid's 65,535."""
    by_card = -(-SCAN_CTAS // max(1, nt))
    by_sets = -(-nsets // (SCAN_THREADS // 32 * SCAN_MIN_SETS))
    return max(1, min(by_card, by_sets, 65535))


def _scan_lib() -> ctypes.CDLL:
    lib = build.load("hetcor_scan")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.hetcor_scan_launch.argtypes = [p, p, p, p, p, p, p, p, p, i, i, i, i, i, f,
                                       i, i, i, i, p, p, p]
    lib.hetcor_scan_launch.restype = i
    return lib


def hetcor_scan(C_x: torch.Tensor, c_row: torch.Tensor, N_x: torch.Tensor,
                n_row: torch.Tensor, t_nbrs: torch.Tensor, t_x: torch.Tensor,
                deg: torch.Tensor, combos_seq: torch.Tensor, left_seq: torch.Tensor,
                th: float, l: int) -> torch.Tensor:
    """The hetcor combinatorial scan of one node tile and one wave: the
    minimum margin over the wave's conditioning sets for every node and
    neighbour slot, (nt, d) f32 (see
    :func:`cigwas_tpu_torch.ops.pcorr.level_scan_hetcor_pre`, its plain
    version, which CPU tensors run).

    C_x, N_x (nt, d, d), c_row, n_row, t_nbrs (nt, d) and t_x (nt,) float32:
    the gathered panels (:func:`~cigwas_tpu_torch.ops.kernels.panel_gather.
    gather_local_panels2`) and time indices; deg (nt,) int32; combos_seq
    (nch, K, l) int64 colex positions, left_seq (nch, nt) int64 the sets of
    each chunk per node; th the scalar |Phi^-1(alpha / 2)|; l in 1..14. A
    CUDA tensor launches ``csrc/hetcor_scan.cu`` once (``launches
    ["hetcor_scan"]``); there is no other route on the card."""
    nt, d = c_row.shape
    nch, K = combos_seq.shape[:2]
    dev = c_row.device
    named = {"C_x": (C_x, torch.float32, (nt, d, d)), "c_row": (c_row, torch.float32, (nt, d)),
             "N_x": (N_x, torch.float32, (nt, d, d)), "n_row": (n_row, torch.float32, (nt, d)),
             "t_nbrs": (t_nbrs, torch.float32, (nt, d)), "t_x": (t_x, torch.float32, (nt,)),
             "deg": (deg, torch.int32, (nt,)), "combos_seq": (combos_seq, torch.int64, (nch, K, l)),
             "left_seq": (left_seq, torch.int64, (nch, nt))}
    for name, (t, dtype, shape) in named.items():
        if t.dtype != dtype or tuple(t.shape) != shape or t.device != dev:
            raise ValueError(f"hetcor_scan: {name} must be {dtype} {shape} on {dev}")
    if dev.type == "cpu":
        return pcorr.level_scan_hetcor_pre(C_x, c_row, N_x, n_row, t_nbrs, t_x, deg,
                                           combos_seq, left_seq, th, l)
    if dev.type != "cuda":
        raise ValueError(f"hetcor_scan: unsupported device {dev}")
    pl = scan_plan(l, d)
    margin = torch.full((nt, d), pcorr.MARGIN_BIG, dtype=torch.float32, device=dev)
    if nt == 0:
        return margin
    ctas = scan_ctas_per_node(nt, nch * K)
    mins = None if pl["staged"] else torch.empty(
        nt * ctas * pl["threads"] // 32 * d, dtype=torch.float32, device=dev)
    args = [t.contiguous() for t in (C_x, c_row, N_x, n_row, t_nbrs, t_x, deg, combos_seq,
                                     left_seq)]
    lib = _scan_lib()
    with torch.cuda.device(dev):
        err = lib.hetcor_scan_launch(
            *(t.data_ptr() for t in args), nt, d, nch, K, l, float(th), pl["threads"], ctas,
            int(pl["staged"]), pl["smem_bytes"], mins.data_ptr() if mins is not None else None,
            margin.data_ptr(), torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"hetcor_scan kernel launch failed: cudaError {err}, plan {pl}")
    launches["hetcor_scan"] += 1
    return margin
