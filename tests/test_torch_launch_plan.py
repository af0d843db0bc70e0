"""The launch plans of the sweep kernels and of the gather, checked without
a card.

``local_sweep.plan(l, d)`` and ``hetcor_sweep.plan(l, d)`` choose, in Python,
everything a launch of ``csrc/local_sweep.cu`` / ``csrc/hetcor_sweep.cu``
is shaped by: the route, the threads per CTA, how many nodes share a CTA or
how many CTAs share a node, the dynamic shared memory and the global
scratch. The C launchers take the plan as it is and refuse one that does not
fit its route, so a plan that is wrong here is a refused launch on the card.
For every level and every bucket width d in 1..7000 (and a few far beyond)
the plan must be launchable on sm_90 (threads a multiple of 32 and at most
1024, shared memory within the 232,448-byte opt-in limit and at least what
the route's layout needs), cover every slot y < d, and change route exactly
at the stated widths. ``panel_gather.plan(d, panels)`` is held to the
launcher of ``csrc/panel_gather.cu`` likewise, for every width 1..13000, and
``dense_l1.plan(entry, nx, ny, vp)`` to the launcher of ``csrc/dense_l1.cu`` for
the slabs of the skeleton's sweeps and of the engines' rings, and
``hetcor_sweep.scan_plan(l, d)`` to the launcher of ``csrc/hetcor_scan.cu``
at every level 1-14.
"""

import numpy as np
import pytest
import torch

from cigwas_tpu_torch.ops.kernels import dense_l1 as dk
from cigwas_tpu_torch.ops.kernels import hetcor_sweep as hs
from cigwas_tpu_torch.ops.kernels import local_sweep as ls
from cigwas_tpu_torch.ops.kernels import panel_gather as pg
from cigwas_tpu_torch.ops.kernels.local_sweep import (
    ROUTE_DIRECT,
    ROUTE_ROWS_L2,
    ROUTE_ROWS_SCRATCH,
    ROUTE_ROWS_STAGED,
    ROUTE_TABLE,
    SMEM_OPT_IN,
)

KERNELS = {"local_sweep": (ls, 1), "hetcor_sweep": (hs, 2)}
# route -> last width d it serves, per kernel and level (the widths the
# kernel notes and the plans' docstrings state)
LIMITS = {
    ("local_sweep", 1): [(ROUTE_DIRECT, 19370), (ROUTE_ROWS_SCRATCH, None)],
    ("local_sweep", 2): [(ROUTE_TABLE, 138), (ROUTE_ROWS_STAGED, 236), (ROUTE_ROWS_L2, 6456),
                         (ROUTE_ROWS_SCRATCH, None)],
    ("local_sweep", 3): [(ROUTE_TABLE, 119), (ROUTE_ROWS_STAGED, 236), (ROUTE_ROWS_L2, 6456),
                         (ROUTE_ROWS_SCRATCH, None)],
    ("hetcor_sweep", 1): [(ROUTE_DIRECT, 10777), (ROUTE_ROWS_SCRATCH, None)],
    ("hetcor_sweep", 2): [(ROUTE_TABLE, 119), (ROUTE_ROWS_STAGED, 166), (ROUTE_ROWS_L2, 4470),
                          (ROUTE_ROWS_SCRATCH, None)],
    ("hetcor_sweep", 3): [(ROUTE_TABLE, 106), (ROUTE_ROWS_STAGED, 166), (ROUTE_ROWS_L2, 4470),
                          (ROUTE_ROWS_SCRATCH, None)],
}
RANGES = [(1, 64), (65, 256), (257, 1024), (1025, 3000), (3001, 5000), (5001, 7000)]


def _needed(module, panels: int, l: int, d: int, p: dict) -> int:
    """Shared memory the route's layout takes, as the C launcher counts it."""
    if p["route"] == ROUTE_DIRECT:
        tiles = p["threads"] // 32 * hs.TILE if panels == 2 else 0
        return 4 * (p["nodes_per_cta"] * module.DIRECT_ROWS * d + tiles)
    if p["route"] == ROUTE_TABLE:
        return module.table_bytes(l, d)
    if p["route"] == ROUTE_ROWS_STAGED:
        return 4 * (module.WORK_ROWS * d + panels * d * (d + 1))
    if p["route"] == ROUTE_ROWS_L2:
        return 4 * module.WORK_ROWS * d
    return 0


def _check(kernel: str, l: int, d: int) -> None:
    module, panels = KERNELS[kernel]
    p = module.plan(l, d)
    where = f"{kernel} l={l} d={d}: {p}"
    assert 32 <= p["threads"] <= 1024 and p["threads"] % 32 == 0, where
    assert 0 <= p["smem_bytes"] <= SMEM_OPT_IN, where
    assert p["smem_bytes"] >= _needed(module, panels, l, d, p), where
    assert p["nodes_per_cta"] >= 1 and p["ctas_per_node"] >= 1, where
    # every slot y < d has a thread (the table route loops over them)
    if p["route"] == ROUTE_TABLE:
        assert l > 1 and p["ctas_per_node"] == 1 and p["nodes_per_cta"] == 1 and d < 1024, where
    elif p["nodes_per_cta"] > 1:
        assert p["route"] == ROUTE_DIRECT and p["ctas_per_node"] == 1, where
        assert p["nodes_per_cta"] * d <= p["threads"], where
    else:
        assert p["ctas_per_node"] * p["threads"] >= d, where
        assert (p["ctas_per_node"] - 1) * p["threads"] < d, where  # no CTA without a slot
    if p["route"] == ROUTE_DIRECT:
        assert l == 1, where
    if p["route"] == ROUTE_ROWS_STAGED:
        assert l > 1, where  # level 1 never stages a (d, d) panel
    assert (p["scratch_floats_per_node"] > 0) == (p["route"] == ROUTE_ROWS_SCRATCH), where
    if p["route"] == ROUTE_ROWS_SCRATCH:
        assert p["scratch_floats_per_node"] == p["ctas_per_node"] * module.WORK_ROWS * d, where
    lo = 1
    for route, last in LIMITS[(kernel, l)]:
        if last is None or d <= last:
            assert p["route"] == route, f"{where}: expected route {route} for d in [{lo}, {last}]"
            break
        lo = last + 1


@pytest.mark.parametrize("d_range", RANGES, ids=[f"d{a}-{b}" for a, b in RANGES])
@pytest.mark.parametrize("l", [1, 2, 3])
@pytest.mark.parametrize("kernel", sorted(KERNELS))
def test_plan_is_launchable_for_every_width(kernel, l, d_range):
    for d in range(d_range[0], d_range[1] + 1):
        _check(kernel, l, d)


@pytest.mark.parametrize("l", [1, 2, 3])
@pytest.mark.parametrize("kernel", sorted(KERNELS))
def test_plan_switches_route_exactly_at_the_limits(kernel, l):
    module, _ = KERNELS[kernel]
    for (route, last), (next_route, _) in zip(LIMITS[(kernel, l)], LIMITS[(kernel, l)][1:]):
        assert module.plan(l, last)["route"] == route
        assert module.plan(l, last + 1)["route"] == next_route
        _check(kernel, l, last)
        _check(kernel, l, last + 1)
    for d in (12000, 20000, 40000):  # wider than any block: still launchable
        _check(kernel, l, d)


@pytest.mark.parametrize("kernel", sorted(KERNELS))
def test_narrow_level1_buckets_share_a_cta(kernel):
    """Bucket widths are multiples of 8: up to d = 64 at least two nodes share
    a CTA at level 1 and no more than a warp's worth of its lanes is idle."""
    module, _ = KERNELS[kernel]
    for d in range(8, 129, 8):
        p = module.plan(1, d)
        assert p["nodes_per_cta"] == 128 // d
        assert p["threads"] - p["nodes_per_cta"] * d < 32
    assert module.plan(1, 40)["nodes_per_cta"] == 3 and module.plan(1, 40)["threads"] == 128


@pytest.mark.parametrize("kernel", sorted(KERNELS))
def test_plan_refuses_what_the_kernel_does_not_serve(kernel):
    module, _ = KERNELS[kernel]
    for l, d in ((0, 8), (4, 8), (1, 0), (2, -3)):
        with pytest.raises(ValueError):
            module.plan(l, d)


def _mixed_degrees(seed: int, nt: int, d: int, l: int):
    """Degrees as a loop launch holds them: rows without a test (0 .. l),
    one hub at the full width, the rest ragged."""
    rng = np.random.default_rng(seed)
    deg = rng.integers(0, d + 1, nt)
    deg[: 2 * (l + 1)] = np.repeat(np.arange(l + 1), 2)
    deg[-1] = d
    return rng.permutation(deg)


@pytest.mark.parametrize("d", [8, 56, 119])
def test_work_order_takes_every_row_once_heavy_first_testless_last(d):
    """A level-3 launch on the table route, sorted from its degrees on their
    own device: one CTA a row, every row once, by degree, largest first
    (equal degrees in launch order), the rows without a test (degree <= 3)
    last, where their CTA writes only the sentinels; degrees past d count as
    d, as the kernel clips them."""
    deg = _mixed_degrees(d, 700, d, 3)
    deg[0] = d + 5
    pl = ls.plan(3, d)
    assert pl["route"] == ROUTE_TABLE
    order = ls.work_order(3, torch.from_numpy(deg.astype(np.int32)), d, pl)
    assert order.dtype == torch.int32 and order.device.type == "cpu"
    order = order.numpy()
    assert sorted(order.tolist()) == list(range(len(deg)))
    g = np.minimum(deg, d)[order]
    assert np.all(np.diff(g) <= 0)
    live = int((deg > 3).sum())
    assert np.all(g[:live] > 3) and np.all(g[live:] <= 3)
    for v in np.unique(g):
        assert np.all(np.diff(order[g == v]) > 0)


def test_work_order_keeps_launch_order_elsewhere():
    """Levels 1-2, and level 3 past the table route, keep the launch's own
    order (no order is sorted)."""
    deg = torch.from_numpy(_mixed_degrees(0, 50, 56, 2).astype(np.int32))
    assert ls.work_order(1, deg, 152, ls.plan(1, 152)) is None
    assert ls.work_order(2, deg, 80, ls.plan(2, 80)) is None
    assert ls.work_order(3, deg, 200, ls.plan(3, 200)) is None


# --- panel_gather -------------------------------------------------------------

GATHER_RANGES = [(1, 256), (257, 2048), (2049, 6000), (6001, 13000)]


def _check_gather(d: int, panels: int) -> None:
    """What `launch` of csrc/panel_gather.cu refuses, and what the kernel
    needs to cover every row once."""
    p = pg.plan(d, panels)
    where = f"panel_gather d={d} panels={panels}: {p}"
    rows, d4 = d + 1, -(-d // 4) * 4
    assert p["route"] == pg.ROUTE_ROWS, where
    assert 32 <= p["threads"] <= 1024 and p["threads"] % 32 == 0, where
    assert p["nodes_per_cta"] >= 1 and p["rows_per_cta"] >= 1, where
    assert 0 <= p["smem_bytes"] <= pg.SMEM_OPT_IN, where
    assert p["staged"] == 1, where  # every list up to d = 58112 fits the opt-in limit
    assert p["smem_bytes"] >= 4 * p["nodes_per_cta"] * d4, where
    warps = p["threads"] // 32
    if p["nodes_per_cta"] > 1:
        # whole nodes, a warp each, no warp without a node in a full CTA
        assert p["rows_per_cta"] == rows and warps <= p["nodes_per_cta"], where
        assert 2 * p["nodes_per_cta"] * rows * d * panels <= pg.CTA_ELEMS, where
    else:
        ctas = -(-rows // p["rows_per_cta"])
        assert (ctas - 1) * p["rows_per_cta"] < rows <= ctas * p["rows_per_cta"], where
        # a run repays staging the list, unless the node has fewer rows
        assert p["rows_per_cta"] >= min(rows, pg.MIN_ROWS), where
        # a bucket of 16,384 nodes stays within the grid limit
        assert 16384 * ctas <= 2**31 - 1, where
        lanes_row = min(32, d // 4 if d % 4 == 0 else d)
        assert warps <= max(1, -(-p["rows_per_cta"] // (32 // lanes_row))), where


@pytest.mark.parametrize("d_range", GATHER_RANGES, ids=[f"d{a}-{b}" for a, b in GATHER_RANGES])
@pytest.mark.parametrize("panels", [1, 2])
def test_gather_plan_is_launchable_for_every_width(panels, d_range):
    for d in range(d_range[0], d_range[1] + 1):
        _check_gather(d, panels)


def test_gather_plan_shares_and_splits_at_the_stated_widths():
    """Narrow nodes share a CTA up to d = 44 (one panel) and 31 (two); the
    lists leave shared memory only past d = 58112; the main paths' 8-node
    launches are one or two CTAs."""
    assert pg.plan(44, 1)["nodes_per_cta"] == 2 and pg.plan(45, 1)["nodes_per_cta"] == 1
    assert pg.plan(31, 2)["nodes_per_cta"] == 2 and pg.plan(32, 2)["nodes_per_cta"] == 1
    assert pg.plan(8, 1)["nodes_per_cta"] >= 8 and pg.plan(16, 2)["nodes_per_cta"] == 7
    assert pg.plan(128, 2)["rows_per_cta"] == 26  # 129 rows over 5 CTAs
    assert pg.plan(58112, 1)["staged"] == 1 and pg.plan(58112, 1)["smem_bytes"] == 232448
    assert pg.plan(58113, 1) == {**pg.plan(58113, 1), "staged": 0, "smem_bytes": 0}
    for d in (20000, 58112, 58113, 100000):
        p = pg.plan(d, 2)
        assert p["rows_per_cta"] == pg.MIN_ROWS and p["threads"] == 256


def test_gather_plan_refuses_what_the_kernel_does_not_serve():
    for d, panels in ((0, 1), (-4, 2), (8, 0), (8, 3)):
        with pytest.raises(ValueError):
            pg.plan(d, panels)


# --- dense_l1 -----------------------------------------------------------------


def _check_dense(entry: str, nx: int, ny: int, vp: int) -> None:
    """What the launchers of csrc/dense_l1.cu refuse or need: the compiled
    block shapes (dense_l1 32 warps, a warp per x row, and 128 y; hetcor 8
    warps, a group of 8 x rows and 64 y), a grid that covers every (x, y) once (dense_l1's
    x CTAs first, hetcor's y CTAs first), grid.y within its limit, the pre-passes' grids (dense_l1 a warp per x row, 8 a CTA;
    hetcor a CTA of 1024 threads per group, each holding at most 16
    segments of 16 mask bytes), shared memory equal to the kernels' layouts
    (none for dense_l1; hetcor two chunks of 32 staged s of R, P and N, the
    per-warp queues and slots), within the opt-in limit and small enough
    that three hetcor CTAs fit an SM's 228 KB (1 KB reserved each)."""
    p = dk.plan(entry, nx, ny, vp)
    where = f"dense_l1 {entry} {nx} x {ny} of {vp}: {p}"
    het = entry == "hetcor_dense_l1"
    rows, cols = (8, 64) if het else (32, 128)
    threads = 256 if het else 1024
    assert p["threads"] == threads and p["rows_per_cta"] == rows and p["cols_per_cta"] == cols, where
    gx, gy = p["grid"]
    y_ctas, x_ctas = (gx, gy) if het else (gy, gx)
    assert (y_ctas - 1) * cols < ny <= y_ctas * cols, where
    assert (x_ctas - 1) * rows < nx <= x_ctas * rows, where
    assert 1 <= gy <= dk.GRID_Y_MAX and gx <= 2**31 - 1, where
    if het:
        assert p["prepass_grid"] == x_ctas and p["prepass_threads"] == 1024, where
        assert -(-(-(-vp // 16)) // 1024) <= 16, where
    else:
        assert (p["prepass_grid"] - 1) * 8 < nx <= p["prepass_grid"] * 8, where
        assert p["prepass_threads"] == 256, where
    want = 2 * 3 * 32 * 64 * 4 + 8 * (16 * 96 + 8 * 64) if het else 0
    assert p["smem_bytes"] == want <= 232448, where
    assert 3 * (p["smem_bytes"] + 1024) <= 233472, where


@pytest.mark.parametrize("entry", ["dense_l1", "hetcor_dense_l1"])
def test_dense_plan_is_launchable_for_the_main_paths_slabs(entry):
    """One card's slabs (ROWS x-rows, the last one ragged, against every y of
    panels up to 16,384 and beyond), the replicated engine's (the same rows
    of a shard's stripe) and the ring's (a stripe of vp / D columns), and
    ragged edges (x and y counts that are no multiple of the CTA's)."""
    for vp in (128, 1536, 2528, 3070, 10112, 11008, 12288, 16384, 65536, 262144):
        for nx in sorted({1, 7, 33, dk.ROWS - 1, dk.ROWS, vp % dk.ROWS or dk.ROWS} & set(
                range(vp + 1))):
            for ny in sorted({vp, vp - 77, min(vp, 129)}):
                _check_dense(entry, nx, ny, vp)
            for D in (2, 3, 4, 8):
                _check_dense(entry, nx, -(-vp // D), vp)
    _check_dense(entry, dk.VP_MAX, 128, dk.VP_MAX)


@pytest.mark.parametrize("entry", ["dense_l1", "hetcor_dense_l1"])
def test_dense_plan_refuses_what_the_kernel_does_not_serve(entry):
    for nx, ny, vp in ((0, 8, 8), (8, 0, 8), (-1, 4, 8), (9, 8, 8), (8, 9, 8),
                       (8, 8, 262145)):
        with pytest.raises(ValueError):
            dk.plan(entry, nx, ny, vp)
    with pytest.raises(ValueError):
        dk.plan("dense", 8, 8, 8)


# --- the hetcor combinatorial scan (csrc/hetcor_scan.cu) ---------------------


def _scan_needed(l: int, d: int, p: dict) -> int:
    """Shared memory the scan's layout takes, as the C launcher counts it
    (``scan_smem_floats``): per warp the inverse's tile; staged, both
    panels at row stride d + 1, three rows and per warp a row of minima."""
    warps = p["threads"] // 32
    staged = 2 * d * (d + 1) + 3 * d + warps * d if p["staged"] else 0
    return 4 * (warps * l * l + staged)


@pytest.mark.parametrize("l", [1, 3, 4, 9, 14])
@pytest.mark.parametrize("d_range", [(1, 256), (257, 4000), (58000, 58200)])
def test_scan_plan_is_launchable_for_every_width(l, d_range):
    """Every level 1-14 at every width has a plan the launcher takes: 256
    threads (the kernel's launch bound), shared memory within the opt-in
    limit and at least the layout's; staged exactly while that fits
    SCAN_PANEL_SMEM (d <= 109 at level 4, 106 at level 14)."""
    last_staged = {1: 109, 3: 109, 4: 109, 9: 108, 14: 106}[l]
    for d in range(d_range[0], d_range[1] + 1):
        p = hs.scan_plan(l, d)
        assert p["threads"] == 256 and p["staged"] == (d <= last_staged), (l, d, p)
        assert _scan_needed(l, d, p) == p["smem_bytes"] <= SMEM_OPT_IN, (l, d, p)
        assert not p["staged"] or p["smem_bytes"] <= hs.SCAN_PANEL_SMEM


def test_scan_ctas_share_a_node_within_the_grid():
    """A few hubs spread their sets over about SCAN_CTAS CTAs, a warp never
    holding fewer than SCAN_MIN_SETS sets; many nodes take a CTA each."""
    assert hs.scan_ctas_per_node(16, 65536) == 33  # the 10k merged input's hubs
    assert hs.scan_ctas_per_node(16, 120) == 4
    assert hs.scan_ctas_per_node(2000, 512) == 1
    assert hs.scan_ctas_per_node(1, 1 << 40) == hs.SCAN_CTAS
    assert hs.scan_ctas_per_node(3, 0) == 1
    for nt in (1, 7, 528, 5000):
        for nsets in (1, 512, 131072):
            c = hs.scan_ctas_per_node(nt, nsets)
            assert 1 <= c <= 65535
            assert c == 1 or -(-nsets // (8 * c)) >= hs.SCAN_MIN_SETS


def test_scan_plan_refuses_what_the_kernel_does_not_serve():
    for l, d in ((0, 16), (15, 16), (4, 0)):
        with pytest.raises(ValueError, match="no plan"):
            hs.scan_plan(l, d)
