"""Wrapper of the dense level-1 kernel ``csrc/dense_l1.cu``.

Both entries work on an x-row slab against a y-column slab of a (vp, vp)
panel, so that one entry serves one card, the replicated engine's slabs and
the row-sharded engine's ring (:mod:`cigwas_tpu_torch.parallel.sharded`):

* :func:`dense_l1` — for every (x, y) the min over s of |rho_{xy|s}| and the
  smallest minimizing s, s ranging over x's neighbours other than x and y
  (the plain skeleton's level 1);
* :func:`hetcor_dense_l1` — the min over the same s, under the time
  constraint, of the hetcor margin (the hetcor skeleton's level 1).

Each launches the CUDA kernel for CUDA tensors and runs its plain version
(:func:`dense_l1_plain`, :func:`hetcor_dense_l1_plain`) for CPU tensors;
nothing else. R = 1 / sqrt(|1 - C^2|) and P = C R come from the caller
(:func:`factors`), the same PyTorch operations for both. A test reads the
entries the level-1 local sweep reads (C[x, y], C[x, s], C[s, y]; N[x, y],
N[x, s], N[y, s]), so both routes give the same bits whether or not the
panel is exactly symmetric: the y side is passed as column slabs, RT_y[s, j]
= R[s, y0 + j] (and P), and NT_y[s, j] = N[y0 + j, s]. The kernel is built at
its first launch (:mod:`cigwas_tpu_torch.ops.kernels.build`), never at
import.
"""

from __future__ import annotations

import ctypes

import torch

from cigwas_tpu_torch.ops.kernels import build

SOURCE = "cigwas_tpu_torch/csrc/dense_l1.cu"
# sentinels of csrc/sweep_common.cuh
RHO_BIG, MARGIN_BIG = 2.0, 3.0e38
# x rows a launch of the skeleton's sweeps takes (the slab)
ROWS = 256
# the CTAs of csrc/dense_l1.cu. dense_l1: 32 x rows (a warp each), 128 y;
# its pre-pass 8 warps, a warp per x row. hetcor_dense_l1: 8 warps, a group
# of 8 x rows (a warp each), 64 y, the union of the group's live s in
# chunks of 32 staged twice over with each warp's queue of 32 + 64 tests
# and its 64 slots; its pre-pass a CTA of 1024 threads per group, each at
# most 16 segments of 16 mask bytes (so vp <= VP_MAX)
WARPS = 8
THREADS = {"dense_l1": 1024, "hetcor_dense_l1": 32 * WARPS}
CTA_ROWS = {"dense_l1": 32, "hetcor_dense_l1": 8}
CTA_COLS = {"dense_l1": 128, "hetcor_dense_l1": 64}
SMEM = {"dense_l1": 0, "hetcor_dense_l1": 2 * 3 * 32 * 64 * 4 + WARPS * (16 * 96 + 8 * 64)}
PREP_THREADS = {"dense_l1": 32 * WARPS, "hetcor_dense_l1": 1024}
VP_MAX = 16 * 16 * 1024
# the largest grid.y
GRID_Y_MAX = 65535
# elements of the largest live intermediate of the plain sweeps
PLAIN_ELEMS = 1 << 24
# kernel launches per entry since the last reset; the CPU path adds nothing
launches = {"dense_l1": 0, "hetcor_dense_l1": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def plan(entry: str, nx: int, ny: int, vp: int) -> dict:
    """The launch plan of an entry over an (nx, ny) slab pair of a (vp, vp)
    panel, as the C launcher takes it (it refuses any other): threads, x
    rows and y per CTA, the grid (x, y) as launched (dense_l1 runs the x
    CTAs of one y segment together, hetcor the y CTAs of one row group), the
    dynamic shared memory; and the pre-pass's grid and threads."""
    if entry not in CTA_ROWS or nx < 1 or ny < 1 or vp < max(nx, ny) or vp > VP_MAX:
        raise ValueError(f"dense_l1: no plan for {entry} over {nx} x {ny} of {vp}")
    rows, cols = CTA_ROWS[entry], CTA_COLS[entry]
    prep = -(-nx // WARPS) if entry == "dense_l1" else -(-nx // rows)
    grid = (-(-ny // cols), -(-nx // rows))
    return {"threads": THREADS[entry], "rows_per_cta": rows, "cols_per_cta": cols,
            "grid": grid[::-1] if entry == "dense_l1" else grid, "smem_bytes": SMEM[entry],
            "prepass_grid": prep, "prepass_threads": PREP_THREADS[entry]}


def factors(C: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(R, P) = (1 / sqrt(|1 - C^2|), C R), elementwise (so a row stripe of
    a panel gives the stripe's rows)."""
    R = 1.0 / torch.sqrt(torch.abs(1.0 - C * C))
    return R, C * R


def _steps(nx: int, ny: int, vp: int):
    """Runs of x rows whose (rows, ny, vp) cube would stay near PLAIN_ELEMS
    (one row at a time past that)."""
    step = max(1, PLAIN_ELEMS // max(1, ny * vp))
    return [(i, min(i + step, nx)) for i in range(0, nx, step)]


def _bad(G_x, x0: int, y0: int, ny: int, i0: int, i1: int) -> torch.Tensor:
    """(rows, ny, vp) mask of the tests of x rows i0 .. i1 - 1 that do not
    count: s == x, s == y, s not a neighbour of x."""
    gx = G_x[i0:i1]
    dev = gx.device
    s_ix = torch.arange(gx.shape[1], device=dev)
    x_ix = x0 + i0 + torch.arange(i1 - i0, device=dev)
    y_ix = y0 + torch.arange(ny, device=dev)
    return ((s_ix[None, None, :] == x_ix[:, None, None])
            | (s_ix[None, None, :] == y_ix[None, :, None]) | ~gx[:, None, :])


def _rho(cxy, rx, px, RT_y, PT_y):
    """|c_xy (R_xs R_sy) - P_xs P_sy| over (x rows, y, s), from the column
    slabs (RT_y[s, y] = R[s, y0 + y])."""
    return torch.abs(cxy[:, :, None] * (rx[:, None, :] * RT_y.T[None, :, :])
                     - px[:, None, :] * PT_y.T[None, :, :])


def dense_l1_plain(C_x, R_x, P_x, G_x, RT_y, PT_y, x0: int, y0: int):
    """Plain version of :func:`dense_l1`, in runs of x rows (see _steps)."""
    nx, vp = C_x.shape
    ny = RT_y.shape[1]
    dev = C_x.device
    s_ix = torch.arange(vp, device=dev)
    rhos, poss = [], []
    for i0, i1 in _steps(nx, ny, vp):
        rho = _rho(C_x[i0:i1, y0:y0 + ny], R_x[i0:i1], P_x[i0:i1], RT_y, PT_y)
        bad = _bad(G_x, x0, y0, ny, i0, i1)
        rho = torch.where(bad | ~torch.isfinite(rho), RHO_BIG, rho)
        m = rho.amin(2)
        pos = torch.where(rho == m[..., None], s_ix, vp).amin(2)
        rhos.append(m)
        poss.append(torch.where(m < RHO_BIG, pos, 0).to(torch.int32))
    if not rhos:
        return (torch.empty((0, ny), device=dev),
                torch.empty((0, ny), dtype=torch.int32, device=dev))
    return torch.cat(rhos), torch.cat(poss)


def hetcor_dense_l1_plain(C_x, R_x, P_x, G_x, N_x, RT_y, PT_y, NT_y, t_ix, x0: int, y0: int,
                          th: float):
    """Plain version of :func:`hetcor_dense_l1`: the rho of
    :func:`dense_l1_plain`, the ESS terms (x, y) + (x, s) + (y, s) of
    `pcorr.hetcor1_local_sweep_pre`, the time constraint t_s <= max(t_x, t_y)."""
    nx, vp = C_x.shape
    ny = RT_y.shape[1]
    dev = C_x.device
    tf = t_ix.float()
    Ny = NT_y.T  # Ny[y, s] = N[y0 + y, s]
    Nyv, Nyc = torch.nan_to_num(Ny), torch.where(torch.isnan(Ny), 0.0, 1.0)
    th_t = torch.tensor(th, dtype=torch.float32, device=dev)
    out = []
    for i0, i1 in _steps(nx, ny, vp):
        Nx = N_x[i0:i1]
        Nxv, Nxc = torch.nan_to_num(Nx), torch.where(torch.isnan(Nx), 0.0, 1.0)
        rho = _rho(C_x[i0:i1, y0:y0 + ny], R_x[i0:i1], P_x[i0:i1], RT_y, PT_y)
        total = Nxv[:, y0:y0 + ny, None] + Nxv[:, None, :] + Nyv[None, :, :]
        count = Nxc[:, y0:y0 + ny, None] + Nxc[:, None, :] + Nyc[None, :, :]
        th_test = torch.tanh(th_t / torch.sqrt(total / count - 4.0))
        t_pair = torch.maximum(tf[x0 + i0:x0 + i1, None], tf[None, y0:y0 + ny])
        bad = _bad(G_x, x0, y0, ny, i0, i1) | (tf[None, None, :] > t_pair[:, :, None])
        margin = rho - th_test
        margin = torch.where(bad | ~torch.isfinite(margin), MARGIN_BIG, margin)
        out.append(margin.amin(2))
    if not out:
        return torch.empty((0, ny), device=dev)
    return torch.cat(out)


def _check(who: str, vp: int, x0: int, y0: int, **named) -> None:
    """named: name=(tensor, shape, dtype); each contiguous-able on one card;
    the slabs within the panel."""
    dev = None
    for name, (t, shape, dtype) in named.items():
        dev = dev or t.device
        if t.dtype != dtype or tuple(t.shape) != shape or t.device != dev:
            raise ValueError(f"{who}: {name} must be {dtype} {shape} on {dev}")
    nx, ny = named["C_x"][1][0], named["RT_y"][1][1]
    if x0 < 0 or y0 < 0 or x0 + nx > vp or y0 + ny > vp:
        raise ValueError(f"{who}: slabs [{x0}, {x0 + nx}) x [{y0}, {y0 + ny}) outside {vp}")


def _device(who: str, C_x: torch.Tensor) -> bool:
    """True for the card, False for the CPU; anything else raises."""
    if C_x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{who}: unsupported device {C_x.device}")
    return C_x.device.type == "cuda"


def _lib() -> ctypes.CDLL:
    lib = build.load("dense_l1")
    p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    lib.dense_l1_launch.argtypes = [p, p, p, p, p, p, ll, i, i, ll, ll, i, i, i, i, p, p, p, p, p]
    lib.dense_l1_launch.restype = i
    lib.hetcor_dense_l1_launch.argtypes = [p, p, p, p, p, p, p, p, p, ll, i, i, ll, ll, f,
                                           i, i, i, i, p, p, p, p, p]
    lib.hetcor_dense_l1_launch.restype = i
    return lib


def dense_l1(C_x: torch.Tensor, R_x: torch.Tensor, P_x: torch.Tensor, G_x: torch.Tensor,
             RT_y: torch.Tensor, PT_y: torch.Tensor, x0: int, y0: int):
    """Min over s of |rho_{xy|s}| for every x of an x-row slab and y of a
    y-column slab, with the smallest minimizing s.

    C_x, R_x, P_x (nx, vp) f32 and G_x (nx, vp) bool: rows x0 .. x0 + nx - 1
    of the panel C, of its :func:`factors` and of the adjacency; RT_y, PT_y
    (vp, ny) f32: columns y0 .. y0 + ny - 1 of R and P (RT_y[s, j] = R[s, y0
    + j]; the whole R for y0 = 0, ny = vp). s ranges over G_x[x] without x
    and y. Returns rho (nx, ny) f32 and s (nx, ny) int32 (global variable
    indices); (2.0, 0) where no s is valid."""
    if not _device("dense_l1", C_x):
        return dense_l1_plain(C_x, R_x, P_x, G_x, RT_y, PT_y, x0, y0)
    nx, vp = C_x.shape
    ny = RT_y.shape[1]
    f32 = torch.float32
    _check("dense_l1", vp, x0, y0, C_x=(C_x, (nx, vp), f32), R_x=(R_x, (nx, vp), f32),
           P_x=(P_x, (nx, vp), f32), G_x=(G_x, (nx, vp), torch.bool),
           RT_y=(RT_y, (vp, ny), f32), PT_y=(PT_y, (vp, ny), f32))
    C_x, R_x, P_x, G_x, RT_y, PT_y = (
        t.contiguous() for t in (C_x, R_x, P_x, G_x, RT_y, PT_y))
    rho = torch.empty((nx, ny), dtype=f32, device=C_x.device)
    s = torch.empty((nx, ny), dtype=torch.int32, device=C_x.device)
    if nx == 0 or ny == 0:
        return rho, s
    pl = plan("dense_l1", nx, ny, vp)
    # the pre-pass's outputs (the kernel allocates nothing): each row's live
    # s and their number
    lst = torch.empty((nx, vp), dtype=torch.int32, device=C_x.device)
    n_live = torch.empty(nx, dtype=torch.int32, device=C_x.device)
    with torch.cuda.device(C_x.device):
        err = _lib().dense_l1_launch(
            C_x.data_ptr(), R_x.data_ptr(), P_x.data_ptr(), G_x.data_ptr(), RT_y.data_ptr(),
            PT_y.data_ptr(), vp, nx, ny, int(x0), int(y0), pl["threads"], pl["rows_per_cta"],
            pl["cols_per_cta"], pl["smem_bytes"], lst.data_ptr(), n_live.data_ptr(),
            rho.data_ptr(), s.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"dense_l1 kernel launch failed: cudaError {err}, plan {pl}")
    launches["dense_l1"] += 1
    return rho, s


def hetcor_dense_l1(C_x: torch.Tensor, R_x: torch.Tensor, P_x: torch.Tensor,
                    G_x: torch.Tensor, N_x: torch.Tensor, RT_y: torch.Tensor,
                    PT_y: torch.Tensor, NT_y: torch.Tensor, t_ix: torch.Tensor, x0: int,
                    y0: int, th: float) -> torch.Tensor:
    """Min hetcor margin |rho_{xy|s}| - tanh(th / sqrt(mean_ess({x, y, s}) - 4))
    for every x of an x-row slab and y of a y-column slab, over the s of
    :func:`dense_l1` with t_s <= max(t_x, t_y).

    The slabs of :func:`dense_l1` plus N_x (nx, vp), the x rows of the
    per-pair ESS panel (raw or truncated, NaN = no estimate), NT_y (vp, ny)
    with NT_y[s, j] = N[y0 + j, s] (N's y rows, transposed), and t_ix (vp,)
    int32. Returns the margin (nx, ny) f32; 3.0e38 where no s is valid."""
    if not _device("hetcor_dense_l1", C_x):
        return hetcor_dense_l1_plain(C_x, R_x, P_x, G_x, N_x, RT_y, PT_y, NT_y, t_ix, x0, y0,
                                     th)
    nx, vp = C_x.shape
    ny = RT_y.shape[1]
    f32 = torch.float32
    _check("hetcor_dense_l1", vp, x0, y0, C_x=(C_x, (nx, vp), f32), R_x=(R_x, (nx, vp), f32),
           P_x=(P_x, (nx, vp), f32), G_x=(G_x, (nx, vp), torch.bool),
           N_x=(N_x, (nx, vp), f32), RT_y=(RT_y, (vp, ny), f32), PT_y=(PT_y, (vp, ny), f32),
           NT_y=(NT_y, (vp, ny), f32), t_ix=(t_ix, (vp,), torch.int32))
    C_x, R_x, P_x, G_x, N_x, RT_y, PT_y, NT_y, t_ix = (
        t.contiguous() for t in (C_x, R_x, P_x, G_x, N_x, RT_y, PT_y, NT_y, t_ix))
    margin = torch.empty((nx, ny), dtype=f32, device=C_x.device)
    if nx == 0 or ny == 0:
        return margin
    pl = plan("hetcor_dense_l1", nx, ny, vp)
    # the pre-pass's outputs: each row group's union of live s and its size,
    # each row's bit per union entry (zeroed by the launcher)
    groups, dev, i32 = pl["prepass_grid"], C_x.device, torch.int32
    ulist = torch.empty((groups, vp), dtype=i32, device=dev)
    unum = torch.empty(groups, dtype=i32, device=dev)
    bits = torch.empty((nx, -(-vp // 32)), dtype=i32, device=dev)
    with torch.cuda.device(C_x.device):
        err = _lib().hetcor_dense_l1_launch(
            C_x.data_ptr(), R_x.data_ptr(), P_x.data_ptr(), G_x.data_ptr(), N_x.data_ptr(),
            RT_y.data_ptr(), PT_y.data_ptr(), NT_y.data_ptr(), t_ix.data_ptr(), vp, nx, ny, int(x0),
            int(y0), float(th), pl["threads"], pl["rows_per_cta"], pl["cols_per_cta"],
            pl["smem_bytes"], ulist.data_ptr(), unum.data_ptr(), bits.data_ptr(),
            margin.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"hetcor_dense_l1 kernel launch failed: cudaError {err}, plan {pl}")
    launches["hetcor_dense_l1"] += 1
    return margin
