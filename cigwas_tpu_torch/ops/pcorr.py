"""Partial-correlation CI tests of the skeleton levels, in plain PyTorch.

Counterpart of :mod:`cigwas_tpu.ops.pcorr`. Two families, the plain
skeleton's |rho| tests and the hetcor skeleton's margin tests
(|rho| - tanh(th / sqrt(mean_ess - l - 3)) under a time constraint):

* :func:`level0_screen`, :func:`hetcor_l0_delete` — the Fisher-z marginal
  screens; :func:`trunc_ref_ess` — the ``ess_mode="reference"`` transform;
* :func:`local_sweep_plain` — levels 1-3 on each node's local panel, the
  plain version of the CUDA kernel ``csrc/local_sweep.cu`` (the wrapper
  :func:`cigwas_tpu_torch.ops.kernels.local_sweep.local_sweep` runs it for
  CPU tensors; on the card the kernel runs and this is what it is held to);
* :func:`hetcor_local_sweep_plain` — the hetcor levels 1-3, the plain
  version of ``csrc/hetcor_sweep.cu`` in the same way
  (:func:`cigwas_tpu_torch.ops.kernels.hetcor_sweep.hetcor_local_sweep`);
* :func:`level1_dense_minrho`, :func:`level1_dense_screen`,
  :func:`hetcor1_dense_margin` — level 1 of
  either skeleton as a dense sweep of x-row slabs against every y, each
  slab one launch of ``csrc/dense_l1.cu``
  (:mod:`cigwas_tpu_torch.ops.kernels.dense_l1`, whose plain versions run
  for CPU tensors); the same tests and ties as the level-1 local sweeps.
  Each folds the launches of :func:`dense1_sweeps` (the engines' launches
  go through the same :func:`dense1_slab_sweeps`) with
  :func:`dense1_gather` or :func:`dense1_screen`;
* :func:`level_scan_minrho_pre`, :func:`level_scan_hetcor_pre` — any level
  over colex chunks of conditioning sets (the combinatorial route), on the
  local panels that the gathers of
  :mod:`cigwas_tpu_torch.ops.kernels.panel_gather` make (the kernel
  ``csrc/panel_gather.cu`` on the card, its plain version on CPU tensors);
  the skeleton calls both steps itself (:func:`level_scan_minrho` is the
  two in one). The plain scan selects with one-hot matmuls like the JAX
  package, so a NaN in a local panel sends a test to ``RHO_BIG`` the same
  way; :func:`level_scan_hetcor_pre` is the plain version of the kernel
  ``csrc/hetcor_scan.cu``
  (:func:`cigwas_tpu_torch.ops.kernels.hetcor_sweep.hetcor_scan`), which
  indexes directly and reproduces that NaN rule node by node.

Every ``rsqrt`` of the JAX sweeps is spelled ``1 / sqrt``: that is IEEE
exact on both CPU and CUDA, so the kernel (built with ``-fmad=false``) and
this file agree bit for bit. Neither is bit-identical to JAX, whose CPU
``rsqrt`` differs from ``1 / sqrt`` by up to 2 ulp.
"""

from __future__ import annotations

import numpy as np
import torch

from cigwas_tpu_torch.ops.kernels import dense_l1 as dk
from cigwas_tpu_torch.ops.kernels.panel_gather import gather_local_panels
from cigwas_tpu_torch.utils.timing import span, to_host

# sentinel for masked or non-finite tests; |rho| <= 1 for any valid test
RHO_BIG = 2.0
# sentinel margin of a masked, time-forbidden or non-finite hetcor test
MARGIN_BIG = 3.0e38
# elements of the largest live intermediate of the plain sweeps
PLAIN_ELEMS = 1 << 24
# cap on (nodes x combos x neighbours x l) elements live per call of the
# combinatorial scan; the skeleton sizes its node tiles by it too
SCAN_ELEMS = 1 << 26


def _rinv(x: torch.Tensor) -> torch.Tensor:
    """rsqrt(|1 - x*x|) of the JAX sweeps."""
    return 1.0 / torch.sqrt(torch.abs(1.0 - x * x))


def level0_keep(C: torch.Tensor, th0: float) -> torch.Tensor:
    """Level-0 test of every entry, elementwise (so a row stripe of a panel
    gives the stripe's rows): keep iff not fisher-z < th0 (`cal_Indepl0`); a
    NaN z compares false and keeps the edge."""
    z0 = torch.abs(0.5 * torch.log(torch.abs((1 + C) / (1 - C))))
    return ~(z0 < th0)


def level0_screen(C: torch.Tensor, th0: float) -> torch.Tensor:
    """Level-0 adjacency: :func:`level0_keep` with the diagonal cleared."""
    eye = torch.eye(C.shape[0], dtype=torch.bool, device=C.device)
    return level0_keep(C, th0) & ~eye


def hetcor_l0_delete(C: torch.Tensor, N: torch.Tensor, th: float) -> torch.Tensor:
    """Hetcor level-0 delete mask (`cigwas_tpu.ops.pcorr.hetcor_l0_packed`,
    as bools): delete iff fisher_z(C) < th / sqrt(N - 3) with the RAW
    per-pair N; a NaN threshold compares false and keeps the edge."""
    z0 = torch.abs(0.5 * torch.log(torch.abs((1 + C) / (1 - C))))
    return z0 < _f32(th, C) / torch.sqrt(N - 3.0)


def trunc_ref_ess(N: torch.Tensor) -> torch.Tensor:
    """The ``ess_mode="reference"`` transform: truncate toward zero with
    NaN -> 0 first (a float -> int cast of NaN differs between CUDA and
    x86, so no cast is involved)."""
    return torch.trunc(torch.nan_to_num(N, nan=0.0))


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    """A Python scalar rounded to float32 on like's device, so th / sqrt(..)
    divides two float32 values as the JAX package's ``jnp.float32(th)``."""
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def _first_min(rho: torch.Tensor, dim: int):
    """(min, first index of the min) along dim; the index is 0 where the
    min is RHO_BIG (no test won), as in the kernel's strict-< scan."""
    m = rho.amin(dim)
    n = rho.shape[dim]
    shape = [1] * rho.dim()
    shape[dim] = n
    iota = torch.arange(n, device=rho.device).view(shape)
    pos = torch.where(rho == m.unsqueeze(dim), iota, n).amin(dim)
    return m, torch.where(m < RHO_BIG, pos, 0)


def _local_panels(C, node_ixs, nbrs):
    Cb = C[nbrs[:, :, None], nbrs[:, None, :]]  # (nt, d, d)
    qb = C[node_ixs[:, None], nbrs]  # (nt, d)
    return Cb, qb


def level1_local_sweep_pre(Cb, qb, deg):
    """min over s of |rho_{xy|s}| per slot y, on gathered panels.

    The pre-scaled form of `cigwas_tpu.ops.pcorr.level1_local_sweep_pre`:
    rho[s, y] = |q_y (R_xs R_sy) - P_xs P_sy|. Returns (rho (nt, d),
    pos (nt, d, 1) int64)."""
    d = qb.shape[1]
    Rc = _rinv(Cb)  # (nt, s, y)
    Pc = Cb * Rc
    Rq = _rinv(qb)  # (nt, s)
    Pq = qb * Rq
    rho = torch.abs(qb[:, None, :] * (Rq[:, :, None] * Rc) - Pq[:, :, None] * Pc)
    ix = torch.arange(d, device=qb.device)
    dg = deg[:, None, None]
    bad = (
        (ix[None, :, None] >= dg)  # s live
        | (ix[:, None] == ix[None, :])[None]  # s == y
        | (ix[None, None, :] >= dg)  # pad slot y
    )
    rho = torch.where(bad | ~torch.isfinite(rho), RHO_BIG, rho)
    rho_min, pos = _first_min(rho, 1)
    return rho_min, pos[..., None]


def _pair_sweep(Cb, qb, deg, t_hi, y_excl):
    """min over pairs s < t < min(deg, t_hi) of |rho_{xy|B u {s,t}}| per y.

    Batched `cigwas_tpu.ops.pcorr._pair_sweep`: Cb (nt, d, d) is the level-|B|
    panel, qb (nt, d) its row of x; t_hi and y_excl are ints. The (t, s) candidates of a t-chunk are reduced in t-major order
    and chunks merge with a strict <, which selects the lowest colex rank
    among ties. Returns (rho (nt, d), t_pos, s_pos)."""
    nt, d = qb.shape
    dev = qb.device
    t_cap = torch.clamp(deg, max=t_hi)
    n_t = int(t_cap.max()) if nt else 0
    ct = max(1, min(d, PLAIN_ELEMS // max(1, nt * d * d)))
    ix = torch.arange(d, device=dev)
    y3 = ix[None, :, None, None]
    s3 = ix[None, None, None, :]
    rho0 = torch.full((nt, d), RHO_BIG, device=dev)
    tp0 = torch.zeros((nt, d), dtype=torch.int64, device=dev)
    sp0 = torch.zeros((nt, d), dtype=torch.int64, device=dev)
    for t0 in range(0, n_t, ct):
        t1 = min(t0 + ct, d)
        Ct = Cb[:, t0:t1, :]  # (nt, t, s)
        qt = qb[:, t0:t1]
        Rt = _rinv(Ct)
        q2 = (qb[:, None, :] - qt[:, :, None] * Ct) * (_rinv(qt)[:, :, None] * Rt)
        CtT = Ct.transpose(1, 2)  # (nt, y, t)
        RtT = Rt.transpose(1, 2)
        T2 = (Cb[:, :, None, :] - CtT[..., None] * Ct[:, None]) * (
            RtT[..., None] * Rt[:, None]
        )  # (nt, y, t, s) = pcorr(y, s | B u {t})
        rho = torch.abs(q2.transpose(1, 2)[..., None] - q2[:, None] * T2) * (
            _rinv(q2)[:, None] * _rinv(T2)
        )
        t3 = torch.arange(t0, t1, device=dev)[None, None, :, None]
        bad = (
            (s3 >= t3)
            | (t3 >= t_cap.reshape(-1, 1, 1, 1))
            | (y3 >= deg.reshape(-1, 1, 1, 1))
            | (y3 == s3)
            | (y3 == t3)
            | (y3 == y_excl)
        )
        rho = torch.where(bad | ~torch.isfinite(rho), RHO_BIG, rho)
        rmin, k = _first_min(rho.reshape(nt, d, -1), 2)
        better = rmin < rho0
        rho0 = torch.where(better, rmin, rho0)
        tp0 = torch.where(better, k // d + t0, tp0)
        sp0 = torch.where(better, k % d, sp0)
    return rho0, tp0, sp0


def level2_local_sweep_pre(Cb, qb, deg):
    """Level-2 sweep on gathered panels: (rho (nt, d), pos (nt, d, 2) as
    ascending positions [s, t])."""
    d = qb.shape[1]
    rho, tp, sp = _pair_sweep(Cb, qb, deg, d, d)
    return rho, torch.stack([sp, tp], dim=-1)


def level3_local_sweep_pre(Cb, qb, deg):
    """Level-3 sweep: for each largest element u (ascending) condition the
    panel on u by one recursion step and run the pair sweep over s < t < u;
    the strict-< merge over u keeps the lowest colex rank. Returns
    (rho (nt, d), pos (nt, d, 3) as [s, t, u])."""
    nt, d = qb.shape
    dev = qb.device
    rho0 = torch.full((nt, d), RHO_BIG, device=dev)
    pos = torch.zeros((nt, d, 3), dtype=torch.int64, device=dev)
    for u in range(2, int(deg.max()) if nt else 0):
        cu = Cb[:, u, :]  # (nt, d)
        qu = qb[:, u]
        Ru = _rinv(cu)
        T1 = (Cb - cu[:, :, None] * cu[:, None, :]) * (Ru[:, :, None] * Ru[:, None, :])
        q1 = (qb - qu[:, None] * cu) * (_rinv(qu)[:, None] * Ru)
        rmin, tb, sb = _pair_sweep(T1, q1, deg, u, u)
        better = (rmin < rho0) & (u < deg)[:, None]
        rho0 = torch.where(better, rmin, rho0)
        upd = torch.stack([sb, tb, torch.full_like(sb, u)], dim=-1)
        pos = torch.where(better[..., None], upd, pos)
    return rho0, pos


def local_sweep_plain(C, node_ixs, nbrs, deg, l: int):
    """Plain version of the levels 1-3 kernel: (rho (nt, d) f32,
    pos (nt, d, l) int32) with pos as ascending positions into each node's
    neighbour list; pad slots y >= deg come back as (RHO_BIG, 0). Nodes run
    in slices so the largest intermediate stays near PLAIN_ELEMS."""
    nt, d = nbrs.shape
    step = max(1, PLAIN_ELEMS // max(1, d * d * (d if l > 1 else 1)))
    sweep = {1: level1_local_sweep_pre, 2: level2_local_sweep_pre,
             3: level3_local_sweep_pre}[l]
    rhos, poss = [], []
    for i in range(0, nt, step):
        sl = slice(i, i + step)
        Cb, qb = _local_panels(C, node_ixs[sl].long(), nbrs[sl].long())
        rho, pos = sweep(Cb, qb, deg[sl].long())
        rhos.append(rho)
        poss.append(pos.to(torch.int32))
    if not rhos:
        return (
            torch.empty((0, d), dtype=torch.float32, device=C.device),
            torch.empty((0, d, l), dtype=torch.int32, device=C.device),
        )
    return torch.cat(rhos), torch.cat(poss)


def _inv_unrolled(M: list, l: int) -> list:
    """Closed-form inverse of an unrolled l x l matrix (l <= 3) whose
    entries are same-shaped tensors (`cigwas_tpu.ops.pcorr._inv_unrolled`,
    the same operations in the same order)."""
    if l == 1:
        return [[1.0 / M[0][0]]]
    if l == 2:
        a, b = M[0]
        c, d = M[1]
        det = a * d - b * c
        return [[d / det, -b / det], [-c / det, a / det]]
    (m00, m01, m02), (m10, m11, m12), (m20, m21, m22) = M
    c00 = m11 * m22 - m12 * m21
    c01 = m02 * m21 - m01 * m22
    c02 = m01 * m12 - m02 * m11
    c10 = m12 * m20 - m10 * m22
    c11 = m00 * m22 - m02 * m20
    c12 = m02 * m10 - m00 * m12
    c20 = m10 * m21 - m11 * m20
    c21 = m01 * m20 - m00 * m21
    c22 = m00 * m11 - m01 * m10
    det = m00 * c00 + m10 * c01 + m20 * c02
    return [[c00 / det, c01 / det, c02 / det],
            [c10 / det, c11 / det, c12 / det],
            [c20 / det, c21 / det, c22 / det]]


def as_bool_adjacency(G, device) -> torch.Tensor:
    """A host or device adjacency as a bool tensor on device."""
    if isinstance(G, torch.Tensor):
        return G.to(device=device, dtype=torch.bool)
    return torch.from_numpy(np.ascontiguousarray(G, dtype=bool)).to(device)


def dense1_hits(rho, s, G_rows, x0: int, y0: int, rho_th: float) -> tuple:
    """The ordered pairs one dense launch condemns from x's side, rho <
    rho_th on an edge, as device tensors (xs, ys, s_sel, rho_sel) in row-major
    order; G_rows is the launch's block of the adjacency."""
    xi, yj = torch.nonzero((rho < rho_th) & G_rows, as_tuple=True)
    return xi + x0, yj + y0, s[xi, yj], rho[xi, yj]


def hetcor1_hits(margin, G_rows, x0: int, y0: int) -> tuple:
    """(xs, ys) of the pairs one hetcor dense launch condemns: margin < 0
    on an edge."""
    xi, yj = torch.nonzero((margin < 0) & G_rows, as_tuple=True)
    return xi + x0, yj + y0


def fetch_hits(hits: list, stats: dict | None = None) -> tuple:
    """The launches' hits (a non-empty list of equal-length tuples of
    tensors, on any devices) concatenated in launch order, on the host;
    their bytes counted in stats (:func:`~cigwas_tpu_torch.utils.timing.to_host`,
    site ``hits``)."""
    return tuple(np.concatenate([to_host(h[k], stats, "hits") for h in hits])
                 for k in range(len(hits[0])))


def dense1_slab_sweeps(C_x, R_x, P_x, G_x, ys: tuple, x0: int, y0: int, N_x=None,
                       t_ix=None, th: float = 0.0, rows: int = dk.ROWS, on_launch=None):
    """The dense level-1 launches of a block of x rows against a y slab,
    ``rows`` x rows a launch: C_x, R_x, P_x, G_x (and N_x for hetcor) are rows
    x0, x0 + 1, ... of C, R, P, the bool adjacency (and N); ys the y slab's
    column blocks (R[:, y0:y0+ny], P[:, y0:y0+ny] and, for hetcor, those
    columns of N transposed). One card, the replicated engine's shards and
    the row-sharded ring's steps all launch through here. Calls on_launch()
    before each launch and yields (the launch's x0, y0, its adjacency rows,
    its output: (rho, s), or the margin when N_x is given)."""
    for a in range(0, C_x.shape[0], rows):
        b = min(a + rows, C_x.shape[0])
        if on_launch is not None:
            on_launch()
        if N_x is None:
            out = dk.dense_l1(C_x[a:b], R_x[a:b], P_x[a:b], G_x[a:b], *ys, x0 + a, y0)
        else:
            out = dk.hetcor_dense_l1(C_x[a:b], R_x[a:b], P_x[a:b], G_x[a:b], N_x[a:b], *ys,
                                     t_ix, x0 + a, y0, th)
        yield x0 + a, y0, G_x[a:b], out


def dense1_sweeps(C: torch.Tensor, G, N: torch.Tensor | None = None, t_ix=None,
                  th: float = 0.0, rows: int = dk.ROWS):
    """One card's dense level-1 launches: every x-row slab of the panel
    against every y (see :func:`dense1_slab_sweeps`). C (and N) (vp, vp), G
    (vp, vp) bool, numpy or tensor."""
    Gd = as_bool_adjacency(G, C.device)
    R, P = dk.factors(C)
    ys = (R, P) if N is None else (R, P, N.T.contiguous())
    return dense1_slab_sweeps(C, R, P, Gd, ys, 0, 0, N, t_ix, th, rows)


def dense1_gather(sweeps, vp: int, device) -> tuple | torch.Tensor:
    """The outputs of dense launches (:func:`dense1_sweeps` or an engine's
    ``dense1_sweeps``) assembled into (vp, vp) tensors on device:
    (rho_min, s_argmin), or the margin."""
    full = None
    for x0, y0, _, out in sweeps:
        parts = out if isinstance(out, tuple) else (out,)
        if full is None:
            full = [torch.empty((vp, vp), dtype=o.dtype, device=device) for o in parts]
        for f, o in zip(full, parts):
            f[x0 : x0 + o.shape[0], y0 : y0 + o.shape[1]] = o.to(device)
    return tuple(full) if len(full) > 1 else full[0]


def dense1_device_hits(sweeps, rho_th: float | None = None) -> list:
    """Every dense launch's hits on the device, one tuple a launch in launch
    order: :func:`dense1_hits` (rho_th given) or :func:`hetcor1_hits`. Each
    launch's hits are taken before the next is read from sweeps."""
    hits = []
    for x0, y0, g, out in sweeps:
        ny = (out[0] if rho_th is not None else out).shape[1]
        g = g[:, y0 : y0 + ny]
        hits.append(hetcor1_hits(out, g, x0, y0) if rho_th is None
                    else dense1_hits(*out, g, x0, y0, rho_th))
    return hits


def dense1_screen(sweeps, vp: int, rho_th: float | None = None, stats: dict | None = None):
    """The pairs that dense launches condemn from x's side, only the hits
    leaving the device. Level 1 (rho_th = tanh(Th[1])): (side (vp, vp) bool,
    xs, ys, s_sel, rho_sel) on the host, the arrays in launch and row-major
    order. Hetcor (rho_th None, the launches' margins): side alone. stats,
    if given, counts the hits' bytes and the host pass that builds side
    (``host_pass_s``, as the skeletons count it)."""
    got = fetch_hits(dense1_device_hits(sweeps, rho_th), stats)
    with span(stats, "host_pass_s", "cigwas.skeleton.host_pass"):
        side = np.zeros((vp, vp), dtype=bool)
        side[got[0], got[1]] = True
    return side if rho_th is None else (side, *got)


def level1_dense_minrho(C: torch.Tensor, G, rows: int = dk.ROWS):
    """Level 1 of the skeleton as dense launches over x-row slabs
    (`cigwas_tpu.ops.pcorr.level1_dense_minrho`): rho_min[x, y] the min over
    the neighbours s of x (s != x, y) of |rho_{xy|s}|, s_argmin the smallest
    such s; (2.0, 0) where none is valid. C (vp, vp) and G (vp, vp) bool
    (numpy or tensor); returns two (vp, vp) tensors on C's device."""
    return dense1_gather(dense1_sweeps(C, G, rows=rows), C.shape[0], C.device)


def level1_dense_screen(C: torch.Tensor, G, rho_th: float, rows: int = dk.ROWS):
    """The level-1 screen of :func:`level1_dense_minrho` with only the hits
    leaving the device (`cigwas_tpu.ops.pcorr.level1_dense_screen`): returns
    (side (vp, vp) bool, xs, ys, s_sel, rho_sel) on the host, side[x, y]
    meaning "x's sweep condemned (x, y)", the arrays listing those pairs in
    row-major order with their minimizing s and |rho|."""
    return dense1_screen(dense1_sweeps(C, G, rows=rows), C.shape[0], rho_th)


def hetcor1_dense_margin(C: torch.Tensor, N: torch.Tensor, t_ix: torch.Tensor, G,
                         th: float, rows: int = dk.ROWS) -> torch.Tensor:
    """Hetcor level 1 as dense launches over x-row slabs
    (`cigwas_tpu.ops.pcorr.hetcor1_dense_margin`): margin[x, y] the min over
    the neighbours s of x (s != x, y, t_s <= max(t_x, t_y)) of |rho_{xy|s}|
    - tanh(th / sqrt(mean_ess({x, y, s}) - 4)); MARGIN_BIG where none is
    valid. C, N (vp, vp), t_ix (vp,) int32, G (vp, vp) bool; returns (vp, vp)
    on C's device. The caller removes an edge where the margin of either
    side is negative."""
    return dense1_gather(dense1_sweeps(C, G, N, t_ix, th, rows), C.shape[0], C.device)


def _combo_onehots(combos: torch.Tensor, d: int, l: int):
    """One-hot selection matrices for each combo position, l x (K, d)."""
    slot = torch.arange(d, device=combos.device)[None, :]
    return [(combos[:, i][:, None] == slot).to(torch.float32) for i in range(l)]


def _combo_ok(left: torch.Tensor, K: int) -> torch.Tensor:
    """(nt, g K) validity of the sets of g consecutive chunks of K sets each,
    left (g, nt) the count of valid leading sets of each chunk per node."""
    k_ix = torch.arange(K, device=left.device)
    return (k_ix[None, None, :] < left.T[:, :, None]).reshape(left.shape[1], -1)


def _chunks_per_call(nch: int, elems: int) -> int:
    """Chunks that one call of the scan takes together: the most, a divisor
    of nch, whose (nt, K, d) x l intermediates (elems a chunk) stay within
    SCAN_ELEMS. A tile of few nodes then scans many chunks a call instead
    of launching the ~l^2 small operations of a chunk once per chunk."""
    g = max(1, min(nch, SCAN_ELEMS // max(1, elems)))
    while nch % g:
        g -= 1
    return g


def _pcorr_rho_local(C_x, c_row, deg, combo_ok, sel, combos, l: int):
    """Level-l |rho| of a node tile from local panels, (nt, K, d); combo_ok
    (nt, K) marks each node's sets that are scanned.

    Batched `cigwas_tpu.ops.pcorr._pcorr_rho_local`: the closed-form
    inverse for l <= 3 (the combinatorial route of levels 1-3), a batched LU
    inverse for l >= 4, as there. Rows of the conditioning sets are
    selected with one-hot matmuls, so a NaN anywhere in a selected row
    smears through 0 * NaN and sends the test to RHO_BIG, as in JAX."""
    K, d = sel[0].shape
    rows = [torch.matmul(sel[i], C_x) for i in range(l)]  # l x (nt, K, d)
    Cx = [torch.sum(sel[i] * c_row[:, None, :], dim=2) for i in range(l)]  # (nt, K)
    M2 = [[torch.sum(rows[i] * sel[j], dim=2) for j in range(l)] for i in range(l)]
    if l <= 3:
        M2inv = _inv_unrolled(M2, l)
    else:
        M2d = torch.stack([torch.stack(M2[i], -1) for i in range(l)], -2)  # (nt, K, l, l)
        M2inv_d = torch.linalg.inv_ex(M2d)[0]  # singular -> inf/NaN -> RHO_BIG
        M2inv = [[M2inv_d[..., i, j] for j in range(l)] for i in range(l)]
    t = [sum(M2inv[i][j] * Cx[j] for j in range(l)) for i in range(l)]
    H00 = 1.0 - sum(Cx[i] * t[i] for i in range(l))  # (nt, K)
    H01 = c_row[:, None, :] - sum(rows[i] * t[i][..., None] for i in range(l))
    H11 = 1.0 - sum(
        rows[i] * M2inv[i][j][..., None] * rows[j]
        for i in range(l)
        for j in range(l)
    )
    rho = torch.abs(H01) * (1.0 / torch.sqrt(torch.abs(H00[..., None] * H11)))
    slot_ix = torch.arange(d, device=C_x.device)
    slot_ok = slot_ix[None, :] < deg[:, None]  # (nt, d)
    y_in_S = torch.zeros((K, d), dtype=torch.bool, device=C_x.device)
    for i in range(l):
        y_in_S = y_in_S | (combos[:, i][:, None] == slot_ix[None, :])
    invalid = ~combo_ok[:, :, None] | ~slot_ok[:, None, :] | y_in_S[None]
    return torch.where(invalid | ~torch.isfinite(rho), RHO_BIG, rho)


def level_scan_minrho(C, node_ixs, nbrs, deg, combos_seq, left_seq, l: int):
    """Many chunks of level-l CI tests (`cigwas_tpu.ops.pcorr.level_scan_minrho`):
    the gather of the local panels (pad slots read as the node itself), then
    :func:`level_scan_minrho_pre`."""
    C_x, c_row = gather_local_panels(C, node_ixs, nbrs, deg)
    return level_scan_minrho_pre(C_x, c_row, deg, combos_seq, left_seq, l)


def level_scan_minrho_pre(C_x, c_row, deg, combos_seq, left_seq, l: int):
    """`level_scan_minrho` on gathered local panels C_x (nt, d, d), c_row (nt, d).

    combos_seq: (nch, K, l) colex position tuples; left_seq: (nch, nt) valid
    rows per node per chunk. Returns (rho_min (nt, d), rank (nt, d) int64):
    the minimum |rho| over every scanned set and the launch-local rank
    (chunk * K + first argmin over K) that achieves it. Consecutive chunks
    are scanned together (:func:`_chunks_per_call`); the first minimum over
    them is the one that a merge chunk by chunk with a strict < keeps, and
    every test is the same arithmetic, so the result does not depend on
    how many are taken together."""
    nt, d = c_row.shape
    nch, K, _ = combos_seq.shape
    dev = c_row.device
    g = _chunks_per_call(nch, nt * K * d * l)
    rho_min = torch.full((nt, d), RHO_BIG, device=dev)
    rank = torch.zeros((nt, d), dtype=torch.int64, device=dev)
    k_ix = torch.arange(g * K, device=dev)[None, :, None]
    for c0 in range(0, nch, g):
        combos = combos_seq[c0 : c0 + g].reshape(g * K, l)
        sel = _combo_onehots(combos, d, l)
        rho = _pcorr_rho_local(C_x, c_row, deg, _combo_ok(left_seq[c0 : c0 + g], K), sel,
                               combos, l)
        rho_c = rho.amin(1)
        argk = torch.where(rho == rho_c[:, None, :], k_ix, g * K).amin(1)
        better = rho_c < rho_min
        rho_min = torch.where(better, rho_c, rho_min)
        rank = torch.where(better, c0 * K + argk, rank)
    return rho_min, rank


# --- hetcor: per-test thresholds from the mean pairwise ESS -----------------


def _ess_masked(N_raw: torch.Tensor):
    """(values with NaN -> 0, counts 1/0) of raw per-pair ESS entries."""
    return torch.nan_to_num(N_raw), torch.where(torch.isnan(N_raw), 0.0, 1.0)


def hetcor_local_gather(C, N, t_ix, node_ixs, nbrs):
    """Local panels of both matrices and the time indices, by tensor
    indexing: Cb, Nb (nt, d, d); qb, nr, tn (nt, d); t_x (nt,)."""
    Cb, qb = _local_panels(C, node_ixs, nbrs)
    Nb, nr = _local_panels(N, node_ixs, nbrs)
    return Cb, qb, Nb, nr, t_ix[nbrs].float(), t_ix[node_ixs].float()


def hetcor1_local_sweep_pre(Cb, qb, Nb_raw, nr_raw, tn, t_x, deg, th: float):
    """Min over s of |rho_{xy|s}| - tanh(th / sqrt(mean_ess({x,y,s}) - 4)) per
    slot y, on gathered panels (`cigwas_tpu.ops.pcorr._hetcor1_local_core`):
    the pre-scaled rho of :func:`level1_local_sweep_pre`, ESS sums
    left-associated (x,y) + (x,s) + (y,s). Pad slots y >= deg, which the JAX
    form leaves to its caller, come back as MARGIN_BIG here."""
    d = qb.shape[1]
    Nbv, Nbc = _ess_masked(Nb_raw)
    nrv, nrc = _ess_masked(nr_raw)
    Rc = _rinv(Cb)  # (nt, s, y)
    Pc = Cb * Rc
    Rq = _rinv(qb)
    Pq = qb * Rq
    rho = torch.abs(qb[:, None, :] * (Rq[:, :, None] * Rc) - Pq[:, :, None] * Pc)
    NyS = Nbv.transpose(1, 2)  # [nt, s, y] = N[y_nbr, s_nbr]
    total = nrv[:, None, :] + nrv[:, :, None] + NyS
    count = nrc[:, None, :] + nrc[:, :, None] + Nbc.transpose(1, 2)
    th_test = torch.tanh(_f32(th, qb) / torch.sqrt(total / count - 4.0))
    t_pair = torch.maximum(t_x[:, None], tn)  # (nt, y)
    ix = torch.arange(d, device=qb.device)
    dg = deg[:, None, None]
    bad = (
        (ix[None, :, None] >= dg)
        | (ix[:, None] == ix[None, :])[None]
        | (tn[:, :, None] > t_pair[:, None, :])
        | (ix[None, None, :] >= dg)
    )
    margin = rho - th_test
    margin = torch.where(bad | ~torch.isfinite(margin), MARGIN_BIG, margin)
    return margin.amin(1)


def _hetcor_pair_margin(Cb, qb, Nbv, Nbc, nrv, nrc, tn, t_x, deg, t_hi: int,
                        y_excl: int, base, th: float, lvl: int):
    """Min hetcor margin over pairs s < t < min(deg, t_hi), per slot y.

    Batched `cigwas_tpu.ops.pcorr._hetcor_pair_margin`. Cb/qb: the level-|B|
    conditioned panel and row; the ESS and time terms use the raw masked N
    (Nbv/Nbc, nrv/nrc) and tn. base = (sum0, cnt0 (nt,), sum_y, cnt_y,
    sum_v, cnt_v (nt, d), t_base (nt,)): the base element's ESS terms and
    time index, or None for an empty base (level 2). The ten ESS terms add
    in the JAX order."""
    nt, d = qb.shape
    dev = qb.device
    t_cap = torch.clamp(deg, max=t_hi)
    n_t = int(t_cap.max()) if nt else 0
    ct = max(1, min(d, PLAIN_ELEMS // max(1, nt * d * d)))
    ix = torch.arange(d, device=dev)
    y3 = ix[None, :, None, None]
    s3 = ix[None, None, None, :]
    zero = torch.zeros((nt, 1), device=dev)
    if base is None:
        base = (zero[:, 0], zero[:, 0], zero, zero, zero, zero,
                torch.full((nt,), -1.0, device=dev))
    sum0, cnt0, sum_y, cnt_y, sum_v, cnt_v, t_base = base
    sum_v, cnt_v = sum_v.expand(nt, d), cnt_v.expand(nt, d)
    th_t = _f32(th, qb)
    out = torch.full((nt, d), MARGIN_BIG, device=dev)
    t_pair = torch.maximum(t_x[:, None], tn)[:, :, None, None]  # (nt, y, 1, 1)
    for t0 in range(0, n_t, ct):
        t1 = min(t0 + ct, d)
        Ct = Cb[:, t0:t1, :]  # (nt, t, s)
        qt = qb[:, t0:t1]
        Rt = _rinv(Ct)
        q2 = (qb[:, None, :] - qt[:, :, None] * Ct) * (_rinv(qt)[:, :, None] * Rt)
        CtT = Ct.transpose(1, 2)
        RtT = Rt.transpose(1, 2)
        T2 = (Cb[:, :, None, :] - CtT[..., None] * Ct[:, None]) * (
            RtT[..., None] * Rt[:, None]
        )
        rho = torch.abs(q2.transpose(1, 2)[..., None] - q2[:, None] * T2) * (
            _rinv(q2)[:, None] * _rinv(T2)
        )  # (nt, y, t, s)
        t3 = torch.arange(t0, t1, device=dev)[None, None, :, None]
        bad = (
            (s3 >= t3)
            | (t3 >= t_cap.reshape(-1, 1, 1, 1))
            | (y3 >= deg.reshape(-1, 1, 1, 1))
            | (y3 == s3)
            | (y3 == t3)
            | (y3 == y_excl)
        )
        rho = torch.where(bad | ~torch.isfinite(rho), RHO_BIG, rho)

        def terms(row, pan, b0, b_y, b_v):
            return (
                row[:, :, None, None]  # (x, y)
                + row[:, None, None, :]  # (x, s)
                + row[:, None, t0:t1, None]  # (x, t)
                + pan[:, :, None, :]  # (y, s)
                + pan[:, :, t0:t1, None]  # (y, t)
                + pan[:, None, t0:t1, :]  # (t, s)
                + b0[:, None, None, None]
                + b_y[:, :, None, None]  # (y, u)
                + b_v[:, None, None, :]  # (s, u)
                + b_v[:, None, t0:t1, None]  # (t, u)
            )

        mean_ess = terms(nrv, Nbv, sum0, sum_y, sum_v) / terms(nrc, Nbc, cnt0, cnt_y, cnt_v)
        th_test = torch.tanh(th_t / torch.sqrt(mean_ess - float(lvl) - 3.0))
        t_set = torch.maximum(
            torch.maximum(tn[:, None, None, :], tn[:, None, t0:t1, None]),
            t_base[:, None, None, None],
        )
        margin = torch.where(
            (t_set > t_pair) | ~torch.isfinite(th_test) | (rho >= RHO_BIG),
            MARGIN_BIG, rho - th_test,
        )
        out = torch.minimum(out, margin.reshape(nt, d, -1).amin(2))
    return out


def hetcor2_local_sweep_pre(Cb, qb, Nb_raw, nr_raw, tn, t_x, deg, th: float):
    """Hetcor level 2 on gathered panels: min margin over all pairs, (nt, d)."""
    d = qb.shape[1]
    Nbv, Nbc = _ess_masked(Nb_raw)
    nrv, nrc = _ess_masked(nr_raw)
    return _hetcor_pair_margin(Cb, qb, Nbv, Nbc, nrv, nrc, tn, t_x, deg, d, d,
                               None, th, 2)


def hetcor3_local_sweep_pre(Cb, qb, Nb_raw, nr_raw, tn, t_x, deg, th: float):
    """Hetcor level 3: for each largest element u condition the panel on u
    and run the pair margin over s < t < u; the base element's ESS terms come
    from column u of the raw N (`cigwas_tpu.ops.pcorr._hetcor3_local_core`)."""
    nt, d = qb.shape
    Nbv, Nbc = _ess_masked(Nb_raw)
    nrv, nrc = _ess_masked(nr_raw)
    out = torch.full((nt, d), MARGIN_BIG, device=qb.device)
    for u in range(2, int(deg.max()) if nt else 0):
        cu = Cb[:, u, :]
        qu = qb[:, u]
        Ru = _rinv(cu)
        T1 = (Cb - cu[:, :, None] * cu[:, None, :]) * (Ru[:, :, None] * Ru[:, None, :])
        q1 = (qb - qu[:, None] * cu) * (_rinv(qu)[:, None] * Ru)
        base = (nrv[:, u], nrc[:, u], Nbv[:, :, u], Nbc[:, :, u],
                Nbv[:, :, u], Nbc[:, :, u], tn[:, u])
        m_u = _hetcor_pair_margin(T1, q1, Nbv, Nbc, nrv, nrc, tn, t_x, deg, u, u,
                                  base, th, 3)
        out = torch.where((u < deg)[:, None], torch.minimum(out, m_u), out)
    return out


def hetcor_local_sweep_plain(C, N, t_ix, node_ixs, nbrs, deg, th: float, l: int):
    """Plain version of the hetcor levels 1-3 kernel: the minimum margin
    |rho_{xy|S}| - tanh(th / sqrt(mean_ess - l - 3)) over the conditioning
    sets S of size l allowed by the time index, (nt, d) f32; MARGIN_BIG where
    no test is valid and at pad slots y >= deg. N is the per-pair ESS the
    levels use (raw, or :func:`trunc_ref_ess` of it); t_ix (vp,) integer."""
    nt, d = nbrs.shape
    step = max(1, PLAIN_ELEMS // max(1, d * d * (d if l > 1 else 1)))
    sweep = {1: hetcor1_local_sweep_pre, 2: hetcor2_local_sweep_pre,
             3: hetcor3_local_sweep_pre}[l]
    out = [
        sweep(*hetcor_local_gather(C, N, t_ix, node_ixs[i : i + step].long(),
                                   nbrs[i : i + step].long()),
              deg[i : i + step].long(), th)
        for i in range(0, nt, step)
    ]
    if not out:
        return torch.empty((0, d), dtype=torch.float32, device=C.device)
    return torch.cat(out)


def _pivoted_inverse(M: torch.Tensor):
    """Inverse of a batch of l x l blocks M (..., l, l) by Gauss-Jordan
    elimination with partial pivoting, the arithmetic of ``csrc/hetcor_scan.cu``
    op for op; returns (inverse, singular (...) bool).

    Step k takes as pivot the unused row with the largest |M[row, k]|, the
    lowest row on a tie (a NaN is never a pivot), and subtracts
    (M[i, k] / pivot) times the pivot row from every other row i, both
    halves of [M | I]: identical rows then cancel exactly, so an exactly
    singular block meets a zero pivot (``singular``; the caller sends its
    tests to the sentinel). The rows are not swapped: row k of the inverse
    is the right half of step k's pivot row over its pivot. No symmetry or
    definiteness is assumed (summary-statistic blocks may be indefinite)."""
    l = M.shape[-1]
    lead = M.shape[:-2]
    A = M.clone()
    B = torch.eye(l, dtype=M.dtype, device=M.device).expand(*lead, l, l).clone()
    rows = torch.arange(l, device=M.device)
    used = torch.zeros((*lead, l), dtype=torch.bool, device=M.device)
    singular = torch.zeros(lead, dtype=torch.bool, device=M.device)
    pivots = []
    for k in range(l):
        absv = torch.abs(A[..., k])
        best = torch.full(lead, -1.0, dtype=M.dtype, device=M.device)
        p = torch.zeros(lead, dtype=torch.int64, device=M.device)
        for i in range(l):
            cand = ~used[..., i] & (absv[..., i] > best)
            best = torch.where(cand, absv[..., i], best)
            p = torch.where(cand, i, p)
        singular = singular | ~(best > 0.0)
        at = p[..., None, None].expand(*lead, 1, l)
        Ap = torch.gather(A, -2, at)  # (..., 1, l)
        Bp = torch.gather(B, -2, at)
        pk = Ap[..., 0, k]
        f = (A[..., :, k] / pk[..., None])[..., None]  # (..., l, 1)
        is_p = (rows == p[..., None])[..., None]
        A[..., :, k + 1 :] = torch.where(is_p, A[..., :, k + 1 :],
                                         A[..., :, k + 1 :] - f * Ap[..., k + 1 :])
        B = torch.where(is_p, B, B - f * Bp)
        used = used | is_p[..., 0]
        pivots.append((at, pk))
    inv = torch.stack([torch.gather(B, -2, at)[..., 0, :] / pk[..., None]
                       for at, pk in pivots], -2)
    return inv, singular


def level_scan_hetcor_pre(C_x, c_row, N_x_raw, n_row_raw, t_nbrs, t_x, deg,
                          combos_seq, left_seq, th: float, l: int):
    """`cigwas_tpu.ops.pcorr.level_scan_hetcor` on gathered panels: the
    minimum margin over every scanned conditioning set, (nt, d); the plain
    version of the kernel ``csrc/hetcor_scan.cu`` (the wrapper
    :func:`cigwas_tpu_torch.ops.kernels.hetcor_sweep.hetcor_scan` runs it for
    CPU tensors), the same operations in the same order, chunk by chunk.

    combos_seq (nch, K, l) colex position tuples, left_seq (nch, nt) the valid
    leading sets of each chunk per node. A test of (x, y | S) compares |rho|
    = |H01| / sqrt(|H00 H11|) of the l x l block M2 = C[S, S], inverted by
    :func:`_inv_unrolled` for l <= 3 and :func:`_pivoted_inverse` above (an
    exactly singular block is the sentinel), with tanh(th / sqrt(mean_ess -
    l - 3)), mean_ess the mean of N over all variable pairs of {x, y} u S
    with NaNs left out, summed S-S (i over l, j < i), x-S, y-S, x-y; S may
    hold no variable later in time than max(t_x, t_y). MARGIN_BIG at pad
    slots, y in S, sets past left and non-finite statistics. A node whose
    gathered C panel or row holds a non-finite entry tests nothing: the
    one-hot selections of the JAX package smear it into every test."""
    nt, d = c_row.shape
    nch, K, _ = combos_seq.shape
    dev = c_row.device
    big = torch.tensor(MARGIN_BIG, device=dev)
    th_t = _f32(th, c_row)
    node_ok = torch.isfinite(C_x).all(2).all(1) & torch.isfinite(c_row).all(1)  # (nt,)
    N_v, N_c = _ess_masked(N_x_raw)
    n_v, n_c = _ess_masked(n_row_raw)
    t_pair = torch.maximum(t_x[:, None], t_nbrs)  # (nt, d)
    slot = torch.arange(d, device=dev)
    slot_ok = slot[None, :] < deg[:, None]  # (nt, d)
    nix = torch.arange(nt, device=dev)[:, None]  # (nt, 1)
    margin_min = torch.full((nt, d), MARGIN_BIG, device=dev)
    for ci in range(nch):
        S = [combos_seq[ci, :, i].clamp(0, d - 1)[None, :] for i in range(l)]  # (1, K)
        rows = [C_x[nix, S[i]] for i in range(l)]  # (nt, K, d): C[S_i, y]
        Cx = [c_row[nix, S[i]] for i in range(l)]  # (nt, K)
        M2 = [[C_x[nix, S[i], S[j]] for j in range(l)] for i in range(l)]
        if l <= 3:
            inv = _inv_unrolled(M2, l)
            singular = torch.zeros((nt, K), dtype=torch.bool, device=dev)
        else:
            inv_d, singular = _pivoted_inverse(
                torch.stack([torch.stack(M2[i], -1) for i in range(l)], -2))
            inv = [[inv_d[..., i, j] for j in range(l)] for i in range(l)]
        t = [sum(inv[i][j] * Cx[j] for j in range(l)) for i in range(l)]
        H00 = 1.0 - sum(Cx[i] * t[i] for i in range(l))  # (nt, K)
        H01 = c_row[:, None, :] - sum(rows[i] * t[i][..., None] for i in range(l))
        H11 = 1.0 - sum(rows[i] * inv[i][j][..., None] * rows[j]
                        for i in range(l) for j in range(l))
        rho = torch.abs(H01) * (1.0 / torch.sqrt(torch.abs(H00[..., None] * H11)))
        # the ESS terms of every variable pair of the test, NaNs left out
        s_SS = torch.zeros((nt, K), device=dev)
        c_SS = torch.zeros((nt, K), device=dev)
        for i in range(l):
            for j in range(i):
                s_SS = s_SS + N_v[nix, S[i], S[j]]
                c_SS = c_SS + N_c[nix, S[i], S[j]]
        s_xS = torch.zeros((nt, K), device=dev)
        c_xS = torch.zeros((nt, K), device=dev)
        for i in range(l):
            s_xS = s_xS + n_v[nix, S[i]]
            c_xS = c_xS + n_c[nix, S[i]]
        s_yS = torch.zeros((nt, K, d), device=dev)
        c_yS = torch.zeros((nt, K, d), device=dev)
        for i in range(l):
            s_yS = s_yS + N_v[nix, S[i]]
            c_yS = c_yS + N_c[nix, S[i]]
        total = s_SS[:, :, None] + s_xS[:, :, None] + s_yS + n_v[:, None, :]
        count = c_SS[:, :, None] + c_xS[:, :, None] + c_yS + n_c[:, None, :]
        th_test = torch.tanh(th_t / torch.sqrt(total / count - l - 3.0))
        tS_max = t_nbrs[nix, S[0]]
        for i in range(1, l):
            tS_max = torch.maximum(tS_max, t_nbrs[nix, S[i]])
        y_in_S = torch.zeros((1, K, d), dtype=torch.bool, device=dev)
        for i in range(l):
            y_in_S = y_in_S | (S[i][..., None] == slot)
        set_ok = (torch.arange(K, device=dev)[None, :] < left_seq[ci][:, None]) & ~singular
        ok = (set_ok[..., None] & slot_ok[:, None, :] & ~y_in_S & node_ok[:, None, None]
              & (rho < RHO_BIG) & ~(tS_max[..., None] > t_pair[:, None, :])
              & torch.isfinite(th_test))
        margin = torch.where(ok, rho - th_test, big)
        margin_min = torch.minimum(margin_min, margin.amin(1))
    return margin_min
