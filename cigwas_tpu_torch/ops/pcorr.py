"""Partial-correlation CI tests of the skeleton levels, in plain PyTorch.

Counterpart of :mod:`cigwas_tpu.ops.pcorr`. Three groups:

* :func:`level0_screen` — the Fisher-z marginal screen;
* :func:`local_sweep_plain` — levels 1-3 on each node's local panel, the
  plain version of the CUDA kernel ``csrc/local_sweep.cu`` (the wrapper
  :func:`cigwas_tpu_torch.ops.kernels.local_sweep.local_sweep` runs it for
  CPU tensors; on the card the kernel runs and this is what it is held to);
* :func:`level_scan_minrho` — levels >= 4 over colex chunks of conditioning
  sets, with one-hot selection matmuls like the JAX package, so a NaN in a
  local panel sends a test to ``RHO_BIG`` the same way.

Every ``rsqrt`` of the JAX sweeps is spelled ``1 / sqrt``: that is IEEE
exact on both CPU and CUDA, so the kernel (built with ``-fmad=false``) and
this file agree bit for bit. Neither is bit-identical to JAX, whose CPU
``rsqrt`` differs from ``1 / sqrt`` by up to 2 ulp.
"""

from __future__ import annotations

import torch

# sentinel for masked or non-finite tests; |rho| <= 1 for any valid test
RHO_BIG = 2.0
# elements of the largest live intermediate of the plain sweeps
PLAIN_ELEMS = 1 << 24


def _rinv(x: torch.Tensor) -> torch.Tensor:
    """rsqrt(|1 - x*x|) of the JAX sweeps."""
    return 1.0 / torch.sqrt(torch.abs(1.0 - x * x))


def level0_screen(C: torch.Tensor, th0: float) -> torch.Tensor:
    """Level-0 adjacency: delete iff fisher-z < th0 (`cal_Indepl0`); a NaN z
    compares false and keeps the edge; the diagonal is cleared."""
    z0 = torch.abs(0.5 * torch.log(torch.abs((1 + C) / (1 - C))))
    eye = torch.eye(C.shape[0], dtype=torch.bool, device=C.device)
    return ~(z0 < th0) & ~eye


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


def _combo_onehots(combos: torch.Tensor, d: int, l: int):
    """One-hot selection matrices for each combo position, l x (K, d)."""
    slot = torch.arange(d, device=combos.device)[None, :]
    return [(combos[:, i][:, None] == slot).to(torch.float32) for i in range(l)]


def _pcorr_rho_local(C_x, c_row, deg, left, sel, combos, l: int):
    """Level-l |rho| of a node tile from local panels, (nt, K, d).

    Batched `cigwas_tpu.ops.pcorr._pcorr_rho_local` (l >= 4 there uses a
    batched LU inverse; so does this). Rows of the conditioning sets are
    selected with one-hot matmuls, so a NaN anywhere in a selected row
    smears through 0 * NaN and sends the test to RHO_BIG, as in JAX."""
    K, d = sel[0].shape
    rows = [torch.matmul(sel[i], C_x) for i in range(l)]  # l x (nt, K, d)
    Cx = [torch.sum(sel[i] * c_row[:, None, :], dim=2) for i in range(l)]  # (nt, K)
    M2d = torch.stack(
        [torch.stack([torch.sum(rows[i] * sel[j], dim=2) for j in range(l)], -1)
         for i in range(l)],
        -2,
    )  # (nt, K, l, l)
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
    k_ix = torch.arange(K, device=C_x.device)
    slot_ix = torch.arange(d, device=C_x.device)
    combo_ok = k_ix[None, :] < left[:, None]  # (nt, K)
    slot_ok = slot_ix[None, :] < deg[:, None]  # (nt, d)
    y_in_S = torch.zeros((K, d), dtype=torch.bool, device=C_x.device)
    for i in range(l):
        y_in_S = y_in_S | (combos[:, i][:, None] == slot_ix[None, :])
    invalid = ~combo_ok[:, :, None] | ~slot_ok[:, None, :] | y_in_S[None]
    return torch.where(invalid | ~torch.isfinite(rho), RHO_BIG, rho)


def level_scan_minrho(C, node_ixs, nbrs, deg, combos_seq, left_seq, l: int):
    """Many chunks of level-l CI tests (`cigwas_tpu.ops.pcorr.level_scan_minrho`).

    combos_seq: (nch, K, l) colex position tuples; left_seq: (nch, nt) valid
    rows per node per chunk. Returns (rho_min (nt, d), rank (nt, d) int64):
    the minimum |rho| over every scanned set and the launch-local rank
    (chunk * K + first argmin over K) that achieves it, merged across chunks
    with a strict <."""
    C_x, c_row = _local_panels(C, node_ixs, nbrs)
    nt, d = c_row.shape
    nch, K, _ = combos_seq.shape
    rho_min = torch.full((nt, d), RHO_BIG, device=C.device)
    rank = torch.zeros((nt, d), dtype=torch.int64, device=C.device)
    for ci in range(nch):
        combos = combos_seq[ci]
        sel = _combo_onehots(combos, d, l)
        rho = _pcorr_rho_local(C_x, c_row, deg, left_seq[ci], sel, combos, l)
        rho_c = rho.amin(1)
        k_ix = torch.arange(K, device=C.device)[None, :, None]
        argk = torch.where(rho == rho_c[:, None, :], k_ix, K).amin(1)
        better = rho_c < rho_min
        rho_min = torch.where(better, rho_c, rho_min)
        rank = torch.where(better, ci * K + argk, rank)
    return rho_min, rank
