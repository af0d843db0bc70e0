"""The multi-device skeleton step over a (block, marker, sample) mesh
(`cigwas_tpu.parallel.spmd`).

One step runs, for a batch of LD blocks:

1. the one-hot genotype decode of each (marker shard, sample shard) tile,
2. contingency counts: the tile's one-hots against the one-hots of every
   marker's codes in the same samples (gathered over ``marker``), summed
   over ``sample`` -> each marker shard owns the Kendall rows of its
   markers,
3. marker-phen and phen-phen Pearson correlations with the same sum over
   ``sample``,
4. the Fisher-z level-0 screen of the shard's rows,
5. an unmasked dense level-1 sweep of the shard's rows: the min over every
   single conditioning variable s != x, y of the Fisher z of
   (c_xy - c_xs c_ys) / sqrt(|(1 - c_xs^2)(1 - c_ys^2)|),

and returns the adjacency of each block, symmetrised. One process drives
every shard of the mesh (a device may repeat): the JAX package's
``all_gather`` over ``marker`` / ``sample`` becomes copies between the
shards' devices, its ``psum`` over ``sample`` the sum of the shards' parts
in sample order on the first device of the shard's sample axis, where the
rest of the shard's work then runs (every sample shard of the JAX step
computes the same thing). The contingency products are exact int8 products
(``torch._int_mm``), the Pearson sums float32 matmuls. The level-1 sweep is
not a route of the skeleton (it masks no s by the adjacency): plain
PyTorch, tiled over x rows.
"""

from __future__ import annotations

import torch

from cigwas_tpu_torch.ops.corr import _kendall_from_counts
from cigwas_tpu_torch.ops.decode import contingency_counts, geno_onehot, geno_value_valid
from cigwas_tpu_torch.parallel.mesh import Mesh

# elements of the largest (rows, v, v) intermediate of the level-1 sweep
SWEEP_ELEMS = 1 << 26


def _onehot(codes: torch.Tensor) -> torch.Tensor:
    """(m, n) 2-bit codes -> (3m, n) int8 one-hot, channel-major, missing
    folded to zero."""
    return geno_onehot(codes).reshape(3 * codes.shape[0], -1)


def _fisher(v: torch.Tensor) -> torch.Tensor:
    return torch.abs(0.5 * torch.log(torch.abs((1.0 + v) / (1.0 - v))))


def _psum(parts: list) -> torch.Tensor:
    """The sum over ``sample`` of one value's parts (one per sample shard,
    each on its shard's device), in sample order, on the first's device."""
    acc = parts[0]
    for t in parts[1:]:
        acc = acc + t.to(acc.device)
    return acc


def _level1_min_z(rows: torch.Tensor, C_full: torch.Tensor, x0: int) -> torch.Tensor:
    """min over s != x, y of the level-1 Fisher z of every (x, y), x the rows
    x0 .. x0 + len(rows) - 1 of C_full; non-finite tests count as inf."""
    ms, v = rows.shape
    dev = rows.device
    s_ix = torch.arange(v, device=dev)
    step = max(1, SWEEP_ELEMS // (v * v))
    out = []
    for a in range(0, ms, step):
        r = rows[a : a + step]
        cxs = r[:, None, :]  # (t, 1, v) over s
        cys = C_full[None, :, :]  # (1, v(y), v(s))
        num = r[:, :, None] - cxs * cys
        den = torch.sqrt(torch.abs((1.0 - cxs**2) * (1.0 - cys**2)))
        z1 = _fisher(num / den)
        x_ix = x0 + a + torch.arange(r.shape[0], device=dev)
        mask = (s_ix[None, None, :] == x_ix[:, None, None]) | (
            s_ix[None, None, :] == s_ix[None, :, None])
        z1 = torch.where(mask | ~torch.isfinite(z1), torch.inf, z1)
        out.append(z1.amin(dim=2))
    return torch.cat(out)


def _block_step(codes_b: torch.Tensor, phen_b: torch.Tensor, grid, th0: torch.Tensor,
                th1: torch.Tensor) -> torch.Tensor:
    """One block over its (marker, sample) grid of devices: the adjacency
    (v, v) int32 on grid[0][0]."""
    M, S = len(grid), len(grid[0])
    m, n = codes_b.shape
    p = phen_b.shape[0]
    ms, ns = m // M, n // S
    tiles = [[codes_b[i * ms : (i + 1) * ms, j * ns : (j + 1) * ns].to(grid[i][j])
              for j in range(S)] for i in range(M)]
    phen = [phen_b[:, j * ns : (j + 1) * ns] for j in range(S)]
    rows_of, mp_of, pp_of = [], [], []
    for i in range(M):
        counts, s_mp, s_p, n_val, s_v, s_vv, pp = ([] for _ in range(7))
        for j in range(S):
            dev = grid[i][j]
            codes_all = torch.cat([tiles[k][j].to(dev) for k in range(M)])  # all_gather(marker)
            counts.append(contingency_counts(_onehot(tiles[i][j]), _onehot(codes_all)))
            vals, valid = geno_value_valid(tiles[i][j])
            ph = phen[j].to(dev)
            s_mp.append(torch.matmul(vals * valid, ph.T))
            s_p.append(torch.matmul(valid, ph.T))
            n_val.append(torch.sum(valid, dim=1, keepdim=True))
            s_v.append(torch.sum(vals * valid, dim=1, keepdim=True))
            s_vv.append(torch.sum(vals**2 * valid, dim=1, keepdim=True))
            pp.append(torch.matmul(ph, ph.T))
        C_mm = _kendall_from_counts(_psum(counts).to(torch.float32), ms, m)
        nv = _psum(n_val)
        mean = _psum(s_v) / nv
        var = _psum(s_vv) / nv - mean**2
        C_mp = (_psum(s_mp) - mean * _psum(s_p)) / (nv * torch.sqrt(var))  # (ms, p)
        pp_n = _psum([torch.full((), float(ns), device=grid[i][j]) for j in range(S)])
        rows_of.append(torch.cat([C_mm, C_mp], dim=1))  # (ms, m + p)
        mp_of.append(C_mp)
        pp_of.append(_psum(pp) / pp_n)
    G_rows = []
    for i in range(M):
        dev = rows_of[i].device
        C_mp_all = torch.cat([t.to(dev) for t in mp_of])  # all_gather(marker)
        trait_rows = torch.cat([C_mp_all.T, pp_of[i]], dim=1)  # (p, m + p)
        C_full = torch.cat([*(t.to(dev) for t in rows_of), trait_rows])  # (v, v)
        keep = (_fisher(rows_of[i]) >= th0.to(dev)) & (
            _level1_min_z(rows_of[i], C_full, i * ms) >= th1.to(dev))
        G_rows.append(keep.to(torch.int32))
        if i == 0:
            G_traits = (_fisher(trait_rows) >= th0.to(dev)).to(torch.int32)
    home = grid[0][0]
    G = torch.cat([*(g.to(home) for g in G_rows), G_traits])  # (v, v)
    G = G * G.T  # an edge survives where both sides kept it
    return G * (1 - torch.eye(m + p, dtype=torch.int32, device=home))


def build_multichip_cusk_step(mesh: Mesh, th0: float, th1: float):
    """The step over a mesh with axes (block, marker, sample)
    (`cigwas_tpu.parallel.spmd.build_multichip_cusk_step`): step(codes (B, m,
    n) integer 2-bit codes, phen (B, p, n) float32 standardised traits) ->
    G (B, m + p, m + p) int32 on the mesh's first device. B, m and n must
    divide by the axes' sizes; block shard b takes blocks b Bs .. (b + 1) Bs -
    1 on its (marker, sample) grid of devices."""
    for ax in ("block", "marker", "sample"):
        if ax not in mesh.axis_names:
            raise ValueError(f"the step needs a mesh with axis {ax!r}: {mesh.axis_names}")
    order = [mesh.axis_names.index(ax) for ax in ("block", "marker", "sample")]
    devices = mesh.devices.transpose(order)
    nb, nm, ns = devices.shape
    t0 = torch.tensor(th0, dtype=torch.float32)
    t1 = torch.tensor(th1, dtype=torch.float32)

    def step(codes, phen) -> torch.Tensor:
        codes = torch.as_tensor(codes)
        phen = torch.as_tensor(phen, dtype=torch.float32)
        B, m, n = codes.shape
        if B % nb or m % nm or n % ns:
            raise ValueError(f"codes {tuple(codes.shape)} do not split over the mesh "
                             f"(block {nb}, marker {nm}, sample {ns})")
        Bs = B // nb
        out = []
        for b in range(B):
            grid = [list(row) for row in devices[b // Bs]]
            out.append(_block_step(codes[b], phen[b], grid, t0, t1))
        home = devices.flat[0]
        return torch.stack([g.to(home) for g in out])

    return step
