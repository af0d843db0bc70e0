"""The dense level-1 sweeps of the port (`ops/kernels/dense_l1.py`, the
one-card entry points in `ops/pcorr.py`) on the CPU: against the JAX package's
`level1_dense_minrho` and `hetcor1_dense_margin` (rho and margins within the
parity tolerance, the minimizing s identical), and against the port's own
list route (the level-1 local sweeps), bit for bit, as both follow the same
operations. The kernel itself runs on the card only; its test carries the
`cuda` marker.
"""

import numpy as np
import pytest
import torch

from torch_parity import ATOL, RTOL, ar1_panel, set_threads

from cigwas_tpu_torch.ops import pcorr
from cigwas_tpu_torch.ops.kernels import dense_l1 as dk

set_threads()


def _case(seed: int, v: int = 90, vp: int = 128, cut: float = 0.25):
    """An AR(1) panel padded to vp with a NaN pair, an adjacency of the
    entries above cut (symmetric, no diagonal), a per-pair ESS with NaNs
    and a time index in {0, 1, 2}."""
    rng = np.random.default_rng(seed)
    C = ar1_panel(seed, v, 400, vp)
    C[5, 7] = C[7, 5] = np.nan
    G = np.abs(np.nan_to_num(C)) > cut
    G[rng.random((vp, vp)) < 0.02] = True
    G = G | G.T
    np.fill_diagonal(G, False)
    N = rng.uniform(150.0, 400.0, size=(vp, vp)).astype(np.float32)
    N = (N + N.T) / 2
    hole = np.triu(rng.random((vp, vp)) < 0.05, 1)
    N[hole | hole.T] = np.nan
    t = rng.integers(0, 3, vp).astype(np.int32)
    return C, G, N, t


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_level1_dense_minrho_matches_jax(seed):
    """rho within the parity tolerance; the minimizing s identical on every
    pair of distinct variables (x == y is a rounding residue near 1)."""
    import jax.numpy as jnp

    from cigwas_tpu.ops import pcorr as jp

    C, G, _, _ = _case(seed)
    rho_j, s_j = (np.asarray(a) for a in jp.level1_dense_minrho(jnp.asarray(C), jnp.asarray(G)))
    rho_t, s_t = (t.numpy() for t in pcorr.level1_dense_minrho(torch.from_numpy(C), G, rows=24))
    np.testing.assert_allclose(rho_t, rho_j, rtol=RTOL, atol=ATOL)
    off = ~np.eye(len(C), dtype=bool)
    assert np.array_equal(s_t[off], s_j[off])
    assert (rho_t[G] < pcorr.RHO_BIG).sum() > 1000


@pytest.mark.parametrize("seed", [3, 4])
@pytest.mark.parametrize("ess_mode", ["float", "reference"])
def test_hetcor1_dense_margin_matches_jax(seed, ess_mode):
    import jax.numpy as jnp

    from cigwas_tpu.ops import pcorr as jp

    C, G, N, t = _case(seed)
    if ess_mode == "reference":
        N = np.trunc(np.nan_to_num(N, nan=0.0)).astype(np.float32)
    th = 4.0
    m_j = np.asarray(jp.hetcor1_dense_margin(jnp.asarray(C), jnp.asarray(N), jnp.asarray(t), G,
                                             th))
    m_t = pcorr.hetcor1_dense_margin(torch.from_numpy(C), torch.from_numpy(N),
                                     torch.from_numpy(t), G, th, rows=40).numpy()
    np.testing.assert_allclose(m_t, m_j, rtol=RTOL, atol=ATOL)
    sure = np.abs(m_j) > 1e-6
    assert np.array_equal((m_t < 0)[sure], (m_j < 0)[sure])
    assert 0 < int(((m_t < 0) & G).sum()) < int(G.sum())


def _lists(G: np.ndarray):
    from cigwas_tpu_torch.skeleton.cupc import _compact_neighbors

    nodes = np.arange(len(G), dtype=np.int32)
    d = int(G.sum(1).max())
    nbrs, deg = _compact_neighbors(G, nodes, d)
    return [torch.from_numpy(a) for a in (nodes, nbrs, deg)]


@pytest.mark.parametrize("seed", [0, 5])
def test_dense_route_equals_list_route_bitwise(seed):
    """For every node x and neighbour y: the dense route's rho[x, y] has the
    bits of the level-1 local sweep's slot y, and its s is the neighbour at
    the local sweep's position (the same operations in the same order)."""
    C, G, _, _ = _case(seed)
    Ct = torch.from_numpy(C)
    rho_d, s_d = pcorr.level1_dense_minrho(Ct, G)
    nodes, nbrs, deg = _lists(G)
    rho_l, pos_l = pcorr.local_sweep_plain(Ct, nodes, nbrs, deg, 1)
    live = torch.arange(nbrs.shape[1])[None, :] < deg[:, None].long()
    x = nodes.long()[:, None].expand_as(nbrs)[live]
    y = nbrs.long()[live]
    assert torch.equal(rho_d[x, y].view(torch.int32), rho_l[live].view(torch.int32))
    won = rho_l[live] < pcorr.RHO_BIG
    s_l = torch.gather(nbrs.long(), 1, pos_l[..., 0].long())[live]
    assert torch.equal(s_d[x, y].long()[won], s_l[won])


def test_dense_route_equals_list_route_on_an_asymmetric_panel():
    """A panel whose C[s, y] and C[y, s] differ in the last bits (as the
    striped panels' Kendall sums may round) and an asymmetric N: the dense
    routes read the entries the list routes read, so the bits still agree."""
    C, G, N, t = _case(10)
    rng = np.random.default_rng(10)
    C = (C * (1 + 1e-7 * rng.integers(-3, 4, C.shape))).astype(np.float32)
    assert not np.array_equal(C, C.T)
    Ct = torch.from_numpy(C)
    rho_d, _ = pcorr.level1_dense_minrho(Ct, G)
    nodes, nbrs, deg = _lists(G)
    rho_l, _ = pcorr.local_sweep_plain(Ct, nodes, nbrs, deg, 1)
    live = torch.arange(nbrs.shape[1])[None, :] < deg[:, None].long()
    x = nodes.long()[:, None].expand_as(nbrs)[live]
    y = nbrs.long()[live]
    assert torch.equal(rho_d[x, y].view(torch.int32), rho_l[live].view(torch.int32))
    args = [Ct, torch.from_numpy(N), torch.from_numpy(t)]
    m_d = pcorr.hetcor1_dense_margin(*args, G, 3.5)
    m_l = pcorr.hetcor_local_sweep_plain(*args, nodes, nbrs, deg, 3.5, 1)
    assert torch.equal(m_d[x, y].view(torch.int32), m_l[live].view(torch.int32))


@pytest.mark.parametrize("seed", [1, 6])
def test_hetcor_dense_route_equals_list_route_bitwise(seed):
    C, G, N, t = _case(seed)
    args = [torch.from_numpy(a) for a in (C, N, t)]
    m_d = pcorr.hetcor1_dense_margin(*args, G, 3.5)
    nodes, nbrs, deg = _lists(G)
    m_l = pcorr.hetcor_local_sweep_plain(*args, nodes, nbrs, deg, 3.5, 1)
    live = torch.arange(nbrs.shape[1])[None, :] < deg[:, None].long()
    x = nodes.long()[:, None].expand_as(nbrs)[live]
    y = nbrs.long()[live]
    assert torch.equal(m_d[x, y].view(torch.int32), m_l[live].view(torch.int32))


def test_slabs_and_ring_steps_compose_the_same_bits():
    """x slabs of any height and y slabs at any offset (a ring's steps)
    give the full sweep's bits: every (x, y) meets all its s in one launch."""
    C, G, N, t = _case(7)
    Ct, Gt, Nt, tt = (torch.from_numpy(a) for a in (C, G, N, t))
    rho, s = pcorr.level1_dense_minrho(Ct, G)
    margin = pcorr.hetcor1_dense_margin(Ct, Nt, tt, G, 3.0)
    R, P = dk.factors(Ct)
    for x0, x1 in ((0, 7), (40, 128)):
        for y0, y1 in ((0, 32), (32, 128), (96, 128)):
            RT, PT = R[:, y0:y1].contiguous(), P[:, y0:y1].contiguous()
            got = dk.dense_l1(Ct[x0:x1], R[x0:x1], P[x0:x1], Gt[x0:x1], RT, PT, x0, y0)
            assert torch.equal(got[0].view(torch.int32), rho[x0:x1, y0:y1].view(torch.int32))
            assert torch.equal(got[1], s[x0:x1, y0:y1])
            m = dk.hetcor_dense_l1(Ct[x0:x1], R[x0:x1], P[x0:x1], Gt[x0:x1], Nt[x0:x1],
                                   RT, PT, Nt[y0:y1].T.contiguous(), tt, x0, y0, 3.0)
            assert torch.equal(m.view(torch.int32), margin[x0:x1, y0:y1].view(torch.int32))


def test_level1_dense_screen_lists_the_hits():
    """The screen's hits are the (x, y) with rho < rho_th on an edge, in
    row-major order, with the minrho's s and rho."""
    C, G, _, _ = _case(8)
    Ct = torch.from_numpy(C)
    rho, s = (t.numpy() for t in pcorr.level1_dense_minrho(Ct, G))
    rho_th = float(np.float32(0.08))
    side, xs, ys, s_sel, rho_sel = pcorr.level1_dense_screen(Ct, G, rho_th, rows=48)
    want = (rho < rho_th) & G
    assert np.array_equal(side, want) and want.sum() > 0
    ex, ey = np.nonzero(want)
    assert np.array_equal(xs, ex) and np.array_equal(ys, ey)
    assert np.array_equal(s_sel, s[ex, ey]) and np.array_equal(rho_sel, rho[ex, ey])
    cond = pcorr.dense1_screen(pcorr.dense1_sweeps(
        Ct, G, torch.full_like(Ct, 300.0), torch.zeros(len(C), dtype=torch.int32), 3.0,
        rows=48), len(C))
    margin = pcorr.hetcor1_dense_margin(Ct, torch.full_like(Ct, 300.0),
                                        torch.zeros(len(C), dtype=torch.int32), G, 3.0).numpy()
    assert np.array_equal(cond, (margin < 0) & G)


def test_ties_resolve_to_the_smallest_s():
    """A panel in which every variable stands four times: the copies of a
    conditioning variable give bitwise equal tests, and the smallest live
    copy must win, as the list route's first position does."""
    C, G, _, _ = _case(9, v=32, vp=32)
    ix = np.arange(128) // 4
    Ct = torch.from_numpy(np.ascontiguousarray(C[ix][:, ix]))
    Gt = np.ascontiguousarray(G[ix][:, ix])
    np.fill_diagonal(Gt, False)
    rho, s = (t.numpy() for t in pcorr.level1_dense_minrho(Ct, Gt))
    xs, ys = np.nonzero((rho < pcorr.RHO_BIG) & Gt)
    assert len(xs) > 100
    for x, y in zip(xs, ys):
        group = 4 * (s[x, y] // 4) + np.arange(4)
        live = [c for c in group if Gt[x, c] and c != x and c != y]
        assert s[x, y] == min(live), (x, y, s[x, y], live)


def test_wrappers_refuse_other_devices_and_shapes():
    C = torch.zeros((8, 8), device="meta")
    with pytest.raises(ValueError):
        dk.dense_l1(C, C, C, C.bool(), C, C, 0, 0)
    with pytest.raises(ValueError):
        dk.hetcor_dense_l1(C, C, C, C.bool(), C, C, C, C, C.int()[0], 0, 0, 1.0)
    with pytest.raises(ValueError):
        dk.plan("dense_l1", 0, 8, 8)
    with pytest.raises(ValueError):
        dk.plan("local_sweep", 8, 8, 8)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the dense kernel has no CPU build")


@pytest.mark.cuda
@pytest.mark.parametrize("slab", [(0, 256, 0, 1024), (700, 811, 130, 900)])
def test_card_kernel_equals_plain(slab):
    """On the card: both entries bit for bit against their plain versions."""
    _card()
    C, G, N, t = _case(11, v=900, vp=1024)
    Cd, Gd, Nd, td = (torch.from_numpy(a).cuda() for a in (C, G, N, t))
    R, P = dk.factors(Cd)
    x0, x1, y0, y1 = slab
    RT, PT = R[:, y0:y1].contiguous(), P[:, y0:y1].contiguous()
    args = (Cd[x0:x1], R[x0:x1], P[x0:x1], Gd[x0:x1], RT, PT, x0, y0)
    for got, exp in zip(dk.dense_l1(*args), dk.dense_l1_plain(*args)):
        assert torch.equal(got.view(torch.int32), exp.view(torch.int32))
    hargs = (Cd[x0:x1], R[x0:x1], P[x0:x1], Gd[x0:x1], Nd[x0:x1], RT, PT,
             Nd[y0:y1].T.contiguous(), td, x0, y0, 3.0)
    assert torch.equal(dk.hetcor_dense_l1(*hargs).view(torch.int32),
                       dk.hetcor_dense_l1_plain(*hargs).view(torch.int32))
