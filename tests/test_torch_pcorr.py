"""The port's CI-test sweeps against the JAX package's, on the CPU.

The local sweeps (levels 1-3) run through the wrapper
``cigwas_tpu_torch.ops.kernels.local_sweep.local_sweep``, which takes the
plain PyTorch version for CPU tensors; the CUDA kernel is held to that plain
version bit for bit on the card (chip_smoke.py, phase 3, and the
``cuda``-marked test at the end, which skips without a card).

Inputs are what the skeleton feeds the sweeps: sample correlation panels
(1% NaNs injected) and ascending neighbour lists of distinct variables that
exclude the node itself, with ragged degrees and pad slots. Tolerances:
positions (the sepset decisions) identical on every valid slot where a test
won; rho within rtol 1e-5, atol 1e-6, the repo's own bound between routes
that differ only in FMA contraction and rsqrt rounding (XLA:CPU's rsqrt
differs from the port's IEEE 1/sqrt by up to 2 ulp).
"""

import math

import numpy as np
import pytest
import torch

from torch_parity import (
    ATOL,
    RTOL,
    jax_local_sweep,
    set_threads,
    tied_case,
    torch_local_sweep,
)

set_threads()


def _sweep_case(seed, vp, nt, d, nan_frac, clustered):
    rng = np.random.default_rng(seed)
    C = np.corrcoef(rng.normal(size=(vp, 300))).astype(np.float32)
    C[rng.random((vp, vp)) < nan_frac] = np.nan
    np.fill_diagonal(C, 1.0)
    node_ixs = rng.choice(vp, nt, replace=False).astype(np.int32)
    deg = rng.integers(max(4, d // 2), d + 1, nt).astype(np.int32)
    deg[0] = d  # one full-width node
    nbrs = np.zeros((nt, d), np.int32)  # pad slots hold 0, as compaction leaves them
    for i, x in enumerate(node_ixs):
        if clustered:  # LD-like: neighbours within a window around the node
            lo = int(np.clip(x - 200, 0, vp - 400))
            pool = np.arange(lo, lo + 400)
        else:  # scattered over the whole panel
            pool = np.arange(vp)
        pool = pool[pool != x]
        nbrs[i, : deg[i]] = np.sort(rng.choice(pool, deg[i], replace=False))
    return C, node_ixs, nbrs, deg


@pytest.mark.parametrize("clustered", [False, True], ids=["scattered", "clustered"])
@pytest.mark.parametrize("l", [1, 2, 3])
def test_local_sweep_matches_jax(l, clustered):
    d = 64
    C, node_ixs, nbrs, deg = _sweep_case(20 + l, 2176, 9, d, 0.01, clustered)
    rho_j, pos_j = jax_local_sweep(C, node_ixs, nbrs, deg, l, ct=16 if l == 2 else 8)
    rho_t, pos_t = torch_local_sweep(C, node_ixs, nbrs, deg, l)
    valid = np.arange(d)[None, :] < deg[:, None]
    won = valid & (rho_j < 2.0)
    assert won.sum() > 0.9 * valid.sum()
    assert np.array_equal(pos_t[won], pos_j[won])
    assert np.array_equal(rho_t[valid] >= 2.0, rho_j[valid] >= 2.0)
    np.testing.assert_allclose(rho_t[valid], rho_j[valid], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("l", [1, 2, 3])
def test_local_sweep_pad_slots(l):
    """Slots y >= deg come back as (RHO_BIG, 0) at every level."""
    d = 24
    C, node_ixs, nbrs, deg = _sweep_case(5, 256, 6, d, 0.0, clustered=True)
    rho, pos = torch_local_sweep(C, node_ixs, nbrs, deg, l)
    pad = np.arange(d)[None, :] >= deg[:, None]
    assert pad.any()
    assert np.all(rho[pad] == 2.0)
    assert np.all(pos[pad] == 0)
    assert pos.shape == (6, d, l) and pos.dtype == np.int32


@pytest.mark.parametrize("l", [1, 2, 3])
def test_local_sweep_mixed_degrees_match_jax_pre(l):
    """A launch as the device-resident loop makes it, every node at the
    level's width d_pad: isolated nodes (degree 0), nodes below degree l + 1
    (no test), one hub at d_pad among light nodes. The port's sweep against
    JAX's
    ``level{1,2,3}_local_sweep_pre`` on the same gathered panels; a node
    without a test returns (RHO_BIG, 0) in every slot."""
    import jax.numpy as jnp

    from cigwas_tpu.ops import pcorr as jp
    from cigwas_tpu_torch.ops.kernels.local_sweep import local_sweep

    d = 24
    C, node_ixs, nbrs, _ = _sweep_case(70 + l, 512, 14, d, 0.01, clustered=True)
    deg = np.array([0, 0, 1, l, l, d, l + 1, 5, 7, 3, 9, 6, 4, 8], np.int32)
    nbrs = np.where(np.arange(d)[None, :] < deg[:, None], nbrs, 0).astype(np.int32)
    Cb = C[nbrs[:, :, None], nbrs[:, None, :]]
    qb = C[node_ixs[:, None], nbrs]
    args = (jnp.asarray(Cb), jnp.asarray(qb), jnp.asarray(deg))
    if l == 1:
        rho_j, pos_j = jp.level1_local_sweep_pre(*args)
        pos_j = np.asarray(pos_j)[:, :, None]
    else:
        fn = jp.level2_local_sweep_pre if l == 2 else jp.level3_local_sweep_pre
        rho_j, pos_j = fn(*args, ct=8)
    rho_j, pos_j = np.asarray(rho_j), np.asarray(pos_j).reshape(len(deg), d, l)
    rho_t, pos_t = local_sweep(*(torch.from_numpy(a) for a in (C, node_ixs, nbrs, deg)), l)
    rho_t, pos_t = rho_t.numpy(), pos_t.numpy()
    valid = np.arange(d)[None, :] < deg[:, None]
    won = valid & (rho_j < 2.0)
    assert won[deg > l].any() and not won[deg <= l].any()
    assert np.array_equal(pos_t[won], pos_j[won])
    assert np.array_equal(rho_t[valid] >= 2.0, rho_j[valid] >= 2.0)
    np.testing.assert_allclose(rho_t[valid], rho_j[valid], rtol=RTOL, atol=ATOL)
    assert np.all(rho_t[deg <= l] == 2.0) and np.all(pos_t[deg <= l] == 0)
    assert np.all(rho_t[~valid] == 2.0) and np.all(pos_t[~valid] == 0)


@pytest.mark.parametrize("l", [4, 5])
def test_level_scan_minrho_matches_jax(l):
    """Levels >= 4: colex chunks through one-hot selections and a batched
    inverse. Ranks identical where a test won; rho within the FMA/rsqrt
    tolerance (LU inverses round differently in the two libraries, well
    inside it here)."""
    import jax.numpy as jnp

    from cigwas_tpu.ops import pcorr as jp
    from cigwas_tpu.utils.combinatorics import colex_combinations_chunk
    from cigwas_tpu_torch.ops import pcorr as tp

    d, K, nch = 12, 64, 4
    C, node_ixs, nbrs, deg = _sweep_case(40 + l, 512, 5, d, 0.01, clustered=True)
    combos = colex_combinations_chunk(0, K * nch, l).reshape(nch, K, l)
    totals = np.array([min(math.comb(int(x), l), K * nch) for x in deg])
    left = np.clip(totals[None, :] - K * np.arange(nch)[:, None], 0, K).astype(np.int32)
    rho_j, rank_j = jp.level_scan_minrho(
        jnp.asarray(C), jnp.asarray(node_ixs), jnp.asarray(nbrs), jnp.asarray(deg),
        jnp.asarray(combos), jnp.asarray(left), l,
    )
    rho_j, rank_j = np.asarray(rho_j), np.asarray(rank_j)
    t = lambda a: torch.from_numpy(np.array(a)).long()
    rho_t, rank_t = tp.level_scan_minrho(
        torch.from_numpy(C), t(node_ixs), t(nbrs), t(deg), t(combos), t(left), l
    )
    rho_t, rank_t = rho_t.numpy(), rank_t.numpy()
    valid = np.arange(d)[None, :] < deg[:, None]
    won = valid & (rho_j < 2.0)
    assert won.any()
    assert np.array_equal(rank_t[won], rank_j[won])
    np.testing.assert_allclose(rho_t[valid], rho_j[valid], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("l", [4, 6])
def test_level_scan_takes_chunks_together_bit_for_bit(l, monkeypatch):
    """The scan with consecutive chunks taken together (the default budget)
    against one chunk a call: the same minima and ranks bit for bit, with
    valid counts that end inside a chunk and tied minima across chunks
    (every variable of the panel repeated, so a set and its copy tie)."""
    from cigwas_tpu_torch.ops import pcorr as tp
    from cigwas_tpu_torch.utils.combinatorics import colex_combinations_chunk

    d, K, nch = 12, 64, 8
    C, node_ixs, nbrs, deg = _sweep_case(60 + l, 256, 5, d, 0.01, clustered=True)
    C = np.kron(C, np.ones((2, 2), np.float32))  # variable 2i + 1 repeats 2i
    half = np.minimum(deg, d // 2)  # each neighbour a with its copy: 2a, 2a + 1
    pairs = np.stack([2 * nbrs[:, : d // 2], 2 * nbrs[:, : d // 2] + 1], -1).reshape(-1, d)
    node_ixs, deg = 2 * node_ixs, 2 * half
    nbrs = np.where(np.arange(d)[None, :] < deg[:, None], pairs, 0)
    combos = colex_combinations_chunk(0, K * nch, l).reshape(nch, K, l)
    totals = np.array([min(math.comb(int(x), l), K * nch - 37) for x in deg])
    left = np.clip(totals[None, :] - K * np.arange(nch)[:, None], 0, K)
    args = [torch.from_numpy(C)] + [torch.from_numpy(np.asarray(a)).long()
                                    for a in (node_ixs, nbrs, deg, combos, left)]
    assert tp._chunks_per_call(nch, len(deg) * K * d * l) == nch
    together = tp.level_scan_minrho(*args, l)
    monkeypatch.setattr(tp, "SCAN_ELEMS", 1)
    assert tp._chunks_per_call(nch, len(deg) * K * d * l) == 1
    alone = tp.level_scan_minrho(*args, l)
    valid = np.arange(d)[None, :] < deg[:, None]
    assert (together[0].numpy()[valid] < 2.0).any()
    assert torch.equal(together[0], alone[0]) and torch.equal(together[1], alone[1])


def test_level0_screen_matches_jax():
    """The Fisher-z screen decides identically (NaN keeps the edge)."""
    import jax.numpy as jnp

    from cigwas_tpu.ops import pcorr as jp
    from cigwas_tpu_torch.ops import pcorr as tp

    rng = np.random.default_rng(3)
    C = np.corrcoef(rng.normal(size=(200, 400))).astype(np.float32)
    C[rng.random(C.shape) < 0.01] = np.nan
    th0 = 0.1
    G_j = np.asarray(jp.level0_screen(jnp.asarray(C), jnp.float32(th0)))
    G_t = tp.level0_screen(torch.from_numpy(C), th0).numpy()
    assert np.array_equal(G_j, G_t)
    assert G_t[np.isnan(C) & ~np.eye(200, dtype=bool)].all()


def _rinv(x):
    return np.float32(1.0) / np.sqrt(np.abs(np.float32(1.0) - x * x))


def _pair_rho(Cb, q, y, t, s):
    """|pcorr(x, y | B t s)| from the level-|B| panel and row, in float32 and
    in the sweeps' association order."""
    rqt = _rinv(q[t])
    cts, cty = Cb[t, s], Cb[t, y]
    rts, rty = _rinv(cts), _rinv(cty)
    q2s = (q[s] - q[t] * cts) * (rqt * rts)
    q2y = (q[y] - q[t] * cty) * (rqt * rty)
    T2 = (Cb[y, s] - cty * cts) * (rty * rts)
    return np.abs(q2y - q2s * T2) * (_rinv(q2s) * _rinv(T2))


def _brute_force_sweep(Cb, q, dx, l):
    """Every test of one node in colex order (u, then t, then s ascending),
    one at a time, a strict < keeping the first of equal minima; returns
    (rho (dx,), pos (dx, l), ties (dx,) = tests equal to the minimum)."""
    rho = np.full(dx, 2.0, np.float32)
    pos = np.zeros((dx, l), np.int32)
    seen = [[] for _ in range(dx)]

    def offer(y, r, where):
        seen[y].append(r)
        if r < rho[y]:
            rho[y], pos[y] = r, where

    with np.errstate(all="ignore"):
        for y in range(dx):
            if l == 1:
                for s in range(dx):
                    if s != y:
                        c = Cb[s, y]
                        rc = _rinv(c)
                        rs = _rinv(q[s])
                        offer(y, np.abs(q[y] * (rs * rc) - (q[s] * rs) * (c * rc)), [s])
            elif l == 2:
                for t in range(1, dx):
                    for s in range(t):
                        if y not in (s, t):
                            offer(y, _pair_rho(Cb, q, y, t, s), [s, t])
            else:
                for u in range(2, dx):
                    cu = Cb[u, :]
                    Ru = _rinv(cu)
                    T1 = (Cb - cu[:, None] * cu[None, :]) * (Ru[:, None] * Ru[None, :])
                    q1 = (q - q[u] * cu) * (_rinv(q[u]) * Ru)
                    for t in range(1, u):
                        for s in range(t):
                            if y not in (s, t, u):
                                offer(y, _pair_rho(T1, q1, y, t, s), [s, t, u])
    ties = np.array([sum(r == m for r in rs) for rs, m in zip(seen, rho)])
    return rho, pos, ties


@pytest.mark.parametrize("l", [1, 2, 3])
def test_local_sweep_ties_take_lowest_colex_rank(l):
    """On a panel of repeated variables many sets give bitwise equal rho; the
    sweep returns the set of lowest colex rank among the equal minima, as a
    loop over the tests in colex order with a strict < does. This is the
    rule a kernel that splits the sets over threads has to keep."""
    C, node_ixs, nbrs, deg = tied_case(7)
    rho_t, pos_t = torch_local_sweep(C, node_ixs, nbrs, deg, l)
    tied_slots = 0
    for i, x in enumerate(node_ixs):
        nb = nbrs[i, : deg[i]]
        rho_b, pos_b, ties = _brute_force_sweep(C[np.ix_(nb, nb)], C[x, nb], int(deg[i]), l)
        assert np.array_equal(rho_t[i, : deg[i]].view(np.int32), rho_b.view(np.int32))
        assert np.array_equal(pos_t[i, : deg[i]], pos_b)
        tied_slots += int(((ties > 1) & (rho_b < 2.0)).sum())
    assert tied_slots >= 6, f"only {tied_slots} slots with a tied minimum"


@pytest.mark.cuda
@pytest.mark.parametrize("l", [1, 2, 3])
def test_local_sweep_kernel_matches_plain(l):
    """On a card: the CUDA kernel equals its plain version bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from cigwas_tpu_torch.ops import pcorr as tp
    from cigwas_tpu_torch.ops.kernels.local_sweep import local_sweep

    for d in (40, 300):
        C, node_ixs, nbrs, deg = _sweep_case(60 + l, 2176, 5, d, 0.01, clustered=False)
        args = [torch.from_numpy(a).cuda() for a in (C, node_ixs, nbrs, deg)]
        rho_k, pos_k = local_sweep(*args, l)
        rho_p, pos_p = tp.local_sweep_plain(*args, l)
        assert torch.equal(rho_k, rho_p)
        assert torch.equal(pos_k, pos_p)
