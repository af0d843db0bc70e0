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

from torch_parity import ATOL, RTOL, jax_local_sweep, set_threads, torch_local_sweep

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
