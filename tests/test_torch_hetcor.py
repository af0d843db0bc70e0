"""The port's hetcor (summary-statistic) tests against the JAX package's, on
the CPU: level 0, the ESS transform, the levels 1-3 margin sweeps (the plain
version of ``csrc/hetcor_sweep.cu``), the level >= 4 scan, the plain panel
gathers (of ``csrc/panel_gather.cu``) against the Pallas kernels in
interpret mode, and the whole hetcor skeleton.

Tolerance of the margins: atol 1e-6 (the parity contract's; XLA:CPU's rsqrt,
tanh and FMA contraction differ from torch's by ulps), with identical signs
wherever |margin| > 1e-6. Decisions (adjacency) are compared exactly.
"""

import math

import numpy as np
import pytest
import torch

from torch_parity import (
    ATOL,
    factor_panel,
    hetcor_case,
    hetcor_inputs_to_torch,
    hetcor_neighbours,
    set_threads,
    tied_case,
)

from cigwas_tpu.utils.stats import hetcor_threshold

set_threads()

TH = hetcor_threshold(1e-3)
BIG = 3.0e38


def _assert_margins(got: np.ndarray, exp: np.ndarray):
    """Same sentinel positions, finite margins within ATOL, signs identical
    outside it."""
    assert got.shape == exp.shape
    big_g, big_e = got >= BIG, exp >= BIG
    np.testing.assert_array_equal(big_g, big_e)
    ok = ~big_e
    np.testing.assert_allclose(got[ok], exp[ok], rtol=0, atol=ATOL)
    firm = ok & (np.abs(exp) > ATOL)
    np.testing.assert_array_equal(got[firm] < 0, exp[firm] < 0)
    assert ok.any() and (exp[ok] < 0).any() and (exp[ok] > 0).any()


def test_hetcor_l0_and_trunc_ref_ess_exact():
    import jax.numpy as jnp

    from cigwas_tpu.ops import pcorr as jp
    from cigwas_tpu_torch.ops import pcorr as tp

    _, N, _ = hetcor_case(0, 40)
    rng = np.random.default_rng(0)
    C = (0.06 * rng.normal(size=(40, 40))).astype(np.float32)
    C = ((C + C.T) / 2).astype(np.float32)  # some pairs below, some above
    np.fill_diagonal(C, 1.0)
    N[3, 5] = N[5, 3] = 2.5  # N - 3 < 0: NaN threshold keeps the edge
    Ct, Nt, _, _ = hetcor_inputs_to_torch(C, N, np.ones((40, 40)), np.zeros(40))
    exp = np.unpackbits(
        np.asarray(jp.hetcor_l0_packed(jnp.asarray(C), jnp.asarray(N), jnp.float32(TH))),
        axis=1, count=40,
    ).astype(bool)
    got = tp.hetcor_l0_delete(Ct, Nt, TH).numpy()
    np.testing.assert_array_equal(got, exp)
    assert exp.any() and not exp.all() and not got[3, 5]
    np.testing.assert_array_equal(
        tp.trunc_ref_ess(Nt).numpy(), np.asarray(jp.trunc_ref_ess(jnp.asarray(N)))
    )
    assert np.isnan(N).any() and not np.isnan(tp.trunc_ref_ess(Nt).numpy()).any()


@pytest.mark.parametrize("ess_mode", ["float", "reference"])
@pytest.mark.parametrize("l", [1, 2, 3])
def test_hetcor_local_sweep_plain_matches_jax(l, ess_mode):
    """15% NaN ESS, time indices in {0, 1, 2}, ragged degrees, d = 24."""
    import jax.numpy as jnp

    from cigwas_tpu.ops import pcorr as jp
    from cigwas_tpu_torch.ops.kernels import hetcor_sweep as hs

    v, nt, d = 60, 9, 24
    C, N, t_ix = hetcor_case(10 + l, v, t_max=2)
    if ess_mode == "reference":
        N = np.trunc(np.nan_to_num(N, nan=0.0)).astype(np.float32)
    node_ixs, nbrs, deg = hetcor_neighbours(l, v, nt, d)
    args = [jnp.asarray(a) for a in (C, N, t_ix, node_ixs, nbrs, deg)]
    if l == 1:
        exp = jp.hetcor1_local_sweep(*args, jnp.float32(TH))
    else:
        fn = jp.hetcor2_local_sweep if l == 2 else jp.hetcor3_local_sweep
        exp = fn(*args, jnp.float32(TH), 8)
    exp = np.asarray(exp)
    Ct, Nt, _, tt = hetcor_inputs_to_torch(C, N, np.zeros((v, v)), t_ix)
    hs.reset_launches()
    got = hs.hetcor_local_sweep(
        Ct, Nt, tt, torch.from_numpy(node_ixs), torch.from_numpy(nbrs),
        torch.from_numpy(deg), TH, l,
    ).numpy()
    assert hs.launches == {1: 0, 2: 0, 3: 0, "hetcor_scan": 0}  # CPU tensors: the plain version
    valid = np.arange(d)[None, :] < deg[:, None]
    assert (got[~valid] >= BIG).all()  # the port's pad slots are the sentinel
    exp = np.where(valid, exp, np.float32(BIG))
    _assert_margins(got, exp)


def _brute_force_margin(Cb, q, Nb, nr, tn, t_x, dx, l):
    """The hetcor margin of every test of one node, one test at a time in
    colex order with a strict <, on float32 torch scalars in the sweeps'
    association order; returns (margin (dx,), ties (dx,) = tests equal to
    the minimum)."""
    one, th = torch.tensor(1.0), torch.tensor(TH, dtype=torch.float32)
    rinv = lambda x: one / torch.sqrt(torch.abs(one - x * x))  # noqa: E731
    out = torch.full((dx,), BIG)
    seen = [[] for _ in range(dx)]

    def pair_rho(P, r, y, t, s):
        rqt = rinv(r[t])
        cts, cty = P[t, s], P[t, y]
        rts, rty = rinv(cts), rinv(cty)
        q2s = (r[s] - r[t] * cts) * (rqt * rts)
        q2y = (r[y] - r[t] * cty) * (rqt * rty)
        T2 = (P[y, s] - cty * cts) * (rty * rts)
        return torch.abs(q2y - q2s * T2) * (rinv(q2s) * rinv(T2))

    def offer(y, rho, ess, times):
        if max(times) > max(t_x, tn[y]):
            return
        tot, cnt = torch.tensor(0.0), torch.tensor(0.0)
        for i, n in enumerate(ess):
            v, c = (torch.tensor(0.0),) * 2 if torch.isnan(n) else (n, one)
            tot, cnt = (v, c) if i == 0 else (tot + v, cnt + c)
        mean = tot / cnt
        th_test = torch.tanh(th / torch.sqrt(mean - 4.0 if l == 1 else (mean - float(l)) - 3.0))
        m = rho - th_test
        if l == 1:
            ok = bool(torch.isfinite(m))
        else:
            ok = bool(rho < 2.0) and bool(torch.isfinite(th_test))
        if ok:
            seen[y].append(float(m))
            if m < out[y]:
                out[y] = m

    for y in range(dx):
        if l == 1:
            for s in range(dx):
                if s != y:
                    c = Cb[s, y]
                    rc, rs = rinv(c), rinv(q[s])
                    rho = torch.abs(q[y] * (rs * rc) - (q[s] * rs) * (c * rc))
                    offer(y, rho, [nr[y], nr[s], Nb[y, s]], [tn[s]])
        elif l == 2:
            for t in range(1, dx):
                for s in range(t):
                    if y not in (s, t):
                        offer(y, pair_rho(Cb, q, y, t, s),
                              [nr[y], nr[s], nr[t], Nb[y, s], Nb[y, t], Nb[t, s]],
                              [tn[s], tn[t]])
        else:
            for u in range(2, dx):
                cu = Cb[u, :]
                Ru = rinv(cu)
                T1 = (Cb - cu[:, None] * cu[None, :]) * (Ru[:, None] * Ru[None, :])
                q1 = (q - q[u] * cu) * (rinv(q[u]) * Ru)
                for t in range(1, u):
                    for s in range(t):
                        if y not in (s, t, u):
                            offer(y, pair_rho(T1, q1, y, t, s),
                                  [nr[y], nr[s], nr[t], Nb[y, s], Nb[y, t], Nb[t, s],
                                   nr[u], Nb[y, u], Nb[s, u], Nb[t, u]],
                                  [tn[s], tn[t], tn[u]])
    ties = np.array([sum(m == float(o) for m in ms) for ms, o in zip(seen, out)])
    return out.numpy(), ties


@pytest.mark.parametrize("l", [1, 2, 3])
def test_hetcor_local_sweep_ties_match_brute_force(l):
    """On panels of repeated variables many sets give bitwise equal margins;
    the sweep's minimum equals, bit for bit, that of a loop over the tests
    one at a time. A minimum over floats does not depend on the order, so
    this pins what a kernel that splits the sets over threads must return."""
    from cigwas_tpu_torch.ops.kernels import hetcor_sweep as hs

    C, N, t_ix, node_ixs, nbrs, deg = tied_case(11, hetcor=True)
    t = torch.from_numpy
    got = hs.hetcor_local_sweep(t(C), t(N), t(t_ix), t(node_ixs), t(nbrs), t(deg), TH, l).numpy()
    tied_slots = 0
    for i, x in enumerate(node_ixs):
        dx = int(deg[i])
        nb = nbrs[i, :dx]
        exp, ties = _brute_force_margin(
            t(C[np.ix_(nb, nb)]), t(C[x, nb]), t(N[np.ix_(nb, nb)]), t(N[x, nb]),
            t_ix[nb].astype(np.float32), float(t_ix[x]), dx, l)
        assert np.array_equal(got[i, :dx].view(np.int32), exp.view(np.int32))
        assert (got[i, dx:] >= BIG).all()
        tied_slots += int(((ties > 1) & (exp < BIG)).sum())
    assert tied_slots >= 6, f"only {tied_slots} slots with a tied minimum"


def _scan_both(C, N, t_ix, node_ixs, nbrs, deg, combos, left, l):
    """The level-l scan of one wave by the JAX package and by the port's
    plain version (through the kernel's wrapper, which takes it for CPU
    tensors): (port, jax) margins."""
    import jax.numpy as jnp

    from cigwas_tpu.ops import pcorr as jp
    from cigwas_tpu_torch.ops.kernels import hetcor_sweep as hs
    from cigwas_tpu_torch.ops.kernels.panel_gather import gather_local_panels2

    exp = np.asarray(jp.level_scan_hetcor(
        jnp.asarray(C), jnp.asarray(N), jnp.asarray(t_ix), jnp.asarray(node_ixs),
        jnp.asarray(nbrs), jnp.asarray(deg), jnp.asarray(combos.astype(np.int32)),
        jnp.asarray(left.astype(np.int32)), jnp.float32(TH), l,
    ))
    t = torch.from_numpy
    Ct, Nt, _, tt = hetcor_inputs_to_torch(C, N, np.zeros((1, 1)), t_ix)
    nodes_t, nbrs_t, deg_t = t(node_ixs), t(nbrs), t(deg)
    panels = gather_local_panels2(Ct, Nt, nodes_t, nbrs_t, deg_t)
    before = dict(hs.launches)
    got = hs.hetcor_scan(*panels, tt[nbrs_t.long()].float(), tt[nodes_t.long()].float(),
                         deg_t, t(combos.astype(np.int64)), t(left.astype(np.int64)), TH,
                         l).numpy()
    assert hs.launches == before  # CPU tensors: the plain version
    return got, exp


# levels 4-8 at the bucket widths 8-40 on factor panels, whose blocks are
# well-conditioned (`torch_parity.factor_panel`), and level 4 on a chain panel
SCAN_CASES = [("chain", 4, 16)] + [("factor", l, d) for l in range(4, 9)
                                   for d in (8, 16, 32, 40) if d > l]


@pytest.mark.parametrize("panel,l,d", SCAN_CASES)
def test_level_scan_hetcor_l4_matches_jax(panel, l, d):
    """Levels 4-8 at bucket widths 8-40: NaN ESS, time indices 0-2 (the
    filter rejects sets), ragged degrees, and chunks whose valid sets end
    part way (left < K) or hold none."""
    from cigwas_tpu.utils.combinatorics import colex_combinations_chunk

    if panel == "chain":
        v, nt, K, nch = 40, 6, 128, 4
        C, N, t_ix = hetcor_case(21, v, t_max=2)
        node_ixs, nbrs, deg = hetcor_neighbours(4, v, nt, d)
    else:
        v, nt, K, nch = d + 24, 16, 64, 4
        seed = 20 + 7 * l + d
        _, N, t_ix = hetcor_case(seed, v, nan_frac=0.1, t_max=2)
        C = factor_panel(np.random.default_rng(seed), v)
        node_ixs, nbrs, deg = hetcor_neighbours(l + d, v, nt, d)
    # a wave that ends part way through the lowest-degree node's sets
    sets = np.array([math.comb(int(g), l) for g in deg])
    offset = max(0, int(sets.min()) - K * nch // 2 + 7)
    combos = colex_combinations_chunk(offset, K * nch, l).reshape(nch, K, l)
    totals = np.clip(sets - offset, 0, K * nch)
    left = np.clip(totals[None, :] - K * np.arange(nch)[:, None], 0, K)
    assert ((left > 0) & (left < K)).any()
    got, exp = _scan_both(C, N, t_ix, node_ixs, nbrs, deg, combos, left, l)
    _assert_margins(got, exp)


def _block_case(special: str):
    """Two nodes whose lists share positions; every set holds positions 0-2
    (l = 4, the sets are those three with one of 3..11). "singular": node 0's
    first two neighbours are one variable twice, so each of its blocks has
    two equal rows; "indefinite": node 0's first three neighbours have
    correlations 0.9, 0.9 and -0.9, which no data give, so each of its
    blocks is indefinite but invertible. Node 1 is an ordinary node."""
    v, d, l = 40, 16, 4
    C, N, t_ix = hetcor_case(51, v, nan_frac=0.1, t_max=1)
    node_ixs = np.array([0, 1], np.int32)
    lists = [np.arange(2, 14), np.arange(14, 26)]
    if special == "singular":
        a, b = lists[0][:2]
        C[b, :] = C[a, :]
        C[:, b] = C[:, a]
        C[a, b] = C[b, a] = C[b, b] = 1.0
    else:
        a, b, c = lists[0][:3]
        C[a, b] = C[b, a] = C[a, c] = C[c, a] = 0.9
        C[b, c] = C[c, b] = -0.9
    nbrs = np.zeros((2, d), np.int32)
    for i, nb in enumerate(lists):
        nbrs[i, : len(nb)] = nb
    deg = np.array([12, 12], np.int32)
    combos = np.array([(0, 1, 2, u) for u in range(3, 12)], np.int64)[None]
    left = np.full((1, 2), combos.shape[1], np.int64)
    blocks = [C[np.ix_(lists[0][list(S)], lists[0][list(S)])] for S in combos[0]]
    return (C, N, t_ix, node_ixs, nbrs, deg, combos, left, l), blocks


@pytest.mark.parametrize("special", ["singular", "indefinite"])
def test_level_scan_hetcor_special_blocks_match_jax(special):
    """An exactly singular block sends its tests to the sentinel, as the JAX
    package's inverse does with inf/NaN; an indefinite, invertible block
    keeps finite margins in both."""
    args, blocks = _block_case(special)
    got, exp = _scan_both(*args)
    dx = 12
    if special == "singular":
        assert all(np.linalg.matrix_rank(B.astype(np.float64)) < 4 for B in blocks)
        assert (exp[0] >= BIG).all() and (got[0] >= BIG).all()
    else:
        assert all(np.linalg.eigvalsh(B.astype(np.float64)).min() < -0.1 for B in blocks)
        live = np.arange(3, dx)  # y outside S's fixed positions 0-2
        assert (exp[0, live] < BIG).all() and (got[0, live] < BIG).all()
    assert (exp[1, 3:dx] < BIG).all()
    _assert_margins(got, exp)


def _bits(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, dtype=np.float32)).view(np.int32)


def test_plain_gather_matches_pallas_window_kernel():
    """`gather_local_panels(..., interpret=True)` (the windowed Pallas kernel
    `_window_kernel`) against the port's plain one-panel gather: bit-identical
    everywhere, NaNs and the node-index pad slots included."""
    import jax.numpy as jnp

    from cigwas_tpu.ops.pallas.panel_gather import gather_local_panels as jax_gather
    from cigwas_tpu_torch.ops.kernels import panel_gather as pg

    vp, nt, d, span = 1024, 7, 64, 200
    rng = np.random.default_rng(0)
    C = rng.normal(size=(vp, vp)).astype(np.float32)
    C[rng.random((vp, vp)) < 0.01] = np.nan
    centers = rng.integers(0, vp, nt)
    lo = np.clip(centers - span // 2, 0, vp - span)
    nbrs = np.sort(lo[:, None] + rng.integers(0, span, (nt, d)), axis=1).astype(np.int32)
    node_ixs = np.clip(centers, lo, lo + span - 1).astype(np.int32)
    deg = rng.integers(30, d + 1, nt).astype(np.int32)
    nbrs[np.arange(d)[None, :] >= deg[:, None]] = 0  # compaction's pad slots
    got_j = jax_gather(jnp.asarray(C), node_ixs, nbrs, deg, interpret=True)
    assert got_j is not None
    pg.reset_launches()
    Cb, qb = pg.gather_local_panels(
        torch.from_numpy(C), torch.from_numpy(node_ixs), torch.from_numpy(nbrs),
        torch.from_numpy(deg),
    )
    assert pg.launches == {"panel_gather": 0, "panel_gather2": 0}
    np.testing.assert_array_equal(_bits(Cb.numpy()), _bits(got_j[0]))
    np.testing.assert_array_equal(_bits(qb.numpy()), _bits(got_j[1]))
    # and, on valid slots, the plain indexing of the raw neighbour lists
    for i in range(nt):
        k = deg[i]
        nb = nbrs[i, :k]
        np.testing.assert_array_equal(_bits(Cb[i, :k, :k].numpy()), _bits(C[np.ix_(nb, nb)]))


def test_plain_gather2_matches_pallas_rowgather2_kernel():
    """`_rowgather2_core(..., interpret=True)` (the two-panel row-DMA Pallas
    kernel `_rowgather2_kernel`) against the port's plain two-panel gather on
    scattered spans: bit-identical everywhere."""
    import jax.numpy as jnp

    from cigwas_tpu.ops.pallas import panel_gather as jpg
    from cigwas_tpu_torch.ops.kernels import panel_gather as pg

    vp, nt, d = 256, 5, 24
    C, N, _ = hetcor_case(31, vp, n=600)
    C[np.random.default_rng(1).random((vp, vp)) < 0.02] = np.nan
    node_ixs, nbrs, deg = hetcor_neighbours(31, vp, nt, d)
    scalars, nbrs2, _ = jpg._row_inputs(node_ixs, nbrs, deg)
    exp = jpg._rowgather2_core(
        jnp.asarray(C), jnp.asarray(N), jnp.asarray(scalars), jnp.asarray(nbrs2), True
    )
    got = pg.gather_local_panels2(
        torch.from_numpy(C), torch.from_numpy(N), torch.from_numpy(node_ixs),
        torch.from_numpy(nbrs), torch.from_numpy(deg),
    )
    assert np.isnan(np.asarray(exp[2])).any() and np.isnan(np.asarray(exp[0])).any()
    for g, e in zip(got, exp):
        np.testing.assert_array_equal(_bits(g.numpy()), _bits(e))


def _both_skeletons(C, N, t_ix, max_level, ess_mode, stats=None):
    from cigwas_tpu.skeleton import hetcor_skeleton as jax_hetcor
    from cigwas_tpu_torch.skeleton import hetcor_skeleton

    v = C.shape[0]
    G0 = np.ones((v, v), np.int32)
    res_j = jax_hetcor(C, G0, N, TH, max_level, time_index=t_ix, ess_mode=ess_mode)
    Ct, Nt, Gt, _ = hetcor_inputs_to_torch(C, N, G0, np.zeros(v))
    res_t = hetcor_skeleton(Ct, Gt, Nt, TH, max_level, time_index=t_ix,
                            device="cpu", ess_mode=ess_mode, stats=stats)
    return res_t, res_j


@pytest.mark.parametrize("ess_mode", ["reference", "float"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_hetcor_skeleton_matches_jax(seed, ess_mode):
    C, N, _ = hetcor_case(seed, 12)
    res_t, res_j = _both_skeletons(C, N, None, 3, ess_mode)
    assert res_t.final_level == res_j.final_level
    np.testing.assert_array_equal(res_t.G, res_j.G)
    assert res_t.sepset is None and 0 < res_t.G.sum() < 12 * 11


@pytest.mark.parametrize("seed", [3, 4])
def test_hetcor_skeleton_time_index_matches_jax(seed):
    C, N, t_ix = hetcor_case(seed, 12, nan_frac=0.1, t_max=2)
    res_t, res_j = _both_skeletons(C, N, t_ix, 3, "reference")
    assert res_t.final_level == res_j.final_level
    np.testing.assert_array_equal(res_t.G, res_j.G)


def _levels_4_to_6_case():
    """Variables loading on shared latent factors keep degrees high, so the
    hetcor branch of the level >= 4 scan (two-panel gather + margins) runs
    and removes edges; stage 2 of cuskss takes the same branch."""
    v, n = 30, 900
    C = factor_panel(np.random.default_rng(7), v, n)
    _, N, t_ix = hetcor_case(8, v, n=n, nan_frac=0.1, t_max=1)
    return C, N, t_ix


@pytest.mark.parametrize("ess_mode", ["reference", "float"])
def test_hetcor_skeleton_levels_4_to_6_match_jax(ess_mode):
    res_t, res_j = _both_skeletons(*_levels_4_to_6_case(), 6, ess_mode)
    assert res_j.final_level >= 4
    assert res_t.final_level == res_j.final_level
    np.testing.assert_array_equal(res_t.G, res_j.G)


# the tests of each level on that panel, as the scan counted them before its
# kernel (one chunk at a time through PyTorch operations)
LEVEL_TESTS_4_TO_6 = {"reference": {2: 3905, 3: 1747, 4: 295, 5: 108},
                      "float": {2: 5091, 3: 2299, 4: 450, 5: 219}}


@pytest.mark.parametrize("ess_mode", ["reference", "float"])
def test_hetcor_skeleton_level_tests_unchanged(ess_mode):
    """The scan's waves stop every node where they stopped before: the
    tests of every level (``ci_tests_level``) are the counts pinned above."""
    stats: dict = {}
    res_t, _ = _both_skeletons(*_levels_4_to_6_case(), 6, ess_mode, stats)
    assert res_t.final_level == 5
    assert stats["level_route"][4] == stats["level_route"][5] == "combinatorial"
    assert dict(stats["ci_tests_level"]) == LEVEL_TESTS_4_TO_6[ess_mode]
    assert stats["ci_tests"] == sum(LEVEL_TESTS_4_TO_6[ess_mode].values())


def test_hetcor_skeleton_honours_incoming_adjacency():
    """Level 0 only deletes: an edge absent from the incoming G stays absent
    (stage 2 of cuskss hands the reduced adjacency on)."""
    from cigwas_tpu.skeleton import hetcor_skeleton as jax_hetcor
    from cigwas_tpu_torch.skeleton import hetcor_skeleton

    C, N, t_ix = hetcor_case(5, 14, t_max=1)
    G0 = (np.random.default_rng(5).random((14, 14)) < 0.6).astype(np.int32)
    G0 = G0 | G0.T
    res_j = jax_hetcor(C, G0, N, TH, 3, time_index=t_ix)
    res_t = hetcor_skeleton(C, G0, N, TH, 3, time_index=t_ix, device="cpu")
    np.testing.assert_array_equal(res_t.G, res_j.G)
    assert not (res_t.G & ~G0).any()
