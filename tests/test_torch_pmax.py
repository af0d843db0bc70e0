"""pMax of the port's skeleton against the JAX package's, on the CPU.

`skeleton(C, th, max_level)` returns pMax by default in both packages.
Decisions are compared exactly (adjacency, sepsets, the final level); pMax
within the parity tolerance (tests/torch_parity.py), with the
PMAX_RETAINED positions identical and the entries written by level 0 (the
Fisher z of C itself, on the host in both packages) bit for bit.
"""

import numpy as np
import pytest
import torch

from torch_parity import ATOL, RTOL, ar1_panel, set_threads

from cigwas_tpu.utils.stats import threshold_array

set_threads()


def _factor_panel(seed, v, n, k=4):
    """Variables loading on k shared latent factors: the skeleton runs past
    level 6 and removes edges at levels >= 4 (as tests/test_torch_skeleton.py)."""
    rng = np.random.default_rng(seed)
    F = rng.normal(size=(k, n))
    W = rng.normal(size=(v, k)) * (rng.random((v, k)) < 0.5)
    return np.corrcoef(W @ F + 1.5 * rng.normal(size=(v, n))).astype(np.float32)


def _with_nans(C, seed, frac):
    """C with a symmetric fraction of its off-diagonal entries set to NaN."""
    rng = np.random.default_rng(seed)
    hit = np.triu(rng.random(C.shape) < frac, k=1)
    C = C.copy()
    C[hit | hit.T] = np.nan
    return C


def _both(C, th, max_level, n_var=None):
    import jax.numpy as jnp

    from cigwas_tpu.skeleton import skeleton as jax_skeleton
    from cigwas_tpu_torch.skeleton import skeleton

    res_j = jax_skeleton(jnp.asarray(C), th, max_level, n_var=n_var)
    res_t = skeleton(C, th, max_level, device="cpu", n_var=n_var)
    return res_t, res_j


def _assert_pmax_matches(res_t, res_j, C, th, n_var=None):
    from cigwas_tpu_torch.constants import PMAX_RETAINED

    assert res_t.final_level == res_j.final_level
    assert np.array_equal(res_t.G, res_j.G)
    assert np.array_equal(res_t.sepset, res_j.sepset)
    assert res_t.pmax.dtype == res_j.pmax.dtype == np.float32
    assert res_t.pmax.shape == res_j.pmax.shape == res_t.G.shape
    assert np.array_equal(res_t.pmax == PMAX_RETAINED, res_j.pmax == PMAX_RETAINED)
    np.testing.assert_allclose(res_t.pmax, res_j.pmax, rtol=RTOL, atol=ATOL)
    # the pairs level 0 deleted hold the Fisher z of C, bit for bit
    from cigwas_tpu_torch.skeleton import skeleton

    deleted0 = skeleton(C, th, 0, device="cpu", n_var=n_var, want_pmax=False).G == 0
    np.fill_diagonal(deleted0, False)
    assert deleted0.any()
    assert np.array_equal(res_t.pmax[deleted0].view(np.int32),
                          res_j.pmax[deleted0].view(np.int32))


CASES = {
    # levels 1-3 (and 4-5) on the AR(1) panel of tests/test_pallas_gather.py,
    # already padded to 128 (n_var marks the real variables)
    "ar1_levels_1_5": lambda: (ar1_panel(5, 96, 900, 128), threshold_array(900, 1e-2), 5, 96),
    # levels 4-6 through the colex scan
    "factor_levels_4_6": lambda: (_factor_panel(1, 60, 2000), threshold_array(2000, 1e-2), 6,
                                  None),
    # 1% NaN: a NaN correlation keeps its edge at level 0 and smears at >= 4
    "factor_nan_1pct": lambda: (_with_nans(_factor_panel(2, 70, 2000), 3, 0.01),
                                threshold_array(2000, 1e-2), 6, None),
    # 150 variables: both packages pad to 256 themselves
    "factor_needs_padding": lambda: (_factor_panel(4, 150, 3000), threshold_array(3000, 1e-3),
                                     3, None),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_pmax_matches_jax(case):
    C, th, max_level, n_var = CASES[case]()
    res_t, res_j = _both(C, th, max_level, n_var=n_var)
    assert res_j.final_level >= 2
    _assert_pmax_matches(res_t, res_j, C, th, n_var)


def test_pmax_n10_fixture(n10_fixture):
    C, A, alpha, n = n10_fixture
    th = threshold_array(n, alpha)
    res_t, res_j = _both(C, th, 14)
    assert np.array_equal(res_t.G, A)
    _assert_pmax_matches(res_t, res_j, C, th)


def test_pmax_properties_n10(n10_fixture):
    """tests/test_skeleton.py's pMax properties, on the port."""
    from cigwas_tpu_torch.constants import PMAX_RETAINED
    from cigwas_tpu_torch.skeleton import skeleton

    C, A, alpha, n = n10_fixture
    res = skeleton(C, threshold_array(n, alpha), 14, device="cpu")
    assert np.all(res.pmax[res.G.astype(bool)] == PMAX_RETAINED)
    assert np.all(np.diag(res.pmax) == 1.0)
    assert np.allclose(res.pmax, res.pmax.T)
    off = ~res.G.astype(bool) & ~np.eye(len(A), dtype=bool)
    assert np.all(np.isfinite(res.pmax[off])) and np.all(res.pmax[off] >= 0)


def test_want_pmax_false_returns_none_and_same_decisions(n10_fixture):
    from cigwas_tpu_torch.skeleton import skeleton

    C, A, alpha, n = n10_fixture
    th = threshold_array(n, alpha)
    stats_on, stats_off = {}, {}
    on = skeleton(C, th, 14, device="cpu", stats=stats_on)
    off = skeleton(C, th, 14, device="cpu", want_pmax=False, stats=stats_off)
    assert off.pmax is None and on.pmax is not None
    assert np.array_equal(on.G, off.G) and np.array_equal(on.sepset, off.sepset)
    assert "c_fetch_wall_s" in stats_on and "pmax_wall_s" in stats_on
    assert "c_fetch_wall_s" not in stats_off


def test_tensor_panel_pmax_equals_numpy_panel():
    """A device tensor (here on the CPU) already padded, as `ops.corr` gives
    it, returns the same pMax as the numpy panel and is not written to."""
    from cigwas_tpu_torch.skeleton import skeleton

    Cp = ar1_panel(5, 96, 900, 128)
    th = threshold_array(900, 1e-2)
    a = skeleton(Cp, th, 5, device="cpu", n_var=96)
    C = torch.from_numpy(Cp.copy())
    b = skeleton(C, th, 5, device="cpu", n_var=96)
    assert np.array_equal(a.pmax.view(np.int32), b.pmax.view(np.int32))
    assert np.array_equal(C.numpy(), Cp)  # the caller's panel is left as it was


def test_hetcor_skeleton_has_no_pmax():
    from torch_parity import hetcor_case

    from cigwas_tpu_torch.skeleton import hetcor_skeleton

    C, N, _ = hetcor_case(0, 40)
    G = 1 - np.eye(40, dtype=np.int32)
    res = hetcor_skeleton(C, G, N, 3.0, 3, device="cpu")
    assert res.pmax is None and res.sepset is None
