"""The port's skeleton against the JAX package's, on the CPU.

Decisions are compared exactly: adjacency, sepsets and the final level
(the parity contract). Levels 1-3 run through the local-sweep wrapper's
plain version here; levels >= 4 through the colex scan.
"""

import numpy as np
import pytest
import torch

from torch_parity import ar1_panel, set_threads

from cigwas_tpu.utils.stats import threshold_array

set_threads()


def _jax_skeleton(C, th, max_level, n_var=None):
    import jax.numpy as jnp

    from cigwas_tpu.skeleton import skeleton

    return skeleton(jnp.asarray(C), th, max_level, n_var=n_var, want_pmax=False)


def _assert_same(res_t, res_j):
    assert res_t.final_level == res_j.final_level
    assert np.array_equal(res_t.G, res_j.G)
    assert np.array_equal(res_t.sepset, res_j.sepset)


def _factor_panel(seed, v, n, k=4):
    """Variables loading on k shared latent factors: partial correlations
    stay non-zero given small sets, so the skeleton runs past level 6 and
    removes edges at levels >= 4 (the colex scan)."""
    rng = np.random.default_rng(seed)
    F = rng.normal(size=(k, n))
    W = rng.normal(size=(v, k)) * (rng.random((v, k)) < 0.5)
    return np.corrcoef(W @ F + 1.5 * rng.normal(size=(v, n))).astype(np.float32)


@pytest.mark.parametrize("as_tensor", [False, True], ids=["numpy", "tensor"])
def test_skeleton_ar1_panel_matches_jax(as_tensor):
    """The AR(1) panel of tests/test_pallas_gather.py (v=96, n=900,
    alpha 1e-2, max level 5)."""
    from cigwas_tpu_torch.skeleton import skeleton

    v, n = 96, 900
    Cp = ar1_panel(5, v, n, 128)
    th = threshold_array(n, 1e-2)
    res_j = _jax_skeleton(Cp, th, 5, n_var=v)
    C = torch.from_numpy(Cp) if as_tensor else Cp
    res_t = skeleton(C, th, 5, device="cpu", n_var=v)
    assert res_j.final_level >= 2
    assert res_t.G.shape == (v, v)
    _assert_same(res_t, res_j)


def test_skeleton_factor_panel_levels_4_to_6_match_jax():
    from cigwas_tpu_torch.skeleton import skeleton

    C = _factor_panel(1, 60, 2000)
    th = threshold_array(2000, 1e-2)
    res_j = _jax_skeleton(C, th, 6)
    res_t = skeleton(C, th, 6, device="cpu")
    assert res_j.final_level == 6
    assert (res_j.sepset[..., 3] >= 0).any()  # level >= 4 removals happened
    _assert_same(res_t, res_j)


def test_skeleton_n10_golden_adjacency(n10_fixture):
    """The reference's `cuPC.expected_skeleton_n10` (`cupc_tests.cpp:17-41`)."""
    from cigwas_tpu_torch.skeleton import skeleton

    C, A, alpha, n = n10_fixture
    th = threshold_array(n, alpha)
    res = skeleton(C, th, 14, device="cpu")
    assert np.array_equal(res.G, A)
    _assert_same(res, _jax_skeleton(C, th, 14))


def test_skeleton_degree_300_level1_node(monkeypatch):
    """No width cap: a hub with ~300 neighbours at level 1 runs through the
    local sweep (the list route, pinned: the default gates send this
    hub-heavy panel to the dense level 1) and decides as the JAX package
    does (its dense level-1 route at this width), as does the default."""
    from cigwas_tpu_torch.skeleton import cupc, skeleton

    rng = np.random.default_rng(9)
    v, n = 384, 3000
    z = rng.normal(size=n)
    X = rng.normal(size=(v, n))
    X[0] += 2.0 * z
    X[1:311] += 0.45 * z  # 310 markers tied to the hub through z
    C = np.corrcoef(X).astype(np.float32)
    th = threshold_array(n, 1e-3)
    default = skeleton(C, th, 1, device="cpu")
    stats = {}
    with monkeypatch.context() as m:
        m.setattr(cupc, "L1_LOCAL_MAX_WIDTH", 1 << 60)
        res_t = skeleton(C, th, 1, device="cpu", stats=stats)
    widths = [d for d, _ in stats["launches"][1]]
    assert max(widths) >= 300
    _assert_same(res_t, _jax_skeleton(C, th, 1))
    _assert_same(default, _jax_skeleton(C, th, 1))

    # and the sweep itself at the hub: positions past 255 come back intact
    G = np.ones((v, v), bool)
    np.fill_diagonal(G, False)
    G[0, 301:] = G[301:, 0] = False
    nbrs, deg = cupc._compact_neighbors(G, np.array([0], np.int32), 304)
    assert deg[0] == 300
    from cigwas_tpu_torch.ops.kernels.local_sweep import local_sweep
    from torch_parity import jax_local_sweep

    rho_t, pos_t = local_sweep(
        torch.from_numpy(C), torch.tensor([0], dtype=torch.int32),
        torch.from_numpy(nbrs), torch.from_numpy(deg), 1,
    )
    rho_j, pos_j = jax_local_sweep(C, np.array([0], np.int32), nbrs, deg, 1)
    won = (np.arange(304) < 300)[None, :] & (rho_j < 2.0)
    assert (pos_j[won] > 255).any()
    assert np.array_equal(pos_t.numpy()[won], pos_j[won])


def test_skeleton_max_level_zero_is_marginal_screen(n10_fixture):
    from cigwas_tpu.utils.stats import fisher_z
    from cigwas_tpu_torch.skeleton import skeleton

    C, A, alpha, n = n10_fixture
    th = threshold_array(n, alpha)
    res = skeleton(C, th, 0, device="cpu")
    exp = (fisher_z(C) >= th[0]).astype(np.int32)
    np.fill_diagonal(exp, 0)
    assert np.array_equal(res.G, exp)
    assert res.final_level == 0


def test_reduce_gcs_matches_jax():
    """The ancestor reduction on a device panel (on-device submatrix gather)
    equals the JAX package's on a host panel."""
    from cigwas_tpu.skeleton.reduce import reduce_gcs as jax_reduce
    from cigwas_tpu.skeleton.reduce import subset_variables as jax_subset
    from cigwas_tpu_torch.skeleton import reduce_gcs, skeleton, subset_variables

    v, n = 96, 900
    Cp = ar1_panel(7, v, n, 128)
    th = threshold_array(n, 1e-2)
    res = skeleton(Cp, th, 3, device="cpu", n_var=v)
    num_markers = v - 4
    keep = subset_variables(res.G, v, num_markers, 2)
    assert np.array_equal(keep, jax_subset(res.G, v, num_markers, 2))
    got = reduce_gcs(res.G, torch.from_numpy(Cp), res.sepset, keep, v, 4, 3)
    exp = jax_reduce(res.G, Cp[:v, :v], res.sepset, keep, v, 4, 3)
    for f in ("num_var", "num_phen", "max_level"):
        assert getattr(got, f) == getattr(exp, f)
    for f in ("new_to_old_indices", "G", "C", "S"):
        assert np.array_equal(getattr(got, f), getattr(exp, f))


def test_direct_x_to_y_matches_jax():
    """Marker->trait edges marked 2/3 in place, on a random int32 skeleton
    (the flattened layout the block files hold), as the JAX function does."""
    from cigwas_tpu.skeleton.reduce import direct_x_to_y as jax_direct
    from cigwas_tpu_torch.skeleton.reduce import direct_x_to_y

    rng = np.random.default_rng(4)
    v, num_markers = 30, 24
    G = np.triu(rng.random((v, v)) < 0.3, 1)
    G = (G | G.T).astype(np.int32)
    flat_t, flat_j = G.ravel().copy(), G.ravel().copy()
    got = direct_x_to_y(flat_t, v, num_markers)
    exp = jax_direct(flat_j, v, num_markers)
    assert np.array_equal(got, exp)
    assert np.array_equal(flat_t, flat_j)  # both wrote through to the caller's array
    assert (got == 2).any() and (got == 3).any()
    assert np.array_equal(got[:num_markers, :num_markers], G[:num_markers, :num_markers])
