"""The port's `cusk_second_stage` against the JAX package's, on the CPU: the
three cases of tests/test_skeleton.py (the N10 golden adjacency, sepsets
that lower the partial correlation, the degree cap), each also held to the
JAX function's adjacency, sepsets and pMax exactly (both are host numpy of
the same arithmetic)."""

import numpy as np
import pytest

from torch_parity import set_threads

from cigwas_tpu.utils.stats import threshold_array

set_threads()


def _assert_same(res_t, res_j):
    assert res_t.final_level == res_j.final_level == 1
    assert np.array_equal(res_t.G, res_j.G)
    assert np.array_equal(res_t.sepset, res_j.sepset)
    assert np.array_equal(res_t.pmax.view(np.int32), res_j.pmax.view(np.int32))


def _both(C, G, th, **kw):
    from cigwas_tpu.skeleton.second_stage import cusk_second_stage as jax_second_stage
    from cigwas_tpu_torch.skeleton.second_stage import cusk_second_stage

    return cusk_second_stage(C, G, th, **kw), jax_second_stage(C, G, th, **kw)


def test_second_stage_n10_golden_adjacency(n10_fixture):
    """`cusk_second_stage.expected_skeleton_n10` (`cupc_tests.cpp:43-63`)."""
    C, A, alpha, n = n10_fixture
    res_t, res_j = _both(C, np.ones_like(A), threshold_array(n, alpha))
    assert np.array_equal(res_t.G, A)
    _assert_same(res_t, res_j)


def test_second_stage_sepsets_lower_pcorr():
    """Second-stage sepsets hold exactly the single-variable conditioners
    that lower the Fisher z below the marginal value."""
    rng = np.random.default_rng(3)
    n = 30000
    z = rng.normal(size=n)
    x = z + rng.normal(size=n)
    y = z + rng.normal(size=n)
    w = rng.normal(size=n)
    C = np.corrcoef(np.stack([x, y, z, w])).astype(np.float32)
    res_t, res_j = _both(C, np.ones((4, 4), np.int32), threshold_array(n, 1e-2))
    sep = res_t.sepset[0, 1]
    sep = set(sep[sep >= 0].tolist())
    assert 2 in sep
    assert 3 not in sep
    _assert_same(res_t, res_j)


@pytest.mark.parametrize("row_chunk", [512, 7])
def test_second_stage_random_skeleton_matches_jax(row_chunk):
    """A 60-variable factor panel on a random skeleton, with row chunks
    that split it: more than ML chosen conditioners for some pairs, so the
    cut at ML is exercised."""
    from cigwas_tpu_torch.constants import ML

    rng = np.random.default_rng(11)
    v, n = 60, 3000
    F = rng.normal(size=(3, n))
    X = rng.normal(size=(v, 3)) @ F + rng.normal(size=(v, n))
    C = np.corrcoef(X).astype(np.float32)
    G = np.triu(rng.random((v, v)) < 0.5, 1)
    G = (G | G.T).astype(np.int32)
    res_t, res_j = _both(C, G, threshold_array(n, 1e-3), row_chunk=row_chunk)
    assert (res_t.sepset[..., ML - 1] >= 0).any()
    _assert_same(res_t, res_j)


def test_second_stage_degree_cap():
    from cigwas_tpu.skeleton.second_stage import cusk_second_stage as jax_second_stage
    from cigwas_tpu_torch.skeleton.second_stage import PCORR_MAX_DEGREE, cusk_second_stage

    n = PCORR_MAX_DEGREE + 5
    # equicorrelated panel keeps every edge at level 0 -> degree > cap
    C = np.full((n, n), 0.5, dtype=np.float32)
    np.fill_diagonal(C, 1.0)
    th = threshold_array(10000, 1e-4)
    for fn in (cusk_second_stage, jax_second_stage):
        with pytest.raises(ValueError, match="max degree"):
            fn(C, np.ones((n, n), np.int32), th)
