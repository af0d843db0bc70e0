"""The port's LD blocking (`cigwas_tpu_torch.blocking`) against the JAX
package's, on seeded inputs, and against the reference's golden boundaries.

Both are host numpy in float64 with the same float32 cast of the cosine
argument, so smoothed signals agree within 1e-9 (in fact to the bit) and
minima and block boundaries are equal.
"""

import os

import numpy as np
import pytest

from cigwas_tpu import blocking as jb
from cigwas_tpu_torch import blocking as tb
from cigwas_tpu_torch.io.blocks import MarkerBlock

GOLDEN = [(0, 194), (195, 335), (336, 620), (621, 843), (844, 1227), (1228, 1447),
          (1448, 1910), (1911, 2112), (2113, 2504), (2505, 2735), (2736, 2930),
          (2931, 3085), (3086, 3172), (3173, 3352), (3353, 3574), (3575, 3897),
          (3898, 3997)]


def _row_sums(seed: int, m: int) -> np.ndarray:
    """A positive signal with LD-like bumps of several widths, float32 as the
    banded row sums are."""
    rng = np.random.default_rng(seed)
    x = np.arange(m)
    v = 5.0 + rng.gamma(2.0, 1.0, m)
    for _ in range(m // 150):
        c, w = rng.integers(0, m), rng.uniform(10, 120)
        v += rng.uniform(5, 40) * np.exp(-0.5 * ((x - c) / w) ** 2)
    return v.astype(np.float32)


def _tuples(blocks):
    return [(b.chr_id, b.first_marker_ix, b.last_marker_ix) for b in blocks]


@pytest.fixture(scope="module")
def blocking_fixture():
    return np.load(os.path.join(os.path.dirname(__file__), "data", "blocking.npz"))


def test_block_chr_golden_boundaries(blocking_fixture):
    """The reference's `block_chr.expected_results_synthetic_data`
    (`blocking_tests.cpp:9-38`): the exact 17 blocks at max size 500."""
    obs = tb.block_chr(blocking_fixture["v"], "1", 500)
    assert obs == [MarkerBlock("1", a, b) for a, b in GOLDEN]
    assert max(b.block_size() for b in obs) <= 500


def test_hanning_smoothing_golden(blocking_fixture):
    """`hanning_smoothing.expected_results` (`blocking_tests.cpp:40-52`),
    within the 0.01 the JAX package's test allows."""
    obs = tb.hanning_smoothing(blocking_fixture["v"][:1000], 101)
    assert obs.shape == blocking_fixture["smooth"].shape
    assert np.allclose(obs, blocking_fixture["smooth"], atol=0.01)


@pytest.mark.parametrize("window", [3, 5, 101, 999, 1501])
@pytest.mark.parametrize("seed", [0, 1])
def test_hanning_smoothing_matches_jax(seed, window):
    v = _row_sums(seed, 3000)
    got, exp = tb.hanning_smoothing(v, window), jb.hanning_smoothing(v, window)
    np.testing.assert_allclose(got, exp, rtol=0, atol=1e-9)
    assert not got[: window // 2].any() and not got[len(v) - window // 2 :].any()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_local_minima_and_blocks_from_minima_match_jax(seed):
    v = jb.hanning_smoothing(_row_sums(seed, 4000), 201)
    minima = tb.local_minima(v)
    assert minima == jb.local_minima(v) and len(minima) > 2
    assert _tuples(tb.blocks_from_minima(minima, "7", len(v))) == _tuples(
        jb.blocks_from_minima(minima, "7", len(v)))
    # flat and monotone signals have no minimum: one block
    for flat in (np.ones(50), np.arange(50.0)):
        assert tb.local_minima(flat) == jb.local_minima(flat) == []


@pytest.mark.parametrize("max_block_size", [40, 150, 500, 2500])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_block_chr_matches_jax(seed, max_block_size):
    """Equal boundaries, a cover without gaps, and the bisection's promise
    where it converges (largest block within MAX_BLOCK_SIZE_TOL below the
    maximum)."""
    v = _row_sums(seed, 6000)
    got = tb.block_chr(v, "3", max_block_size)
    assert _tuples(got) == _tuples(jb.block_chr(v, "3", max_block_size))
    assert got[0].first_marker_ix == 0 and got[-1].last_marker_ix == len(v) - 1
    for a, b in zip(got, got[1:]):
        assert b.first_marker_ix == a.last_marker_ix + 1
