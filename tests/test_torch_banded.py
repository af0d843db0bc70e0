"""The port's marker-marker and banded correlations and `make_blocks`
against the JAX package's, on the CPU.

Tolerances: correlations rtol 1e-5 / atol 1e-6 (the counts are exact
integers in both; the float32 tau-b -> sin map differs in the last bits,
see tests/test_torch_corr.py); the |corr| row sums of the band rtol 2e-5 /
atol 1e-4, what the JAX package allows between its own two routes
(tests/test_corr.py), because numpy, XLA and torch each sum in another order.
"""

import numpy as np
import pytest

from torch_parity import ATOL, RTOL, dir_bytes, genotypes, planted_dataset, set_threads

from cigwas_tpu.io.bed import encode_bed_values
from cigwas_tpu.ops import corr as jc
from cigwas_tpu_torch.ops import corr as tc

set_threads()
SUM_RTOL, SUM_ATOL = 2e-5, 1e-4


def _bed(seed: int, m: int, n: int, missing: float = 0.02):
    return encode_bed_values(genotypes(np.random.default_rng(seed), m, n, missing))


@pytest.mark.parametrize("row_tile", [None, 64])
def test_kendall_npn_corr_matches_jax(row_tile):
    m, n = 150, 517  # n % 4 != 0: tail codes of the last byte are missing
    bb = _bed(0, m, n)
    got = tc.kendall_npn_corr(bb, n, row_tile=row_tile, device="cpu")
    exp = jc.kendall_npn_corr(bb, n, row_tile=row_tile)
    assert got.shape == (m, m) and np.all(np.diag(got) == 1.0)
    np.testing.assert_allclose(got, exp, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("m,width,row_tile", [
    (300, 40, 128), (300, 40, 32), (300, 40, 2048),  # last tile short; one tile
    (100, 150, 64),   # the band reaches past the chromosome's end in every row
    (12, 16, 2048),   # fewer rows than the int8 product wants on a card
])
def test_kendall_npn_corr_banded_matches_jax(m, width, row_tile):
    n = 512
    bb = _bed(1, m, n)
    got = tc.kendall_npn_corr_banded(bb, n, width, row_tile=row_tile, device="cpu")
    exp = jc.kendall_npn_corr_banded(bb, n, width, row_tile=row_tile)
    assert got.shape == (m, width) and np.all(np.isfinite(got))
    np.testing.assert_allclose(got, exp, rtol=RTOL, atol=ATOL)
    # band[i, j] = corr(i, i + 1 + j), zero past the end
    full = tc.kendall_npn_corr(bb, n, device="cpu")
    for i, j in ((0, 0), (m // 2, 3), (m - 2, 0)):
        assert got[i, j] == pytest.approx(full[i, i + 1 + j], abs=ATOL)
    ii, jj = np.indices(got.shape)
    assert not got[ii + 1 + jj >= m].any()


def test_banded_all_missing_marker_gives_zero_not_nan():
    """A marker without a single genotype has 0/0 correlations; the band
    holds 0 there, as for the pad rows of the last tile."""
    rng = np.random.default_rng(2)
    G = genotypes(rng, 40, 256)
    G[7] = np.nan
    bb = encode_bed_values(G)
    got = tc.kendall_npn_corr_banded(bb, 256, 8, row_tile=16, device="cpu")
    exp = jc.kendall_npn_corr_banded(bb, 256, 8, row_tile=16)
    assert not got[7].any() and np.all(np.isfinite(got))
    np.testing.assert_allclose(got, exp, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("row_tile", [128, 100])
def test_row_abs_sums_both_routes_match_jax(row_tile):
    m, n, w = 300, 512, 40
    bb = _bed(3, m, n)
    two_step = tc.banded_row_abs_sums(
        tc.kendall_npn_corr_banded(bb, n, w, row_tile=row_tile, device="cpu"))
    streaming = tc.banded_row_abs_sums_streaming(bb, n, w, row_tile=row_tile, device="cpu")
    assert two_step.dtype == streaming.dtype == np.float32 and streaming.shape == (m,)
    np.testing.assert_allclose(streaming, two_step, rtol=SUM_RTOL, atol=SUM_ATOL)
    jax_two_step = jc.banded_row_abs_sums(jc.kendall_npn_corr_banded(bb, n, w, row_tile=row_tile))
    jax_streaming = jc.banded_row_abs_sums_streaming(bb, n, w, row_tile=row_tile)
    np.testing.assert_allclose(two_step, jax_two_step, rtol=SUM_RTOL, atol=SUM_ATOL)
    np.testing.assert_allclose(streaming, jax_streaming, rtol=SUM_RTOL, atol=SUM_ATOL)


def test_banded_entries_default_to_the_card():
    """No `device` means the card: without one the entry raises instead of
    carrying on on the CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    bb = _bed(4, 8, 64)
    for fn in (tc.kendall_npn_corr_banded, tc.banded_row_abs_sums_streaming):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn(bb, 64, 4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tc.kendall_npn_corr(bb, 64)


@pytest.fixture(scope="module")
def three_chromosomes(tmp_path_factory):
    from cigwas_tpu.prep import prep_bed

    tmp = tmp_path_factory.mktemp("torch_blocks")
    stem = str(tmp / "sim")
    planted_dataset(stem, 11, 600, [130, 90, 20], {0: [(5, 0.4)], 1: [(150, 0.4)]})
    prep_bed(stem)
    return tmp, stem


@pytest.mark.parametrize("route", ["two_step", "streaming"])
def test_make_blocks_writes_the_jax_blocks_file(three_chromosomes, route):
    """Three chromosomes (one smaller than the correlation width) through
    the JAX `make_blocks` and the port's, by the two-step route and with the
    streaming route forced by its threshold argument: the same `.blocks`
    bytes, and a second call appends to the file as the original does."""
    from cigwas_tpu.pipelines import make_blocks as jax_make_blocks
    from cigwas_tpu_torch.pipelines import make_blocks

    tmp, stem = three_chromosomes
    exp_path = str(tmp / f"jax_{route}.blocks")
    exp = jax_make_blocks(stem, 48, 24, out_path=exp_path, verbose=False)
    got_path = str(tmp / f"torch_{route}.blocks")
    kw = {"streaming_min_markers": 0} if route == "streaming" else {}
    got = make_blocks(stem, 48, 24, out_path=got_path, verbose=False, device="cpu", **kw)
    assert [b.to_file_string() for b in got] == [b.to_file_string() for b in exp]
    assert {b.chr_id for b in got} == {"1", "2", "3"} and len(got) > 3
    once = open(got_path, "rb").read()
    assert once == open(exp_path, "rb").read()
    make_blocks(stem, 48, 24, out_path=got_path, verbose=False, device="cpu", **kw)
    assert open(got_path, "rb").read() == once + once


def test_make_blocks_default_path_and_device(three_chromosomes):
    import os

    import torch

    from cigwas_tpu_torch.pipelines import make_blocks

    tmp, stem = three_chromosomes
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_blocks(stem, 48, 24, verbose=False)
    assert not os.path.exists(stem + "_m48.blocks")
    make_blocks(stem, 48, 24, verbose=False, device="cpu")
    assert os.path.getsize(stem + "_m48.blocks") > 0
    assert "sim_m48.blocks" in dir_bytes(tmp)
