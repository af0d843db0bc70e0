"""The port's correlation panels against the JAX package's, on the CPU.

Same packed genotypes (with missing calls) and phenotypes (with NaNs) go
through both. Tolerance: contingency counts exactly equal (int32 on both
sides); panels within atol 1e-6 with identical NaN positions — the Kendall
map and the Pearson sums are the same float32 expressions, but XLA:CPU may
contract them into FMA and sums run in another order, and the two sin()
implementations differ in the last ulp.
"""

import os

import numpy as np
import pytest
import torch

from torch_parity import assert_close_nan, set_threads

from cigwas_tpu.io.bed import encode_bed_values

set_threads()


def _block(seed, m, n, p, miss=0.02, phen_nan=0.01):
    rng = np.random.default_rng(seed)
    maf = rng.uniform(0.1, 0.5, m)
    G = ((rng.random((m, n)) < maf[:, None]).astype(np.float32)
         + (rng.random((m, n)) < maf[:, None]))
    for i in range(1, m):  # some LD between neighbours
        mask = rng.random(n) < 0.5
        G[i, mask] = G[i - 1, mask]
    G[rng.random((m, n)) < miss] = np.nan
    Y = rng.normal(size=(p, n)).astype(np.float32)
    Y[0] += 0.3 * np.nan_to_num(G[m // 2] - 1.0)
    Y = (Y - Y.mean(1, keepdims=True)) / Y.std(1, keepdims=True)
    Y[rng.random((p, n)) < phen_nan] = np.nan
    valid = ~np.isnan(G)
    means = (np.nansum(G, 1) / valid.sum(1)).astype(np.float32)
    stds = np.sqrt(np.nansum((G - means[:, None]) ** 2, 1) / valid.sum(1)).astype(np.float32)
    return encode_bed_values(G), Y, means, stds


def test_contingency_counts_exact():
    import jax.numpy as jnp

    from cigwas_tpu.ops import decode as jd
    from cigwas_tpu_torch.ops import decode as td

    bb, _, _, _ = _block(0, 40, 1000, 2)
    oh_j = jd.geno_onehot(jd.unpack_bed_codes(jnp.asarray(bb))).reshape(120, -1)
    cnt_j = np.asarray(jd.contingency_counts(oh_j, oh_j))
    oh_t = td.geno_onehot(td.unpack_bed_codes(torch.from_numpy(bb))).reshape(120, -1)
    cnt_t = td.contingency_counts(oh_t, oh_t).numpy()
    assert cnt_t.dtype == np.int32
    assert np.array_equal(cnt_t, cnt_j)
    assert np.array_equal(oh_t.numpy(), np.asarray(oh_j))


@pytest.mark.parametrize("sample_chunk", [131072, 256], ids=["one-chunk", "4-chunks"])
def test_corr_panel_device_matches_jax(sample_chunk):
    from cigwas_tpu.ops import corr as jc
    from cigwas_tpu_torch.ops import corr as tc

    bb, Y, means, stds = _block(1, 200, 1000, 3)
    C_j, v_j = jc.corr_panel_device(bb, Y, means, stds, 1000)
    C_t, v_t = tc.corr_panel_device(bb, Y, means, stds, 1000, "cpu",
                                    sample_chunk=sample_chunk)
    assert v_t == v_j == 203
    assert tuple(C_t.shape) == C_j.shape == (256, 256)
    assert_close_nan(C_t.numpy(), np.asarray(C_j), atol=1e-6)


@pytest.mark.parametrize(
    "n", [1024, 1000, 1001, 1003],
    ids=["rows-of-16-bytes", "rows-padded-to-16-bytes", "1-code-in-last-byte",
         "3-codes-in-last-byte"],
)
def test_corr_panel_device_tiled_matches_jax(n):
    """A canvas of 128-row multiples; the Kendall block is one launch over
    every sample of the packed rows, padded to 16 bytes only where they
    fall short, codes past n counted as missing; with the pre-screen's
    correlations and without."""
    from cigwas_tpu.ops import corr as jc
    from cigwas_tpu_torch.ops import corr as tc

    bb, Y, means, stds = _block(2, 300, n, 3)
    mp = jc.marker_phen_corr(bb, Y, means, stds, n)
    for mp_corr in (None, mp):
        C_j, v_j = jc.corr_panel_device_tiled(
            bb, Y, means, stds, n, mp_corr=mp_corr, row_tile=128
        )
        C_t, v_t = tc.corr_panel_device_tiled(
            bb, Y, means, stds, n, "cpu", mp_corr=mp_corr, row_tile=128,
        )
        assert v_t == v_j == 303
        assert tuple(C_t.shape) == C_j.shape == (384, 384)
        assert_close_nan(C_t.numpy(), np.asarray(C_j), atol=1e-6)


def test_marker_phen_prescreen_matches_jax():
    """The pre-screen correlations and the phen-phen panel (host epilogue
    after the device sums, as in the JAX package)."""
    from cigwas_tpu.ops import corr as jc
    from cigwas_tpu_torch.ops import corr as tc

    bb, Y, means, stds = _block(3, 64, 777, 4)  # n not a multiple of 4
    mp_j = jc.marker_phen_corr_from_sums(
        jc.marker_phen_sums_dispatch(bb, Y, 777), means, stds
    )
    mp_t = tc.marker_phen_corr_from_sums(tc.marker_phen_sums(bb, Y, 777, "cpu"), means, stds)
    assert_close_nan(mp_t, mp_j, atol=1e-6)
    assert_close_nan(tc.phen_phen_corr(Y, "cpu"), jc.phen_phen_corr(Y), atol=1e-6)


def test_kendall_npn_golden():
    """The reference's hand-computed npn correlations (`corr_tests.cpp:176-184`,
    7 markers x 100 individuals), through the port's fused panel."""
    from cigwas_tpu_torch.ops import corr as tc

    path = os.path.join(os.path.dirname(__file__), "data", "bed_marker.npz")
    if not os.path.exists(path):
        pytest.skip("bed_marker fixture cache missing")
    data = np.load(path)
    bb = data["bmt2_marker_vals"].reshape(7, 25)
    exp = np.eye(7, dtype=np.float32)
    iu = np.triu_indices(7, k=1)
    exp[iu] = data["bmt2_marker_corrs"]
    exp[(iu[1], iu[0])] = data["bmt2_marker_corrs"]
    phen = np.zeros((1, 100), np.float32)
    C, _ = tc.corr_panel_device(bb, phen, np.ones(7), np.ones(7), 100, "cpu")
    assert np.allclose(C.numpy()[:7, :7], exp, atol=1e-5)


def _bmt2():
    path = os.path.join(os.path.dirname(__file__), "data", "bed_marker.npz")
    if not os.path.exists(path):
        pytest.skip("bed_marker fixture cache missing")
    return np.load(path)


def _unpack_tri(vals, m):
    """Upper-tri packed (row-major, no diagonal) -> dense symmetric, unit diagonal."""
    out = np.eye(m, dtype=np.float32)
    iu = np.triu_indices(m, k=1)
    out[iu] = vals
    out[(iu[1], iu[0])] = vals
    return out


@pytest.mark.parametrize("sample_chunk", [131072, 256], ids=["one-chunk", "4-chunks"])
def test_marker_pearson_corr_matches_jax_bitwise(sample_chunk):
    """Exact integer sums on both sides and the same f32 host quotient:
    bit for bit, NaNs (markers with no jointly valid sample) included."""
    from cigwas_tpu.ops import corr as jc
    from cigwas_tpu_torch.ops import corr as tc

    bb, _, means, stds = _block(5, 50, 1001, 1, miss=0.05)
    got = tc.marker_pearson_corr(bb, means, stds, 1001, sample_chunk=sample_chunk,
                                 device="cpu")
    exp = jc.marker_pearson_corr(bb, means, stds, 1001, sample_chunk=sample_chunk)
    assert got.dtype == exp.dtype == np.float32 and got.shape == (50, 50)
    assert np.array_equal(got.view(np.int32), exp.view(np.int32))


def test_marker_phen_corr_matches_jax():
    from cigwas_tpu.ops import corr as jc
    from cigwas_tpu_torch.ops import corr as tc

    bb, Y, means, stds = _block(6, 48, 901, 3)
    got = tc.marker_phen_corr(bb, Y, means, stds, 901, device="cpu")
    assert_close_nan(got, jc.marker_phen_corr(bb, Y, means, stds, 901), atol=1e-6)


def test_pack_square_and_antidiag_sums_match_jax():
    from cigwas_tpu.ops import corr as jc
    from cigwas_tpu_torch.ops import corr as tc

    rng = np.random.default_rng(8)
    m, p = 9, 3
    mm = rng.uniform(-1, 1, (m, m)).astype(np.float32)
    mm = (mm + mm.T) / 2
    mp = rng.uniform(-1, 1, (m, p)).astype(np.float32)
    pp = rng.uniform(-1, 1, (p, p)).astype(np.float32)
    sq = tc.pack_square_corr(mm, mp, pp)
    assert np.array_equal(sq, jc.pack_square_corr(mm, mp, pp))
    for M in (mm, sq, np.ones((1, 1), np.float32)):
        assert np.array_equal(tc.marker_corr_mat_antidiag_sums(M),
                              jc.marker_corr_mat_antidiag_sums(M))


def test_ops_exports_match_jax():
    import cigwas_tpu.ops as jops
    import cigwas_tpu_torch.ops as tops

    assert tops.__all__ == jops.__all__
    assert all(callable(getattr(tops, name)) for name in tops.__all__)


def test_bmt2_golden_pearson_phen_antidiag():
    """The reference's hand-computed values (`corr_tests.cpp`, bmt2: 7
    markers x 100 individuals, 5 traits), as tests/test_corr_parity.py
    pins them for the JAX package."""
    from cigwas_tpu_torch.ops import corr as tc

    data = _bmt2()
    bb = data["bmt2_marker_vals"].reshape(7, 25)
    C = tc.marker_pearson_corr(bb, data["bmt2_marker_mean"], data["bmt2_marker_std"], 100,
                               device="cpu")
    assert np.allclose(C, _unpack_tri(data["bmt2_marker_corrs_pearson"], 7), atol=1e-5)
    sums = tc.marker_corr_mat_antidiag_sums(_unpack_tri(data["bmt2_marker_corrs"], 7))
    assert np.allclose(sums, data["bmt2_marker_corr_antidiag_sums"], atol=1e-5)
    w, p, m = 3, 5, 7
    sparse = data["bmt2_sparse_corrs"].reshape(m + p, w + p)
    phen = data["bmt2_phen_vals"].reshape(p, 100)
    mp = tc.marker_phen_corr(bb, phen, data["bmt2_marker_mean"], data["bmt2_marker_std"], 100,
                             device="cpu")
    assert np.allclose(mp, sparse[:m, w:], atol=1e-5)
    small = tc.marker_phen_corr(data["bmt_marker_vals"].reshape(3, 3),
                                data["bmt_phen_vals"].reshape(2, 10), data["bmt_marker_mean"],
                                data["bmt_marker_std"], 10, device="cpu")
    assert small.shape == (3, 2) and np.all(np.abs(small) <= 1.0 + 1e-6)


def test_marker_pearson_corr_needs_a_device():
    from cigwas_tpu_torch.ops import corr as tc

    bb, _, means, stds = _block(5, 20, 64, 1)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tc.marker_pearson_corr(bb, means, stds, 64)
