"""The port's summary-statistic pipeline `cuskss` against the JAX package's,
on the CPU, on the checked-in fixtures: the five configurations of
tests/test_cuskss.py through both packages — `.ixs/.adj/.mdim` byte-identical,
`.corr` within atol 1e-6 — plus the device panel assembly and `reduce_gc`.
"""

import os

import numpy as np
import pytest
import torch

from torch_parity import ATOL, rfdisease_input, set_threads

from cigwas_tpu.pipelines import CuskssArgs as JaxArgs
from cigwas_tpu.pipelines import cuskss as jax_cuskss
from cigwas_tpu_torch.pipelines import CuskssArgs, cuskss

set_threads()

DATA = os.path.join(os.path.dirname(__file__), "data", "test_files")


def p(name: str) -> str:
    return os.path.join(DATA, name)


def _se_files(tmp_path):
    mxp_lines = open(p("marker_trait_summary_stats.txt")).read().splitlines()
    with open(tmp_path / "mxp_se.txt", "w") as f:
        f.write(mxp_lines[0] + "\n")
        for line in mxp_lines[1:]:
            fields = line.split()
            f.write(" ".join(fields[:3] + ["0.00001"] * (len(fields) - 3)) + "\n")
    pxp_lines = open(p("trait_summary_stats.txt")).read().splitlines()
    with open(tmp_path / "pxp_se.txt", "w") as f:
        f.write(pxp_lines[0] + "\n")
        for line in pxp_lines[1:]:
            fields = line.split()
            f.write(" ".join(fields[:1] + ["0.00001"] * (len(fields) - 1)) + "\n")
    return dict(mxp_se=str(tmp_path / "mxp_se.txt"), pxp_se=str(tmp_path / "pxp_se.txt"))


# the five configurations of tests/test_cuskss.py:39-160
CONFIGS = {
    "trait_only_merged": (dict(mxm="NULL", max_level_two=0), "trait_only"),
    "pearson_two_stage_merged": ({}, "cuskss_merged"),
    "pearson_two_stage_block": (
        dict(marker_indices="NULL", blockfile=p("blocks.txt"), block_index=0), "1_0_2"),
    "hetcor_two_stage_merged": ("se", "cuskss_merged"),
    "time_index_merged": (dict(time_index=p("time_index.txt")), "cuskss_merged"),
    # 500 markers merged from 600 rows, 4 risk factors at time 1 and 2
    # diseases at time 2, with standard errors and stage 2 to level 14
    "rfdisease_time_index_merged": ("rfdisease", "cuskss_merged"),
}


def _rfdisease_files(tmp_path):
    d, _ = rfdisease_input(tmp_path)
    return dict(mxm=d["mxm"], mxp=d["mxp"], mxp_se=d["mxp_se"], pxp=d["pxp"],
                pxp_se=d["pxp_se"], marker_indices=d["marker_ixs"],
                time_index=d["time_index"], max_level_two=14)


def _args(cls, outdir, overrides):
    kw = dict(
        mxm=p("small_mxm.bin"), mxp=p("marker_trait_summary_stats.txt"),
        pxp=p("trait_summary_stats.txt"), marker_indices=p("marker_indices.bin"),
        alpha=0.0001, num_samples=500000, max_level_one=3, max_level_two=1,
        max_depth=1, outdir=str(outdir),
    )
    kw.update(overrides)
    return cls.from_paths(**kw)


@pytest.mark.parametrize("ess_mode", ["reference", "float"])
@pytest.mark.parametrize("config", list(CONFIGS))
def test_cuskss_files_match_jax(tmp_path, config, ess_mode):
    overrides, stem = CONFIGS[config]
    if overrides == "se":
        overrides = _se_files(tmp_path)
    elif overrides == "rfdisease":
        overrides = _rfdisease_files(tmp_path)
    overrides = dict(overrides, ess_mode=ess_mode)
    dj, dt = tmp_path / "jax", tmp_path / "torch"
    dj.mkdir()
    dt.mkdir()
    res_j = jax_cuskss(_args(JaxArgs, dj, overrides), verbose=False)
    res_t = cuskss(_args(CuskssArgs, dt, overrides), verbose=False, device="cpu")
    assert sorted(os.listdir(dt)) == sorted(os.listdir(dj)) == sorted(
        stem + e for e in (".adj", ".corr", ".ixs", ".mdim"))
    for ext in (".ixs", ".adj", ".mdim"):
        assert (dt / (stem + ext)).read_bytes() == (dj / (stem + ext)).read_bytes(), ext
    np.testing.assert_allclose(
        np.fromfile(dt / (stem + ".corr"), np.float32),
        np.fromfile(dj / (stem + ".corr"), np.float32), rtol=0, atol=ATOL)
    assert res_t.num_var == res_j.num_var and res_t.num_markers() == res_j.num_markers()
    np.testing.assert_array_equal(res_t.S, res_j.S)  # ESS carried through
    assert isinstance(res_t.C, np.ndarray) and res_t.C.dtype == np.float32


def test_cuskss_defaults_to_the_card():
    """`cuskss` asks for the card unless told otherwise and raises without one."""
    import inspect

    assert inspect.signature(cuskss).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cuskss(_args(CuskssArgs, "/nonexistent", {}), verbose=False)


def test_cuskss_rejects_mismatched_inputs(tmp_path):
    np.ones(10, np.float32).tofile(tmp_path / "mxm4.bin")  # 4 markers, mxp has 3
    with pytest.raises(ValueError, match="markers seem to differ"):
        cuskss(_args(CuskssArgs, tmp_path, dict(mxm=str(tmp_path / "mxm4.bin"))),
               verbose=False, device="cpu")
    with pytest.raises(ValueError, match="markers seem to differ"):
        jax_cuskss(_args(JaxArgs, tmp_path, dict(mxm=str(tmp_path / "mxm4.bin"))),
                   verbose=False)


@pytest.mark.parametrize("het", [True, False], ids=["hetcor", "pearson"])
def test_assemble_cuskss_panels_device_matches_host(tmp_path, het):
    """Assembly from the compact triangle and blocks equals
    `make_square_cuskss_inputs` of both packages exactly, incl. the loader's
    NaN -> 0 on mxm and the Pearson ESS fill."""
    import cigwas_tpu.io as jio
    import cigwas_tpu_torch.io as tio
    from cigwas_tpu.pipelines.cuskss import make_square_cuskss_inputs as jax_square
    from cigwas_tpu_torch.pipelines.cuskss import (
        assemble_cuskss_panels_device,
        make_square_cuskss_inputs,
    )

    m = 3
    tril = np.fromfile(p("small_mxm.bin"), np.float32).copy()
    tril[1] = np.nan
    tril.tofile(tmp_path / "mxm.bin")
    se = _se_files(tmp_path) if het else {}
    sq = []
    for io_, square in ((jio, jax_square), (tio, make_square_cuskss_inputs)):
        ixs = io_.read_ints_from_binary(p("marker_indices.bin"))
        mxm = io_.MarkerSummaryStats(str(tmp_path / "mxm.bin"))
        mxp = io_.MarkerTraitSummaryStats(
            p("marker_trait_summary_stats.txt"), se_path=se.get("mxp_se"), marker_ixs=ixs)
        pxp = (io_.TraitSummaryStats(p("trait_summary_stats.txt"), se_path=se["pxp_se"])
               if het else io_.TraitSummaryStats(p("trait_summary_stats.txt"), sample_size=5e5))
        sq.append(square(mxm, mxp, pxp, 5e5, het))
    np.testing.assert_array_equal(sq[0][0], sq[1][0])
    np.testing.assert_array_equal(sq[0][1], sq[1][1])
    C, N = assemble_cuskss_panels_device(
        tril, mxp.get_corrs(), pxp.get_corrs(), 5e5,
        mp_ess=mxp.get_sample_sizes() if het else None,
        pp_ess=pxp.get_sample_sizes() if het else None, device="cpu",
    )
    assert mxm.get_num_markers() == m and C.shape == (m + 3, m + 3)
    np.testing.assert_array_equal(C.numpy(), sq[0][0])
    np.testing.assert_array_equal(N.numpy(), sq[0][1])
    assert C[1, 0] == 0.0 and C[0, 1] == 0.0


def test_assemble_cuskss_panels_random_matches_jax():
    """The random 37-marker case of tests/test_cuskss.py through both
    packages' device assembly."""
    from cigwas_tpu.pipelines.cuskss import assemble_cuskss_panels_device as jax_assemble
    from cigwas_tpu_torch.pipelines.cuskss import assemble_cuskss_panels_device

    rng = np.random.default_rng(4)
    m, k, n = 37, 3, 50000.0
    full = rng.normal(size=(m, m)).astype(np.float32)
    full = ((full + full.T) / 2).astype(np.float32)
    full[rng.random((m, m)) < 0.02] = np.nan
    full = np.triu(full) + np.triu(full, 1).T
    tril = full[np.tril_indices(m)]
    mxp = rng.normal(size=(m, k)).astype(np.float32)
    pxp = rng.normal(size=(k, k)).astype(np.float32)
    mp_ess = rng.uniform(1e4, 5e4, (m, k)).astype(np.float32)
    pp_ess = rng.uniform(1e4, 5e4, (k, k)).astype(np.float32)
    Cj, Nj = jax_assemble(tril, mxp, pxp, n, mp_ess=mp_ess, pp_ess=pp_ess)
    Ct, Nt = assemble_cuskss_panels_device(tril, mxp, pxp, n, mp_ess=mp_ess,
                                           pp_ess=pp_ess, device="cpu")
    np.testing.assert_array_equal(Ct.numpy(), np.asarray(Cj))
    np.testing.assert_array_equal(Nt.numpy(), np.asarray(Nj))
    with pytest.raises(ValueError, match="not triangular"):
        assemble_cuskss_panels_device(tril[:-1], mxp, pxp, n, device="cpu")


@pytest.mark.parametrize("as_tensor", [False, True], ids=["numpy", "tensor"])
def test_reduce_gc_matches_jax(as_tensor):
    from cigwas_tpu.skeleton import reduce_gc as jax_reduce_gc
    from cigwas_tpu_torch.skeleton import reduce_gc

    rng = np.random.default_rng(0)
    n, k = 6, 2
    G = (rng.random((n, n)) < 0.5).astype(np.int32)
    C = rng.normal(size=(n, n)).astype(np.float32)
    S = rng.uniform(10, 100, (n, n)).astype(np.float32)
    S[1, 2] = np.nan
    keep = np.array([0, 2, 3, 5])
    imap = np.arange(100, 100 + n, dtype=np.int32)
    exp = jax_reduce_gc(G, C, S, keep, n, k, 14, index_map=imap)
    if as_tensor:  # pad-extended device panels, as the first stage holds them
        Cp = torch.nn.functional.pad(torch.from_numpy(C), (0, 2, 0, 2))
        Sp = torch.nn.functional.pad(torch.from_numpy(S), (0, 2, 0, 2), value=10.0)
        got = reduce_gc(G, Cp, Sp, keep, n, k, 14, index_map=imap)
    else:
        got = reduce_gc(G, C, S, keep, n, k, 14, index_map=imap)
    for f in ("G", "C", "S", "new_to_old_indices"):
        np.testing.assert_array_equal(getattr(got, f), getattr(exp, f))
    assert (got.num_var, got.num_phen, got.max_level) == (4, k, 14)
