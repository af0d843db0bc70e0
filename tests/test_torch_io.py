"""The port's host-side copies (files, prep, statistics, colex enumeration)
against the JAX package's originals, on the checked-in fixtures: identical
arrays and byte-identical files. The port imports none of `cigwas_tpu`, so
each module is its own copy and is held to its original here.
"""

import filecmp
import math
import os
import shutil

import numpy as np
import pytest

import cigwas_tpu.io as jio
import cigwas_tpu.io.bed as jbed
import cigwas_tpu.prep as jprep
import cigwas_tpu.utils.combinatorics as jcomb
import cigwas_tpu.utils.stats as jstats
import cigwas_tpu_torch.io as tio
import cigwas_tpu_torch.io.bed as tbed
import cigwas_tpu_torch.prep as tprep
import cigwas_tpu_torch.utils.combinatorics as tcomb
import cigwas_tpu_torch.utils.stats as tstats

DATA = os.path.join(os.path.dirname(__file__), "data", "test_files")


def p(name: str) -> str:
    return os.path.join(DATA, name)


def _prepped(tmp_path, prep, name):
    d = tmp_path / name
    d.mkdir()
    stem = str(d / "small")
    for sfx in (".bed", ".bim", ".fam"):
        shutil.copy(p("small" + sfx), stem + sfx)
    prep.prep_bed(stem)
    return stem


def test_constants_equal():
    import cigwas_tpu.constants as jc
    import cigwas_tpu_torch.constants as tc

    names = [n for n in dir(jc) if n.isupper()]
    assert names and {n: getattr(tc, n) for n in names} == {n: getattr(jc, n) for n in names}


def test_prep_bed_outputs_byte_identical(tmp_path):
    sj = _prepped(tmp_path, jprep, "j")
    st = _prepped(tmp_path, tprep, "t")
    for sfx in (".dim", ".means", ".stds", ".modes"):
        assert filecmp.cmp(sj + sfx, st + sfx, shallow=False), sfx
    assert tbed.BedDims.from_file(st + ".dim") == tbed.BedDims(10, 5)


def test_prep_bed_numpy_path_byte_identical(tmp_path, monkeypatch):
    """Without the native library (a machine with no g++) the numpy path
    writes the same files."""
    import cigwas_tpu_torch.native as tnative

    sj = _prepped(tmp_path, jprep, "j")
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "_tried", True)
    st = _prepped(tmp_path, tprep, "t")
    for sfx in (".dim", ".means", ".stds", ".modes"):
        assert filecmp.cmp(sj + sfx, st + sfx, shallow=False), sfx


def test_bed_block_reads_equal(tmp_path):
    stem = _prepped(tmp_path, tprep, "t")
    out = []
    for io_, bed in ((jio, jbed), (tio, tbed)):
        bf = io_.BfilesBase(stem)
        assert bf.has_valid_bed_prefix()
        dims = io_.BedDims.from_file(bf.dim())
        bim = io_.BimInfo(bf.bim())
        blocks = [io_.MarkerBlock("1", 0, 2), io_.MarkerBlock("1", 1, 4)]
        out.append([bed.read_block_from_bed(bf.bed(), b, dims, bim) for b in blocks]
                   + [np.asarray(bim.num_markers_on_chr),
                      io_.read_floats_from_line_range(bf.means(), 1, 3)])
    for a, b in zip(*out):
        np.testing.assert_array_equal(a, b)
    assert out[0][0].dtype == np.uint8 and out[0][0].shape[0] == 3


@pytest.mark.parametrize("stem", ["wrong_magic_num_one", "wrong_magic_num_two",
                                  "wrong_magic_num_three"])
def test_bed_prefix_rejects_wrong_magic(tmp_path, stem):
    bad = tio.BfilesBase(str(tmp_path / stem))
    shutil.copy(p(stem + ".bed"), bad.bed())
    assert not bad.has_valid_bed_prefix()


def test_bed_encode_decode_equal():
    rng = np.random.default_rng(3)
    g = rng.integers(0, 3, size=(7, 13)).astype(np.float32)
    g[rng.random(g.shape) < 0.2] = np.nan
    bj, bt = jbed.encode_bed_values(g), tbed.encode_bed_values(g)
    np.testing.assert_array_equal(bj, bt)
    for a, b in zip(jbed.decode_bed_values(bj, 13), tbed.decode_bed_values(bt, 13)):
        np.testing.assert_array_equal(a, b)


def test_blocks_equal(tmp_path):
    got = tio.read_blocks_from_file(p("blocks.txt"))
    exp = jio.read_blocks_from_file(p("blocks.txt"))
    assert [(b.chr_id, b.first_marker_ix, b.last_marker_ix,
             b.get_first_marker_global_ix(), b.to_file_string()) for b in got] == [
        (b.chr_id, b.first_marker_ix, b.last_marker_ix,
         b.get_first_marker_global_ix(), b.to_file_string()) for b in exp]
    tio.write_marker_blocks_to_file(got, str(tmp_path / "t.blocks"))
    jio.write_marker_blocks_to_file(exp, str(tmp_path / "j.blocks"))
    assert filecmp.cmp(tmp_path / "t.blocks", tmp_path / "j.blocks", shallow=False)


@pytest.mark.parametrize("name", ["with_nan.phen"])
def test_phen_equal(name):
    got, exp = tio.load_phen(p(name)), jio.load_phen(p(name))
    assert (got.num_phen, got.num_samples) == (exp.num_phen, exp.num_samples)
    np.testing.assert_array_equal(got.data, exp.data)
    assert np.isnan(got.data).any()
    np.testing.assert_array_equal(
        tio.read_floats_from_lines(p("small.phen")), jio.read_floats_from_lines(p("small.phen"))
    )


def _se_files(tmp_path):
    """SE tables matching the corr fixtures, with one NA entry each."""
    mxp_lines = open(p("marker_trait_summary_stats.txt")).read().splitlines()
    with open(tmp_path / "mxp_se.txt", "w") as f:
        f.write(mxp_lines[0] + "\n")
        for i, line in enumerate(mxp_lines[1:]):
            fields = line.split()
            f.write(" ".join(fields[:3] + [f"{0.001 * (i + 1):.4f}"] * (len(fields) - 3)) + "\n")
    pxp_lines = open(p("trait_summary_stats.txt")).read().splitlines()
    with open(tmp_path / "pxp_se.txt", "w") as f:
        f.write(pxp_lines[0] + "\n")
        for line in pxp_lines[1:]:
            fields = line.split()
            f.write(" ".join(fields[:1] + ["0.002"] * (len(fields) - 1)) + "\n")
    return str(tmp_path / "mxp_se.txt"), str(tmp_path / "pxp_se.txt")


@pytest.mark.parametrize("loader", ["pxp", "pxp_se", "mxm", "mxp_block", "mxp_ixs_se"])
def test_summary_stat_loaders_equal(tmp_path, loader):
    mxp_se, pxp_se = _se_files(tmp_path)
    out = []
    for io_ in (jio, tio):
        if loader == "pxp":
            s = io_.TraitSummaryStats(p("trait_summary_stats.txt"), sample_size=5e5)
        elif loader == "pxp_se":
            s = io_.TraitSummaryStats(p("trait_summary_stats.txt"), se_path=pxp_se)
        elif loader == "mxm":
            s = io_.MarkerSummaryStats(p("small_mxm.bin"))
        elif loader == "mxp_block":
            blk = io_.read_blocks_from_file(p("blocks.txt"))[0]
            s = io_.MarkerTraitSummaryStats(p("marker_trait_summary_stats.txt"), block=blk)
        else:
            ixs = io_.read_ints_from_binary(p("marker_indices.bin"))
            s = io_.MarkerTraitSummaryStats(
                p("marker_trait_summary_stats.txt"), se_path=mxp_se, marker_ixs=ixs)
        ess = s.get_sample_sizes() if hasattr(s, "get_sample_sizes") else None
        out.append((s.get_corrs(), ess))
    (cj, ej), (ct, et) = out
    np.testing.assert_array_equal(cj, ct)
    assert (ej is None) == (et is None)
    if ej is not None:
        np.testing.assert_array_equal(ej, et)
    if loader.endswith("_se"):
        assert np.isfinite(et).all() and et.max() > 1e3


@pytest.mark.parametrize("kind", ["gcs", "gc"])
def test_reduced_results_round_trip(tmp_path, kind):
    rng = np.random.default_rng(0)
    k, p_, ml = 6, 2, 14
    common = dict(
        num_var=k, num_phen=p_, max_level=ml,
        new_to_old_indices=rng.permutation(20)[:k].astype(np.int32),
        G=(rng.random((k, k)) < 0.5).astype(np.int32),
        C=rng.normal(size=(k, k)).astype(np.float32),
    )
    if kind == "gcs":
        S = rng.integers(-1, k, (k, k, ml)).astype(np.int32)
        cls_t, cls_j, exts = tio.ReducedGCS, jio.ReducedGCS, (".mdim", ".ixs", ".adj", ".corr", ".sep")
    else:
        S = rng.uniform(10, 100, (k, k)).astype(np.float32)
        cls_t, cls_j, exts = tio.ReducedGC, jio.ReducedGC, (".mdim", ".ixs", ".adj", ".corr")
    bt, bj = str(tmp_path / "t"), str(tmp_path / "j")
    cls_t(S=S, **common).to_file(bt)
    cls_j(S=S, **common).to_file(bj)
    for ext in exts:
        assert filecmp.cmp(bt + ext, bj + ext, shallow=False), ext
    assert not os.path.exists(bt + ".sep") or kind == "gcs"
    back = cls_t.from_file(bj)  # the port reads what the JAX package wrote
    assert (back.num_var, back.num_phen, back.max_level) == (k, p_, ml)
    np.testing.assert_array_equal(back.new_to_old_indices, common["new_to_old_indices"])
    np.testing.assert_array_equal(back.G, common["G"])
    np.testing.assert_array_equal(back.C, common["C"])
    if kind == "gcs":
        np.testing.assert_array_equal(back.S, S)
    else:
        assert back.S.shape == (k, k) and np.isnan(back.S).all()


def test_statistics_equal():
    for n, alpha in ((16384, 1e-4), (500000, 1e-3), (400, 0.05)):
        got, exp = tstats.threshold_array(n, alpha), jstats.threshold_array(n, alpha)
        assert got.dtype == np.float32 and got.shape == (15,)
        np.testing.assert_array_equal(got, exp)
        assert tstats.hetcor_threshold(alpha) == jstats.hetcor_threshold(alpha)
        assert tstats.alpha_threshold(alpha, n, 2) == jstats.alpha_threshold(alpha, n, 2)
    v = np.array([-1.0, -0.7, 0.0, 1e-4, 0.3, 1.0, np.nan], dtype=np.float32)
    np.testing.assert_array_equal(tstats.fisher_z(v), jstats.fisher_z(v))


@pytest.mark.parametrize("l", [1, 2, 3, 4, 6])
def test_colex_enumeration_equal(l):
    for offset, count in ((0, 300), (1234, 512), (40000, 64)):
        got = tcomb.colex_combinations_chunk(offset, count, l)
        np.testing.assert_array_equal(got, jcomb.colex_combinations_chunk(offset, count, l))
        assert got.shape == (count, l)
    # unranking walks up to the largest element, so keep that below ~300
    for r in (0, 1, 17, 299, math.comb(300, l) - 1):
        assert tcomb.colex_unrank(r, l) == jcomb.colex_unrank(r, l)
    assert tcomb.binom(40, l) == jcomb.binom(40, l)
