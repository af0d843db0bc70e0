"""The port's `analysis` and `vis` against the JAX package's, on the
synthetic block outputs and PAG of tests/test_analysis.py (reproduced here:
those fixtures sit beside tests that need the reference checkout). Every
numpy function must give the JAX function's result exactly; the two
association tables are the JAX DataFrames' ``to_dict("records")``; the plot
helpers render under the Agg backend."""

import os

import numpy as np
import pytest

from cigwas_tpu import analysis as ja
from cigwas_tpu_torch import analysis as ta

NUM_P = 3


@pytest.fixture(scope="module")
def block_outputs(tmp_path_factory):
    """tests/test_analysis.py's three synthetic blocks (one absent)."""
    tmp = tmp_path_factory.mktemp("bdpc")
    rng = np.random.default_rng(3)
    blockfile = tmp / "sim.blocks"
    specs = [("1", 0, 59, 12), ("1", 60, 99, 0), ("2", 0, 79, 9)]
    with open(blockfile, "w") as f:
        for chrom, a, b, _ in specs:
            f.write(f"{chrom}\t{a}\t{b}\n")
    present_blockfile = tmp / "present.blocks"
    with open(present_blockfile, "w") as f:
        for chrom, a, b, num_m in specs:
            if num_m:
                f.write(f"{chrom}\t{a}\t{b}\n")
    outdir = tmp / "out"
    outdir.mkdir()
    for chrom, a, b, num_m in specs:
        if num_m == 0:
            continue
        n = num_m + NUM_P
        adj = np.zeros((n, n), np.int32)
        for _ in range(3 * n):
            i, j = rng.integers(0, n, 2)
            if i != j:
                adj[i, j] = adj[j, i] = 1
        corr = rng.normal(size=(n, n))
        corr = (((corr + corr.T) / 2) * adj).astype(np.float32)
        stem = str(outdir / f"{chrom}_{a}_{b}")
        with open(stem + ".mdim", "w") as f:
            f.write(f"{n}\t{NUM_P}\t3\n")
        adj.tofile(stem + ".adj")
        corr.tofile(stem + ".corr")
        np.full((n, n, 3), -1, np.int32).tofile(stem + ".sep")
        np.sort(
            rng.choice(b - a + 1, num_m, replace=False).astype(np.int32)
        ).tofile(stem + ".ixs")
    return str(blockfile), str(outdir) + "/", str(present_blockfile)


@pytest.fixture(scope="module")
def pag_files(tmp_path_factory):
    """tests/test_analysis.py's random PAG over 4 traits and 30 markers."""
    from scipy.io import mmwrite
    from scipy.sparse import coo_matrix

    tmp = tmp_path_factory.mktemp("pag")
    rng = np.random.default_rng(5)
    num_phen, num_m = 4, 30
    n = num_phen + num_m
    pag = np.zeros((n, n), np.int64)
    marks = [(1, 1), (1, 2), (2, 1), (2, 2), (2, 3), (3, 2), (3, 3), (1, 3), (3, 1)]
    for _ in range(4 * n):
        i, j = rng.integers(0, n, 2)
        if i != j and pag[i, j] == 0:
            a, b = marks[rng.integers(len(marks))]
            pag[i, j], pag[j, i] = a, b
    pag_path = str(tmp / "pag.mtx")
    mmwrite(pag_path, coo_matrix(pag))
    pheno_path = str(tmp / "p.phen")
    with open(pheno_path, "w") as f:
        f.write("FID\tIID\t" + "\t".join(f"T{i}" for i in range(num_phen)) + "\n")
    ace = np.where(pag[:num_phen, :num_phen] != 0,
                   rng.normal(size=(num_phen, num_phen)), 0.0)
    ace_path = str(tmp / "ace.mtx")
    mmwrite(ace_path, coo_matrix(ace))
    return pag_path, pheno_path, pag, num_phen, ace_path


def _same_dict(a: dict, b: dict):
    assert set(a) == set(b)
    for k in a:
        assert a[k] == b[k], k


@pytest.mark.parametrize("max_depth", [1, 2, np.inf])
def test_pleiotropy_mats_match_jax(block_outputs, max_depth):
    blockfile, outdir, _ = block_outputs
    for fn in ("global_epm", "global_upm", "global_eps"):
        _same_dict(getattr(ta, fn)(blockfile, outdir, max_depth=max_depth),
                   getattr(ja, fn)(blockfile, outdir, max_depth=max_depth))
    for mat_type in ("exclusive", "union"):
        np.testing.assert_array_equal(
            ta.get_skeleton_pleiotropy_mat(outdir, blockfile, None, max_depth, mat_type,
                                           num_phen=NUM_P),
            ja.get_skeleton_pleiotropy_mat(outdir, blockfile, None, max_depth, mat_type,
                                           num_phen=NUM_P))


@pytest.mark.parametrize("depth", [1, 2, 3])
@pytest.mark.parametrize("reduced", [False, True])
def test_ancestor_and_parent_sets_match_jax(block_outputs, depth, reduced):
    blockfile, outdir, present = block_outputs
    _same_dict(ta.global_ancestor_sets(blockfile, outdir, reduced, depth),
               ja.global_ancestor_sets(blockfile, outdir, reduced, depth))
    _same_dict(ta.global_parent_sets(present, outdir, reduced),
               ja.global_parent_sets(present, outdir, reduced))


def test_block_sets_match_jax(block_outputs):
    blockfile, outdir, _ = block_outputs
    for bo_t, bo_j in zip(ta._iter_blocks(blockfile, outdir), ja._iter_blocks(blockfile, outdir)):
        _same_dict(ta.block_pheno_direct_parents(bo_t), ja.block_pheno_direct_parents(bo_j))
        for depth in (1, 2, 5):
            _same_dict(ta.block_pheno_ancestor_sets(bo_t, depth),
                       ja.block_pheno_ancestor_sets(bo_j, depth))


@pytest.mark.parametrize("depth", [1, 2])
def test_pag_pleiotropy_sets_match_jax(pag_files, depth):
    pag_path, pheno_path = pag_files[:2]
    for t_fn, j_fn in ((ta.is_possible_child, ja.is_possible_child),
                       (ta.is_child, ja.is_child)):
        _same_dict(ta.pag_exclusive_pleiotropy_sets(pag_path, pheno_path, t_fn, depth),
                   ja.pag_exclusive_pleiotropy_sets(pag_path, pheno_path, j_fn, depth))


def test_pag_paths_and_tallies_match_jax(pag_files):
    pag_path, pheno_path, pag, num_phen, ace_path = pag_files
    for max_len in (np.inf, 1, 2):
        np.testing.assert_array_equal(
            ta.get_causal_paths(pag_path, pheno_path, max_path_len=max_len),
            ja.get_causal_paths(pag_path, pheno_path, max_path_len=max_len))
    np.testing.assert_array_equal(ta.get_possibly_causal_paths(pag_path, pheno_path),
                                  ja.get_possibly_causal_paths(pag_path, pheno_path))
    _same_dict(ta.pag_edge_types(pag_path, pheno_path), ja.pag_edge_types(pag_path, pheno_path))
    _same_dict(ta.pag_x_to_y_edge_types(pag_path, pheno_path),
               ja.pag_x_to_y_edge_types(pag_path, pheno_path))
    np.testing.assert_array_equal(ta.pag_to_dag_directed(pag), ja.pag_to_dag_directed(pag))
    np.testing.assert_array_equal(ta.pag_to_dag_possibly_directed(pag),
                                  ja.pag_to_dag_possibly_directed(pag))
    np.testing.assert_array_equal(ta.load_ace(ace_path, pheno_path),
                                  ja.load_ace(ace_path, pheno_path))
    np.testing.assert_array_equal(ta.load_ace_directed_only(ace_path, pag_path, pheno_path),
                                  ja.load_ace_directed_only(ace_path, pag_path, pheno_path))
    assert ta.get_pheno_codes(pheno_path) == ja.get_pheno_codes(pheno_path)


def test_dag_helpers_match_jax():
    rng = np.random.default_rng(9)
    adj = np.triu(rng.random((12, 12)) < 0.3, k=1).astype(np.float64)
    adj *= rng.normal(size=adj.shape)
    np.testing.assert_array_equal(ta.make_adj_symmetric(adj), ja.make_adj_symmetric(adj))
    assert ta.make_link_type_dict(adj) == ja.make_link_type_dict(adj)
    np.testing.assert_array_equal(ta.path_in_sem(adj), ja.path_in_sem(adj))


def _write_bim(path, n_bim, chrom="1"):
    with open(path, "w") as f:
        for i in range(n_bim):
            f.write(f"{chrom}\trs{i}\t0\t{1000 + i}\tA\tC\n")


def _records(df):
    return df.to_dict("records")


def _key(r):
    return (str(r["phenotype"]), r["bim_line_ix"])


@pytest.mark.parametrize("chrom", ["1", "X"])
def test_marker_pheno_associations_match_jax(block_outputs, tmp_path, chrom):
    """The table of tests/test_analysis.py, by trait index and by name."""
    from cigwas_tpu_torch.merge import merge_block_outputs

    blockfile, outdir, _ = block_outputs
    gm = merge_block_outputs(blockfile, outdir)
    stem = str(tmp_path / "merged")
    gm.write_mm(stem)
    bim_path = str(tmp_path / "sim.bim")
    _write_bim(bim_path, 200, chrom)
    kw = dict(bim_path=bim_path, corr_path=stem + "_scm.mtx", adj_path=stem + "_sam.mtx",
              ixs_path=stem + ".ixs")
    phen = str(tmp_path / "p.phen")
    with open(phen, "w") as f:
        f.write("FID\tIID\tH0\tH1\tH2\n")
    for extra in (dict(num_phen=NUM_P), dict(num_phen=1, pheno_codes=["a", "b", "c"]),
                  dict(pheno_path=phen)):
        got = ta.marker_pheno_associations(**kw, **extra)
        exp = _records(ja.marker_pheno_associations(**kw, **extra))
        assert got and got == exp
        assert list(got[0]) == ["phenotype", "rsID", "bim_line_ix", "chr", "bp", "corr"]
    with pytest.raises(RuntimeError):
        ta.marker_pheno_associations(**kw)


def test_marker_pheno_associations_with_pnames_match_jax(block_outputs, tmp_path, capsys):
    blockfile, outdir, _ = block_outputs
    bim_path = str(tmp_path / "sim.bim")
    _write_bim(bim_path, 60)  # some indices past the end: skipped and printed
    got = ta.marker_pheno_associations_with_pnames(blockfile, outdir, ["A", "B", "C"],
                                                   bim_path, depth=2)
    printed_t = capsys.readouterr().out
    exp = _records(ja.marker_pheno_associations_with_pnames(blockfile, outdir,
                                                            ["A", "B", "C"], bim_path,
                                                            depth=2))
    assert printed_t == capsys.readouterr().out
    assert got and sorted(got, key=_key) == sorted(exp, key=_key)


@pytest.fixture
def agg():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    yield plt
    plt.close("all")


def test_plot_helpers_render(block_outputs, pag_files, tmp_path, agg):
    """tests/test_analysis.py's render smoke test, through the port, plus
    the ACE heatmap."""
    blockfile, outdir, _ = block_outputs
    pag_path, pheno_path, _, num_phen, ace_path = pag_files
    p3 = str(tmp_path / "p3.phen")
    with open(p3, "w") as f:
        f.write("FID\tIID\tT0\tT1\tT2\n")
    _, ax = agg.subplots()
    ta.plot_skeleton_pleiotropy_mat(outdir, blockfile, p3, ax=ax)
    _, ax = agg.subplots()
    ta.plot_pag(pag_path, pheno_path, ax=ax)
    _, ax = agg.subplots()
    ta.plot_pleiotropy_mat(pag_path, pheno_path, ax=ax)
    _, ax = agg.subplots()
    ta.plot_ace(ace_path, pheno_path, ax=ax, directed_only=True, pag_path=pag_path)
    assert ta.get_skeleton_pleiotropy_mat(outdir, blockfile, p3).shape == (NUM_P, NUM_P)
    assert ta.all_edge_types.cmap.N == len(ta.all_edge_types.colors)


def test_vis_corr_plot_and_reader(tmp_path, agg):
    """tests/test_utils.py's `corr_plot` case, through the port."""
    from cigwas_tpu.vis import read_floats_from_bin as jax_read
    from cigwas_tpu_torch.vis import corr_plot, read_floats_from_bin

    m = 12
    nv = m * (m - 1) // 2
    rng = np.random.default_rng(3)
    v1 = rng.uniform(-1, 1, nv).astype(np.float32)
    v2 = (v1 * 0.9).astype(np.float32)
    a, b = str(tmp_path / "a.bin"), str(tmp_path / "b.bin")
    v1.tofile(a)
    v2.tofile(b)
    assert np.array_equal(read_floats_from_bin(a, nv), jax_read(a, nv))
    ax = corr_plot(a, b, m, title="qc")
    assert any("1.0" in t.get_text() for t in ax.texts)
    out = str(tmp_path / "p.png")
    ax.figure.savefig(out)
    assert os.path.getsize(out) > 0
