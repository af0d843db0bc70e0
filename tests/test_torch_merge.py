"""The port's block scheduling, multi-block runner, merge and sepselect
against the JAX package's, on the CPU.

`partition_blocks`, `merge_block_outputs`, `sepselect_merged` and
`orient_v_structures_merged` are host numpy/scipy in both packages: the
same block directory gives the same lists and byte-identical merged files.
Block directories written by the two `run_all_blocks` agree as single
blocks do: `.corr` within atol 1e-6, every other file byte-identical.
"""

import os

import numpy as np
import pytest

from torch_parity import assert_block_dirs_match, dir_bytes, planted_dataset, set_threads

from cigwas_tpu_torch.io.blocks import MarkerBlock
from cigwas_tpu_torch.io.results import ReducedGCS
from cigwas_tpu_torch.merge import merge_block_outputs

set_threads()
MERGED = ("_sam.mtx", "_scm.mtx", ".mdim", ".ixs")
ALPHA, N = 1e-3, 2500


# --- the reference's merge quirks (the cases of tests/test_merge_quirks.py) ---


def _write_block(outdir, stem, num_m, num_p, edges, marker_rel_ixs, max_level=14):
    """A minimal `.mdim/.ixs/.adj/.corr/.sep` block output: edges are dense
    index pairs (markers first, then traits) with correlation 0.5."""
    n = num_m + num_p
    G = np.zeros((n, n), np.int32)
    C = np.eye(n, dtype=np.float32)
    for i, j in edges:
        G[i, j] = G[j, i] = 1
        C[i, j] = C[j, i] = 0.5
    ixs = np.zeros(n, dtype=np.int32)
    ixs[:num_m] = np.asarray(marker_rel_ixs, dtype=np.int32)
    ReducedGCS(num_var=n, num_phen=num_p, max_level=max_level, new_to_old_indices=ixs,
               G=G, C=C, S=np.full((n, n, max_level), -1, dtype=np.int32)).to_file(
        str(outdir / stem))


def _write_blockfile(path, blocks):
    with open(path, "w") as f:
        f.writelines(f"{c}\t{a}\t{b}\n" for c, a, b in blocks)


def test_trait_intersection_off_by_one(tmp_path):
    """Trait-trait edges missing from a block are dropped, except those that
    touch the last trait (`add_sam`, `merge_blocks.py:336-345`)."""
    _write_block(tmp_path, "1_0_9", 2, 3, [(2, 3), (3, 4), (2, 4), (0, 2)], [1, 7])
    _write_block(tmp_path, "1_10_19", 2, 3, [(0, 3)], [0, 4])
    bf = tmp_path / "test.blocks"
    _write_blockfile(bf, [("1", 0, 9), ("1", 10, 19)])
    res = merge_block_outputs(str(bf), str(tmp_path))
    assert (1, 2) not in res.sam and (2, 1) not in res.sam
    assert (2, 3) in res.sam and (3, 2) in res.sam
    assert (1, 3) in res.sam and (3, 1) in res.sam


def test_missing_block_skipped_with_correct_offsets(tmp_path, capsys):
    """A missing block is reported and skipped; later blocks keep their
    `.bim` rows (`merge_blocks.py:371-391`)."""
    _write_block(tmp_path, "1_0_9", 2, 2, [(0, 2), (1, 3)], [1, 7])
    _write_block(tmp_path, "1_10_19", 2, 2, [(0, 2)], [3, 5])
    _write_block(tmp_path, "1_20_29", 2, 2, [(0, 3), (1, 2)], [0, 4])
    bf = tmp_path / "test.blocks"
    _write_blockfile(bf, [("1", 0, 9), ("1", 10, 19), ("1", 20, 29)])
    assert merge_block_outputs(str(bf), str(tmp_path)).gmi == {
        3: 1, 4: 7, 5: 13, 6: 15, 7: 20, 8: 24}
    for suffix in (".mdim", ".ixs", ".adj", ".corr", ".sep"):
        (tmp_path / ("1_10_19" + suffix)).unlink()
    capsys.readouterr()
    res = merge_block_outputs(str(bf), str(tmp_path))
    out = capsys.readouterr().out
    assert "Missing:" in out and "1_10_19" in out
    assert res.gmi == {3: 1, 4: 7, 5: 20, 6: 24} and res.num_var == 4 + 2
    assert (5, 2) in res.sam and (6, 1) in res.sam


def test_first_block_missing_drops_trait_edges(tmp_path):
    """Without block 0 no trait-trait edge is seeded, except through the
    same off-by-one (`merge_blocks.py:361-380`); no block at all raises."""
    _write_block(tmp_path, "1_10_19", 2, 3, [(0, 2), (2, 3), (3, 4)], [3, 5])
    bf = tmp_path / "test.blocks"
    _write_blockfile(bf, [("1", 0, 9), ("1", 10, 19)])
    res = merge_block_outputs(str(bf), str(tmp_path))
    assert (1, 2) not in res.sam and (2, 1) not in res.sam
    assert (2, 3) in res.sam and (3, 2) in res.sam
    assert (4, 1) in res.sam and res.gmi == {4: 13, 5: 15}
    _write_blockfile(bf, [("1", 0, 9)])
    with pytest.raises(FileNotFoundError):
        merge_block_outputs(str(bf), str(tmp_path))


# --- scheduling ---------------------------------------------------------------


@pytest.mark.parametrize("num_partitions", [1, 2, 3, 4])
def test_partition_blocks_matches_jax(num_partitions):
    from cigwas_tpu.io.blocks import MarkerBlock as JaxBlock
    from cigwas_tpu.parallel.block_scheduler import partition_blocks as jax_partition
    from cigwas_tpu_torch.parallel import block_cost, partition_blocks

    rng = np.random.default_rng(5)
    sizes = rng.integers(1, 3000, 23)
    first = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    spans = [("1", int(a), int(a + s - 1)) for a, s in zip(first, sizes)]
    mine, theirs = [MarkerBlock(*s) for s in spans], [JaxBlock(*s) for s in spans]
    seen = []
    for index in range(num_partitions):
        got = partition_blocks(mine, num_partitions, index)
        exp = jax_partition(theirs, num_partitions, index)
        assert [b.to_file_string() for b in got] == [b.to_file_string() for b in exp]
        seen += got
    assert sorted(b.first_marker_ix for b in seen) == sorted(int(a) for a in first)
    assert block_cost(mine[0]) == int(sizes[0]) ** 2 + 128 * 128
    # the defaults are one process, every block
    assert partition_blocks(mine) == mine
    with pytest.raises(ValueError):
        partition_blocks(mine, 2, 2)


# --- run_all_blocks, merge, sepselect ----------------------------------------


@pytest.fixture(scope="module")
def blocked_dataset(tmp_path_factory):
    """The dataset of tests/test_parallel.py (seed 17, n = 2500, m = 96,
    blocks of at most 32 markers), prepared and blocked by the port, and its
    block directory from the JAX package's `run_all_blocks`."""
    from cigwas_tpu.parallel import run_all_blocks as jax_run_all_blocks
    from cigwas_tpu_torch.pipelines import make_blocks
    from cigwas_tpu_torch.prep import prep_bed

    tmp = tmp_path_factory.mktemp("torch_merge")
    stem = str(tmp / "sim")
    planted_dataset(stem, 17, N, [96],
                    {0: [(5, 0.4), (40, 0.4), (70, 0.4)], 1: [(20, 0.4)]}, {1: [(0, 0.5)]})
    prep_bed(stem)
    blockfile = stem + "_m32.blocks"
    make_blocks(stem, 32, 16, verbose=False, device="cpu")
    out = tmp / "out_jax"
    out.mkdir()
    jax_run_all_blocks(stem + ".phen", stem, blockfile, ALPHA, 3, 14, 1, str(out),
                       num_partitions=1, partition_index=0, verbose=False)
    return tmp, stem, blockfile, out


def _run(tmp, stem, blockfile, tag, num_partitions, verbose=False):
    from cigwas_tpu_torch.parallel import run_all_blocks

    out = tmp / f"out_{tag}"
    out.mkdir()
    covered = []
    for index in range(num_partitions):
        res = run_all_blocks(stem + ".phen", stem, blockfile, ALPHA, 3, 14, 1, str(out),
                             num_partitions=num_partitions, partition_index=index,
                             verbose=verbose, device="cpu")
        covered += list(res)
    return out, covered


def test_run_all_blocks_matches_jax_and_reports_each_block(blocked_dataset, capsys):
    tmp, stem, blockfile, out_jax = blocked_dataset
    out, covered = _run(tmp, stem, blockfile, "p1", 1, verbose=True)
    n_blocks = sum(1 for _ in open(blockfile))
    assert n_blocks >= 3 and len(covered) == n_blocks
    assert_block_dirs_match(dir_bytes(out), dir_bytes(out_jax))
    printed = capsys.readouterr().out
    for block in covered:  # one closing line per block, skipped or not
        assert printed.count(f"[run_all_blocks] [{block}] retained ") == 1
    assert f"processed {n_blocks} blocks" in printed and "device memory 0.000 GiB now" in printed


@pytest.mark.parametrize("num_partitions", [2, 3])
def test_multi_partition_run_matches_single_partition(blocked_dataset, num_partitions):
    """The blocks spread over 2 and 3 partitions are each run once and merge
    to the bytes of the one-partition run (the reference's
    distribute-then-merge workflow, `merge_blocks.py:361-395`)."""
    tmp, stem, blockfile, _ = blocked_dataset
    merged = {}
    for tag, parts in (("one", 1), ("many", num_partitions)):
        out, covered = _run(tmp, stem, blockfile, f"{tag}_{num_partitions}", parts)
        assert sorted(covered) == sorted(set(covered))
        assert len(covered) == sum(1 for _ in open(blockfile))
        mstem = str(out / "merged_blocks")
        merge_block_outputs(blockfile, str(out)).write_mm(mstem)
        merged[tag] = {s: open(mstem + s, "rb").read() for s in MERGED}
    assert merged["many"] == merged["one"]


def test_merge_and_sepselect_files_match_jax(blocked_dataset):
    """One block directory through both packages' merge, sepselect and
    v-structure orientation: the same bytes in every file they write."""
    from cigwas_tpu import merge as jm
    from cigwas_tpu_torch import merge as tm

    tmp, _, blockfile, out_jax = blocked_dataset
    files = {}
    for name, pkg in (("jax", jm), ("torch", tm)):
        d = tmp / f"merged_{name}"
        d.mkdir()
        gm = pkg.merge_block_outputs(blockfile, str(out_jax))
        gm.write_mm(str(d / "merged_blocks"))
        pkg.sepselect_merged(str(d / "merged_blocks"), ALPHA, N).to_file(
            str(d / "max_sep_min_pc"))
        pkg.orient_v_structures_merged(str(d / "merged_blocks"), ALPHA, N).to_file(
            str(d / "oriented"))
        files[name] = dir_bytes(d)
    assert files["torch"] == files["jax"]
    assert {"merged_blocks" + s for s in MERGED} <= set(files["torch"])
    assert any(f.startswith("max_sep_min_pc") for f in files["torch"])
    # the planted structure is in the merged skeleton
    gm = tm.merge_block_outputs(blockfile, str(out_jax))
    mk = {row: ix for ix, row in gm.gmi.items()}
    adjacent = lambda a, b: (a, b) in gm.sam or (b, a) in gm.sam  # noqa: E731
    assert adjacent(1, 2) and adjacent(mk[5], 1) and adjacent(mk[20], 2)
    assert tm.block_stems_from_blockfile(blockfile) == jm.merge_blocks.block_stems_from_blockfile(
        blockfile)


def test_reformat_cuskss_merged_output_matches_jax(tmp_path):
    """The summary-statistic step after `cuskss --marker-indices`: the
    fixture run's `cuskss_merged` files plus a `merged_blocks.ixs` give the
    same MatrixMarket files in both packages."""
    from cigwas_tpu.merge import reformat_cuskss_merged_output as jax_reformat
    from cigwas_tpu_torch.merge import reformat_cuskss_merged_output
    from cigwas_tpu_torch.pipelines import CuskssArgs, cuskss

    data = os.path.join(os.path.dirname(__file__), "data", "test_files")
    cuskss(CuskssArgs.from_paths(
        mxm=os.path.join(data, "small_mxm.bin"),
        mxp=os.path.join(data, "marker_trait_summary_stats.txt"),
        pxp=os.path.join(data, "trait_summary_stats.txt"),
        marker_indices=os.path.join(data, "marker_indices.bin"),
        alpha=1e-4, num_samples=500000, max_level_one=3, max_level_two=1, max_depth=1,
        outdir=str(tmp_path)), verbose=False, device="cpu")
    n_ix = np.fromfile(os.path.join(data, "marker_indices.bin"), dtype=np.int32).size
    (np.arange(n_ix, dtype=np.int32) * 3 + 7).tofile(str(tmp_path / "merged_blocks.ixs"))
    out = {}
    for name, fn in (("jax", jax_reformat), ("torch", reformat_cuskss_merged_output)):
        d = tmp_path / name
        d.mkdir()
        fn(cusk_dir=str(tmp_path)).write_mm(str(d / "cuskss_merged"))
        out[name] = dir_bytes(d)
    assert out["torch"] == out["jax"] and len(out["jax"]) == 4
