"""The port's shell entry points (`cigwas_tpu_torch.cli`) against the JAX
package's CLI: the same argument vectors parse to the same values, what
cannot run is refused with its message, the drive from prep-bed to mvivw
runs through the port on the CPU and writes the JAX CLI's files, and so do
`cusk`, `cuskss` and `cusk-all` with `--mesh`.
"""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch
from scipy.io import mmread

from torch_parity import assert_block_dirs_match, dir_bytes, planted_dataset, set_threads

from cigwas_tpu.cli import build_parser as jax_parser
from cigwas_tpu_torch.cli import build_parser, main

set_threads()

VECTORS = {
    "prep-bed": ["prep-bed", "data/sim"],
    "block": ["block", "data/sim", "11000", "10", "2000"],
    "cusk": ["cusk", "3", "sim.blocks", "data/sim", "sim.phen", "1e-4", "3", "14", "1", "out"],
    "cuskss": ["cuskss", "--mxm", "a.bin", "--mxp", "b.txt", "--pxp", "c.txt", "--mxp-se",
               "d.txt", "--pxp-se", "e.txt", "--block-index", "2", "--blockfile", "f.blocks",
               "--alpha", "0.001", "--max-level-one", "2", "--max-level-two", "5",
               "--max-depth", "2", "--time-index", "t.txt", "--num-samples", "400000",
               "--outdir", "o", "--ess-mode", "float"],
    "cuskss-defaults": ["cuskss", "--pxp", "c.txt", "--marker-indices", "ix.bin", "--alpha",
                        "1e-4", "--num-samples", "5"],
    "cusk-all": ["cusk-all", "sim.blocks", "data/sim", "sim.phen", "1e-4", "3", "14", "1", "out",
                 "--num-partitions", "4", "--partition-index", "1"],
    "merge-block-outputs": ["merge-block-outputs", "out", "sim.blocks"],
    "sepselect": ["sepselect", "out/merged_blocks", "1e-4", "16384"],
    "orient-v-structs": ["orient-v-structs", "out/merged_blocks", "1e-4", "16384",
                         "--orientation-prior", "prior.txt"],
    "srfci": ["srfci", "out/max_sep_min_pc", "1e-4", "16384"],
    "mvivw": ["mvivw", "out/merged_blocks", "16384", "-s", "--orientation-prior", "p.txt"],
    "cusk-mesh": ["cusk", "0", "b", "s", "p", "1e-4", "3", "14", "1", "o", "--mesh", "4",
                  "--panel-mode", "rowsharded"],
}
BAD_VECTORS = {
    "block-size": ["block", "s", "1", "10", "2000"],
    "alpha": ["cusk", "0", "b", "s", "p", "1.5", "3", "14", "1", "o"],
    "max-level": ["cusk-all", "b", "s", "p", "1e-4", "15", "14", "1", "o"],
    "num-samples": ["sepselect", "m", "1e-4", "0"],
    "missing-pxp": ["cuskss", "--alpha", "1e-4", "--num-samples", "5"],
    "ess-mode": ["cuskss", "--pxp", "c", "--alpha", "1e-4", "--num-samples", "5", "--ess-mode", "x"],
    "panel-mode": ["cusk", "0", "b", "s", "p", "1e-4", "3", "14", "1", "o", "--mesh", "2",
                   "--panel-mode", "stripes"],
    "cusk-all-panel-mode": ["cusk-all", "b", "s", "p", "1e-4", "3", "14", "1", "o",
                            "--panel-mode", "x"],
    "no-subcommand": [],
}


def _values(ns) -> dict:
    return {k: v for k, v in vars(ns).items() if k not in ("func", "device")}


@pytest.mark.parametrize("name", sorted(VECTORS))
def test_parsers_accept_the_same_vectors(name):
    """Same positionals, bounds and defaults; the port adds only `--device`
    (default cuda) on the subcommands that touch the device."""
    got, exp = build_parser().parse_args(VECTORS[name]), jax_parser().parse_args(VECTORS[name])
    assert _values(got) == _values(exp)
    assert got.func.__name__ == exp.func.__name__
    on_device = VECTORS[name][0] in ("block", "cusk", "cuskss", "cusk-all")
    assert getattr(got, "device", None) == ("cuda" if on_device else None)
    if on_device:
        assert build_parser().parse_args(VECTORS[name] + ["--device", "cpu"]).device == "cpu"


@pytest.mark.parametrize("name", sorted(BAD_VECTORS))
def test_parsers_refuse_the_same_vectors(name, capsys):
    for parser in (build_parser(), jax_parser()):
        with pytest.raises(SystemExit) as exc:
            parser.parse_args(BAD_VECTORS[name])
        assert exc.value.code == 2
    assert build_parser().prog == "ci-gwas-torch"
    capsys.readouterr()


PXP = ["--pxp", "c.txt", "--alpha", "1e-4", "--num-samples", "5", "--device", "cpu"]
CUSK = ["0", "b", "s", "p", "1e-4", "3", "14", "1", "o", "--device", "cpu"]
# more cards than any machine of these tests has: a mesh never shrinks
CARDS = ["--device", "cuda", "--mesh", "64"]
REFUSED = {
    "cusk-mesh": (["cusk", *CUSK, "--mesh", "0"], "--mesh 0 (every card) needs --device cuda"),
    "cusk-all-mesh": (["cusk-all", *CUSK[1:], "--mesh", "0"],
                      "--mesh 0 (every card) needs --device cuda"),
    "cuskss-mesh": (["cuskss", *PXP, "--marker-indices", "i", "--mesh", "0"],
                    "--mesh 0 (every card) needs --device cuda"),
    "cusk-rowsharded": (["cusk", *CUSK, *CARDS, "--panel-mode", "rowsharded"], "--mesh 64: "),
    "cusk-all-rowsharded": (["cusk-all", *CUSK[1:], *CARDS, "--panel-mode", "rowsharded"],
                            "--mesh 64: "),
    "cuskss-cards": (["cuskss", *PXP, "--marker-indices", "i", *CARDS], "--mesh 64: "),
    "cusk-all-partition-cards": (["cusk-all", *CUSK[1:], *CARDS, "--num-partitions", "2",
                                  "--partition-index", "1"], "--mesh 64: "),
    "cuskss-no-markers": (["cuskss", *PXP], "Either blockfile + block index or marker indices"),
    "cuskss-one-se": (["cuskss", *PXP, "--marker-indices", "i", "--mxp-se", "se.txt"],
                      "Please provide no or both pxp and mxp standard error files."),
    "cuskss-one-corr": (["cuskss", *PXP, "--marker-indices", "i", "--mxm", "mxm.bin"],
                        "Please provide no or both mxp and mxm correlation files."),
}


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_refusals_exit_with_their_message(name):
    """A mesh that cannot be had (every card on the CPU; more cards than are
    visible, which never shrinks to fewer), and the three `cuskss` argument
    errors: a non-zero exit with the message, before any file is touched."""
    argv, message = REFUSED[name]
    with pytest.raises(SystemExit) as exc:
        main(argv)
    assert isinstance(exc.value.code, str) and message in exc.value.code


def host_chain(cli_main, out, keep) -> None:
    """sepselect, orient-v-structs, srfci, mvivw and mvivw -s over a merged
    skeleton through a CLI's main; the plain mvivw table, which `-s`
    overwrites, is copied to keep first."""
    merged, pag = str(out / "merged_blocks"), str(out / "max_sep_min_pc")
    cli_main(["sepselect", merged, "1e-3", "4000"])
    cli_main(["orient-v-structs", merged, "1e-3", "4000"])
    cli_main(["srfci", pag, "1e-3", "4000"])
    cli_main(["mvivw", merged, "4000"])
    shutil.copy(merged + "_mvivw_results.tsv", keep)
    cli_main(["mvivw", merged, "4000", "-s"])


@pytest.fixture(scope="module")
def drive(tmp_path_factory):
    """The verify drive (seed 42, n = 4000, m = 120, SNP10 -> T1, SNP50 -> T2,
    T1 -> T2, alpha 1e-3) through the port's commands on the CPU, from
    prep-bed to mvivw -s."""
    tmp = tmp_path_factory.mktemp("torch_cli")
    stem = str(tmp / "sim")
    planted_dataset(stem, 42, 4000, [120], {0: [(10, 0.4)], 1: [(50, 0.4)]}, {1: [(0, 0.5)]})
    out = tmp / "out"
    out.mkdir()
    blockfile = stem + "_m64.blocks"
    main(["prep-bed", stem])
    main(["block", stem, "64", "10", "16", "--device", "cpu"])
    main(["cusk-all", blockfile, stem, stem + ".phen", "1e-3", "3", "14", "1", str(out),
          "--device", "cpu"])
    main(["merge-block-outputs", str(out), blockfile])
    host_chain(main, out, tmp / "mvivw_plain.tsv")
    return tmp, stem, blockfile, out


def test_drive_recovers_the_planted_structure(drive):
    from cigwas_tpu_torch.merge import merge_block_outputs

    tmp, _, blockfile, out = drive
    files = dir_bytes(out)
    for name in ("merged_blocks_sam.mtx", "merged_blocks_scm.mtx", "merged_blocks.mdim",
                 "merged_blocks.ixs"):
        assert len(files[name]) > 0
    assert any(f.startswith("max_sep_min_pc") for f in files)
    # srfci: T1 - T2 kept, markers into traits; mvivw: both ordered pairs
    pag = mmread(str(out / "max_sep_min_pc_estimated_pag.mtx")).toarray()
    assert pag[0, 1] != 0 and pag[1, 0] != 0
    assert set(np.unique(pag[2:, :2])) == {0, 2} and set(np.unique(pag[:2, 2:])) == {0, 3}
    assert files["merged_blocks_iv_candidates.csv"].startswith(b"Exposure,Outcome,IV\n")
    for tsv in (files["merged_blocks_mvivw_results.tsv"],
                open(tmp / "mvivw_plain.tsv", "rb").read()):
        assert tsv.startswith(b"source\tsink\teffect\tp\tsk_adj\tnum_snps\n")
        assert tsv.count(b"\n") == 3 and b"\tTRUE\t" in tsv
    gm = merge_block_outputs(blockfile, str(out))
    mk = {row: ix for ix, row in gm.gmi.items()}
    adjacent = lambda a, b: (a, b) in gm.sam or (b, a) in gm.sam  # noqa: E731
    assert adjacent(1, 2)  # T1 - T2
    assert adjacent(mk[10], 1) and adjacent(mk[50], 2)
    assert not adjacent(mk[10], 2) and not adjacent(mk[50], 1)


def test_drive_files_match_the_jax_cli(drive):
    """The JAX package's CLI over the same fileset: the same `.blocks` bytes,
    block files (`.corr` within atol 1e-6), merged and sepselect files, and
    the srfci PAG, IV candidates and both mvivw tables byte-identical."""
    from cigwas_tpu.cli import main as jax_main

    tmp, stem, blockfile, out = drive
    jax_blocks = str(tmp / "jax.blocks")
    from cigwas_tpu.pipelines import make_blocks as jax_make_blocks

    jax_make_blocks(stem, 64, 16, out_path=jax_blocks, verbose=False)
    assert open(jax_blocks, "rb").read() == open(blockfile, "rb").read()
    out_jax = tmp / "out_jax"
    out_jax.mkdir()
    jax_main(["cusk-all", blockfile, stem, stem + ".phen", "1e-3", "3", "14", "1", str(out_jax)])
    jax_main(["merge-block-outputs", str(out_jax), blockfile])
    host_chain(jax_main, out_jax, tmp / "mvivw_plain_jax.tsv")
    got, exp = dir_bytes(out), dir_bytes(out_jax)
    for f in ("max_sep_min_pc_estimated_pag.mtx", "merged_blocks_iv_candidates.csv",
              "merged_blocks_mvivw_results.tsv"):
        assert f in exp and got[f] == exp[f], f
    assert (open(tmp / "mvivw_plain.tsv", "rb").read()
            == open(tmp / "mvivw_plain_jax.tsv", "rb").read())
    # the `_scm.mtx` files are text of the `.corr` values: compared as numbers
    scm = sorted(f for f in exp if f.endswith("_scm.mtx"))
    assert scm == ["max_sep_min_pc_scm.mtx", "merged_blocks_scm.mtx"]
    assert_block_dirs_match({f: b for f, b in got.items() if f not in scm},
                            {f: b for f, b in exp.items() if f not in scm})
    for f in scm:
        a, b = (np.loadtxt(str(d / f), skiprows=2) for d in (out, out_jax))
        assert np.array_equal(a[:, :2], b[:, :2])
        np.testing.assert_allclose(a[:, 2], b[:, 2], rtol=0, atol=1e-6)


def test_single_block_cusk_command_equals_cusk_all(drive, tmp_path):
    tmp, stem, blockfile, out = drive
    main(["cusk", "0", blockfile, stem, stem + ".phen", "1e-3", "3", "14", "1", str(tmp_path),
          "--device", "cpu"])
    one = dir_bytes(tmp_path)
    assert one and all(dir_bytes(out)[f] == data for f, data in one.items())


MESH_COMMANDS = {
    "cusk": ["cusk", "0", "{blocks}", "{stem}", "{stem}.phen", "1e-3", "3", "14", "1", "{out}"],
    "cusk-all": ["cusk-all", "{blocks}", "{stem}", "{stem}.phen", "1e-3", "3", "14", "1", "{out}"],
    "cuskss-rowsharded": ["cuskss", "--mxm", "{data}/small_mxm.bin",
                          "--mxp", "{data}/marker_trait_summary_stats.txt",
                          "--pxp", "{data}/trait_summary_stats.txt",
                          "--marker-indices", "{data}/marker_indices.bin", "--alpha", "1e-4",
                          "--num-samples", "500000", "--max-level-two", "1", "--outdir", "{out}",
                          "--panel-mode", "rowsharded"],
}


@pytest.mark.parametrize("name", sorted(MESH_COMMANDS))
def test_mesh_commands_match_the_jax_cli(drive, tmp_path, name):
    """`cusk`, `cusk-all` and `cuskss --panel-mode rowsharded` with `--mesh 4
    --device cpu` write the JAX CLI's files with `--mesh 4` (decision files
    byte-identical, `.corr` within atol 1e-6) and, for the first two, the
    port's one-device files byte for byte."""
    from cigwas_tpu.cli import main as jax_main

    _, stem, blockfile, out = drive
    data = os.path.join(os.path.dirname(__file__), "data", "test_files")
    got, exp = tmp_path / "port", tmp_path / "jax"
    for d, run, extra in ((got, main, ["--device", "cpu"]), (exp, jax_main, [])):
        d.mkdir()
        if name.startswith("cuskss"):
            n_ix = np.fromfile(os.path.join(data, "marker_indices.bin"), dtype=np.int32).size
            np.arange(n_ix, dtype=np.int32).tofile(str(d / "merged_blocks.ixs"))
        argv = [a.format(blocks=blockfile, stem=stem, out=d, data=data)
                for a in MESH_COMMANDS[name]]
        run(argv + ["--mesh", "4"] + extra)
    got_b, exp_b = dir_bytes(got), dir_bytes(exp)
    scm = [f for f in exp_b if f.endswith("_scm.mtx")]
    assert_block_dirs_match({f: b for f, b in got_b.items() if f not in scm},
                            {f: b for f, b in exp_b.items() if f not in scm})
    for f in scm:
        a, b = (np.loadtxt(str(d / f), skiprows=2) for d in (got, exp))
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
    if not name.startswith("cuskss"):
        one = {f: b for f, b in dir_bytes(out).items() if f in got_b}
        assert one and one == got_b


def test_orient_v_structs_command(drive):
    _, _, _, out = drive
    before = dir_bytes(out)
    main(["orient-v-structs", str(out / "merged_blocks"), "1e-3", "4000"])
    after = dir_bytes(out)
    assert after.keys() == before.keys()  # rewrites max_sep_min_pc's files


def test_cuskss_command_writes_the_reformatted_files(tmp_path):
    """`cuskss --marker-indices` through the CLI, then the
    `reformat_cuskss_merged_output` step it ends with."""
    data = os.path.join(os.path.dirname(__file__), "data", "test_files")
    n_ix = np.fromfile(os.path.join(data, "marker_indices.bin"), dtype=np.int32).size
    np.arange(n_ix, dtype=np.int32).tofile(str(tmp_path / "merged_blocks.ixs"))
    main(["cuskss", "--mxm", os.path.join(data, "small_mxm.bin"),
          "--mxp", os.path.join(data, "marker_trait_summary_stats.txt"),
          "--pxp", os.path.join(data, "trait_summary_stats.txt"),
          "--marker-indices", os.path.join(data, "marker_indices.bin"),
          "--alpha", "1e-4", "--num-samples", "500000", "--max-level-two", "1",
          "--outdir", str(tmp_path), "--device", "cpu"])
    files = dir_bytes(tmp_path)
    for name in ("cuskss_merged.adj", "cuskss_merged_sam.mtx", "cuskss_merged_scm.mtx"):
        assert len(files[name]) > 0


def test_commands_default_to_the_card(drive):
    """Without `--device cpu` and without a card, `block`, `cusk` and
    `cusk-all` fail with require_cuda's message; nothing runs on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    _, stem, blockfile, out = drive
    tail = [blockfile, stem, stem + ".phen", "1e-3", "3", "14", "1", str(out)]
    for argv in (["block", stem, "64", "10", "16"], ["cusk", "0", *tail], ["cusk-all", *tail]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(argv)


def test_module_runs_from_the_shell(drive):
    """`python3 -m cigwas_tpu_torch.cli`: help exits 0, and `block` without
    a card exits non-zero with require_cuda's message."""
    _, stem, _, _ = drive
    env = {**os.environ, "PYTHONPATH": os.path.dirname(os.path.dirname(__file__))}
    run = lambda *a: subprocess.run(  # noqa: E731
        [sys.executable, "-m", "cigwas_tpu_torch.cli", *a], capture_output=True, text=True,
        timeout=120, env=env)
    proc = run("--help")
    assert proc.returncode == 0 and "ci-gwas-torch" in proc.stdout and "cusk-all" in proc.stdout
    if not torch.cuda.is_available():
        proc = run("block", stem, "64", "10", "16")
        assert proc.returncode != 0 and "no CUDA device is available" in proc.stderr
