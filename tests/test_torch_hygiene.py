"""Import rules of the port: no jax and nothing of the JAX package, no nvcc
at import, no CPU fallback for the card."""

import subprocess
import sys
import textwrap

import pytest
import torch

from torch_parity import set_threads

set_threads()

_TINY_BLOCK = textwrap.dedent(
    """
    import os, sys, tempfile
    import numpy as np
    from cigwas_tpu_torch.constants import BED_PREFIX_COL_MAJ
    from cigwas_tpu_torch.io import MarkerBlock, write_marker_blocks_to_file
    from cigwas_tpu_torch.io.bed import encode_bed_values
    from cigwas_tpu_torch.pipelines import cusk
    from cigwas_tpu_torch.prep import prep_bed
    rng = np.random.default_rng(0)
    m, n = 12, 400
    G = (rng.random((m, n)) < 0.3).astype(np.float32) + (rng.random((m, n)) < 0.3)
    y = 0.5 * (G[3] - G[3].mean()) + rng.normal(size=n)
    y = (y - y.mean()) / y.std()
    d = tempfile.mkdtemp()
    stem = os.path.join(d, "t")
    with open(stem + ".bed", "wb") as f:
        f.write(BED_PREFIX_COL_MAJ + encode_bed_values(G).tobytes())
    with open(stem + ".bim", "w") as f:
        f.writelines(f"1\\trs{i}\\t0\\t{i}\\tA\\tG\\n" for i in range(m))
    with open(stem + ".fam", "w") as f:
        f.writelines(f"F{i} I{i} 0 0 0 -9\\n" for i in range(n))
    with open(stem + ".phen", "w") as f:
        f.write("FID\\tIID\\tT0\\n")
        f.writelines(f"F{i}\\tI{i}\\t{y[i]:.6f}\\n" for i in range(n))
    prep_bed(stem)
    write_marker_blocks_to_file([MarkerBlock("1", 0, m - 1)], stem + ".blocks")
    res = cusk(stem + ".phen", stem, stem + ".blocks", 1e-3, 3, 14, 1, d, 0,
                  verbose=False, device="cpu")
    assert res is not None and res.num_markers() >= 1
    """
)

# neither jax nor any module of the JAX package may have been imported
_NO_JAX = textwrap.dedent(
    """
    bad = sorted(k for k in sys.modules
                 if k == "jax" or k.startswith("jax.")
                 or k == "cigwas_tpu" or k.startswith("cigwas_tpu."))
    assert not bad, bad
    print("OK")
    """
)

_TINY_CUSKSS = textwrap.dedent(
    """
    import os, sys, tempfile
    from cigwas_tpu_torch.pipelines import CuskssArgs, cuskss
    data = sys.argv[1]
    d = tempfile.mkdtemp()
    args = CuskssArgs.from_paths(
        mxm=os.path.join(data, "small_mxm.bin"),
        mxp=os.path.join(data, "marker_trait_summary_stats.txt"),
        pxp=os.path.join(data, "trait_summary_stats.txt"),
        marker_indices=os.path.join(data, "marker_indices.bin"),
        alpha=1e-4, num_samples=500000, max_level_one=3, max_level_two=1,
        max_depth=1, outdir=d,
    )
    res = cuskss(args, verbose=False, device="cpu")
    assert res.num_markers() >= 1 and os.path.getsize(os.path.join(d, "cuskss_merged.adj")) > 0
    """
)


def test_port_never_imports_jax():
    """A fresh interpreter runs a tiny block through the port's cusk on the
    CPU and ends with neither jax nor any `cigwas_tpu` module imported."""
    proc = subprocess.run(
        [sys.executable, "-c", _TINY_BLOCK + _NO_JAX], capture_output=True, text=True,
        timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("OK")


def test_port_cuskss_never_imports_jax():
    """The same for a tiny summary-statistic run through the port's cuskss."""
    import os

    data = os.path.join(os.path.dirname(__file__), "data", "test_files")
    proc = subprocess.run(
        [sys.executable, "-c", _TINY_CUSKSS + _NO_JAX, data], capture_output=True,
        text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("OK")


_IMPORT_ALL = textwrap.dedent(
    """
    import importlib, pkgutil, sys
    import cigwas_tpu_torch
    names = sorted(m.name for m in pkgutil.walk_packages(cigwas_tpu_torch.__path__,
                                                         "cigwas_tpu_torch."))
    for name in names:
        importlib.import_module(name)
    for new in ("blocking", "cli", "merge.merge_blocks", "merge.sepselect",
                "parallel.block_scheduler", "parallel.runner", "utils.timing",
                "merge.mr_assumptions", "pag.rfci", "pag.davs", "pag.simulations",
                "mr.mvivw", "mr.cause", "mr.competitors", "io.tables", "phen_prep", "sim",
                "analysis", "vis", "skeleton.second_stage", "parallel.mesh",
                "parallel.sharded", "parallel.distributed", "parallel.spmd",
                "ops.kernels.dense_l1"):
        assert "cigwas_tpu_torch." + new in names, new
    from cigwas_tpu_torch.cli import build_parser
    build_parser().parse_args(["sepselect", "stem", "1e-4", "10"])
    bad = sorted(k for k in sys.modules
                 if k.split(".")[0] in ("jax", "jaxlib", "cigwas_tpu", "pandas", "triton",
                                        "matplotlib"))
    assert not bad, bad
    from cigwas_tpu_torch.ops.kernels import build
    assert build._loaded == {}
    print("OK", len(names))
    """
)


def test_every_module_imports_without_jax_pandas_or_a_build():
    """A fresh interpreter imports every module of the port (the CLI, the
    blocking, merge and parallel packages among them) and builds its
    parser: neither jax, nor the JAX package, nor pandas, nor matplotlib,
    nor triton is imported, and no kernel is built."""
    proc = subprocess.run([sys.executable, "-c", _IMPORT_ALL], capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().startswith("OK")


_HOST_CHAIN = textwrap.dedent(
    """
    import os, sys, tempfile
    sys.path.insert(0, sys.argv[1])
    from torch_parity import merged_fileset
    from cigwas_tpu_torch.cli import main
    d = tempfile.mkdtemp()
    merged, pag = os.path.join(d, "merged_blocks"), os.path.join(d, "max_sep_min_pc")
    merged_fileset(merged, 0, n=2000)
    main(["orient-v-structs", merged, "1e-3", "2000"])
    main(["srfci", pag, "1e-3", "2000"])
    main(["mvivw", merged, "2000"])
    main(["mvivw", merged, "2000", "-s"])
    for f in (pag + "_estimated_pag.mtx", merged + "_iv_candidates.csv",
              merged + "_mvivw_results.tsv"):
        assert os.path.getsize(f) > 0, f
    bad = sorted(k for k in sys.modules if k.split(".")[0] in ("jax", "cigwas_tpu", "pandas"))
    assert not bad, bad
    print("OK")
    """
)


def test_port_srfci_and_mvivw_never_import_jax_or_pandas():
    """A fresh interpreter runs orient-v-structs, srfci, mvivw and mvivw -s
    through the port's CLI over a merged skeleton and ends with none of jax,
    the JAX package or pandas imported."""
    import os

    proc = subprocess.run(
        [sys.executable, "-c", _HOST_CHAIN, os.path.dirname(__file__)], capture_output=True,
        text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("OK")


_API_DRIVE = textwrap.dedent(
    """
    import os, sys, tempfile
    import numpy as np
    from cigwas_tpu_torch import analysis, sim
    from cigwas_tpu_torch.merge import merge_block_outputs
    from cigwas_tpu_torch.phen_prep import PhenotypesFile, make_merged_pheno_file
    from cigwas_tpu_torch.pipelines import cusk
    from cigwas_tpu_torch.prep import prep_bed
    from cigwas_tpu_torch.io import MarkerBlock, write_marker_blocks_to_file
    from cigwas_tpu_torch.skeleton import skeleton
    from cigwas_tpu_torch.skeleton.second_stage import cusk_second_stage
    from cigwas_tpu_torch.utils.stats import threshold_array
    d = tempfile.mkdtemp()
    stem = sim.simulate_genotype_dataset(d, num_samples=600, num_markers=40, seed=2)
    with open(stem + ".phen") as f:
        rows = [ln.split("\\t") for ln in f.read().splitlines()]
    with open(os.path.join(d, "a.txt"), "w") as f:
        f.writelines(" ".join(r[:4]) + "\\n" for r in rows)
    make_merged_pheno_file([PhenotypesFile(os.path.join(d, "a.txt"), ["T0", "T1"])],
                           stem + ".fam", stem + "_merged.phen")
    prep_bed(stem)
    write_marker_blocks_to_file([MarkerBlock("1", 0, 39)], stem + ".blocks")
    out = os.path.join(d, "out")
    os.makedirs(out)
    cusk(stem + "_merged.phen", stem, stem + ".blocks", 1e-3, 3, 14, 1, out, 0,
         verbose=False, device="cpu")
    analysis.global_epm(stem + ".blocks", out)
    analysis.global_ancestor_sets(stem + ".blocks", out, depth=2)
    gm = merge_block_outputs(stem + ".blocks", out)
    gm.write_mm(os.path.join(d, "merged"))
    m = os.path.join(d, "merged")
    rows = analysis.marker_pheno_associations(stem + ".bim", m + "_scm.mtx", m + "_sam.mtx",
                                              m + ".ixs", num_phen=2)
    assert rows, "no trait-adjacent marker"
    dag = sim.gen_rand_dag(2000, 30, 3, 1, 3, 0.2, 0.1, 0.3, 0.1, 0.4, seed=1)
    C = np.corrcoef(dag.observed(), rowvar=False).astype(np.float32)
    th = threshold_array(2000, 1e-3)
    res = skeleton(C, th, 14, device="cpu")
    assert res.pmax is not None
    cusk_second_stage(C, res.G, th)
    bad = sorted(k for k in sys.modules
                 if k.split(".")[0] in ("jax", "cigwas_tpu", "pandas", "matplotlib"))
    assert not bad, bad
    print("OK")
    """
)


def test_port_api_modules_never_import_jax_pandas_or_matplotlib():
    """A fresh interpreter simulates a fileset, merges its phenotypes,
    runs a block, the analysis tables, a skeleton with pMax and the
    second stage through the port: none of jax, the JAX package, pandas or
    matplotlib is imported (only the plot helpers import matplotlib)."""
    proc = subprocess.run([sys.executable, "-c", _API_DRIVE], capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("OK")


_MESH_DRIVE = textwrap.dedent(
    """
    import cigwas_tpu_torch.parallel as par
    import torch.distributed as dist
    assert not dist.is_initialized()
    assert par.process_partition() == (1, 0)
    """
) + _TINY_BLOCK.replace('verbose=False, device="cpu")',
                        'verbose=False, mesh=["cpu"] * 3, panel_mode="rowsharded")') + _NO_JAX


def test_parallel_imports_without_a_process_group_or_jax():
    """A fresh interpreter imports `cigwas_tpu_torch.parallel` without any
    process group (its partition is then (1, 0)) and runs a tiny block over a
    3-entry CPU mesh with the row-sharded engine: neither jax nor the JAX
    package is imported."""
    proc = subprocess.run([sys.executable, "-c", _MESH_DRIVE], capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("OK")


def test_port_sources_name_no_jax_import():
    """No source line of the port or of chip_smoke.py imports jax or the JAX
    package (the grep of the port's rules, over every file)."""
    import pathlib
    import re

    root = pathlib.Path(__file__).resolve().parents[1]
    files = sorted((root / "cigwas_tpu_torch").rglob("*.py")) + [root / "chip_smoke.py"]
    assert len(files) > 40
    pat = re.compile(r"^\s*(import|from) (jax|cigwas_tpu|pandas)\b", re.MULTILINE)
    bad = [str(f) for f in files if pat.search(f.read_text())]
    assert not bad, bad


def test_kernel_modules_import_without_building():
    """Importing the kernel wrapper compiles nothing (this machine may have
    no nvcc); the build happens at the first launch on a card."""
    proc = subprocess.run(
        [sys.executable, "-c",
         "import cigwas_tpu_torch.ops.kernels.local_sweep as ls, "
         "cigwas_tpu_torch.ops.kernels.hetcor_sweep as hs, "
         "cigwas_tpu_torch.ops.kernels.panel_gather as pg, "
         "cigwas_tpu_torch.ops.kernels.kendall_panel as kp, "
         "cigwas_tpu_torch.ops.kernels.build as b; "
         "assert b._loaded == {} and ls.launches == {1: 0, 2: 0, 3: 0}; "
         "assert hs.launches == {1: 0, 2: 0, 3: 0, 'hetcor_scan': 0}; "
         "assert kp.launches == {'kendall_int8_panel': 0}; "
         "assert pg.launches == {'panel_gather': 0, 'panel_gather2': 0}; print('OK')"],
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr


def test_require_cuda_has_no_cpu_fallback():
    from cigwas_tpu_torch import require_cuda

    if torch.cuda.is_available():
        assert require_cuda().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            require_cuda()


def test_cpu_path_counts_no_launches():
    """The wrapper takes the plain version for CPU tensors and counts no
    kernel launch."""
    import numpy as np

    from cigwas_tpu_torch.ops.kernels import local_sweep as ls

    ls.reset_launches()
    C = torch.eye(16)
    nbrs = torch.arange(1, 9, dtype=torch.int32)[None, :]
    rho, pos = ls.local_sweep(C, torch.zeros(1, dtype=torch.int32), nbrs,
                              torch.tensor([8], dtype=torch.int32), 2)
    assert ls.launches == {1: 0, 2: 0, 3: 0}
    assert rho.shape == (1, 8) and pos.shape == (1, 8, 2)
    assert np.all(np.isfinite(rho.numpy()))


@pytest.mark.parametrize("as_tensor", [False, True], ids=["numpy", "tensor"])
@pytest.mark.parametrize(
    "fault", [None, "nbrs_high", "nbrs_negative", "node_high", "deg_high", "deg_negative"])
def test_check_index_range(as_tensor, fault):
    """The range check every launch's lists pass, on host arrays (the
    skeleton, before upload) or on tensors (the wrappers, otherwise)."""
    import numpy as np

    from cigwas_tpu_torch.ops.kernels.checks import check_index_range

    vp, d = 32, 8
    node_ixs = np.array([3, 31], np.int32)
    nbrs = np.tile(np.arange(d, dtype=np.int32), (2, 1))
    deg = np.array([0, d], np.int32)
    if fault == "nbrs_high":
        nbrs[1, 7] = vp
    elif fault == "nbrs_negative":
        nbrs[0, 0] = -1
    elif fault == "node_high":
        node_ixs[0] = vp
    elif fault == "deg_high":
        deg[1] = d + 1
    elif fault == "deg_negative":
        deg[0] = -1
    lists = [torch.from_numpy(a) if as_tensor else a for a in (node_ixs, nbrs, deg)]
    if fault is None:
        check_index_range("test", vp, d, *lists)
        check_index_range("test", vp, 0, lists[0], lists[1][:, :0], lists[2])  # empty
    else:
        with pytest.raises(ValueError, match="index out of range"):
            check_index_range("test", vp, d, *lists)


def test_build_key_covers_included_headers(tmp_path, monkeypatch):
    """An edited header under csrc changes the library's key, as an edited
    source does, so a stale library is never loaded; a source that includes
    nothing keeps a key of its own."""
    import shutil

    from cigwas_tpu_torch.ops.kernels import build

    for name in ("local_sweep", "hetcor_sweep"):
        assert [p.name for p in build.source_files(name)] == [f"{name}.cu", "sweep_common.cuh"]
    assert [p.name for p in build.source_files("panel_gather")] == ["panel_gather.cu"]

    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    monkeypatch.setattr(build, "CSRC", csrc)
    before = {n: build.library_path(n).name
              for n in ("local_sweep", "hetcor_sweep", "panel_gather")}
    with open(csrc / "sweep_common.cuh", "a") as f:
        f.write("// edited\n")
    after = {n: build.library_path(n).name for n in before}
    assert after["local_sweep"] != before["local_sweep"]
    assert after["hetcor_sweep"] != before["hetcor_sweep"]
    assert after["panel_gather"] == before["panel_gather"]
    with open(csrc / "panel_gather.cu", "a") as f:
        f.write("// edited\n")
    assert build.library_path("panel_gather").name != before["panel_gather"]
