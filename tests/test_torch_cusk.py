"""The port's `cusk` pipeline against the JAX package's, on the CPU.

Block outputs: `.adj/.ixs/.mdim/.sep` byte-identical (the decisions and the
index maps); `.corr` within atol 1e-6 (the panel's float32 values, see
tests/test_torch_corr.py for why they are not bit-equal).
"""

import os

import numpy as np
import pytest

from torch_parity import set_threads

from cigwas_tpu.constants import BED_PREFIX_COL_MAJ
from cigwas_tpu.io.bed import encode_bed_values

set_threads()


def _write_plink(stem: str, G: np.ndarray, Y: np.ndarray) -> None:
    m, n = G.shape
    with open(stem + ".bed", "wb") as f:
        f.write(BED_PREFIX_COL_MAJ)
        f.write(encode_bed_values(G).tobytes())
    with open(stem + ".bim", "w") as f:
        for i in range(m):
            f.write(f"1\trs{i}\t0\t{1000 * i}\tA\tG\n")
    with open(stem + ".fam", "w") as f:
        for i in range(n):
            f.write(f"F{i} I{i} 0 0 0 -9\n")
    with open(stem + ".phen", "w") as f:
        f.write("FID\tIID\t" + "\t".join(f"T{t}" for t in range(len(Y))) + "\n")
        for i in range(n):
            f.write(f"F{i}\tI{i}\t" + "\t".join(f"{v:.6f}" for v in Y[:, i]) + "\n")


def _std(v):
    return (v - v.mean()) / v.std()


def _genotypes(rng, m, n):
    maf = rng.uniform(0.1, 0.5, m)
    return (rng.random((m, n)) < maf[:, None]).astype(np.float32) + (
        rng.random((m, n)) < maf[:, None]
    )


def _prep_blocks(stem: str) -> str:
    """prep-bed and blocks of at most 64 markers, both by the port."""
    from cigwas_tpu_torch.pipelines import make_blocks
    from cigwas_tpu_torch.prep import prep_bed

    prep_bed(stem)
    make_blocks(stem, 64, 16, verbose=False, device="cpu")
    return stem + "_m64.blocks"


@pytest.fixture(scope="module")
def e2e_dataset(tmp_path_factory):
    """The dataset of tests/test_pipeline_e2e.py (seed 42, n=4000, m=120)."""
    tmp = tmp_path_factory.mktemp("torch_e2e")
    rng = np.random.default_rng(42)
    n, m = 4000, 120
    G = _genotypes(rng, m, n)
    y0 = sum(0.35 * _std(G[i]) for i in (10, 20, 30, 40)) + rng.normal(size=n)
    y1 = sum(0.35 * _std(G[i]) for i in (50, 60, 70)) + 0.5 * y0 + rng.normal(size=n)
    y2 = rng.normal(size=n)
    Y = np.stack([y0, y1, y2])
    Y = (Y - Y.mean(1, keepdims=True)) / Y.std(1, keepdims=True)
    stem = str(tmp / "sim")
    _write_plink(stem, G, Y)
    return tmp, stem, _prep_blocks(stem)


def test_block_file_matches_jax(e2e_dataset):
    """The port's `.blocks` file, which the drives below run on, is the JAX
    `make_blocks`' byte for byte."""
    from cigwas_tpu.pipelines import make_blocks as jax_make_blocks

    tmp, stem, blockfile = e2e_dataset
    jax_blocks = str(tmp / "jax.blocks")
    jax_make_blocks(stem, 64, 16, out_path=jax_blocks, verbose=False)
    assert open(blockfile, "rb").read() == open(jax_blocks, "rb").read()


def test_cusk_block_outputs_match_jax(e2e_dataset):
    from cigwas_tpu.pipelines import cusk as jax_cusk
    from cigwas_tpu_torch.pipelines import cusk

    tmp, stem, blockfile = e2e_dataset
    n_blocks = sum(1 for _ in open(blockfile))
    assert n_blocks >= 2
    written = 0
    for bi in range(n_blocks):
        outs = {}
        for name, fn, kw in (("jax", jax_cusk, {}), ("torch", cusk, {"device": "cpu"})):
            out = tmp / f"out_{name}_{bi}"
            out.mkdir()
            fn(stem + ".phen", stem, blockfile, 1e-3, 3, 14, 1, str(out), bi,
               verbose=False, **kw)
            outs[name] = {f: (out / f).read_bytes() for f in sorted(os.listdir(out))}
        assert outs["torch"].keys() == outs["jax"].keys()
        for f, data in outs["jax"].items():
            got = outs["torch"][f]
            if f.endswith(".corr"):
                np.testing.assert_allclose(
                    np.frombuffer(got, np.float32), np.frombuffer(data, np.float32),
                    rtol=0, atol=1e-6,
                )
            else:
                assert got == data, f"block {bi}: {f} differs"
        written += len(outs["jax"]) > 0
    assert written >= 1


def test_cusk_recovers_planted_structure(tmp_path):
    """The drive of the verify skill (seed 42, n=4000, m=120, effects
    0.4/0.5, alpha 1e-3) through the port: SNP10->T1, SNP50->T2 and T1-T2
    come back."""
    from cigwas_tpu_torch.merge import merge_block_outputs
    from cigwas_tpu_torch.pipelines import cusk

    rng = np.random.default_rng(42)
    n, m = 4000, 120
    G = _genotypes(rng, m, n)
    t1 = 0.4 * _std(G[10]) + rng.normal(size=n)
    t2 = 0.4 * _std(G[50]) + 0.5 * _std(t1) + rng.normal(size=n)
    Y = np.stack([_std(t1), _std(t2)])
    stem = str(tmp_path / "sim")
    _write_plink(stem, G, Y)
    blockfile = _prep_blocks(stem)
    out = tmp_path / "out"
    out.mkdir()
    for bi in range(sum(1 for _ in open(blockfile))):
        cusk(stem + ".phen", stem, blockfile, 1e-3, 3, 14, 1, str(out), bi,
             verbose=False, device="cpu")
    gm = merge_block_outputs(blockfile, str(out) + "/")
    mk = {row: ix for ix, row in gm.gmi.items()}

    def adjacent(a, b):
        return (a, b) in gm.sam or (b, a) in gm.sam

    assert adjacent(1, 2)  # T1 - T2
    assert adjacent(mk[10], 1) and adjacent(mk[50], 2)
