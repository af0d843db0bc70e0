"""The block panel over several sample chunks, and a whole ``cusk`` solve,
against the benchmark's chunked plain reference (``h100bench/reference/
panel_samples.py``, ``cusk_samples.py``), on the CPU.

At a biobank's sample size the reference sums float64 counts chunk by
chunk, where the port's panel counts every sample in one launch of the
Kendall panel kernel (its plain version here), on a canvas of 128- or
2,048-row multiples. Here both run at 300 markers x 3,901 individuals, the
reference in 1,024-sample chunks (four chunks, the last one partial).
Tolerances: the panel within
the parity contract's rtol 1e-5 / atol 1e-6 (float32 sums and Kendall
arithmetic against float64); the chunked reference within 1e-12 of the
whole-block reference (the same exact counts, float64 sums in another
order); the solve within the limits of the cell ``cusk.block11k_n500k``.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from torch_parity import RTOL, ATOL, genotypes, set_threads, write_plink

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from h100bench.harness import load_module  # noqa: E402
from h100bench.reference import compare, panel, panel_samples  # noqa: E402

set_threads()

BENCH = ROOT / "h100bench"
M, N, P = 300, 3901, 3
CHUNK = 1024


@pytest.fixture(scope="module")
def block(tmp_path_factory):
    """(stem, packed bytes, traits (p, n) as read back, means, stds): M
    markers with LD between neighbours and 2% missing calls, P traits, one
    associated with a marker, 1% missing values."""
    from cigwas_tpu_torch.io.bed import encode_bed_values

    rng = np.random.default_rng(16)
    G = genotypes(rng, M, N)
    for i in range(1, M):
        mask = rng.random(N) < 0.5
        G[i, mask] = G[i - 1, mask]
    G[rng.random((M, N)) < 0.02] = np.nan
    Y = rng.normal(size=(P, N))
    Y[0] += 0.3 * np.nan_to_num(G[M // 2] - 1.0)
    Y = (Y - Y.mean(1, keepdims=True)) / Y.std(1, keepdims=True)
    Y[rng.random((P, N)) < 0.01] = np.nan
    stem = str(tmp_path_factory.mktemp("ukb") / "sim")
    write_plink(stem, G, Y)
    valid = ~np.isnan(G)
    means = (np.nansum(G, 1) / valid.sum(1)).astype(np.float32)
    stds = np.sqrt(np.nansum((G - means[:, None]) ** 2, 1) / valid.sum(1)).astype(np.float32)
    return stem, encode_bed_values(G), panel.read_phen(stem + ".phen"), means, stds


@pytest.mark.parametrize("with_mp", [False, True], ids=["own-sums", "prescreen-corr"])
@pytest.mark.parametrize("row_tile", [128, 2048], ids=["canvas-384", "canvas-2048"])
def test_striped_panel_over_four_chunks_matches_the_chunked_reference(
        block, row_tile, with_mp):
    from cigwas_tpu_torch.ops import corr

    stem, bb, Y, means, stds = block
    mp = corr.marker_phen_corr(bb, Y, means, stds, N, sample_chunk=CHUNK,
                               device="cpu") if with_mp else None
    stats: dict = {}
    C, v = corr.corr_panel_device_tiled(bb, Y, means, stds, N, "cpu", mp_corr=mp,
                                        row_tile=row_tile, stats=stats)
    # one launch of the Kendall panel kernel over every sample, whatever the canvas
    assert v == M + P and C.shape == (-(-v // row_tile) * row_tile,) * 2
    assert stats["panel_sample_chunks"] == 1
    assert (stats["panel_decode_bytes"], stats["panel_kernel_launches"]) == (0, 1)
    ref = panel_samples.panel(stem + ".bed", M, N, Y, chunk=CHUNK).numpy()
    assert np.isfinite(ref).all()
    np.testing.assert_allclose(C[:v, :v].double().numpy(), ref, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("chunk", [CHUNK, 1000, 1 << 16], ids=["1024", "1000", "one-chunk"])
def test_the_chunked_reference_equals_the_whole_block_reference(block, chunk):
    stem = block[0]
    Y = block[2]
    whole = panel.panel(panel.read_bed(stem + ".bed", M, N, "cpu"), Y)
    chunked = panel_samples.panel(stem + ".bed", M, N, Y, chunk=chunk)
    assert torch.equal(torch.isnan(whole), torch.isnan(chunked))
    assert (whole - chunked).abs().max().item() <= 1e-12


def test_a_chunk_must_start_on_a_byte(block):
    with pytest.raises(ValueError):
        next(panel_samples.read_bed_chunks(block[0] + ".bed", M, N, "cpu", chunk=1022))


@pytest.fixture(scope="module")
def solved(tmp_path_factory):
    """One block of the cell's own generator and configuration, cut to 400
    markers x 3,001 individuals, solved by the entry's solve and reference
    (in 1,024-sample chunks) on the CPU."""
    entry = load_module(BENCH / "entries" / "cusk_samples.py", "test_entry_cusk_samples")
    generator = load_module(BENCH / "generators" / "ar1_block.py", "test_generator_ar1")
    work = json.loads((BENCH / "workloads" / "cusk.block11k_n500k.json").read_text())
    cfg = {**json.loads((BENCH / "configs" / f"{work['config']}.json").read_text()),
           "individuals": 3001}
    traffic = {**json.loads((BENCH / "traffic" / f"{work['traffic']}.json").read_text()),
               "markers": 400, "chunk": 128}
    tmp = tmp_path_factory.mktemp("ukb_solve")
    data = generator.generate(cfg, traffic, 2**31 + 16, str(tmp), "cpu")
    state = entry.setup(cfg, data, "cpu")
    (tmp / "out").mkdir()
    stats = entry.solve(state, str(tmp / "out"))
    out = compare.read_output(compare.output_base(str(tmp / "out")), entry.WITH_SEPSETS)
    prev = panel_samples.CHUNK
    panel_samples.CHUNK = CHUNK
    try:
        ref = entry.expected(state, "cpu")
        ctl = entry.expected(state, "cpu", torch.bfloat16)
    finally:
        panel_samples.CHUNK = prev
    return work["limits"], stats, out, ref, ctl


def test_a_cusk_solve_is_within_the_cells_limits(solved):
    limits, stats, out, ref, _ = solved
    numbers = compare.compare(out, ref)
    assert set(numbers) == set(limits)
    assert all(numbers[k] <= limits[k] for k in limits), numbers
    assert out["ixs"].size > P  # markers were kept
    assert stats["panel_markers"] == 400 and stats["panel_samples"] == 3001


def test_the_control_in_bfloat16_fails_a_limit_of_the_cell(solved):
    limits, _, _, ref, ctl = solved
    numbers = compare.compare(ctl, ref)
    assert any(numbers[k] > limits[k] for k in limits), numbers


def test_the_control_over_a_cut_of_the_markers_fails_a_limit_the_program_meets(capsys):
    """``h100bench/control_cut.py``, which gives the cell's control readings
    over the first markers of its traffic, at 300 markers x 2,001
    individuals on the CPU: one line a seed, the program within every limit
    of the cell and the bfloat16 control over one."""
    limits = json.loads((BENCH / "workloads" / "cusk.block11k_n500k.json").read_text())["limits"]
    cut = load_module(BENCH / "control_cut.py", "test_control_cut")
    assert cut.main(["--workload", "cusk.block11k_n500k", "--markers", "300",
                     "--individuals", "2001", "--seeds", str(2**32 + 5)]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert (line["markers"], line["individuals"]) == (300, 2001)
    assert all(line["program"][k] <= limits[k] for k in limits), line
    assert any(line["control"][k] > limits[k] for k in limits), line


def test_the_roofline_counts_each_distinct_pair_of_indicator_rows_once():
    """The int8 products' least time: 3 m (3 m + 1) n operations (a multiply
    and an add for each distinct pair of the 3 m indicator rows, a row with
    itself included) at the int8 peak, or the bytes at the memory's rate
    where those take longer."""
    from h100bench import roofline

    m, n = 11000, 262144
    assert roofline.int8_panel_seconds(m, n) == pytest.approx(
        3 * m * (3 * m + 1) * n / roofline.INT8_PEAK_OPS, rel=1e-12)
    # one sample: the bytes bound it
    assert roofline.int8_panel_seconds(m, 1) == pytest.approx(
        (3 * m + 2.0 * 3 * m * (3 * m + 1)) / roofline.HBM_BYTES, rel=1e-12)
