"""The Kendall panel kernel's wrapper (`cigwas_tpu_torch/ops/kernels/
kendall_panel.py`, `csrc/kendall_panel.cu`): its plain version against the
striped one-hot products the panels ran before it (`_kendall_counts_block`
and `_kendall_from_counts` of `ops/corr.py`), bit for bit, on the CPU; the
block panels against the same panels built by those stripes; the kernel
against the plain version on the card. No jax here: the card test runs
where it is not installed
(``python -m pytest tests/test_torch_kendall_panel.py -m cuda --noconftest``)."""

import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from torch_parity import set_threads

set_threads()

ROOT = Path(__file__).resolve().parents[1]


def _codes(m: int, n: int, seed: int, miss: float = 0.05) -> np.ndarray:
    """(m, ceil(n / 4)) packed codes with ~miss missing calls, marker 1 all
    missing and marker 2 monomorphic (where m > 2), PLINK's zero bits past n."""
    from cigwas_tpu_torch.io.bed import encode_bed_values

    rng = np.random.default_rng(seed)
    maf = rng.uniform(0.05, 0.5, m)
    G = ((rng.random((m, n)) < maf[:, None]).astype(np.float32)
         + (rng.random((m, n)) < maf[:, None]))
    for i in range(1, m):  # some LD between neighbours
        mask = rng.random(n) < 0.4
        G[i, mask] = G[i - 1, mask]
    G[rng.random((m, n)) < miss] = np.nan
    if m > 2:
        G[1] = np.nan
        G[2] = 1.0
    return encode_bed_values(G)


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> None:
    """Equal bit for bit, NaNs in the same places."""
    assert a.shape == b.shape
    nan = torch.isnan(a)
    assert torch.equal(nan, torch.isnan(b)), "NaN positions differ"
    assert torch.equal(a.view(torch.int32)[~nan], b.view(torch.int32)[~nan])


def _striped(rows: np.ndarray, cols: np.ndarray, n: int, sample_chunk: int) -> torch.Tensor:
    """The npn panel of rows against cols as the panels computed it before
    the kernel: the padded sample chunks' one-hots, their int32 products
    summed, the Kendall map."""
    from cigwas_tpu_torch.ops import corr

    sc = corr._sample_chunk(rows.shape[1], sample_chunk)
    pr, n_chunks = corr._prep_bytes(rows, n, sc)
    pc, _ = corr._prep_bytes(cols, n, sc)
    counts = corr._kendall_counts_block(torch.from_numpy(pr), torch.from_numpy(pc), n_chunks)
    return corr._kendall_from_counts(counts, rows.shape[0], cols.shape[0])


@pytest.mark.parametrize("m,n", [(1, 5), (63, 130), (65, 1001), (200, 777)])
def test_plain_version_equals_the_striped_products_in_both_orientations(m, n):
    """out[i, j] and out[j, i] for the markers of two row sets, each against
    the striped products of that orientation; one chunk and 128-sample
    chunks; NaN where a marker is all missing or monomorphic."""
    from cigwas_tpu_torch.ops.kernels import kendall_panel as kp

    bb = _codes(m, n, seed=m + n)
    out = torch.full((m + 2, m + 3), -7.0)
    kp.reset_launches()
    kp.kendall_panel(torch.from_numpy(bb), n, out)
    assert kp.launches == {"kendall_int8_panel": 0}  # the CPU takes the plain version
    assert (out[m:] == -7).all() and (out[:, m:] == -7).all()
    h = max(1, m // 3)
    for sample_chunk in (131072, 128):
        for a, b in ((slice(0, h), slice(h, m)), (slice(h, m), slice(0, h)),
                     (slice(0, m), slice(0, m))):
            if a.stop - a.start and b.stop - b.start:
                _same_bits(out[a, b], _striped(bb[a], bb[b], n, sample_chunk))
    if m > 2:
        assert torch.isnan(out[1, :m]).all() and torch.isnan(out[:m, 2]).all()
        assert not torch.isnan(out[0, 3:m]).any()


@pytest.mark.parametrize("m,n,row_tile,chunk_bytes", [
    (200, 1001, 64, 40), (65, 777, 64, 8), (130, 130, 128, 1 << 20), (63, 1001, 2048, 8)],
    ids=["ragged-stripe-and-chunk", "stripe-of-one-row", "one-chunk", "one-stripe"])
def test_plain_version_in_stripes_and_chunks_equals_one_product(m, n, row_tile, chunk_bytes,
                                                                 monkeypatch):
    """The plain version's row stripes and sample chunks, each cut short at
    the block's edge, give the panel of one product of the whole one-hot
    bit for bit: the counts are exact, and the Kendall map takes each pair's
    nine counts alone."""
    from cigwas_tpu_torch.ops.decode import contingency_counts, geno_onehot, unpack_bed_codes
    from cigwas_tpu_torch.ops.kernels import kendall_panel as kp

    bb = torch.from_numpy(_codes(m, n, seed=m * n))
    x = unpack_bed_codes(bb)
    x[:, n:] = 1  # missing
    oh = geno_onehot(x).reshape(3 * m, -1)
    want = kp.kendall_from_counts(contingency_counts(oh, oh).to(torch.float32), m, m)
    # chunk_bytes bytes of codes a chunk: the one-hot of a chunk of m rows
    monkeypatch.setattr(kp, "PLAIN_ONEHOT_BYTES", 12 * m * chunk_bytes)
    monkeypatch.setattr(kp, "PLAIN_ROW_TILE", row_tile)
    got = torch.full((m, m), -7.0)
    kp.kendall_panel_plain(bb, n, got)
    _same_bits(got, want)


@pytest.mark.parametrize("pad", ["chunks", "rows", "both"])
def test_unpadded_bytes_give_the_padded_panel(pad):
    """The bytes as they are against the bytes padded as the panels padded
    them: missing codes past n, whole sample chunks, all-missing rows."""
    from cigwas_tpu_torch.ops import corr
    from cigwas_tpu_torch.ops.decode import PAD_BYTE
    from cigwas_tpu_torch.ops.kernels.kendall_panel import kendall_panel

    m, n = 70, 999
    bb = _codes(m, n, seed=11)
    plain = torch.zeros((m, m))
    kendall_panel(torch.from_numpy(bb), n, plain)
    padded = bb
    if pad in ("chunks", "both"):
        padded, _ = corr._prep_bytes(padded, n, 512)
    if pad in ("rows", "both"):
        padded = corr._pad_rows(padded, 128, PAD_BYTE)
    got = torch.zeros((padded.shape[0], padded.shape[0]))
    kendall_panel(torch.from_numpy(np.ascontiguousarray(padded)), n, got)
    _same_bits(got[:m, :m], plain)


@pytest.mark.parametrize("bad", ["dtype", "shape", "contiguity", "samples", "out-dtype",
                                 "out-small", "out-contiguity"])
def test_wrapper_refuses_what_the_kernel_does_not_take(bad):
    from cigwas_tpu_torch.ops.kernels.kendall_panel import kendall_panel

    codes = torch.from_numpy(_codes(8, 64, seed=1))
    out = torch.zeros((8, 8))
    args = {
        "dtype": (codes.to(torch.int8), 64, out),
        "shape": (codes.reshape(-1), 64, out),
        "contiguity": (codes.t(), 64, out),
        "samples": (codes, 65, out),
        "out-dtype": (codes, 64, out.double()),
        "out-small": (codes, 64, out[:7]),
        "out-contiguity": (codes, 64, torch.zeros((8, 16))[:, ::2]),
    }[bad]
    with pytest.raises(ValueError):
        kendall_panel(*args)


def _parent_kendall_block(row_tile: int, sample_chunk: int):
    """A stand-in for `corr._kendall_block` with the panels' striped products
    before the kernel: the rows padded with all-missing markers to the
    canvas' size (so pad rows read NaN, as they did), stripes of row_tile."""
    from cigwas_tpu_torch.ops import corr
    from cigwas_tpu_torch.ops.decode import PAD_BYTE

    def block(codes, num_samples, out, stats):
        R = out.shape[0]
        bed = corr._pad_rows(codes.numpy(), R, PAD_BYTE)
        sc = corr._sample_chunk(bed.shape[1], sample_chunk)
        padded, n_chunks = corr._prep_bytes(bed, num_samples, sc)
        cols = torch.from_numpy(padded)
        for t0 in range(0, R, row_tile):
            rt = min(row_tile, R - t0)
            counts = corr._kendall_counts_block(cols[t0 : t0 + rt], cols, n_chunks)
            out[t0 : t0 + rt, :R] = corr._kendall_from_counts(counts, rt, R)

    return block


@pytest.mark.parametrize("route,with_mp", [("fused", False), ("tiled", False), ("tiled", True)],
                         ids=["fused", "tiled-own-sums", "tiled-prescreen-corr"])
def test_block_panels_equal_the_striped_panels(route, with_mp, monkeypatch):
    """`corr_panel_device` and `corr_panel_device_tiled` on the CPU, with
    the kernel's plain version and with the striped products in its place:
    the same panel bit for bit (pad rows and columns cleared either way)."""
    from cigwas_tpu_torch.ops import corr

    m, n, p = 150, 1001, 3
    rng = np.random.default_rng(5)
    bb = _codes(m, n, seed=5)
    Y = rng.normal(size=(p, n)).astype(np.float32)
    Y[rng.random((p, n)) < 0.01] = np.nan
    means, stds = rng.uniform(0.5, 1.5, m).astype(np.float32), rng.uniform(0.3, 0.8, m).astype(
        np.float32)
    mp = corr.marker_phen_corr(bb, Y, means, stds, n, device="cpu") if with_mp else None

    def panel():
        if route == "fused":
            return corr.corr_panel_device(bb, Y, means, stds, n, "cpu", sample_chunk=256)
        return corr.corr_panel_device_tiled(bb, Y, means, stds, n, "cpu", mp_corr=mp,
                                            row_tile=128)

    got, v = panel()
    monkeypatch.setattr(corr, "_kendall_block",
                        _parent_kendall_block(128, 256 if route == "fused" else 131072))
    want, v_want = panel()
    assert v == v_want == m + p
    _same_bits(got, want)
    assert torch.isnan(got[1, :m]).any() and not torch.isnan(got[m:, m:]).any()


def test_the_roofline_metric_finds_the_kernel_by_its_name():
    """`kernels.int8_mm_device_ms.block` (and through it the int8 roofline)
    reads the device time of the kernels whose names its PATTERN matches:
    the kernel's `__global__` name must be one of them."""
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from h100bench.harness import load_module

    from cigwas_tpu_torch.ops.kernels import kendall_panel

    metric = load_module(ROOT / "h100bench" / "metrics" / "kernels.int8_mm_device_ms.block.py",
                         "test_metric_int8_mm_device_ms")
    src = (ROOT / kendall_panel.SOURCE).read_text()
    names = re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)\s*\(", src)
    assert names == ["kendall_int8_panel_kernel"]
    assert re.search(metric.PATTERN, names[0])
    assert all(re.search(metric.PATTERN, k) for k in kendall_panel.launches)


@pytest.mark.cuda
@pytest.mark.parametrize("m,n", [(1, 7), (63, 130), (65, 1001), (200, 777), (700, 4096)])
def test_kernel_equals_plain_version_on_the_card(m, n):
    """The kernel's panel equals its plain version on the card bit for bit,
    NaNs included; nothing outside out[:m, :m] is written."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU build")
    from cigwas_tpu_torch.ops import corr
    from cigwas_tpu_torch.ops.kernels.kendall_panel import kendall_panel, kendall_panel_plain

    codes = torch.from_numpy(corr._kernel_rows(_codes(m, n, seed=m))).cuda()
    got = torch.full((m + 1, m + 2), -7.0, device="cuda")
    want = got.clone()
    kendall_panel(codes, n, got)
    kendall_panel_plain(codes, n, want)
    torch.cuda.synchronize()
    _same_bits(got.cpu(), want.cpu())
    assert (got[m:] == -7).all() and (got[:, m:] == -7).all()
