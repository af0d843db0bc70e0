"""Correlation panels on the device (`cigwas_tpu.ops.corr`).

* marker–marker Kendall tau-b ("npn"): the 3x3 genotype contingency table of
  every marker pair comes from an exact int8 product ``X (3m, n) @ X.T``;
  tau-b maps to Pearson by sin(pi/2 * tau). A block's square panel is one
  launch of ``csrc/kendall_panel.cu`` from the packed codes
  (:mod:`~cigwas_tpu_torch.ops.kernels.kendall_panel`); the host panels,
  the banded tiles and the engines' slabs decode one-hots for
  ``torch._int_mm``;
* marker–phenotype Pearson with NaN masking and phenotype–phenotype Pearson
  are float32 matmuls in full precision (TF32 off, asserted);
* the banded variant (LD blocking) computes row tiles of the dense panel
  against the next ``row_tile + width`` markers and gathers the width-w
  diagonal band; at chromosome scale each tile's band is reduced to its
  |corr| row sums on the device and one (m,) vector is fetched at the end.

Panels come back as device tensors padded to a PANEL_ALIGN multiple (or a
``row_tile`` multiple for the striped panel) with layout [m markers,
p traits, inert pads]: pad rows and columns are 0 off the diagonal, so the
level-0 screen isolates them.
"""

from __future__ import annotations

import numpy as np
import torch

from cigwas_tpu_torch.device import require_full_f32, resolve
from cigwas_tpu_torch.constants import PANEL_ALIGN
from cigwas_tpu_torch.ops.decode import (
    PAD_BYTE,
    contingency_counts,
    geno_onehot,
    geno_value_valid,
    unpack_bed_codes,
)
from cigwas_tpu_torch.ops.kernels.kendall_panel import (
    ROW_ALIGN,
    kendall_from_counts as _kendall_from_counts,
    kendall_panel,
)
from cigwas_tpu_torch.utils.timing import count, to_device, to_host

# samples per decode step (bytes chunk = this / 4)
DEFAULT_SAMPLE_CHUNK = 131072
# rows of the striped panel's canvas are a multiple of this (a PANEL_ALIGN
# multiple), and marker rows per output tile of the full and banded Kendall
# panels
PANEL_ROW_TILE = 2048
# the engines' slabs decode the whole (3m, n) int8 one-hot once when it fits
# this many bytes; beyond it each slab re-decodes its sample chunks
DECODE_ONCE_MAX_BYTES = 2 << 30


def _pad_rows(arr: np.ndarray, multiple: int, fill) -> np.ndarray:
    pad = (-arr.shape[0]) % multiple
    if pad == 0:
        return arr
    return np.concatenate(
        [arr, np.full((pad,) + arr.shape[1:], fill, dtype=arr.dtype)], axis=0
    )


def _prep_bytes(bed_bytes: np.ndarray, num_samples: int, sample_chunk: int):
    """Pad the byte matrix so every sample chunk is full; returns (bytes,
    n_chunks). Tail codes of the last partial byte and padding bytes are
    forced to "missing" so they contribute nothing."""
    bed_bytes = np.asarray(bed_bytes, dtype=np.uint8)
    m, B = bed_bytes.shape
    rem = num_samples % 4
    if rem and B * 4 >= num_samples:
        last = bed_bytes[:, (num_samples - 1) // 4].astype(np.uint16)
        keep_mask = (1 << (2 * rem)) - 1
        pad_bits = PAD_BYTE & ~keep_mask
        bed_bytes = bed_bytes.copy()
        bed_bytes[:, (num_samples - 1) // 4] = ((last & keep_mask) | pad_bits).astype(np.uint8)
    chunk_bytes = sample_chunk // 4
    padB = (-B) % chunk_bytes
    if padB:
        bed_bytes = np.concatenate(
            [bed_bytes, np.full((m, padB), PAD_BYTE, dtype=np.uint8)], axis=1
        )
    return bed_bytes, bed_bytes.shape[1] // chunk_bytes


def _sample_chunk(n_bytes: int, sample_chunk: int) -> int:
    return min(sample_chunk, 4 * (((n_bytes + 31) // 32) * 32))


def _kendall_counts_block(rows_bytes: torch.Tensor, cols_bytes: torch.Tensor,
                          n_chunks: int) -> torch.Tensor:
    """Accumulated 3x3 contingency counts between two packed byte panels.

    rows_bytes (mr, B), cols_bytes (mc, B) uint8 on one device ->
    channel-major counts (3mr, 3mc) f32 (see `_kendall_from_counts`). Each
    sample chunk is decoded on the fly and feeds one int8 product with exact
    int32 accumulation."""
    mr, B = rows_bytes.shape
    mc = cols_bytes.shape[0]
    cb = B // n_chunks
    counts = torch.zeros((3 * mr, 3 * mc), dtype=torch.int32, device=rows_bytes.device)
    for c in range(n_chunks):
        ra = geno_onehot(unpack_bed_codes(rows_bytes[:, c * cb : (c + 1) * cb]))
        ca = geno_onehot(unpack_bed_codes(cols_bytes[:, c * cb : (c + 1) * cb]))
        counts += contingency_counts(ra.reshape(3 * mr, -1), ca.reshape(3 * mc, -1))
    return counts.to(torch.float32)


def kendall_npn_corr(bed_bytes, num_samples: int, row_tile: int | None = None,
                     sample_chunk: int = DEFAULT_SAMPLE_CHUNK, device="cuda") -> np.ndarray:
    """Full (m, m) marker-marker npn correlation panel, as a host array
    (`cu_corr_pearson_npn`, `corr_host.cu:1094-1197`): the packed bytes are
    uploaded once and each row tile is one product against all markers."""
    device = resolve(device)
    bed_bytes = np.asarray(bed_bytes, dtype=np.uint8)
    m = bed_bytes.shape[0]
    sample_chunk = _sample_chunk(bed_bytes.shape[1], sample_chunk)
    padded, n_chunks = _prep_bytes(bed_bytes, num_samples, sample_chunk)
    if row_tile is None:
        row_tile = m if m <= 4096 else PANEL_ROW_TILE
    padded = _pad_rows(padded, row_tile, PAD_BYTE)
    mp = padded.shape[0]
    cols = torch.tensor(padded, device=device)
    out = np.empty((mp, m), dtype=np.float32)
    for t0 in range(0, mp, row_tile):
        counts = _kendall_counts_block(cols[t0 : t0 + row_tile], cols, n_chunks)
        out[t0 : t0 + row_tile] = _kendall_from_counts(counts, row_tile, mp)[:, :m].cpu().numpy()
    res = out[:m]
    np.fill_diagonal(res, 1.0)
    return res


def _upload_banded(bed_bytes, num_samples: int, corr_width: int, row_tile: int,
                   sample_chunk: int, device):
    """The chromosome's packed bytes on the device, once, for the banded
    tiles: rows padded to a ``row_tile`` multiple plus the band width with
    all-missing markers, so every tile slices the same tensor (pad markers
    give NaN correlations, which the band masks to 0). Returns (bytes
    (mp + width, B) uint8, m, row_tile, n_chunks)."""
    bed_bytes = np.asarray(bed_bytes, dtype=np.uint8)
    m = bed_bytes.shape[0]
    sample_chunk = _sample_chunk(bed_bytes.shape[1], sample_chunk)
    padded, n_chunks = _prep_bytes(bed_bytes, num_samples, sample_chunk)
    row_tile = min(row_tile, m)
    mp = -(-m // row_tile) * row_tile
    big = _pad_rows(padded, mp + corr_width, PAD_BYTE)[: mp + corr_width]
    return torch.tensor(big, device=device), m, row_tile, n_chunks


def _banded_tile(cols_all: torch.Tensor, t0: int, m: int, row_tile: int, width: int,
                 n_chunks: int) -> torch.Tensor:
    """The (row_tile, width) band of the tile whose first marker is t0:
    band[i, j] = corr(t0 + i, t0 + i + 1 + j), 0 where that column falls off
    the chromosome or the correlation is not finite."""
    rows_bytes = cols_all[t0 : t0 + row_tile]
    cols_bytes = cols_all[t0 : t0 + row_tile + width]
    counts = _kendall_counts_block(rows_bytes, cols_bytes, n_chunks)
    corr = _kendall_from_counts(counts, row_tile, row_tile + width)
    dev = cols_all.device
    # local column of corr(i, i + 1 + j) is i_local + 1 + j
    gather_ix = (torch.arange(1, width + 1, device=dev)[None, :]
                 + torch.arange(row_tile, device=dev)[:, None])
    band = torch.gather(corr, 1, gather_ix.clamp(max=corr.shape[1] - 1))
    return torch.where(((t0 + gather_ix) >= m) | ~torch.isfinite(band), 0.0, band)


def kendall_npn_corr_banded(bed_bytes, num_samples: int, corr_width: int,
                            row_tile: int = PANEL_ROW_TILE,
                            sample_chunk: int = DEFAULT_SAMPLE_CHUNK,
                            device="cuda") -> np.ndarray:
    """Banded npn correlations as a host array: band[i, j] = corr(i, i+1+j),
    zero past the end (`cal_mcorrk_banded`, `corr_host.cu:1199-1319`), as
    row-tile x (tile + width) panel products."""
    device = resolve(device)
    cols_all, m, row_tile, n_chunks = _upload_banded(
        bed_bytes, num_samples, corr_width, row_tile, sample_chunk, device)
    band = np.zeros((m, corr_width), dtype=np.float32)
    for t0 in range(0, m, row_tile):
        rt = min(row_tile, m - t0)
        tile = _banded_tile(cols_all, t0, m, row_tile, corr_width, n_chunks)
        band[t0 : t0 + rt] = tile[:rt].cpu().numpy()
    return band


def banded_row_abs_sums(band: np.ndarray) -> np.ndarray:
    """Forward-band |corr| row sums used by LD blocking (`corr_host.cu:112-128`)."""
    return np.abs(band).sum(axis=1).astype(np.float32)


def _banded_tile_abs_sums(cols_all: torch.Tensor, t0: int, m: int, row_tile: int,
                          width: int, n_chunks: int) -> torch.Tensor:
    """One banded tile reduced to its (row_tile,) |corr| row sums on the
    device: the band never leaves it."""
    return _banded_tile(cols_all, t0, m, row_tile, width, n_chunks).abs().sum(dim=1)


def banded_row_abs_sums_streaming(bed_bytes, num_samples: int, corr_width: int,
                                  row_tile: int = PANEL_ROW_TILE,
                                  sample_chunk: int = DEFAULT_SAMPLE_CHUNK,
                                  device="cuda") -> np.ndarray:
    """`banded_row_abs_sums(kendall_npn_corr_banded(...))` with the band
    reduced on the device: the tiles are queued one after the other without
    a fetch, each writes its row sums into one (m,) tensor, and that vector
    is fetched once at the end.

    The f32 row sums reduce in torch's order instead of numpy's pairwise
    order, so they can differ from the two-step host route in the last
    digits (rtol 2e-5 / atol 1e-4 between the routes); `make_blocks` takes
    this route only at chromosome scale."""
    device = resolve(device)
    cols_all, m, row_tile, n_chunks = _upload_banded(
        bed_bytes, num_samples, corr_width, row_tile, sample_chunk, device)
    sums = torch.zeros(-(-m // row_tile) * row_tile, dtype=torch.float32, device=device)
    for t0 in range(0, m, row_tile):
        sums[t0 : t0 + row_tile] = _banded_tile_abs_sums(
            cols_all, t0, m, row_tile, corr_width, n_chunks)
    return sums[:m].cpu().numpy()


def _phen_arrays(phen: np.ndarray, n_padded: int, device, stats: dict | None = None):
    """NaN-zeroed phenotypes and their validity, zero-padded to n_padded;
    their upload counted under the site ``phen``."""
    phen = np.asarray(phen, dtype=np.float32)
    phen0 = np.zeros((phen.shape[0], n_padded), dtype=np.float32)
    phenv = np.zeros((phen.shape[0], n_padded), dtype=np.float32)
    phen0[:, : phen.shape[1]] = np.nan_to_num(phen)
    phenv[:, : phen.shape[1]] = np.isfinite(phen).astype(np.float32)
    return (to_device(phen0, device, stats, "phen"), to_device(phenv, device, stats, "phen"))


def _chunk_sums(codes, ph0, phv):
    """One sample chunk's (s_mp, s_p, n_val) contributions."""
    vals, valid = geno_value_valid(codes)
    return (
        (vals * valid) @ ph0.T,
        valid @ ph0.T,
        valid @ phv.T,
    )


def marker_phen_sums(bed_bytes, phen: np.ndarray, num_samples: int, device,
                     sample_chunk: int = DEFAULT_SAMPLE_CHUNK, stats: dict | None = None):
    """(s_mp, s_p, n_val) (m, p) f32 device tensors, accumulated over sample
    chunks (`cigwas_tpu.ops.corr.marker_phen_sums_dispatch`); no host fetch.
    stats, if given, counts the uploads (:func:`~cigwas_tpu_torch.utils.timing.to_device`,
    sites ``prescreen_block`` and ``phen``)."""
    device = resolve(device)
    require_full_f32()
    bed_bytes = np.asarray(bed_bytes, dtype=np.uint8)
    sample_chunk = _sample_chunk(bed_bytes.shape[1], sample_chunk)
    padded, n_chunks = _prep_bytes(bed_bytes, num_samples, sample_chunk)
    ph0, phv = _phen_arrays(phen, padded.shape[1] * 4, device, stats)
    rows = to_device(padded, device, stats, "prescreen_block")
    cb = padded.shape[1] // n_chunks
    sums = None
    for c in range(n_chunks):
        part = _chunk_sums(
            unpack_bed_codes(rows[:, c * cb : (c + 1) * cb]),
            ph0[:, c * 4 * cb : (c + 1) * 4 * cb],
            phv[:, c * 4 * cb : (c + 1) * 4 * cb],
        )
        sums = part if sums is None else tuple(a + b for a, b in zip(sums, part))
    return sums


def marker_phen_corr_from_sums(sums, marker_mean: np.ndarray, marker_std: np.ndarray,
                               stats: dict | None = None) -> np.ndarray:
    """Fetch the sums and finish r = (s_mp - mean s_p) / (n_valid std) on the
    host, as the JAX package does; stats, if given, counts the fetch's bytes
    (:func:`~cigwas_tpu_torch.utils.timing.to_host`, site ``prescreen``)."""
    s_mp, s_p, n_val = (to_host(t, stats, "prescreen") for t in sums)
    mean = np.asarray(marker_mean, dtype=np.float32)[:, None]
    std = np.asarray(marker_std, dtype=np.float32)[:, None]
    return (s_mp - mean * s_p) / (n_val * std)


def marker_phen_corr(bed_bytes, phen: np.ndarray, marker_mean: np.ndarray,
                     marker_std: np.ndarray, num_samples: int,
                     sample_chunk: int = DEFAULT_SAMPLE_CHUNK, device="cuda") -> np.ndarray:
    """(m, p) Pearson correlations between markers and standardized phenotypes
    (`cigwas_tpu.ops.corr.marker_phen_corr`; `corr_kernels.cu:92-155`):
    r = (sum(g y) - mean_g sum(y)) / (n_valid std_g), sums over samples where
    the genotype is non-missing and the phenotype is not NaN; the sums on the
    device, the quotient on the host, as the JAX function does."""
    sums = marker_phen_sums(bed_bytes, phen, num_samples, device, sample_chunk)
    return marker_phen_corr_from_sums(sums, marker_mean, marker_std)


def phen_phen_corr(phen: np.ndarray, device="cuda", stats: dict | None = None) -> np.ndarray:
    """(p, p) Pearson panel of standardized phenotypes with pairwise NaN
    masking: r_ab = sum_valid(y_a y_b) / n_valid_ab; stats, if given,
    counts the upload of the phenotypes (site ``phen``)."""
    device = resolve(device)
    require_full_f32()
    phen = np.asarray(phen, dtype=np.float32)
    p0 = to_device(np.nan_to_num(phen), device, stats, "phen")
    v = to_device(np.isfinite(phen).astype(np.float32), device, stats, "phen")
    return ((p0 @ p0.T) / (v @ v.T)).cpu().numpy()


def _count_panel(stats: dict | None, m: int, num_samples: int, n_chunks: int) -> None:
    """The panel's counters: ``panel_markers`` and ``panel_samples`` (the
    block's shape, unpadded) and ``panel_sample_chunks`` (the int8 products
    of a stripe); each int8 one-hot written to device memory adds its bytes
    to ``panel_decode_bytes``, and each launch of the Kendall panel kernel
    adds 1 to ``panel_kernel_launches``."""
    if stats is not None:
        stats.update(panel_markers=m, panel_samples=num_samples, panel_sample_chunks=n_chunks)


def _kendall_block(codes: torch.Tensor, num_samples: int, out: torch.Tensor,
                   stats: dict | None) -> None:
    """out[:m, :m] from the m rows of packed codes by one launch of the
    Kendall panel kernel: no one-hot in device memory."""
    kendall_panel(codes, num_samples, out)
    count(stats, "panel_decode_bytes", 0)
    count(stats, "panel_kernel_launches", 1)


def _kernel_rows(bed_bytes: np.ndarray) -> np.ndarray:
    """The packed rows as the kernel reads them: padded with missing codes
    to a ROW_ALIGN multiple of bytes only where they fall short of one."""
    pad = (-bed_bytes.shape[1]) % ROW_ALIGN
    if pad == 0:
        return bed_bytes
    return np.concatenate(
        [bed_bytes, np.full((bed_bytes.shape[0], pad), PAD_BYTE, dtype=np.uint8)], axis=1)


def _reorder_mask_panel(C: torch.Tensor, idx: torch.Tensor, v_valid: int):
    """Move inert pad-marker rows behind the traits and zero their corrs.

    idx permutes [markers, pad, traits] -> [markers, traits, pad]; rows and
    columns at positions >= v_valid are cleared off the diagonal (their raw
    values are NaN from all-missing pad genotypes)."""
    C2 = C.index_select(0, idx).index_select(1, idx)
    r = torch.arange(C.shape[0], device=C.device)
    pad_rc = (r[:, None] >= v_valid) | (r[None, :] >= v_valid)
    off_diag = r[:, None] != r[None, :]
    return torch.where(pad_rc & off_diag, 0.0, C2)


def _pads_last_index(m: int, m_pad: int, p: int, device) -> torch.Tensor:
    return torch.from_numpy(
        np.concatenate([np.arange(m), np.arange(m_pad, m_pad + p), np.arange(m, m_pad)])
    ).to(device)


def _fused_inputs(bed_bytes, phen: np.ndarray, marker_mean: np.ndarray,
                  marker_std: np.ndarray, num_samples: int, device, sample_chunk: int,
                  stats: dict | None = None):
    """The single-pass panel's device inputs: the packed rows padded to
    m_pad = m + (-(m + p) mod PANEL_ALIGN) markers, their sample chunks, the
    phenotypes and the padded means and stds. Returns (rows, n_chunks, ph0,
    phv, mean (m_pad, 1), std (m_pad, 1), m_pad). stats, if given, counts
    the uploads (sites ``panel_block``, ``phen``, ``panel_traits``)."""
    bed_bytes = np.asarray(bed_bytes, dtype=np.uint8)
    m, p = bed_bytes.shape[0], phen.shape[0]
    m_pad = m + ((-(m + p)) % PANEL_ALIGN)
    bed_bytes = _pad_rows(bed_bytes, m_pad, PAD_BYTE)
    mean = _pad_rows(np.asarray(marker_mean, dtype=np.float32), m_pad, 1.0)
    std = _pad_rows(np.asarray(marker_std, dtype=np.float32), m_pad, 1.0)
    sample_chunk = _sample_chunk(bed_bytes.shape[1], sample_chunk)
    padded, n_chunks = _prep_bytes(bed_bytes, num_samples, sample_chunk)
    ph0, phv = _phen_arrays(phen, padded.shape[1] * 4, device, stats)
    return (to_device(padded, device, stats, "panel_block"), n_chunks, ph0, phv,
            to_device(mean, device, stats, "panel_traits")[:, None],
            to_device(std, device, stats, "panel_traits")[:, None], m_pad)


def _fused_trait_blocks(sums, ph0, phv, mean_t, std_t):
    """(C_mp (m_pad, p), C_pp (p, p)) of the single-pass panel from its
    accumulated marker-phen sums."""
    s_mp, s_p, n_val = sums
    return (s_mp - mean_t * s_p) / (n_val * std_t), (ph0 @ ph0.T) / (phv @ phv.T)


def fused_trait_blocks(bed_bytes, phen: np.ndarray, marker_mean: np.ndarray,
                       marker_std: np.ndarray, num_samples: int, device,
                       sample_chunk: int = DEFAULT_SAMPLE_CHUNK):
    """The marker-phen (m, p) and phen-phen (p, p) blocks of
    :func:`corr_panel_device`'s panel as device tensors, computed as it
    computes them (the same padded rows, chunks and products, so the same
    bits), without the marker-marker counts; the sharded engines build those
    per shard."""
    device = resolve(device)
    require_full_f32()
    m = np.asarray(bed_bytes).shape[0]
    rows, n_chunks, ph0, phv, mean_t, std_t, _ = _fused_inputs(
        bed_bytes, phen, marker_mean, marker_std, num_samples, device, sample_chunk)
    cb = rows.shape[1] // n_chunks
    sums = None
    for c in range(n_chunks):
        part = _chunk_sums(
            unpack_bed_codes(rows[:, c * cb : (c + 1) * cb]),
            ph0[:, c * 4 * cb : (c + 1) * 4 * cb], phv[:, c * 4 * cb : (c + 1) * 4 * cb],
        )
        sums = part if sums is None else tuple(a + b for a, b in zip(sums, part))
    C_mp, C_pp = _fused_trait_blocks(sums, ph0, phv, mean_t, std_t)
    return C_mp[:m], C_pp


def corr_panel_device(bed_bytes, phen: np.ndarray, marker_mean: np.ndarray,
                      marker_std: np.ndarray, num_samples: int, device,
                      sample_chunk: int = DEFAULT_SAMPLE_CHUNK, stats: dict | None = None):
    """Packed correlation panel of a block, built and left on ``device``;
    returns (C (vp, vp) f32, v). The marker-marker block is one launch of
    the Kendall panel kernel over the uploaded rows; each sample chunk's
    codes feed the marker-phen sums
    (`cigwas_tpu.ops.corr.corr_panel_device`). For blocks up to ~4096
    markers; larger blocks use :func:`corr_panel_device_tiled`. stats, if
    given, receives the panel's counters (see :func:`_count_panel`) and its
    uploads (:func:`_fused_inputs`)."""
    device = resolve(device)
    require_full_f32()
    m, p = np.asarray(bed_bytes).shape[0], phen.shape[0]
    v = m + p
    rows, n_chunks, ph0, phv, mean_t, std_t, m_pad = _fused_inputs(
        bed_bytes, phen, marker_mean, marker_std, num_samples, device, sample_chunk, stats)
    _count_panel(stats, m, num_samples, 1)
    # pad rows and columns stay 0 here; the reorder below clears them anyway
    C_mm = torch.zeros((m_pad, m_pad), dtype=torch.float32, device=device)
    _kendall_block(rows[:m], num_samples, C_mm, stats)
    cb = rows.shape[1] // n_chunks
    sums = None
    for c in range(n_chunks):
        part = _chunk_sums(
            unpack_bed_codes(rows[:, c * cb : (c + 1) * cb]),
            ph0[:, c * 4 * cb : (c + 1) * 4 * cb], phv[:, c * 4 * cb : (c + 1) * 4 * cb],
        )
        sums = part if sums is None else tuple(a + b for a, b in zip(sums, part))
    C_mp, C_pp = _fused_trait_blocks(sums, ph0, phv, mean_t, std_t)
    C = torch.cat([torch.cat([C_mm, C_mp], 1), torch.cat([C_mp.T, C_pp], 1)], 0)
    C.fill_diagonal_(1.0)
    if m_pad == m:
        return C, v
    return _reorder_mask_panel(C, _pads_last_index(m, m_pad, p, device), v), v


def corr_panel_device_tiled(bed_bytes, phen: np.ndarray, marker_mean: np.ndarray,
                            marker_std: np.ndarray, num_samples: int, device,
                            mp_corr: np.ndarray | None = None,
                            row_tile: int = PANEL_ROW_TILE, stats: dict | None = None):
    """Large-block panel, built into a device canvas and left there; returns
    (C, v) with vp the smallest ``row_tile`` multiple >= m + p
    (`cigwas_tpu.ops.corr.corr_panel_device_tiled`).

    The marker-marker block is one launch of the Kendall panel kernel over
    the block's packed rows as they are (padded to ROW_ALIGN bytes only
    where a row falls short), over every sample at once. mp_corr: the
    (m, p) marker-phen correlations when the caller already has them (the
    cusk pre-screen), else computed here on the device. stats, if given,
    receives the panel's counters (see :func:`_count_panel`) and its uploads
    (sites ``panel_block``, ``panel_traits``, ``phen`` and, without mp_corr,
    ``prescreen_block``).
    """
    device = resolve(device)
    require_full_f32()
    bed_bytes = np.asarray(bed_bytes, dtype=np.uint8)
    phen = np.asarray(phen, dtype=np.float32)
    m, p = bed_bytes.shape[0], phen.shape[0]
    v = m + p
    vp = -(-v // row_tile) * row_tile
    m_pad = vp - p
    if mp_corr is None:
        s_mp, s_p, n_val = marker_phen_sums(bed_bytes, phen, num_samples, device,
                                            stats=stats)
        mean_t = to_device(np.asarray(marker_mean, np.float32), device, stats,
                           "panel_traits")[:, None]
        std_t = to_device(np.asarray(marker_std, np.float32), device, stats,
                          "panel_traits")[:, None]
        mp = (s_mp - mean_t * s_p) / (n_val * std_t)
    else:
        mp = to_device(np.asarray(mp_corr, dtype=np.float32), device, stats, "panel_traits")
    _count_panel(stats, m, num_samples, 1)
    codes = to_device(_kernel_rows(bed_bytes), device, stats, "panel_block")
    # rows and columns m .. m_pad - 1 stay 0 here; the reorder below clears them anyway
    C = torch.zeros((vp, vp), dtype=torch.float32, device=device)
    _kendall_block(codes, num_samples, C, stats)
    del codes
    # NaN marker-phen corrs stay NaN: the level-0 screen keeps such edges
    C[:m, m_pad:] = mp
    C[m_pad:, :m] = mp.T
    C[m_pad:, m_pad:] = to_device(phen_phen_corr(phen, device, stats), device, stats,
                                  "panel_traits")
    C.fill_diagonal_(1.0)
    return _reorder_mask_panel(C, _pads_last_index(m, m_pad, p, device), v), v


def pack_square_corr(
    marker_corr: np.ndarray, marker_phen: np.ndarray, phen_corr: np.ndarray
) -> np.ndarray:
    """Assemble the dense (m+p, m+p) correlation matrix fed to the skeleton
    (the triangular->square packing of `cli.cpp:594-649`); the diagonal is 1."""
    m, p = marker_phen.shape
    n = m + p
    sq = np.ones((n, n), dtype=np.float32)
    sq[:m, :m] = marker_corr
    sq[:m, m:] = marker_phen
    sq[m:, :m] = marker_phen.T
    sq[m:, m:] = phen_corr
    np.fill_diagonal(sq, 1.0)
    return sq


def marker_corr_mat_antidiag_sums(corrs: np.ndarray) -> np.ndarray:
    """Antidiagonal sums of the strictly-upper triangular panel
    (`marker_corr_mat_antidiag_sums`, `corr_host.cu:130-166`): entry (row,
    col) contributes to antidiagonal row + col - 1; the result has 2m - 3
    entries. Accepts a dense symmetric panel."""
    corrs = np.asarray(corrs, dtype=np.float64)
    m = corrs.shape[0]
    sums = np.zeros(max(2 * m - 3, 0), dtype=np.float64)
    iu = np.triu_indices(m, k=1)
    np.add.at(sums, iu[0] + iu[1] - 1, corrs[iu])
    return sums.astype(np.float32)


def _marker_pearson_sums(rows: torch.Tensor, n_chunks: int):
    """(sum over jointly valid samples of g_a g_b, joint valid counts), both
    (m, m) int32 on the device: per sample chunk, two exact int8 products of
    the decoded genotype values (0/1/2, 0 where missing) and validities."""
    m, B = rows.shape
    cb = B // n_chunks
    s_gg = torch.zeros((m, m), dtype=torch.int32, device=rows.device)
    n_joint = torch.zeros_like(s_gg)
    for c in range(n_chunks):
        codes = unpack_bed_codes(rows[:, c * cb : (c + 1) * cb])
        gv = ((codes == 0).to(torch.int8) * 2 + (codes == 2).to(torch.int8))
        valid = (codes != 1).to(torch.int8)
        s_gg += contingency_counts(gv, gv)
        n_joint += contingency_counts(valid, valid)
    return s_gg, n_joint


def marker_pearson_corr(bed_bytes, marker_mean: np.ndarray, marker_std: np.ndarray,
                        num_samples: int, sample_chunk: int = DEFAULT_SAMPLE_CHUNK,
                        device="cuda") -> np.ndarray:
    """(m, m) pairwise-complete Pearson correlations between markers
    (`cigwas_tpu.ops.corr.marker_pearson_corr`; `bed_marker_corr_pearson`,
    `corr_kernels.cu:344-407`): r = (sum(g_a g_b)/n_joint - mean_a mean_b) /
    (std_a std_b) with sums over individuals where both genotypes are
    non-missing. The sums are exact integers (int8 products); the quotient
    is the JAX package's f32 host expression, so the result equals its bit
    for bit on the same bytes."""
    device = resolve(device)
    bed_bytes = np.asarray(bed_bytes, dtype=np.uint8)
    sample_chunk = _sample_chunk(bed_bytes.shape[1], sample_chunk)
    padded, n_chunks = _prep_bytes(bed_bytes, num_samples, sample_chunk)
    s_gg, n_joint = _marker_pearson_sums(torch.tensor(padded, device=device), n_chunks)
    s_gg = s_gg.cpu().numpy().astype(np.float32)
    n_joint = n_joint.cpu().numpy().astype(np.float32)
    mean = np.asarray(marker_mean, dtype=np.float32)
    std = np.asarray(marker_std, dtype=np.float32)
    with np.errstate(invalid="ignore", divide="ignore"):
        corr = (s_gg / n_joint - mean[:, None] * mean[None, :]) / (
            std[:, None] * std[None, :]
        )
    np.fill_diagonal(corr, 1.0)
    return corr.astype(np.float32)
