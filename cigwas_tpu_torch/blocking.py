"""LD blocking: tile a chromosome into approximately unlinked marker blocks.

Equivalent of `blocking.cpp`: the forward-banded |corr| row sums are smoothed
with a Hanning window, block boundaries are local minima of the smoothed
signal, and the window size is found by bisection so that the largest block
is within MAX_BLOCK_SIZE_TOL of (and not above) max_block_size
(`block_chr`, `blocking.cpp:102-136`).
"""

from __future__ import annotations

import numpy as np

from cigwas_tpu_torch.constants import MAX_BLOCK_SIZE_TOL
from cigwas_tpu_torch.io.blocks import MarkerBlock


def hanning_smoothing(v: np.ndarray, window_size: int) -> np.ndarray:
    """Hanning-window convolution, zero at the margins (`blocking.cpp:8-34`).

    Note the reference evaluates cosf in single precision inside a double
    accumulation; numpy float64 stays within the test tolerance (1e-2).
    """
    n = np.arange(window_size, dtype=np.float64)
    window = 0.5 - 0.5 * np.cos(
        (2.0 * np.pi * n / (window_size - 1.0)).astype(np.float32).astype(np.float64)
    )
    v = np.asarray(v, dtype=np.float64)
    margin = window_size // 2
    res = np.zeros_like(v)
    full = np.convolve(v, window[::-1], mode="valid")  # length len(v)-window+1
    # centers margin .. len(v)-margin-1 map to full[0:...] (window odd)
    res[margin : len(v) - margin] = full[: len(v) - 2 * margin]
    return res


def local_minima(v: np.ndarray) -> list[int]:
    """Indices of local minima with the reference's running-max hysteresis
    (`blocking.cpp:36-53`): a minimum requires a preceding value larger than
    the current one since the last reported minimum."""
    res = []
    left = 0.0
    for i in range(1, len(v) - 1):
        if left > v[i] and v[i] < v[i + 1]:
            res.append(i)
            left = 0.0
        elif v[i] > left:
            left = v[i]
    return res


def blocks_from_minima(minima: list[int], chr_id: str, num_vars: int) -> list[MarkerBlock]:
    res = []
    prev = 0
    for pos in minima:
        res.append(MarkerBlock(chr_id, prev, pos, 0))
        prev = pos + 1
    res.append(MarkerBlock(chr_id, prev, num_vars - 1, 0))
    return res


def _make_odd(v: int) -> int:
    return v - 1 if v % 2 == 0 else v


def block_chr_with_window_size(
    forward_corr_sums: np.ndarray, chr_id: str, window_size: int
) -> list[MarkerBlock]:
    smooth = hanning_smoothing(forward_corr_sums, window_size)
    return blocks_from_minima(local_minima(smooth), chr_id, len(forward_corr_sums))


def block_chr(
    forward_corr_sums: np.ndarray, chr_id: str, max_block_size: int
) -> list[MarkerBlock]:
    """Bisection over the smoothing window size (`blocking.cpp:102-136`)."""
    too_large = len(forward_corr_sums)
    too_small = 3
    window_size = _make_odd((too_large + too_small) // 2)

    res = block_chr_with_window_size(forward_corr_sums, chr_id, window_size)
    lbs = max(b.block_size() for b in res)

    while abs(lbs - max_block_size) > MAX_BLOCK_SIZE_TOL or lbs > max_block_size:
        if lbs > max_block_size:
            too_large = min(too_large, window_size)
        else:
            too_small = max(too_small, window_size)
        new_window_size = _make_odd((too_large + too_small) // 2)
        if new_window_size == window_size:
            break
        window_size = new_window_size
        res = block_chr_with_window_size(forward_corr_sums, chr_id, window_size)
        lbs = max(b.block_size() for b in res)

    return res
