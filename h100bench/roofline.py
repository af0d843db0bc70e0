"""Work of the program's kernels, computed from the input's shape, and the
card's published peaks that their roofline shares are taken against.

Peaks: NVIDIA H100 SXM data sheet, dense rates at the 700 W power limit.
"""

# int8 tensor-core operations a second
INT8_PEAK_OPS = 1.979e15
# HBM3 bytes a second
HBM_BYTES = 3.35e12


def int8_panel_seconds(markers: int, samples: int) -> float:
    """The least time of the block panel's contingency products on the card:
    the larger of their operations over the int8 peak and their bytes over
    the memory's. Operations: each distinct pair of the 3 m genotype
    indicator rows, a row with itself included, over the n samples, a
    multiply and an add each: 2 x 3 m (3 m + 1) / 2 x n = 3 m (3 m + 1) n.
    The (3 m, 3 m) count matrix is symmetric, so its other half is no work
    the input needs. Bytes: the (3 m, n) int8 indicators read once and the
    distinct int32 counts written once. Unpadded: the padding's rows and
    samples are the program's own choice, not work that the input needs."""
    rows = 3 * markers
    pairs = rows * (rows + 1) / 2.0
    ops = 2.0 * pairs * samples
    nbytes = rows * samples + 4.0 * pairs
    return max(ops / INT8_PEAK_OPS, nbytes / HBM_BYTES)
