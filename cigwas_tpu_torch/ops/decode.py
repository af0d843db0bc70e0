"""2-bit PLINK genotype decode on the device (`cigwas_tpu.ops.decode`).

Code semantics (LSB-first pairs within each byte):
    00 -> value 2, valid      10 -> value 1, valid
    01 -> missing             11 -> value 0, valid
"""

from __future__ import annotations

import torch

# Byte that packs four "missing" codes — pads sample tails and marker rows so
# that padded entries contribute nothing to any statistic.
PAD_BYTE = 0x55


def unpack_bed_codes(bed_bytes: torch.Tensor) -> torch.Tensor:
    """(m, B) packed uint8 -> (m, 4*B) uint8 2-bit codes (LSB-first)."""
    parts = [(bed_bytes >> s) & 0x3 for s in (0, 2, 4, 6)]
    return torch.stack(parts, dim=-1).reshape(bed_bytes.shape[0], -1)


def geno_onehot(codes: torch.Tensor) -> torch.Tensor:
    """(m, n) codes -> (3, m, n) int8 one-hot over genotype values {0, 1, 2}.

    Missing genotypes give an all-zero column. CHANNEL-MAJOR layout:
    ``.reshape(3 * m, n)`` orders rows [channel, marker], so the (3m, 3m)
    contingency product lands the nine per-channel-pair count matrices as
    contiguous (m, m) blocks, which `_kendall_from_counts` slices.
    """
    return torch.stack([codes == 3, codes == 2, codes == 0]).to(torch.int8)


def contingency_counts(ra: torch.Tensor, ca: torch.Tensor) -> torch.Tensor:
    """(3mr, n) x (3mc, n) int8 one-hots -> exact int32 counts (3mr, 3mc).

    ``torch._int_mm`` accumulates in int32 (exact). On CUDA it needs more
    than 16 rows and the other two dimensions multiples of 8: the sample
    padding gives n, and zero rows (which count nothing) are appended to
    row counts that fall short, then cut from the result.
    """
    if not ra.is_cuda:
        return torch._int_mm(ra, ca.t())
    if ra.shape[1] % 8:
        raise ValueError(f"contingency_counts: {ra.shape[1]} samples is not a multiple of 8")
    mr, mc = ra.shape[0], ca.shape[0]
    return torch._int_mm(_zero_rows_to(ra, max(24, -(-mr // 8) * 8)),
                         _zero_rows_to(ca, -(-mc // 8) * 8).t())[:mr, :mc]


def _zero_rows_to(x: torch.Tensor, rows: int) -> torch.Tensor:
    if x.shape[0] == rows:
        return x
    return torch.cat([x, x.new_zeros((rows - x.shape[0], x.shape[1]))])


def geno_value_valid(codes: torch.Tensor):
    """(m, n) codes -> (values, validity) float32; missing decodes to value
    2.0 with validity 0 (like the reference's lookup tables)."""
    valid = (codes != 1).to(torch.float32)
    values = (
        (codes == 0).to(torch.float32) * 2.0
        + (codes == 2).to(torch.float32) * 1.0
        + (codes == 1).to(torch.float32) * 2.0
    )
    return values, valid
