"""The correlation panel of a block of individual-level data, built by
chunks of samples, so that a block of a biobank's size fits a card.

The panel is that of :mod:`h100bench.reference.panel`, whose definitions
hold here. Only the order of the work differs: each chunk of samples is
decoded from the ``.bed`` bytes on its own, and its sums are added into the
block's totals.

- the 3 x 3 genotype contingency counts of every marker pair: a product of
  the chunk's float32 0/1 indicators with TF32 off, exact below 2^24
  samples a chunk, added into float64 totals;
- each marker's count of present samples, sum and sum of squares, and its
  products with the traits over the samples where both are present: float64
  sums a chunk.

Kendall's tau-b, each marker's mean and standard deviation (divided by the
count) and the correlations then follow from the totals, the marker pairs
and the marker - trait pairs in the requested dtype as in ``panel``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from h100bench.reference.panel import ROWS

# samples a chunk: a multiple of 4, so that a chunk starts on a byte
CHUNK = 1 << 16
# genotype of each 2-bit code: 00 two copies of the first allele, 01 missing,
# 10 one copy, 11 none
CODE_GENOTYPE = (2, -1, 1, 0)


def _byte_genotypes(device) -> torch.Tensor:
    """(256, 4) int8: the genotypes of the four samples of each byte, the
    first sample in the lowest bits."""
    codes = np.arange(256)[:, None] >> np.array([0, 2, 4, 6]) & 3
    return torch.tensor(np.array(CODE_GENOTYPE, dtype=np.int8)[codes], device=device)


def read_bed_chunks(path: str, num_markers: int, num_samples: int, device,
                    chunk: int = CHUNK):
    """Yields (s0, G): the (m, k) int8 genotypes (copies of the first allele,
    -1 missing) of samples [s0, s0 + k) of a marker-major ``.bed``, chunk by
    chunk."""
    if chunk % 4:
        raise ValueError(f"a chunk of {chunk} samples does not start on a byte")
    raw = np.memmap(path, dtype=np.uint8, mode="r")
    if raw[:3].tolist() != [0x6C, 0x1B, 0x01]:
        raise ValueError(f"{path}: not a marker-major .bed")
    per = -(-num_samples // 4)
    body = raw[3 : 3 + num_markers * per].reshape(num_markers, per)
    lut = _byte_genotypes(device)
    for s0 in range(0, num_samples, chunk):
        k = min(chunk, num_samples - s0)
        b = torch.from_numpy(np.array(body[:, s0 // 4 : -(-(s0 + k) // 4)]))
        yield s0, lut[b.to(device).long()].reshape(num_markers, -1)[:, :k]


def _tau(n: list, dtype) -> torch.Tensor:
    """sin(pi/2 tau_b) from the 3 x 3 float64 counts n[a][b] (rows of markers
    with genotype a against columns with genotype b), in the arithmetic and
    order of ``panel.kendall_npn``."""
    conc = disc = tie_x = tie_y = 0
    for a in range(3):
        for b in range(3):
            for a2 in range(a, 3):
                for b2 in range(3):
                    if a2 == a and b2 <= b:
                        continue
                    prod = n[a][b] * n[a2][b2]
                    if a2 > a and b2 > b:
                        conc = conc + prod
                    elif a2 > a and b2 < b:
                        disc = disc + prod
                    elif a2 == a:
                        tie_x = tie_x + prod  # same x, y differs
                    else:
                        tie_y = tie_y + prod  # same y, x differs
    conc, disc, tie_x, tie_y = (t.to(dtype) for t in (conc, disc, tie_x, tie_y))
    tau = (conc - disc) / torch.sqrt((conc + disc + tie_x) * (conc + disc + tie_y))
    return torch.sin(math.pi / 2 * tau)


def panel(bed: str, num_markers: int, num_samples: int, Y: np.ndarray,
          dtype=torch.float64, device="cpu", chunk: int | None = None) -> torch.Tensor:
    """(m + p, m + p) panel of the m markers of the ``.bed`` at path bed over
    num_samples samples and traits Y (p, n), on device, by chunks of
    ``chunk`` samples (default ``CHUNK``)."""
    dev = torch.device(device)
    chunk = chunk or CHUNK
    m, p = num_markers, Y.shape[0]
    y = torch.from_numpy(Y).to(dev)
    y_ok = torch.isfinite(y).to(torch.float64)
    y0 = torch.nan_to_num(y)
    counts = torch.zeros((3 * m, 3 * m), dtype=torch.float64, device=dev)
    cnt, s1, s2 = (torch.zeros((m, 1), dtype=torch.float64, device=dev) for _ in range(3))
    gy, py, pv = (torch.zeros((m, p), dtype=torch.float64, device=dev) for _ in range(3))
    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        for s0, G in read_bed_chunks(bed, m, num_samples, dev, chunk):
            # rows [a * m, (a + 1) * m): the indicators of genotype a
            X = torch.cat([(G == g) for g in (0, 1, 2)]).float()
            counts.add_(X @ X.T)
            del X
            present = (G >= 0).to(torch.float64)
            g = G.to(torch.float64) * present
            cnt += present.sum(1, keepdim=True)
            s1 += g.sum(1, keepdim=True)
            s2 += (g * g).sum(1, keepdim=True)
            ys, oks = y0[:, s0 : s0 + G.shape[1]], y_ok[:, s0 : s0 + G.shape[1]]
            gy += g @ ys.T
            py += present @ ys.T
            pv += present @ oks.T
            del present, g
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
    C = torch.empty((m + p, m + p), dtype=dtype, device=dev)
    for r0 in range(0, m, ROWS):
        r1 = min(m, r0 + ROWS)
        n = [[counts[a * m + r0 : a * m + r1, b * m : (b + 1) * m] for b in range(3)]
             for a in range(3)]
        C[r0:r1, :m] = _tau(n, dtype)
    del counts
    mean = s1 / cnt
    # sum over present samples of (g - mean)^2 = s2 - mean s1
    std = torch.sqrt((s2 - mean * s1) / cnt)
    mp = (gy - mean * py) / (pv * std)
    C[:m, m:] = mp.to(dtype)
    C[m:, :m] = mp.T.to(dtype)
    C[m:, m:] = ((y0 @ y0.T) / (y_ok @ y_ok.T)).to(dtype)
    C.fill_diagonal_(1.0)
    return C
