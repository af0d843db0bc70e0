"""The correlation panel of a block of individual-level data.

- genotypes from the PLINK ``.bed`` bytes: per sample two bits, the first
  sample in the lowest bits, 00 two copies of the first allele, 10 one, 11
  none, 01 missing;
- marker - marker: Kendall's tau-b of the 3 x 3 genotype contingency table
  over the samples where both are present, mapped to a Pearson correlation
  by sin(pi / 2 tau);
- marker - trait: Pearson's r over the samples where both are present, the
  marker's mean and standard deviation (divided by the count) taken over
  its present samples;
- trait - trait: the mean product of the standardised traits over the
  samples where both are present.

Variables are ordered [markers, traits]; the diagonal is 1. The counts are
float32 products of 0/1 indicators with TF32 off, exact below 2^24
samples; everything after them runs in the requested dtype.
"""

from __future__ import annotations

import math

import numpy as np
import torch

# markers per block of rows of the contingency products
ROWS = 2048


def read_bed(path: str, num_markers: int, num_samples: int, device) -> torch.Tensor:
    """(m, n) int8 genotypes (copies of the first allele, -1 missing) of a
    marker-major ``.bed``."""
    raw = np.fromfile(path, dtype=np.uint8)
    if raw[:3].tolist() != [0x6C, 0x1B, 0x01]:
        raise ValueError(f"{path}: not a marker-major .bed")
    per = -(-num_samples // 4)
    b = torch.from_numpy(raw[3:].reshape(num_markers, per)).to(device)
    codes = torch.stack([(b >> s) & 3 for s in (0, 2, 4, 6)], dim=-1).reshape(num_markers, -1)
    lut = torch.tensor([2, -1, 1, 0], dtype=torch.int8, device=device)
    return lut[codes[:, :num_samples].long()]


def read_phen(path: str) -> np.ndarray:
    """(p, n) float64 traits of a ``.phen`` (header, two id columns, NA
    missing)."""
    with open(path) as f:
        next(f)
        rows = [[math.nan if v == "NA" else float(v) for v in line.split()[2:]]
                for line in f if line.strip()]
    return np.array(rows, dtype=np.float64).T


def _indicators(G: torch.Tensor) -> torch.Tensor:
    """(3, m, n) float32 indicators of genotype 0, 1, 2."""
    return torch.stack([(G == g) for g in (0, 1, 2)]).float()


def kendall_npn(G: torch.Tensor, dtype) -> torch.Tensor:
    """(m, m) sin(pi/2 tau_b) of every marker pair."""
    m = G.shape[0]
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        X = _indicators(G)  # (3, m, n)
        out = torch.empty((m, m), dtype=dtype, device=G.device)
        for r0 in range(0, m, ROWS):
            r1 = min(m, r0 + ROWS)
            # n[a][b]: samples with genotype a at the row marker, b at the column marker
            n = [[(X[a, r0:r1] @ X[b].T).to(torch.float64) for b in range(3)] for a in range(3)]
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
            out[r0:r1] = torch.sin(math.pi / 2 * tau)
        return out
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def panel(G: torch.Tensor, Y: np.ndarray, dtype=torch.float64) -> torch.Tensor:
    """(m + p, m + p) panel of genotypes G (m, n) and traits Y (p, n)."""
    dev = G.device
    m, p = G.shape[0], Y.shape[0]
    C = torch.empty((m + p, m + p), dtype=dtype, device=dev)
    C[:m, :m] = kendall_npn(G, dtype)
    present = (G >= 0).to(torch.float64)
    g = G.to(torch.float64) * present
    cnt = present.sum(1, keepdim=True)
    mean = g.sum(1, keepdim=True) / cnt
    std = torch.sqrt((((g - mean) * present) ** 2).sum(1, keepdim=True) / cnt)
    y = torch.from_numpy(Y).to(dev)
    y_ok = torch.isfinite(y).to(torch.float64)
    y0 = torch.nan_to_num(y)
    mp = (((g - mean) * present) @ y0.T) / ((present @ y_ok.T) * std)
    C[:m, m:] = mp.to(dtype)
    C[m:, :m] = mp.T.to(dtype)
    C[m:, m:] = ((y0 @ y0.T) / (y_ok @ y_ok.T)).to(dtype)
    C.fill_diagonal_(1.0)
    return C
