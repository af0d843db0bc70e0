"""PLINK files of one chromosome of individual-level data, made on the card.

The model of ``chip_smoke.py``'s ``write_genome_fileset`` (itself that of
``bench.py``'s block): a marker's liability is an AR(1) chain along the
chromosome with lag-one correlation ``ld_ar1``, each chromosome starting
from the stationary state; each of an individual's two allele copies is 1
with probability sigmoid(``logit_scale`` x liability); every trait is
standard normal noise plus ``effect`` x the standardised genotypes of its
``planted_per_trait`` markers, and is then standardised. The planted
markers are one uniform draw over the markers that the traffic's
``layout_seed`` fixes, dealt to the traits in an order drawn from the seed:
every seed plants the same set, so that the seed changes the data and not
the sizes of the work. Within a chunk of rows the chain is one product with
the lower-triangular matrix of the AR weights. The genotypes are packed on
the card, so that only ``.bed`` bytes cross to the host.

Traffic keys: ``markers`` (on one chromosome "1"), ``chunk`` (rows a
product), ``layout_seed``. Configuration keys: ``individuals``, ``traits``,
``ld_ar1``, ``logit_scale``, ``planted_per_trait``, ``effect``.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch

BED_MAGIC = bytes([0x6C, 0x1B, 0x01])


def pack(G: torch.Tensor) -> torch.Tensor:
    """(rows, n) uint8 genotypes in {0, 1, 2} -> packed marker-major
    ``.bed`` rows (codes 11, 10, 00, the first sample in the lowest bits)."""
    codes = 3 - G - (G == 2).to(torch.uint8)
    pad = (-codes.shape[1]) % 4
    if pad:
        codes = torch.cat([codes, codes.new_zeros(len(codes), pad)], dim=1)
    c = codes.view(len(codes), -1, 4)
    return c[:, :, 0] | (c[:, :, 1] << 2) | (c[:, :, 2] << 4) | (c[:, :, 3] << 6)


def planted_markers(m: int, p: int, k: int, layout_seed: int, rng) -> list:
    """[(trait, marker)]: k markers a trait from one fixed uniform draw of
    p x k markers, the traits' shares dealt in the order rng draws."""
    layout = np.random.default_rng(layout_seed).integers(0, m, (p, k))
    return [(t, int(j)) for t, row in zip(rng.permutation(p), layout) for j in row]


def write_phen(path: str, Y: np.ndarray) -> None:
    """A ``.phen`` of traits Y (p, n): header, two id columns, %.6f values."""
    p, n = Y.shape
    body = np.char.mod("%.6f", Y.T)
    with open(path, "w") as f:
        f.write("FID\tIID\t" + "\t".join(f"T{t}" for t in range(p)) + "\n")
        f.writelines(f"F{i}\tI{i}\t" + "\t".join(body[i]) + "\n" for i in range(n))


def generate(cfg: dict, traffic: dict, seed: int, workdir: str, device) -> dict:
    """Writes ``sim.bed/.bim/.fam/.phen`` under workdir; returns {stem,
    markers, individuals, traits, planted [(trait, marker)]}."""
    m, n, p = traffic["markers"], cfg["individuals"], cfg["traits"]
    chunk = traffic.get("chunk", 1024)
    ar = cfg["ld_ar1"]
    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    rng = np.random.default_rng(seed)
    planted = planted_markers(m, p, cfg["planted_per_trait"], traffic["layout_seed"], rng)
    wanted = sorted({k for _, k in planted})
    prev_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    i = torch.arange(chunk, dtype=torch.float64, device=dev)
    W = (math.sqrt(1 - ar**2) * ar ** (i[:, None] - i[None, :]).clamp(min=0)).tril().float()
    carry = (ar ** (i + 1)).float()
    rows_of = {}
    stem = os.path.join(workdir, "sim")
    try:
        with open(stem + ".bed", "wb") as f:
            f.write(BED_MAGIC)
            acc = torch.randn(n, generator=gen, device=dev)
            for r0 in range(0, m, chunk):
                k = min(chunk, m - r0)
                z = torch.randn((k, n), generator=gen, device=dev)
                X = torch.addmm(carry[:k, None] * acc[None, :], W[:k, :k], z)
                acc = X[-1]
                pfreq = torch.sigmoid(cfg["logit_scale"] * X)
                G = (torch.rand((k, n), generator=gen, device=dev) < pfreq).to(torch.uint8)
                G += (torch.rand((k, n), generator=gen, device=dev) < pfreq).to(torch.uint8)
                for j in wanted:
                    if r0 <= j < r0 + k:
                        rows_of[j] = G[j - r0].double()
                f.write(pack(G).cpu().numpy().tobytes())
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev_tf32
    with open(stem + ".bim", "w") as f:
        f.writelines(f"1\trs{i}\t0\t{100 * i}\tA\tG\n" for i in range(m))
    with open(stem + ".fam", "w") as f:
        f.writelines(f"F{i} I{i} 0 0 0 -9\n" for i in range(n))
    Y = torch.randn((p, n), generator=gen, device=dev, dtype=torch.float64)
    for t, j in planted:
        g = rows_of[j]
        Y[t] += cfg["effect"] * (g - g.mean()) / g.std(unbiased=False)
    Y = (Y - Y.mean(1, keepdim=True)) / Y.std(1, unbiased=False, keepdim=True)
    write_phen(stem + ".phen", Y.cpu().numpy())
    return {"stem": stem, "markers": m, "individuals": n, "traits": p, "planted": planted}
