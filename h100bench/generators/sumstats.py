"""A summary-statistic input as the files ``ci-gwas-torch cuskss`` reads.

The input of ``chip_smoke.py``'s ``write_sumstats`` (``bench.py``'s cuskss
phase), made from the seed on the card: the marker correlations are the
AR(1) ``ld_ar1``^|i - j|, stored as the binary float32 lower triangle, row
by row with the diagonal; each trait's marker correlations are
N(0, 1 / ``gwas_samples``) noise plus ``effect`` x ``ld_ar1``^|i - k| around
each of its ``planted_per_trait`` markers k (one fixed uniform draw, the
traffic's ``layout_seed``, dealt to the traits in an order drawn from the
seed: every seed plants the same set); the traits
correlate ``trait_corr`` with each other; every marker - trait and trait -
trait entry has a standard error that gives it an effective sample size
uniform in [``ess_low``, ``ess_high``], N = ((1 - r^2) / se)^2. One block
covers all markers. Tables are written with ``%.9e``, which a float32 value
survives.

Traffic keys: ``markers``, ``layout_seed``. Configuration keys:
``traits``, ``ld_ar1``, ``gwas_samples``, ``planted_per_trait``,
``effect``, ``trait_corr``, ``ess_low``, ``ess_high``.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from h100bench.generators.ar1_block import planted_markers


def _table(path: str, head: str, names: list, tab: np.ndarray) -> None:
    body = np.char.mod("%.9e", tab)
    with open(path, "w") as f:
        f.write(head + "\n")
        f.writelines(f"{names[i]} " + " ".join(body[i]) + "\n" for i in range(len(tab)))


def generate(cfg: dict, traffic: dict, seed: int, workdir: str, device) -> dict:
    """Writes ``mxm.bin``, ``mxp.txt``, ``mxp_se.txt``, ``pxp.txt``,
    ``pxp_se.txt`` and ``ss.blocks`` under workdir; returns their paths,
    the sizes and the planted [(trait, marker)]."""
    m, p, ar = traffic["markers"], cfg["traits"], cfg["ld_ar1"]
    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    rng = np.random.default_rng(seed)
    planted = planted_markers(m, p, cfg["planted_per_trait"], traffic["layout_seed"], rng)
    files = {k: os.path.join(workdir, f) for k, f in (
        ("mxm", "mxm.bin"), ("mxp", "mxp.txt"), ("mxp_se", "mxp_se.txt"),
        ("pxp", "pxp.txt"), ("pxp_se", "pxp_se.txt"), ("blocks", "ss.blocks"))}
    powers = ar ** torch.arange(m, dtype=torch.float64, device=dev)
    with open(files["mxm"], "wb") as f:
        for r0 in range(0, m, 1024):
            rows = torch.arange(r0, min(m, r0 + 1024), device=dev)
            lag = rows[:, None] - torch.arange(m, device=dev)[None, :]
            vals = powers[lag.clamp(min=0)].float()
            f.write(vals[lag >= 0].cpu().numpy().tobytes())  # row-major lower triangle
    ii = torch.arange(m, dtype=torch.float64, device=dev)
    mxp = torch.randn((m, p), generator=gen, device=dev, dtype=torch.float64)
    mxp /= np.sqrt(cfg["gwas_samples"])
    for t, k in planted:
        mxp[:, t] += cfg["effect"] * ar ** (ii - k).abs()
    lo, hi = cfg["ess_low"], cfg["ess_high"]

    def se_of(r: torch.Tensor) -> torch.Tensor:
        ess = lo + (hi - lo) * torch.rand(r.shape, generator=gen, device=dev, dtype=torch.float64)
        return (1.0 - r**2) / torch.sqrt(ess)

    mxp = mxp.float().double()
    mxp_se = se_of(mxp).float()
    pxp = torch.full((p, p), cfg["trait_corr"], dtype=torch.float64, device=dev)
    pxp.fill_diagonal_(1.0)
    pxp_se = se_of(pxp)
    pxp_se = torch.triu(pxp_se) + torch.triu(pxp_se, 1).T
    pxp_se.fill_diagonal_(1.0)  # r = 1 has no standard error; the diagonal is never read
    traits = [f"T{t}" for t in range(p)]
    snps = [f"1 rs{i} A" for i in range(m)]
    head = "chr snp ref " + " ".join(traits)
    _table(files["mxp"], head, snps, mxp.float().cpu().numpy())
    _table(files["mxp_se"], head, snps, mxp_se.cpu().numpy())
    _table(files["pxp"], " ".join(traits), traits, pxp.float().cpu().numpy())
    _table(files["pxp_se"], " ".join(traits), traits, pxp_se.float().cpu().numpy())
    with open(files["blocks"], "w") as f:
        f.write(f"1\t0\t{m - 1}\n")
    return {**files, "markers": m, "traits": p, "planted": planted}
