"""A merged, time-indexed summary-statistic input of risk factors and the
diseases they cause, as the files that ``ci-gwas-torch cuskss
--marker-indices ... --time-index ...`` reads, made from the seed on the card.

The traits follow a linear SEM with unit-variance noise (the reference's
``simulate_dag.R``): ``risk_factors`` risk factors, each caused by
``rf_planted`` markers at ``marker_effect``, every such marker acting on
``pleiotropy`` distinct risk factors; ``diseases`` diseases, each caused by
``disease_parents`` risk factors at ``rf_to_disease`` and by
``disease_direct`` markers of its own at ``marker_effect``. The markers are
standardised with the AR(1) correlation ``ld_ar1``^|i - j| along the
merged markers, the planted ones on an even grid, far apart. The marker -
trait and trait - trait correlations are the SEM's exact population
correlations; every marker - trait entry also gets N(0, 1 / ``gwas_samples``)
noise, which along the merged markers follows their AR(1) LD, as the
sampling errors of summary statistics do (independent noise in markers of
high LD gives partial correlations given a neighbour ~2.5 times its spread,
and spurious edges). The marker - trait tables have ``table_rows`` rows, of
which the ``markers`` rows of ``marker_ixs.bin`` (ascending, drawn from the
seed) hold the merged markers in order and the others independent noise
only. Standard errors
give every marker - trait and trait - trait entry an effective sample size
uniform in [``ess_low``, ``ess_high``], as :mod:`h100bench.generators.sumstats`
makes them. ``time_index.txt`` puts the risk factors at 1, the diseases at 2
(the markers are at 0). The layout (which markers act on which risk factors,
which risk factors cause which disease) is fixed by the traffic's
``layout_seed``, so every seed has the same shape of work; the seed draws
the selected rows, the noise and the standard errors.

Traffic keys: ``markers``, ``table_rows``, ``layout_seed``. Configuration
keys: ``risk_factors``, ``diseases``, ``rf_planted``, ``pleiotropy``,
``marker_effect``, ``disease_parents``, ``rf_to_disease``,
``disease_direct``, ``ld_ar1``, ``gwas_samples``, ``ess_low``, ``ess_high``.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch

from h100bench.generators.sumstats import _table

#: The configuration and traffic keys that cut the input to a CPU test's
#: size: 4 risk factors and 2 diseases over 500 markers merged from 600 rows.
SMALL = {"risk_factors": 4, "diseases": 2, "rf_planted": 4, "disease_parents": 3,
         "disease_direct": 2}
SMALL_TRAFFIC = {"markers": 500, "table_rows": 600}


def _pleiotropic(rng, traits: int, per_trait: int, ways: int) -> np.ndarray:
    """(traits x per_trait / ways, ways) trait indices: each row the traits
    one marker acts on, all distinct, each trait in per_trait rows."""
    deal = rng.permutation(np.repeat(np.arange(traits), per_trait)).reshape(-1, ways)
    for _ in range(100 * len(deal)):
        bad = [r for r in range(len(deal)) if len(set(deal[r])) < ways]
        if not bad:
            return deal
        r, s = bad[0], int(rng.integers(len(deal)))
        i, j = int(rng.integers(ways)), int(rng.integers(ways))
        a, b = deal[r].copy(), deal[s].copy()
        a[i], b[j] = b[j], a[i]
        if s != r and len(set(a)) == ways and len(set(b)) == ways:
            deal[r], deal[s] = a, b
    raise ValueError("no pleiotropic layout found")


def layout(cfg: dict, m: int, layout_seed: int) -> dict:
    """The SEM's fixed shape: ``effects`` {trait: [(marker, effect)]}, the
    markers acting on each trait directly; ``parents`` {disease: its risk
    factors}; the planted ``positions``, ascending."""
    rng = np.random.default_rng(layout_seed)
    nr, nd = cfg["risk_factors"], cfg["diseases"]
    deal = _pleiotropic(rng, nr, cfg["rf_planted"], cfg["pleiotropy"])
    slots = len(deal) + nd * cfg["disease_direct"]
    if slots > m:
        raise ValueError(f"{slots} planted markers do not fit {m} markers")
    step = m // slots
    grid = rng.permutation(step * np.arange(slots) + step // 2)
    effects: dict = {t: [] for t in range(nr + nd)}
    b = cfg["marker_effect"]
    for k, traits in enumerate(deal):
        for t in traits:
            effects[int(t)].append((int(grid[k]), b))
    for d in range(nd):
        for k in grid[len(deal) + d * cfg["disease_direct"]:][:cfg["disease_direct"]]:
            effects[nr + d].append((int(k), b))
    parents = {nr + d: sorted(int(j) for j in rng.choice(nr, cfg["disease_parents"],
                                                          replace=False))
               for d in range(nd)}
    return {"effects": effects, "parents": parents, "positions": np.sort(grid)}


def population(cfg: dict, m: int, lay: dict, device) -> tuple:
    """(corr_xy (m, traits), corr_yy (traits, traits)) float64 on device: the
    SEM's exact correlations of the markers with the traits and among the
    traits. Y = A Y + B X + E: Cov(Y) = L (B S B' + I) L', Cov(X, Y) = S B' L'
    with L = (I - A)^-1 and S the markers' AR(1) correlation."""
    dev = torch.device(device)
    ar = cfg["ld_ar1"]
    nr, nd = cfg["risk_factors"], cfg["diseases"]
    p = nr + nd
    pos = torch.as_tensor(lay["positions"], dtype=torch.float64, device=dev)
    col = {int(k): i for i, k in enumerate(lay["positions"])}
    B = torch.zeros((p, pos.numel()), dtype=torch.float64, device=dev)
    for t, eff in lay["effects"].items():
        for k, e in eff:
            B[t, col[k]] += e
    A = torch.zeros((p, p), dtype=torch.float64, device=dev)
    for d, pa in lay["parents"].items():
        A[d, pa] = cfg["rf_to_disease"]
    L = torch.linalg.inv(torch.eye(p, dtype=torch.float64, device=dev) - A)
    S_pp = ar ** (pos[:, None] - pos[None, :]).abs()
    cov_yy = L @ (B @ S_pp @ B.T + torch.eye(p, dtype=torch.float64, device=dev)) @ L.T
    ii = torch.arange(m, dtype=torch.float64, device=dev)
    cov_xy = (ar ** (ii[:, None] - pos[None, :]).abs()) @ B.T @ L.T
    sd = torch.sqrt(torch.diagonal(cov_yy))
    return cov_xy / sd[None, :], cov_yy / (sd[:, None] * sd[None, :])


def _ar1(xi: torch.Tensor, ar: float, gen, chunk: int = 1024) -> torch.Tensor:
    """Unit-variance AR(1) noise down the rows of xi (rows, cols) of
    standard normals: e_i = ar e_(i-1) + sqrt(1 - ar^2) xi_i from a
    stationary start, a chunk of rows at a time as one product with the
    lower-triangular matrix of the AR weights."""
    dev = xi.device
    prev = torch.randn((1, xi.shape[1]), generator=gen, device=dev, dtype=xi.dtype)
    out = torch.empty_like(xi)
    for r0 in range(0, xi.shape[0], chunk):
        x = xi[r0:r0 + chunk]
        i = torch.arange(x.shape[0], device=dev)
        lag = i[:, None] - i[None, :]
        W = torch.where(lag >= 0, ar ** lag.clamp(min=0).to(xi.dtype), 0.0)
        out[r0:r0 + chunk] = math.sqrt(1 - ar * ar) * (W @ x) + ar ** (i[:, None] + 1.0) * prev
        prev = out[r0 + x.shape[0] - 1:r0 + x.shape[0]]
    return out


def _write_mxm(path: str, m: int, ar: float, dev) -> None:
    """The AR(1) correlations of m markers as the binary float32 lower
    triangle, row by row with the diagonal."""
    powers = ar ** torch.arange(m, dtype=torch.float64, device=dev)
    with open(path, "wb") as f:
        for r0 in range(0, m, 1024):
            rows = torch.arange(r0, min(m, r0 + 1024), device=dev)
            lag = rows[:, None] - torch.arange(m, device=dev)[None, :]
            vals = powers[lag.clamp(min=0)].float()
            f.write(vals[lag >= 0].cpu().numpy().tobytes())


def generate(cfg: dict, traffic: dict, seed: int, workdir: str, device) -> dict:
    """Writes ``mxm.bin``, ``mxp.txt``, ``mxp_se.txt``, ``pxp.txt``,
    ``pxp_se.txt``, ``marker_ixs.bin`` and ``time_index.txt`` under workdir;
    returns their paths, the sizes and the layout."""
    m, rows = traffic["markers"], traffic["table_rows"]
    nr, nd = cfg["risk_factors"], cfg["diseases"]
    p = nr + nd
    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    rng = np.random.default_rng(seed)
    lay = layout(cfg, m, traffic["layout_seed"])
    files = {k: os.path.join(workdir, f) for k, f in (
        ("mxm", "mxm.bin"), ("mxp", "mxp.txt"), ("mxp_se", "mxp_se.txt"),
        ("pxp", "pxp.txt"), ("pxp_se", "pxp_se.txt"), ("marker_ixs", "marker_ixs.bin"),
        ("time_index", "time_index.txt"))}
    _write_mxm(files["mxm"], m, cfg["ld_ar1"], dev)
    ixs = np.sort(rng.choice(rows, m, replace=False)).astype(np.int32)
    ixs.tofile(files["marker_ixs"])
    corr_xy, corr_yy = population(cfg, m, lay, dev)
    mxp = torch.randn((rows, p), generator=gen, device=dev, dtype=torch.float64)
    sel = torch.from_numpy(ixs.astype(np.int64)).to(dev)
    mxp[sel] = _ar1(mxp[sel], cfg["ld_ar1"], gen)  # the merged markers' noise follows their LD
    mxp /= np.sqrt(cfg["gwas_samples"])
    mxp[sel] += corr_xy
    lo, hi = cfg["ess_low"], cfg["ess_high"]

    def se_of(r: torch.Tensor) -> torch.Tensor:
        ess = lo + (hi - lo) * torch.rand(r.shape, generator=gen, device=dev, dtype=torch.float64)
        return (1.0 - r**2) / torch.sqrt(ess)

    mxp = mxp.float().double()
    mxp_se = se_of(mxp).float()
    pxp = corr_yy.float().double()
    pxp_se = se_of(pxp)
    pxp_se = torch.triu(pxp_se) + torch.triu(pxp_se, 1).T
    pxp_se.fill_diagonal_(1.0)  # r = 1 has no standard error; the diagonal is never read
    traits = [f"RF{t}" for t in range(nr)] + [f"D{d}" for d in range(nd)]
    snps = [f"1 rs{i} A" for i in range(rows)]
    head = "chr snp ref " + " ".join(traits)
    _table(files["mxp"], head, snps, mxp.float().cpu().numpy())
    _table(files["mxp_se"], head, snps, mxp_se.cpu().numpy())
    _table(files["pxp"], " ".join(traits), traits, pxp.float().cpu().numpy())
    _table(files["pxp_se"], " ".join(traits), traits, pxp_se.float().cpu().numpy())
    with open(files["time_index"], "w") as f:
        f.write("1\n" * nr + "2\n" * nd)
    return {**files, "markers": m, "traits": p, "layout": lay}
