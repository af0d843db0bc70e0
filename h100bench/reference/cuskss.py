"""The reference of a summary-statistic input's two-stage solve (hetcor).

The panel is the input's correlations, [markers, traits]: the binary lower
triangle of the markers (missing entries 0), the marker - trait and the
upper triangle of the trait - trait table. Effective sample sizes: the
GWAS sample size between markers, ((1 - r^2) / se)^2 elsewhere. Markers are
at time 0 and traits at time 1. Stage 1 runs the hetcor skeleton to
``max_level`` from the complete graph; the traits and the markers within
``depth`` of them are kept; stage 2 runs it to ``max_level_two`` from
stage 1's kept adjacency; the same reduction of its result is the output.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from h100bench.reference import reduce, skeleton


def _rows(path: str, lead: int) -> np.ndarray:
    with open(path) as f:
        next(f)
        return np.array([[math.nan if v in ("NA", "NaN", "nan", "NAN") else float(v)
                          for v in line.split()[lead:]] for line in f if line.strip()])


def panels(files: dict, m: int, gwas_samples: float, device, dtype):
    """(C, N) (v, v) of the input's files."""
    tril = np.fromfile(files["mxm"], dtype=np.float32).astype(np.float64)
    mxp, mxp_se = _rows(files["mxp"], 3), _rows(files["mxp_se"], 3)
    pxp, pxp_se = _rows(files["pxp"], 1), _rows(files["pxp_se"], 1)
    p = pxp.shape[0]
    v = m + p
    C = np.ones((v, v))
    r, c = np.tril_indices(m)
    C[r, c] = C[c, r] = np.nan_to_num(tril)
    C[:m, m:], C[m:, :m] = np.nan_to_num(mxp), np.nan_to_num(mxp).T
    up = np.triu(np.nan_to_num(pxp), 1)
    C[m:, m:] = up + up.T + np.diag(np.diag(pxp))
    N = np.full((v, v), gwas_samples)
    ess_mp = ((1 - mxp**2) / mxp_se) ** 2
    ess_pp = np.triu(((1 - pxp**2) / pxp_se) ** 2, 1)
    N[:m, m:], N[m:, :m] = ess_mp, ess_mp.T
    N[m:, m:] = ess_pp + ess_pp.T
    return (torch.from_numpy(C).to(device, dtype), torch.from_numpy(N).to(device, dtype), p)


def solve(files: dict, m: int, cfg: dict, device, dtype=torch.float64) -> dict:
    """{ixs, G, C, S None, num_phen} of the input in files."""
    C, N, p = panels(files, m, cfg["gwas_samples"], device, dtype)
    t = torch.cat([torch.zeros(m), torch.ones(p)]).to(device, dtype)
    G = np.ones((m + p, m + p), dtype=bool)
    G1 = skeleton.hetcor_skeleton(C, N, G, t, cfg["alpha"], cfg["max_level"])
    keep = reduce.kept(G1, m, cfg["depth"])
    k = torch.from_numpy(keep).to(device)
    C1, N1, t1 = C[k][:, k], N[k][:, k], t[k]
    G2 = skeleton.hetcor_skeleton(C1, N1, G1[np.ix_(keep, keep)], t1, cfg["alpha"],
                                  cfg["max_level_two"])
    keep2 = reduce.kept(G2, keep.size - p, cfg["depth"])
    k2 = torch.from_numpy(keep2).to(device)
    return {"num_phen": p, "ixs": keep[keep2], "G": G2[np.ix_(keep2, keep2)],
            "C": C1[k2][:, k2].double().cpu().numpy(), "S": None}
