"""The reference of a merged, time-indexed summary-statistic input's
two-stage solve (hetcor).

The merged markers are the rows of the marker - trait tables that
``marker_ixs.bin`` names, in its order; the binary lower triangle holds
their correlations. The panel is built from them as
:func:`h100bench.reference.cuskss.panels` builds it. The time index puts
the markers at 0 and each trait at its line of the time-index file; the
hetcor skeleton never conditions a pair on a variable later than both of
its ends. Then the two stages and their reductions, as
:func:`h100bench.reference.cuskss.solve` runs them.
"""

from __future__ import annotations

import numpy as np
import torch

from h100bench.reference import reduce, skeleton
from h100bench.reference.cuskss import _rows


def panels(files: dict, gwas_samples: float, device, dtype):
    """(C, N, m, p): the (v, v) correlation and ESS panels of the merged
    input in files, its markers and traits."""
    ixs = np.fromfile(files["marker_ixs"], dtype=np.int32).astype(np.int64)
    tril = np.fromfile(files["mxm"], dtype=np.float32).astype(np.float64)
    m = ixs.size
    if m * (m + 1) // 2 != tril.size:
        raise ValueError(f"{ixs.size} marker indices, a triangle of {tril.size}")
    mxp, mxp_se = _rows(files["mxp"], 3)[ixs], _rows(files["mxp_se"], 3)[ixs]
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
    return (torch.from_numpy(C).to(device, dtype), torch.from_numpy(N).to(device, dtype), m, p)


def time_index(path: str, m: int) -> np.ndarray:
    """(m + p,) times: the markers at 0, then the file's one a trait."""
    with open(path) as f:
        traits = [int(line) for line in f if line.strip()]
    return np.concatenate([np.zeros(m), np.array(traits, dtype=np.float64)])


def solve(files: dict, cfg: dict, device, dtype=torch.float64) -> dict:
    """{ixs, G, C, S None, num_phen} of the merged input in files."""
    C, N, m, p = panels(files, cfg["gwas_samples"], device, dtype)
    t = torch.from_numpy(time_index(files["time_index"], m)).to(device, dtype)
    if t.numel() != m + p:
        raise ValueError(f"{t.numel() - m} times for {p} traits")
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
