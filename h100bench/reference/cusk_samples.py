"""The reference of one block's two-stage solve at a biobank's sample size.

The solve of :mod:`h100bench.reference.cusk`, stage for stage, with the
panel built by chunks of samples (:mod:`h100bench.reference.panel_samples`)
in place of ``panel.panel``, whose (3, m, n) indicators and (m, n) codes do
not fit a card at 500,000 samples.
"""

from __future__ import annotations

import numpy as np
import torch

from h100bench.reference import panel, panel_samples, reduce, skeleton
from h100bench.reference.cusk import ML


def solve(bed: str, phen: str, num_markers: int, num_samples: int, cfg: dict, device,
          dtype=torch.float64) -> dict:
    """{ixs, G, C, S, num_phen} of the block in files bed and phen."""
    Y = panel.read_phen(phen)
    C = panel_samples.panel(bed, num_markers, num_samples, Y, dtype, device)
    m, p = num_markers, Y.shape[0]
    n, alpha, depth = num_samples, cfg["alpha"], cfg["depth"]
    G1, _ = skeleton.skeleton(C, n, alpha, cfg["max_level"], max(1, cfg["max_level"]))
    keep = reduce.kept(G1, m, depth)
    keep_t = torch.from_numpy(keep).to(C.device)
    C1 = C[keep_t][:, keep_t]
    del C
    G2, S2 = skeleton.skeleton(C1, n, alpha, cfg["max_level_two"],
                               max(1, min(ML, cfg["max_level_two"])))
    keep2 = reduce.kept(G2, keep.size - p, depth)
    k2 = torch.from_numpy(keep2).to(C1.device)
    return {
        "num_phen": p,
        "ixs": keep[keep2],
        "G": G2[np.ix_(keep2, keep2)],
        "C": C1[k2][:, k2].double().cpu().numpy(),
        "S": reduce.sepsets(S2, keep2, ML),
    }
