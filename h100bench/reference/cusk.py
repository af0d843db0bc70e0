"""The reference of one block's two-stage solve (individual-level data).

Stage 1 runs the skeleton to ``max_level`` over the block's panel; the
traits and the markers within ``depth`` of them are kept; stage 2 runs the
skeleton to ``max_level_two`` over the kept variables' panel, from level 0
again; the same reduction of its result, with its separation sets at the
stride ``ML``, is the output. Indices are the block's variables [markers,
traits].
"""

from __future__ import annotations

import numpy as np
import torch

from h100bench.reference import panel, reduce, skeleton

ML = 14


def solve(bed: str, phen: str, num_markers: int, num_samples: int, cfg: dict, device,
          dtype=torch.float64) -> dict:
    """{ixs, G, C, S, num_phen} of the block in files bed and phen."""
    G_geno = panel.read_bed(bed, num_markers, num_samples, device)
    Y = panel.read_phen(phen)
    C = panel.panel(G_geno, Y, dtype)
    del G_geno
    m, p = num_markers, Y.shape[0]
    n, alpha, depth = num_samples, cfg["alpha"], cfg["depth"]
    G1, _ = skeleton.skeleton(C, n, alpha, cfg["max_level"], max(1, cfg["max_level"]))
    keep = reduce.kept(G1, m, depth)
    keep_t = torch.from_numpy(keep).to(device)
    C1 = C[keep_t][:, keep_t]
    del C
    G2, S2 = skeleton.skeleton(C1, n, alpha, cfg["max_level_two"],
                               max(1, min(ML, cfg["max_level_two"])))
    keep2 = reduce.kept(G2, keep.size - p, depth)
    k2 = torch.from_numpy(keep2).to(device)
    return {
        "num_phen": p,
        "ixs": keep[keep2],
        "G": G2[np.ix_(keep2, keep2)],
        "C": C1[k2][:, k2].double().cpu().numpy(),
        "S": reduce.sepsets(S2, keep2, ML),
    }
