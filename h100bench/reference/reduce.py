"""The reduction between the stages and before the output.

The variables kept are every trait and the markers that a path of at most
``depth`` edges, through markers only, joins to a trait. Kept variables
keep their order. A separation set keeps its kept members in order, is
renumbered into the kept variables and padded with -1 to ``stride``.
"""

from __future__ import annotations

import numpy as np


def kept(G: np.ndarray, num_markers: int, depth: int) -> np.ndarray:
    """Ascending indices of the kept variables."""
    m = num_markers
    reached = np.zeros(m, dtype=bool)
    frontier = G[m:, :m].any(0)
    for _ in range(depth):
        new = frontier & ~reached
        if not new.any():
            break
        reached |= new
        frontier = G[:m, :m][new].any(0)
    return np.concatenate([np.flatnonzero(reached), np.arange(m, G.shape[0])])


def sepsets(S: np.ndarray, keep: np.ndarray, stride: int) -> np.ndarray:
    """(k, k, stride) separation sets among the kept variables."""
    v = S.shape[0]
    new = np.full(v, -1, dtype=np.int64)
    new[keep] = np.arange(keep.size)
    sub = S[np.ix_(keep, keep)].astype(np.int64)
    out = np.full((keep.size, keep.size, stride), -1, dtype=np.int64)
    for i, j in zip(*np.nonzero((sub >= 0).any(-1))):
        members = [int(new[s]) for s in sub[i, j] if s >= 0 and new[s] >= 0]
        out[i, j, : len(members)] = members
    return out
