"""Second-stage separation-set improvement on a given skeleton
(`cigwas_tpu.skeleton.second_stage`; `cusk/src/cuPC-S-second-stage.cu`).

On an already-computed skeleton: re-screen marginally (delete-only), then
compute the level-1 partial correlation of every ordered pair (X, Y) given
each single neighbour of X, and record as SepSet(X, Y) all neighbours whose
conditioning lowered the Fisher z below the marginal value
(`select_non_colliders`, `cuPC-S-second-stage.cu:117-137`).

Host numpy, as in the JAX package: the reference calls it only from its
tests (`tests/cupc_tests.cpp:43-63`), and its work is one level-1 pass.
"""

from __future__ import annotations

import numpy as np

from cigwas_tpu_torch.constants import ML, PMAX_RETAINED
from cigwas_tpu_torch.skeleton.cupc import SkeletonResult
from cigwas_tpu_torch.utils.stats import fisher_z

# max degree after the marginal screen (`cuPC-S.h:51`)
PCORR_MAX_DEGREE = 100


def cusk_second_stage(
    C: np.ndarray,
    G: np.ndarray,
    thresholds: np.ndarray,
    max_level: int = ML,
    row_chunk: int = 512,
) -> SkeletonResult:
    """Returns (G after marginal screen, min-pcorr sepsets, pMax).

    If the post-screen max degree exceeds PCORR_MAX_DEGREE the reference
    bails out without touching the host outputs; here a ValueError is raised
    instead of silently returning stale data. SepSet(X, Y) lists the chosen
    neighbours of X in ascending order, at most ML of them.
    """
    C = np.asarray(C, dtype=np.float32)
    n = C.shape[0]
    G = np.asarray(G).astype(bool).copy()
    th0 = float(np.asarray(thresholds).ravel()[0])

    pmax = np.ones((n, n), dtype=np.float32)
    z0 = fisher_z(C)
    deleted = (z0 < th0) & G
    np.fill_diagonal(G, False)
    G &= ~deleted
    pmax[deleted] = z0[deleted]
    np.fill_diagonal(pmax, 1.0)

    deg = G.sum(axis=1)
    nprime = int(deg.max()) if n else 0
    if nprime > PCORR_MAX_DEGREE:
        raise ValueError("max degree exceeds allowed value")

    sepset = np.full((n, n, ML), -1, dtype=np.int32)
    d_max = max(nprime, 1)

    for x0 in range(0, n, row_chunk):
        xs = np.arange(x0, min(x0 + row_chunk, n))
        # ascending neighbour lists for this row block
        rows = G[xs]
        order = np.argsort(~rows, axis=1, kind="stable")[:, :d_max]
        degs = rows.sum(axis=1)
        nbrs = order.copy()
        slot = np.arange(d_max)[None, :]
        nbrs[slot >= degs[:, None]] = 0
        # z(x, y | s) for every y and every neighbour slot s of x
        c_xs = np.take_along_axis(C[xs], nbrs, axis=1)  # (r, d)
        c_xy = C[xs][:, :, None]  # (r, n, 1)
        # C[y, s] for all y and the row block's neighbour slots: (r, n, d)
        c_ys = C[:, nbrs.reshape(-1)].reshape(n, len(xs), d_max).transpose(1, 0, 2)
        with np.errstate(invalid="ignore", divide="ignore"):
            rho = (c_xy - c_xs[:, None, :] * c_ys) / np.sqrt(
                np.abs((1.0 - c_xs[:, None, :] ** 2) * (1.0 - c_ys**2))
            )
            z1 = fisher_z(rho)  # (r, n, d)
        # invalid slots (>= deg) and s == y keep pcorr at 1.0 like the init
        invalid = slot[:, None, :] >= degs[:, None, None]
        y_eq_s = nbrs[:, None, :] == np.arange(n)[None, :, None]
        z1 = np.where(invalid | y_eq_s | ~np.isfinite(z1), 1.0, z1)

        # all conditioning vars that lowered z below the marginal, in slot
        # order, the first ML of them; y == x is never written
        chosen = z1 < pmax[xs][:, :, None]  # (r, n, d)
        chosen[np.arange(len(xs)), xs, :] = False
        rank = np.cumsum(chosen, axis=2) - 1
        ri, y, s = np.nonzero(chosen & (rank < ML))
        sepset[xs[ri], y, rank[ri, y, s]] = nbrs[ri, s]

    # pMax postprocess identical to Skeleton (`cuPC-S-second-stage.cu:283-300`)
    iu = np.triu_indices(n, k=1)
    upper_edges = G[iu]
    mx = np.maximum(pmax[iu], pmax[(iu[1], iu[0])])
    vals = np.where(upper_edges, PMAX_RETAINED, mx)
    pmax[iu] = vals
    pmax[(iu[1], iu[0])] = vals
    np.fill_diagonal(pmax, 1.0)

    return SkeletonResult(G=G.astype(np.int32), sepset=sepset, final_level=1, pmax=pmax)
