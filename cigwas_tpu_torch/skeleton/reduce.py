"""Ancestor-subset selection and graph/correlation/sepset reduction
(`cigwas_tpu.skeleton.reduce`; `parent_set.cpp:8-238`).

Host numpy like the JAX package, except that a device panel is reduced on
the device: only the kept (k, k) submatrix is fetched.
"""

from __future__ import annotations

import numpy as np
import torch

from cigwas_tpu_torch.io.results import ReducedGC, ReducedGCS
from cigwas_tpu_torch.skeleton.cupc import SepsetRecords
from cigwas_tpu_torch.utils.timing import count, to_host


def subset_variables(
    G: np.ndarray, num_var: int, num_markers: int, max_depth: int
) -> np.ndarray:
    """Sorted indices of all traits plus the markers reachable from any trait
    through marker-only paths of length <= max_depth (`parent_set.cpp:8-53`)."""
    G = np.asarray(G).reshape(num_var, num_var).astype(bool)
    keep_markers = np.zeros(num_markers, dtype=bool)
    frontier = G[num_markers:, :num_markers].any(axis=0)
    visited = np.zeros(num_markers, dtype=bool)
    for _ in range(max_depth):
        new = frontier & ~visited
        if not new.any():
            break
        visited |= new
        keep_markers |= new
        frontier = G[:num_markers, :num_markers][new].any(axis=0)
    keep = np.concatenate([np.where(keep_markers)[0], np.arange(num_markers, num_var)])
    return np.sort(keep).astype(np.int32)


def _submatrix(M, keep: np.ndarray, num_var: int, stats: dict | None = None) -> np.ndarray:
    """The kept (k, k) block of a numpy panel, of a device tensor (possibly
    pad-extended beyond num_var) or of a sharded engine's panel; a tensor is
    gathered on its device, a sharded panel on its shards, and only the
    block is fetched (a tensor's fetch counted in stats, site
    ``reduce_panel``)."""
    if hasattr(M, "submatrix"):
        return M.submatrix(keep)
    if isinstance(M, torch.Tensor):
        kd = torch.from_numpy(keep).to(M.device)
        block = M.index_select(0, kd).index_select(1, kd)
        return to_host(block, stats, "reduce_panel").astype(np.float32)
    return np.asarray(M).reshape(num_var, num_var)[np.ix_(keep, keep)].astype(np.float32)


def reduce_gcs(
    G: np.ndarray,
    C,
    S,
    keep: np.ndarray,
    num_var: int,
    num_phen: int,
    max_level: int,
    index_map: np.ndarray | None = None,
    stats: dict | None = None,
) -> ReducedGCS:
    """Kept-variable submatrices of G/C/S, with sepset entries remapped to
    the new index space and entries that point at removed variables
    dropped (`parent_set.cpp:84-175`). C is a numpy panel, a device tensor
    (possibly pad-extended beyond num_var) or a sharded engine's panel. S
    is a skeleton's :class:`~cigwas_tpu_torch.skeleton.cupc.SepsetRecords`
    or a (num_var, num_var, depth) sepset, taken as its records. Output
    sepsets have stride ``max_level``; S may be narrower, its missing slots
    being -1. stats, if given, counts the bytes of C's fetch
    (``d2h_bytes``)."""
    keep = np.asarray(keep, dtype=np.int64)
    G = np.asarray(G).reshape(num_var, num_var)
    k = keep.size

    old_to_new = np.full(num_var, -1, dtype=np.int32)
    old_to_new[keep] = np.arange(k, dtype=np.int32)

    Gr = G[np.ix_(keep, keep)].astype(np.int32)
    Cr = _submatrix(C, keep, num_var, stats)
    Sr = _reduce_sepsets(S, old_to_new, k, max_level)

    if index_map is not None:
        new_to_old = np.asarray(index_map, dtype=np.int32)[keep]
    else:
        new_to_old = keep.astype(np.int32)

    return ReducedGCS(
        num_var=k,
        num_phen=num_phen,
        max_level=max_level,
        new_to_old_indices=new_to_old,
        G=Gr,
        C=Cr,
        S=Sr,
    )


def _reduce_sepsets(S, old_to_new: np.ndarray, k: int, max_level: int) -> np.ndarray:
    """The (k, k, max_level) int32 sepsets of the kept corner, -1 padded,
    from the records whose x and y are both kept (old_to_new >= 0): each
    set cut to max_level entries, its variables mapped to the new indices,
    those not kept dropped, the rest moved to the front in their order.
    Counts ``sepset_kept`` in the records' stats."""
    num_var = old_to_new.size
    if not isinstance(S, SepsetRecords):
        S = SepsetRecords.from_dense(np.asarray(S).reshape(num_var, num_var, -1))
    if S.n != num_var:
        raise ValueError(f"sepset records over {S.n} variables, expected {num_var}")
    Sr = np.full((k, k, max_level), -1, dtype=np.int32)
    kept = 0
    for l, xs, ys, sep in S.latest(old_to_new >= 0):
        w = min(l, max_level)
        v = sep[:, :w]
        in_range = (v >= 0) & (v < num_var)
        new = np.where(in_range, old_to_new[np.where(in_range, v, 0)], -1)
        order = np.argsort(new < 0, axis=1, kind="stable")
        Sr[old_to_new[xs], old_to_new[ys], :w] = np.take_along_axis(new, order, axis=1)
        kept += xs.size
    count(S.stats, "sepset_kept", kept)
    return Sr


def reduce_gc(
    G: np.ndarray,
    C,
    S,
    keep: np.ndarray,
    num_var: int,
    num_phen: int,
    max_level: int,
    index_map: np.ndarray | None = None,
    stats: dict | None = None,
) -> ReducedGC:
    """Like :func:`reduce_gcs` but S is the (num_var, num_var) ESS matrix
    (`parent_set.cpp:177-238`). C and S are numpy panels or device tensors;
    stats, if given, counts the bytes of their fetches."""
    keep = np.asarray(keep, dtype=np.int64)
    G = np.asarray(G).reshape(num_var, num_var)
    if index_map is not None:
        new_to_old = np.asarray(index_map, dtype=np.int32)[keep]
    else:
        new_to_old = keep.astype(np.int32)
    return ReducedGC(
        num_var=keep.size,
        num_phen=num_phen,
        max_level=max_level,
        new_to_old_indices=new_to_old,
        G=G[np.ix_(keep, keep)].astype(np.int32),
        C=_submatrix(C, keep, num_var, stats),
        S=_submatrix(S, keep, num_var, stats),
    )


def direct_x_to_y(G: np.ndarray, num_var: int, num_markers: int) -> np.ndarray:
    """Mark marker->trait edges with PAG codes 2/3 in place
    (`direct_x_to_y`, `parent_set.cpp:62-82`; unused in the reference's main
    path but part of its API surface). Returns G as a (num_var, num_var)
    view."""
    G = np.asarray(G).reshape(num_var, num_var)
    sink, source = np.nonzero(G[num_markers:, :num_markers] == 1)
    sink += num_markers
    G[source, sink] = 2
    G[sink, source] = 3
    return G
