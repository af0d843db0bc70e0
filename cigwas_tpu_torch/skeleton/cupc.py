"""Level-wise PC-stable skeleton search (`cigwas_tpu.skeleton.cupc.skeleton`).

* level 0 is the Fisher-z screen of the whole panel, on the device;
* levels 1-3 run per degree bucket through the local-sweep kernel
  (:func:`cigwas_tpu_torch.ops.kernels.local_sweep.local_sweep`; its plain
  version on CPU tensors): one launch covers every node of a bucket and
  returns, per neighbour slot, the min |rho| over all conditioning sets and
  its positions; only the hits ``rho < tanh(Th[l])`` and their positions
  leave the device;
* levels >= 4 stream colex chunks of conditioning sets through
  :func:`cigwas_tpu_torch.ops.pcorr.level_scan_minrho`, in the JAX package's
  waves, so a node stops at the same point and its sepset is the same.

Deletions apply between levels (PC-stable). The separation set of a deleted
ordered pair (x, y) is the argmin-|rho| set from x's side, the lowest colex
rank among ties.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass

import numpy as np
import torch

from cigwas_tpu_torch.device import require_full_f32, resolve
from cigwas_tpu_torch.host import ML, PANEL_ALIGN, colex_combinations_chunk, colex_unrank
from cigwas_tpu_torch.ops import pcorr
from cigwas_tpu_torch.ops.kernels.local_sweep import local_sweep

# combos per chunk of the level >= 4 scan
CHUNK = 512
# max chunks per scan launch
MAX_CHUNKS_PER_LAUNCH = 256
# cap on (nodes x combos x neighbours x l) elements live per scan call
ELEM_BUDGET = 1 << 26


@dataclass
class SkeletonResult:
    G: np.ndarray  # (n, n) int32 adjacency
    sepset: np.ndarray  # (n, n, depth) int32, -1 padded
    final_level: int


def _next_pow2(v: int) -> int:
    return 1 << max(0, (v - 1).bit_length())


def _compact_neighbors(G: np.ndarray, nodes: np.ndarray, d_max: int):
    """Ascending neighbour indices per node, padded with 0, and degrees."""
    rows = G[nodes].astype(bool)
    ri, ci = np.nonzero(rows)  # row-major -> cols ascending within each row
    deg = np.bincount(ri, minlength=len(nodes)).astype(np.int32)
    starts = np.cumsum(deg) - deg
    slot = np.arange(len(ri)) - np.repeat(starts, deg)
    nbrs = np.zeros((len(nodes), d_max), dtype=np.int32)
    ok = slot < d_max
    nbrs[ri[ok], slot[ok]] = ci[ok]
    return nbrs, deg


def _degree_buckets(deg_all: np.ndarray, active: np.ndarray):
    """[(d_pad, nodes ascending)] with d_pad the degree rounded up to a
    multiple of 8 (min 8): the kernel's work per node follows its true
    degree, the bucket only sets the output width and shared-memory size."""
    d_pad = np.maximum(8, -(-deg_all[active] // 8) * 8)
    return [(int(d), active[d_pad == d].astype(np.int32)) for d in np.unique(d_pad)]


def panel_from_numpy(C: np.ndarray, v_real: int, device) -> torch.Tensor:
    """A host panel as a device tensor, zero-padded to a PANEL_ALIGN multiple
    (pads have corr 0 with everything, so level 0 isolates them)."""
    C = np.asarray(C, dtype=np.float32)[:v_real, :v_real]
    pad = (-v_real) % PANEL_ALIGN
    return torch.from_numpy(np.pad(C, ((0, pad), (0, pad)))).to(device)


def _run_level_local(C: torch.Tensor, G: np.ndarray, l: int, rho_threshold: float,
                     stats: dict | None = None):
    """All level-l tests (l <= 3) as one kernel launch per degree bucket.

    Returns (removed (n, n) bool, xs, ys, sep (k, l)): the ordered pairs
    condemned from x's side and their minimizing conditioning variables."""
    n = G.shape[0]
    deg_all = G.sum(axis=1)
    active = np.where(deg_all >= l + 1)[0]
    dev = C.device
    xs_l, ys_l, sep_l = [], [], []
    det = {"compact_s": 0.0, "sweep_s": 0.0}
    for d_pad, nodes in _degree_buckets(deg_all, active):
        t0 = time.perf_counter()
        nbrs, deg = _compact_neighbors(G, nodes, d_pad)
        nbrs_t = torch.from_numpy(nbrs).to(dev)
        deg_t = torch.from_numpy(deg).to(dev)
        t1 = time.perf_counter()
        rho, pos = local_sweep(C, torch.from_numpy(nodes).to(dev), nbrs_t, deg_t, l)
        slot_ok = torch.arange(d_pad, device=dev)[None, :] < deg_t[:, None]
        ri, ci = torch.nonzero((rho < rho_threshold) & slot_ok, as_tuple=True)
        pos_h = pos[ri, ci].cpu().numpy()
        ri, ci = ri.cpu().numpy(), ci.cpu().numpy()
        det["compact_s"] += t1 - t0
        det["sweep_s"] += time.perf_counter() - t1  # ends in the hits' fetch
        xs_l.append(nodes[ri])
        ys_l.append(nbrs[ri, ci])
        sep_l.append(nbrs[ri[:, None], pos_h])  # positions -> variable indices
        if stats is not None:
            stats.setdefault("launches", {}).setdefault(l, []).append(
                (int(d_pad), int(len(nodes)))
            )
    if stats is not None:
        stats.setdefault("level_detail", {})[l] = det
    xs = np.concatenate(xs_l) if xs_l else np.empty(0, np.int64)
    ys = np.concatenate(ys_l) if ys_l else np.empty(0, np.int64)
    sep = np.concatenate(sep_l) if sep_l else np.empty((0, l), np.int32)
    removed = np.zeros((n, n), dtype=bool)
    removed[xs, ys] = True
    removed[ys, xs] = True
    return removed, xs, ys, sep


def _run_level(C: torch.Tensor, G: np.ndarray, l: int, rho_threshold: float):
    """All level-l tests (l >= 4) over colex chunks; returns (removed,
    rho_min_full, rank_full) like `cigwas_tpu.skeleton.cupc._run_level`.

    Waves: every bucket scans its next CHUNK * n_chunks combos, then nodes
    whose combos are exhausted or whose edges are all condemned stop. The
    wave sizes follow the JAX package exactly, because where a node stops
    decides which later sets it never tests, and so its sepsets."""
    n = G.shape[0]
    deg_all = G.sum(axis=1)
    active = np.where(deg_all >= l + 1)[0]
    removed = np.zeros((n, n), dtype=bool)
    if active.size == 0:
        return removed, None, None
    dev = C.device
    stat_full = np.full((n, n), np.inf, dtype=np.float32)
    total_combos = {int(x): math.comb(int(deg_all[x]), l) for x in active}
    rank_dtype = (
        object if max(total_combos.values(), default=0) > (1 << 62) else np.int64
    )
    rank_full = np.zeros((n, n), dtype=rank_dtype)
    buckets: dict = {}
    for x in active:
        buckets.setdefault(_next_pow2(max(int(deg_all[x]), 8)), []).append(int(x))
    work = [(d_pad, buckets[d_pad], 0) for d_pad in sorted(buckets)]
    while work:
        next_work = []
        for d_pad, remaining, offset in work:
            nodes = np.array(remaining, dtype=np.int32)
            node_tile = max(1, min(len(nodes), ELEM_BUDGET // (CHUNK * d_pad * l)))
            max_left = max(total_combos[x] - offset for x in remaining)
            n_chunks = _next_pow2(
                min(MAX_CHUNKS_PER_LAUNCH, max(1, -(-min(max_left, 1 << 30) // CHUNK)))
            )
            combos_seq = torch.from_numpy(
                colex_combinations_chunk(offset, CHUNK * n_chunks, l)
                .reshape(n_chunks, CHUNK, l).astype(np.int64)
            ).to(dev)
            for s0 in range(0, len(nodes), node_tile):
                tile = nodes[s0 : s0 + node_tile]
                nbrs, deg = _compact_neighbors(G, tile, d_pad)
                totals = np.array(
                    [min(total_combos[int(x)] - offset, CHUNK * n_chunks) for x in tile],
                    dtype=np.int64,
                )
                bases = CHUNK * np.arange(n_chunks, dtype=np.int64)[:, None]
                left_seq = np.clip(totals[None, :] - bases, 0, CHUNK)
                rho_t, rank_t = pcorr.level_scan_minrho(
                    C, torch.from_numpy(tile).long().to(dev),
                    torch.from_numpy(nbrs).long().to(dev),
                    torch.from_numpy(deg).long().to(dev), combos_seq,
                    torch.from_numpy(left_seq).to(dev), l,
                )
                rho_c = rho_t.cpu().numpy()
                rank_c = rank_t.cpu().numpy().astype(rank_dtype) + offset
                valid = np.arange(d_pad)[None, :] < deg[:, None]
                x_idx = np.repeat(tile, d_pad).reshape(len(tile), d_pad)[valid]
                y_idx = nbrs[valid]
                vals = rho_c[valid]
                better = vals < stat_full[x_idx, y_idx]
                stat_full[x_idx[better], y_idx[better]] = vals[better]
                rank_full[x_idx[better], y_idx[better]] = rank_c[valid][better]
            next_work.append((d_pad, remaining, offset + CHUNK * n_chunks))
        cond = (stat_full < rho_threshold) & G
        live_edge = G & ~(cond | cond.T)
        work = []
        for d_pad, remaining, offset in next_work:
            nxt = [
                x for x in remaining
                if total_combos[x] > offset and live_edge[x].any()
            ]
            if nxt:
                work.append((d_pad, nxt, offset))
    cond = (stat_full < rho_threshold) & G
    return cond | cond.T, stat_full, rank_full


def skeleton(C, thresholds: np.ndarray, max_level: int, device="cuda",
             n_var: int | None = None, verbose: bool = False,
             stats: dict | None = None) -> SkeletonResult:
    """PC-stable skeleton over a dense correlation panel (`Skeleton`,
    `cuPC-S.cu:61-450`; level 0 overwrites the adjacency from C).

    C: a numpy panel (padded here, see :func:`panel_from_numpy`) or a device
    tensor; n_var marks a tensor that is already padded with inert
    variables (the `ops.corr` panels). stats, if given, collects
    ``l0_wall_s``, ``sepset_alloc_s``, ``level_wall_s`` {level: s}, the
    per-bucket ``launches`` {level: [(d_pad, nodes)]} and, for levels 1-3,
    ``level_detail`` {level: {compact_s, sweep_s}} (host compaction and
    upload; kernel launches up to the fetch of their hits).

    Not ported: pMax (the pipeline never consumes it) and the JAX package's
    alternative level-1-3 routes, which all decide the same.
    """
    device = resolve(device)
    require_full_f32()  # the level >= 4 one-hot selections must be exact
    if isinstance(C, torch.Tensor):
        v_real = n_var if n_var is not None else C.shape[0]
        C = C.to(device=device, dtype=torch.float32)
        if C.shape[0] == v_real and v_real % PANEL_ALIGN:
            pad = (-v_real) % PANEL_ALIGN
            C = torch.nn.functional.pad(C, (0, pad, 0, pad))
    else:
        v_real = n_var if n_var is not None else np.asarray(C).shape[0]
        C = panel_from_numpy(C, v_real, device)
    th = np.asarray(thresholds, dtype=np.float32)
    n = C.shape[0]

    t_mark = time.perf_counter()
    G = pcorr.level0_screen(C, float(th[0])).cpu().numpy()
    if stats is not None:
        stats["l0_wall_s"] = time.perf_counter() - t_mark
    t_mark = time.perf_counter()
    sep_depth = max(1, min(ML, max_level))
    sepset = np.full((n, n, sep_depth), -1, dtype=np.int32)
    if stats is not None:
        stats["sepset_alloc_s"] = time.perf_counter() - t_mark

    final_level = 0
    for l in range(1, min(ML, max_level) + 1):
        nprime = int(G.sum(axis=1).max()) if n else 0
        if nprime - 1 < l:
            final_level = l - 1
            break
        if verbose:
            print(f"[skeleton] level {l}: max degree {nprime}")
        t_level = time.perf_counter()
        # f32-rounded threshold, compared in f32 on the device
        rho_th = float(np.float32(np.tanh(float(th[l]))))
        if l <= 3:  # the local-sweep kernel
            removed, xs, ys, sep = _run_level_local(C, G, l, rho_th, stats)
            sepset[xs, ys, l:] = -1
            sepset[xs, ys, :l] = sep
        else:
            removed, rho_min, rank = _run_level(C, G, l, rho_th)
            if rho_min is not None:
                xs, ys = np.nonzero((rho_min < rho_th) & G)
                sepset[xs, ys, l:] = -1
                prev_x, nbr_x = -1, None
                for x, y in zip(xs, ys):  # xs ascending from np.nonzero
                    if x != prev_x:
                        nbr_x = np.where(G[x])[0]
                        prev_x = x
                    sepset[x, y, :l] = nbr_x[colex_unrank(int(rank[x, y]), l)]
        G = G & ~removed
        if stats is not None:
            stats.setdefault("level_wall_s", {})[l] = time.perf_counter() - t_level
        final_level = l

    return SkeletonResult(
        G=G[:v_real, :v_real].astype(np.int32),
        sepset=sepset[:v_real, :v_real],
        final_level=final_level,
    )
