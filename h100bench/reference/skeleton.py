"""Plain PC-stable skeleton and hetcor skeleton.

A test of the ordered pair (x, y) given a conditioning set S, |S| = l,
takes S from the neighbours of x at the start of the level (PC-stable),
y left out. Its partial correlation comes from the Schur complement of the
(S, S) block, r = (c_xy - c_xS M c_Sy) / sqrt((1 - c_xS M c_Sx)(1 - c_yS M
c_Sy)) with M the inverse of C[S, S]; a test whose value is not finite
does not count.

- ``skeleton``: level 0 keeps a pair unless its Fisher z is below
  Th[0] = z_{alpha/2} / sqrt(n - 3); level l deletes x - y when the
  smallest |r| over x's sets or over y's sets is below tanh(Th[l]),
  Th[l] = z_{alpha/2} / sqrt(n - l - 3). The separation set of (x, y) is
  x's set of smallest |r|, the first in colex order of the positions in x's
  ascending neighbour list among ties, and only where x's side deletes.
  From level 4 on a node scans its sets in waves of colex ranks and stops
  once every edge it has is deleted, so later sets are never tested and
  cannot become its separation sets; the waves are those of the program's
  documented scan (512 sets a chunk, up to 256 chunks, a power of two, per
  group of nodes whose degree rounds up to the same power of two).
- ``hetcor_skeleton``: the same levels on a given adjacency, with the
  threshold of each test tanh(z / sqrt(mean ESS - l - 3)), the mean over
  every pair of {x, y} u S of the truncated effective sample sizes, and no
  set that holds a variable later in time than both x and y; level 0
  deletes where the Fisher z is below z / sqrt(N_xy - 3). No separation
  sets.

Everything runs in the dtype of the panel: float64 for the reference,
bfloat16 for its control (whose small inverses go through float32).
"""

from __future__ import annotations

import math
from statistics import NormalDist

import numpy as np
import torch

# elements of the largest (nodes, sets, l, width) intermediate of a scan,
# on a card (2 GiB of float64) and on the CPU
BUDGET = {"cuda": 1 << 28, "cpu": 1 << 22}
# the program's scan of levels >= 4: sets a chunk, chunks a wave at most
CHUNK, MAX_CHUNKS = 512, 256
FIRST_WAVE_LEVEL = 4


def z_alpha(alpha: float) -> float:
    return abs(NormalDist().inv_cdf(alpha / 2))


def thresholds(n: float, alpha: float, levels: int) -> np.ndarray:
    q = z_alpha(alpha)
    return np.array([q / math.sqrt(n - l - 3) for l in range(levels + 1)])


def fisher_z(c: torch.Tensor) -> torch.Tensor:
    return torch.abs(0.5 * torch.log(torch.abs((1 + c) / (1 - c))))


def _next_pow2(v: int) -> int:
    return 1 << max(0, (v - 1).bit_length())


def _inverse(A: torch.Tensor) -> torch.Tensor:
    """Inverse of (..., l, l) matrices: by cofactors for l <= 3, else
    torch.linalg.inv_ex (float32 for a bfloat16 panel); a singular matrix
    gives entries that are not finite."""
    l = A.shape[-1]
    if l == 1:
        return 1.0 / A
    if l == 2:
        a, b, c, d = A[..., 0, 0], A[..., 0, 1], A[..., 1, 0], A[..., 1, 1]
        det = a * d - b * c
        return torch.stack([torch.stack([d, -b], -1), torch.stack([-c, a], -1)], -2) / det[
            ..., None, None]
    if l == 3:
        m = [[A[..., i, j] for j in range(3)] for i in range(3)]
        cof = [[m[(j + 1) % 3][(i + 1) % 3] * m[(j + 2) % 3][(i + 2) % 3]
                - m[(j + 1) % 3][(i + 2) % 3] * m[(j + 2) % 3][(i + 1) % 3]
                for j in range(3)] for i in range(3)]  # cof[i][j]: adjugate entry (i, j)
        det = m[0][0] * cof[0][0] + m[0][1] * cof[1][0] + m[0][2] * cof[2][0]
        adj = torch.stack([torch.stack(row, -1) for row in cof], -2)
        return adj / det[..., None, None]
    inv, info = torch.linalg.inv_ex(A.float() if A.dtype == torch.bfloat16 else A)
    return torch.where((info == 0)[..., None, None], inv, torch.nan).to(A.dtype)


class Tests:
    """The statistic of every test of a level: |r| (``hetcor`` None), or the
    hetcor margin |r| - tanh(z / sqrt(mean ESS - l - 3)) with hetcor =
    (N (v, v) truncated ESS, t (v,) time index, z)."""

    def __init__(self, C: torch.Tensor, hetcor=None):
        self.C = C
        self.hetcor = hetcor

    def chunk(self, nodes: torch.Tensor, nb: torch.Tensor, deg: torch.Tensor,
              combos: torch.Tensor) -> torch.Tensor:
        """(nt, K, d) statistics of nodes (nt,) with neighbour lists nb
        (nt, d) and degrees deg over the position sets combos (K, l); +inf
        where a set reaches past the degree, y is in the set, y is a pad
        slot, the value is not finite or, for hetcor, the set is too late."""
        C = self.C
        nt, d = nb.shape
        K, l = combos.shape
        Cb = C[nb[:, :, None], nb[:, None, :]]  # (nt, d, d)
        q = C[nodes[:, None], nb]  # (nt, d)
        Cs = Cb[:, combos, :]  # (nt, K, l, d)
        M = _inverse(Cb[:, combos[:, :, None], combos[:, None, :]])  # (nt, K, l, l)
        qS = q[:, combos]  # (nt, K, l)
        Z = torch.matmul(M, Cs)  # (nt, K, l, d)
        w = torch.matmul(M, qS[..., None])[..., 0]  # (nt, K, l)
        ax = 1 - (qS * w).sum(-1)  # (nt, K)
        num = q[:, None, :] - torch.einsum("nkl,nkld->nkd", qS, Z)
        ay = 1 - (Cs * Z).sum(2)  # (nt, K, d)
        del Z, Cs
        stat = torch.abs(num) / torch.sqrt(ax[..., None] * ay)
        iy = torch.arange(d, device=C.device)
        bad = (
            (combos[None, :, -1:] >= deg[:, None, None])  # set past the degree
            | (combos[:, :, None] == iy).any(1)[None]  # y in the set
            | (iy[None, None, :] >= deg[:, None, None])  # pad slot y
        )
        if self.hetcor is not None:
            N, t, z = self.hetcor
            Nb = N[nb[:, :, None], nb[:, None, :]]
            nr = N[nodes[:, None], nb]
            pairs = 1 + 2 * l + l * (l - 1) // 2
            total = nr[:, None, :] + nr[:, combos].sum(-1)[..., None] + Nb[:, combos, :].sum(2)
            for i in range(l):
                for j in range(i):
                    total = total + Nb[:, combos[:, i], combos[:, j]][..., None]
            thr = torch.tanh(z / torch.sqrt(total / pairs - l - 3))
            tb = t[nb]  # (nt, d)
            t_pair = torch.maximum(t[nodes][:, None], tb)  # (nt, d)
            late = tb[:, combos].amax(-1)[..., None] > t_pair[:, None, :]
            bad = bad | late | ~torch.isfinite(thr)
            stat = stat - thr
        return torch.where(bad | ~torch.isfinite(stat), torch.inf, stat)


def _neighbours(G: np.ndarray, nodes: np.ndarray, d: int):
    """Ascending neighbour lists of nodes, padded with 0 to width d, and
    their degrees."""
    ri, ci = np.nonzero(G[nodes])  # row-major: ascending within a row
    deg = np.bincount(ri, minlength=len(nodes)).astype(np.int64)
    slot = np.arange(ri.size) - np.repeat(np.cumsum(deg) - deg, deg)
    nb = np.zeros((len(nodes), d), dtype=np.int64)
    ok = slot < d
    nb[ri[ok], slot[ok]] = ci[ok]
    return nb, deg


def colex_of(ranks: np.ndarray, l: int, width: int) -> np.ndarray:
    """The position sets (k, l) of the given colex ranks."""
    r = np.asarray(ranks, dtype=np.int64).copy()
    out = np.empty((r.size, l), dtype=np.int64)
    for i in range(l, 0, -1):
        table = np.array([math.comb(c, i) for c in range(width + 1)], dtype=np.int64)
        c = np.searchsorted(table, r, side="right") - 1
        out[:, i - 1] = c
        r = r - table[c]
    return out


def colex(lo: int, hi: int, l: int, width: int) -> np.ndarray:
    """The l-subsets of range(width) of colex ranks lo .. hi - 1, (k, l)
    ascending positions."""
    return colex_of(np.arange(lo, hi, dtype=np.int64), l, width)


def scan(tests: Tests, G: np.ndarray, nodes: np.ndarray, l: int, lo: int, hi: int,
         width: int):
    """Smallest statistic over the sets of colex ranks lo .. hi - 1 of each
    node's neighbour positions, per live neighbour slot: (xs, ys, best
    float64, rank int64), one entry per node x and neighbour y."""
    dev = tests.C.device
    nb, deg = _neighbours(G, nodes, width)
    best = np.full((len(nodes), width), np.inf)
    rank = np.zeros((len(nodes), width), dtype=np.int64)
    hi = min(hi, math.comb(width, l))
    if hi > lo and len(nodes):
        per_set, budget = l * width, BUDGET[dev.type]
        k_step = max(1, min(hi - lo, budget // per_set))
        n_step = max(1, budget // (per_set * k_step))
        nb_t, deg_t = torch.from_numpy(nb).to(dev), torch.from_numpy(deg).to(dev)
        nodes_t = torch.from_numpy(np.asarray(nodes, dtype=np.int64)).to(dev)
        for k0 in range(lo, hi, k_step):
            k1 = min(hi, k0 + k_step)
            combos = torch.from_numpy(colex(k0, k1, l, width)).to(dev)
            for n0 in range(0, len(nodes), n_step):
                sl = slice(n0, n0 + n_step)
                stat = tests.chunk(nodes_t[sl], nb_t[sl], deg_t[sl], combos)
                m, i = torch.min(stat, dim=1)  # the first minimum: the lowest rank
                m = m.double().cpu().numpy()
                i = i.cpu().numpy() + k0
                better = m < best[sl]
                best[sl] = np.where(better, m, best[sl])
                rank[sl] = np.where(better, i, rank[sl])
    live = np.arange(width)[None, :] < deg[:, None]
    xs = np.repeat(np.asarray(nodes, dtype=np.int64), width).reshape(len(nodes), width)
    return xs[live], nb[live], best[live], rank[live]


def _level(tests: Tests, G: np.ndarray, l: int, cut: float, waves: bool):
    """One level's smallest statistic per tested ordered pair and the rank
    of its set, over every set or in waves: (xs, ys, stat, rank)."""
    deg = G.sum(1)
    active = np.flatnonzero(deg >= l + 1)
    if not waves:
        parts = []
        pad = np.maximum(8, -(-deg[active] // 8) * 8)
        for w in np.unique(pad):
            parts.append(scan(tests, G, active[pad == w], l, 0, math.comb(int(w), l), int(w)))
        return tuple(np.concatenate([p[k] for p in parts]) for k in range(4)) if parts else (
            np.empty(0, np.int64), np.empty(0, np.int64), np.empty(0), np.empty(0, np.int64))
    v = G.shape[0]
    stat = np.full((v, v), np.inf)
    rank = np.zeros((v, v), dtype=np.int64)
    total = {int(x): math.comb(int(deg[x]), l) for x in active}
    groups: dict = {}
    for x in active:
        groups.setdefault(_next_pow2(max(int(deg[x]), 8)), []).append(int(x))
    work = [(w, groups[w], 0) for w in sorted(groups)]
    while work:
        nxt = []
        for w, nodes, offset in work:
            left = max(total[x] - offset for x in nodes)
            size = CHUNK * _next_pow2(min(MAX_CHUNKS, max(1, -(-min(left, 1 << 30) // CHUNK))))
            xs, ys, b, r = scan(tests, G, np.array(nodes), l, offset, offset + size,
                                int(deg[nodes].max()))
            better = b < stat[xs, ys]
            stat[xs[better], ys[better]] = b[better]
            rank[xs[better], ys[better]] = r[better]
            nxt.append((w, nodes, offset + size))
        cond = (stat < cut) & G
        live_edge = G & ~(cond | cond.T)
        work = [(w, kept, off) for w, nodes, off in nxt
                if (kept := [x for x in nodes if total[x] > off and live_edge[x].any()])]
    xs, ys = np.nonzero(np.isfinite(stat))
    return xs, ys, stat[xs, ys], rank[xs, ys]


def _levels(tests: Tests, G: np.ndarray, max_level: int, cuts, sepsets: np.ndarray | None):
    """Levels 1 .. max_level on adjacency G (changed in place); the
    separation sets of x's deletions go to sepsets."""
    for l in range(1, max_level + 1):
        deg = G.sum(1)
        if not G.shape[0] or int(deg.max()) - 1 < l:
            break
        xs, ys, stat, rank = _level(tests, G, l, cuts[l], waves=l >= FIRST_WAVE_LEVEL)
        hit = stat < cuts[l]
        xs, ys, rank = xs[hit], ys[hit], rank[hit]
        if sepsets is not None and xs.size:
            width = int(deg.max())
            ux, inv = np.unique(xs, return_inverse=True)
            nb = _neighbours(G, ux, width)[0][inv]
            sepsets[xs, ys, :] = -1
            sepsets[xs, ys, :l] = np.take_along_axis(nb, colex_of(rank, l, width), axis=1)
        G[xs, ys] = False
        G[ys, xs] = False
    return G


def skeleton(C: torch.Tensor, n: float, alpha: float, max_level: int, depth: int):
    """(G (v, v) bool, sepsets (v, v, depth) int32 -1 padded) of the
    PC-stable skeleton of panel C over n samples, levels 0 .. max_level."""
    v = C.shape[0]
    th = thresholds(n, alpha, max_level)
    z0 = fisher_z(C)
    G = (~(z0 < float(th[0]))).cpu().numpy()
    np.fill_diagonal(G, False)
    sepsets = np.full((v, v, depth), -1, dtype=np.int32)
    cuts = [math.tanh(t) for t in th]
    G = _levels(Tests(C), G, max_level, cuts, sepsets)
    return G, sepsets


def hetcor_skeleton(C: torch.Tensor, N_raw: torch.Tensor, G: np.ndarray, t: torch.Tensor,
                    alpha: float, max_level: int) -> np.ndarray:
    """Adjacency of the hetcor skeleton that starts from G."""
    z = z_alpha(alpha)
    G = G.astype(bool).copy()
    G &= ~(fisher_z(C) < z / torch.sqrt(N_raw - 3)).cpu().numpy()
    np.fill_diagonal(G, False)
    N = torch.trunc(torch.nan_to_num(N_raw))
    return _levels(Tests(C, (N, t, z)), G, max_level, [0.0] * (max_level + 1), None)
