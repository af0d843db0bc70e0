"""Level-wise PC-stable skeleton search (`cigwas_tpu.skeleton.cupc`):
:func:`skeleton` over a correlation panel and :func:`hetcor_skeleton` over
summary statistics (correlations plus per-pair effective sample sizes).

* level 0 is the Fisher-z screen of the whole panel, on the device;
* levels 1-3, the list route: per degree bucket through the
  local-sweep kernel (:func:`cigwas_tpu_torch.ops.kernels.local_sweep.
  local_sweep`; its plain version on CPU tensors): one launch covers every
  node of a bucket and returns, per neighbour slot, the min |rho| over all
  conditioning sets and its positions; only the hits ``rho < tanh(Th[l])``
  and their positions leave the device;
* levels 1-3, the device-resident loop (panels up to ``DEV_RESIDENT_MAX``
  whose level-0 width is at most 152, no engine; checked first): the
  adjacency stays on the device, each level compacts the lists of the
  nodes with a test there and makes one local-sweep launch over them at
  the level's width;
* level 1, the dense route (where :func:`_l1_route_local` finds level 1
  hub-heavy, up to ``DENSE_L1_MAX``): x-row slabs against every y through
  the dense kernel (:mod:`cigwas_tpu_torch.ops.kernels.dense_l1`);
* the combinatorial route (every level >= 4; levels 2-3 left out of
  ``LOCAL_LEVELS``; level 1 above ``DENSE_L1_MAX`` when the gate says
  dense): gather each node tile's local panels with the gather kernel
  (:mod:`cigwas_tpu_torch.ops.kernels.panel_gather`) and stream colex chunks
  of conditioning sets through
  :func:`cigwas_tpu_torch.ops.pcorr.level_scan_minrho_pre`, in the JAX
  package's waves, so a node stops at the same point and its sepset is the
  same.

Every route decides what the others decide (the same tests, the lowest
colex rank among tied minima); the module attributes above choose among
them, as in the JAX package, from the port's own measurements.

The hetcor skeleton has the same levels with per-test thresholds
tanh(th / sqrt(mean_ess - l - 3)) and a time constraint on the conditioning
sets: levels 1-3 through
:func:`cigwas_tpu_torch.ops.kernels.hetcor_sweep.hetcor_local_sweep`, level
1 also by the dense route, the combinatorial route through the two-panel
gather and one launch of the scan kernel a node tile and wave
(:func:`cigwas_tpu_torch.ops.kernels.hetcor_sweep.hetcor_scan`; its plain
version :func:`cigwas_tpu_torch.ops.pcorr.level_scan_hetcor_pre` on CPU
tensors). It keeps
no sepsets. On one card its levels 1-3 run in the same device level loop as
the block's (:func:`_device_levels`): each level's hits are cleared in
place, the local route's lists compacted on the device
(:mod:`cigwas_tpu_torch.ops.kernels.compact_rows`) and swept in one launch
at the level's width, until the first level that is combinatorial, local
and wider than 152, or past level 3; the host loop takes over from there.
On one card both skeletons keep the adjacency on the device from level 0
on and fetch it once, where the host loop takes over. An engine runs
every level on the host's adjacency.

Deletions apply between levels (PC-stable). The separation set of a deleted
ordered pair (x, y) is the argmin-|rho| set from x's side, the lowest colex
rank among ties.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from cigwas_tpu_torch.device import require_full_f32, resolve
from cigwas_tpu_torch.constants import ML, PANEL_ALIGN, PMAX_RETAINED
from cigwas_tpu_torch.ops import pcorr
from cigwas_tpu_torch.ops.kernels.checks import check_index_range
from cigwas_tpu_torch.ops.kernels.compact_rows import compact_rows
from cigwas_tpu_torch.ops.kernels.hetcor_sweep import hetcor_local_sweep, hetcor_scan
from cigwas_tpu_torch.ops.kernels.local_sweep import local_sweep
from cigwas_tpu_torch.ops.kernels.panel_gather import (
    gather_local_panels,
    gather_local_panels2,
)
from cigwas_tpu_torch.utils.combinatorics import colex_combinations_chunk, colex_unrank
from cigwas_tpu_torch.utils.stats import fisher_z
from cigwas_tpu_torch.utils.timing import count, span, to_host

# combos per chunk of the combinatorial scan
CHUNK = 512
# max chunks per scan launch
MAX_CHUNKS_PER_LAUNCH = 256
# cap on (nodes x combos x neighbours x l) elements live per scan call
ELEM_BUDGET = pcorr.SCAN_ELEMS

# Route gates (`cigwas_tpu.skeleton.cupc`'s names; tests and chip_smoke.py
# monkeypatch them). Every route decides the same. The values are the port's
# own, not the JAX package's TPU values: a route is the default where its
# walls beat the other routes' by more than the ~15% the walls move between
# calls, from chip_smoke.py's `routes` phase on one NVIDIA H100 80GB HBM3 at
# 700 W (PERF.md §6).
# levels 2-3 that run on the local sweep; the others take the combinatorial
# route (on the 1,500-marker block the combinatorial levels 1-3 took 0.321 s
# against the list route's 0.067 s)
LOCAL_LEVELS = (2, 3)
# largest panel whose level 1 may take the dense route: the largest measured
DENSE_L1_MAX = 12288
# largest panel whose levels 1-3 run in the device-resident loop, before
# the level-1 gate below: the loop beat both other routes at every size
# measured, the 1,500-marker block (vp 1,536; levels 1-3 0.007 s against
# 0.036 s on the list route) and the 11k block (vp 12,288; block 1.62 s
# against 3.65 s on the list route and 3.09 s with the dense level 1)
DEV_RESIDENT_MAX = 12288
# widest padded level-0 max degree the loop takes: the widest measured (the
# 11k block's 152; the JAX package's TPU value is 128)
_DEV_RESIDENT_WIDTH = 152
# level 1 takes the list route whenever the padded max degree is at most this
L1_LOCAL_MAX_WIDTH = 128
# above it, the list route's sum(d_pad^2) slots times this ratio against the
# dense route's vp^3 decide. The dense level 1 beat the list route's level 1
# at every panel measured wider than L1_LOCAL_MAX_WIDTH: the 10k input (vp
# 10,112; 0.410 against 0.700 s, sending it dense needs 6,331), the 11k block
# (vp 12,288; 0.346 against 0.707 s, 11,502) and the engines' 11k block (vp
# 11,008; 0.288 against 0.650 s, 8,270): the smallest round ratio that sends
# them all dense
L1_LOCAL_COST_RATIO = 12000


class SepsetRecords:
    """The separating sets of a skeleton's removals as an append-only
    record: one entry a removed ordered pair (x, y), condemned from x's
    side, with the l variables of its set, in int32 arrays, one group an
    :meth:`append` (one level of one route). A level-0 removal (the empty
    set) needs no record. A later record of an ordered pair replaces an
    earlier one, as a later write replaced it in the dense (n, n, depth)
    array, -1 padded, that :meth:`dense` builds. stats, if given (the
    skeleton's), counts ``sepset_records`` as they are appended and, in
    :func:`~cigwas_tpu_torch.skeleton.reduce.reduce_gcs`, ``sepset_kept``,
    the records of the kept corner."""

    def __init__(self, n: int, depth: int, stats: dict | None = None):
        self.n, self.depth, self.stats = n, depth, stats
        self.parts: list[tuple[int, np.ndarray, np.ndarray, np.ndarray]] = []
        count(stats, "sepset_records", 0)

    def append(self, l: int, xs, ys, sep) -> None:
        """Records the ordered pairs (xs[i], ys[i]) with the sets sep[i],
        l variables each (-1 where a dense array left a gap)."""
        xs = np.array(xs, dtype=np.int32).ravel()
        ys = np.array(ys, dtype=np.int32).ravel()
        sep = np.array(sep, dtype=np.int32).reshape(xs.size, l)
        if xs.size:
            self.parts.append((l, xs, ys, sep))
        count(self.stats, "sepset_records", xs.size)

    def __len__(self) -> int:
        return sum(xs.size for _, xs, _, _ in self.parts)

    def latest(self, kept: np.ndarray | None = None) -> list:
        """[(l, xs, ys, sep)]: the groups with each ordered pair's last
        record only, and with kept, an (n,) bool mask, only the records
        whose x and y are both kept."""
        parts = self.parts
        if kept is not None:
            parts = []
            for l, xs, ys, sep in self.parts:
                m = kept[xs] & kept[ys]
                parts.append((l, xs[m], ys[m], sep[m]))
        keys = np.concatenate([xs.astype(np.int64) * self.n + ys for _, xs, ys, _ in parts]
                              or [np.empty(0, np.int64)])
        _, first_rev = np.unique(keys[::-1], return_index=True)
        last = np.zeros(keys.size, dtype=bool)
        last[keys.size - 1 - first_rev] = True
        out, start = [], 0
        for l, xs, ys, sep in parts:
            m = last[start:start + xs.size]
            start += xs.size
            if m.any():
                out.append((l, xs[m], ys[m], sep[m]))
        return out

    def dense(self) -> np.ndarray:
        """The (n, n, depth) int32 sepset, -1 padded."""
        S = np.full((self.n, self.n, self.depth), -1, dtype=np.int32)
        for l, xs, ys, sep in self.latest():
            S[xs, ys, :l] = sep
        return S

    @classmethod
    def from_dense(cls, S: np.ndarray) -> "SepsetRecords":
        """The records of an (n, n, depth) sepset: one for each ordered pair
        with an entry other than -1, as wide as its last such entry."""
        S = np.asarray(S)
        n, _, depth = S.shape
        rec = cls(n, depth)
        set_ = S != -1
        width = np.where(set_.any(axis=2), depth - np.argmax(set_[:, :, ::-1], axis=2), 0)
        for w in range(1, depth + 1):
            xs, ys = np.nonzero(width == w)
            rec.append(w, xs, ys, S[xs, ys, :w])
        return rec


class SkeletonResult:
    """A skeleton's result: ``G`` the (n, n) int32 adjacency;
    ``final_level``; ``pmax``, (n, n) f32 max Fisher z of a deleted pair's
    tests from either side, PMAX_RETAINED on kept edges, 1.0 on the
    diagonal, None unless asked for; ``records``, the removals' separating
    sets (:class:`SepsetRecords`), and ``sepset``, the same as the (n, n,
    depth) int32 array, -1 padded, built from the records on first access
    (None for hetcor). Either form may be given as ``sepset``."""

    def __init__(self, G: np.ndarray, sepset, final_level: int,
                 pmax: np.ndarray | None = None):
        self.G, self.final_level, self.pmax = G, final_level, pmax
        self._records = sepset if isinstance(sepset, SepsetRecords) else None
        self._dense = None if self._records is not None else sepset

    @property
    def sepset(self) -> np.ndarray | None:
        if self._dense is None and self._records is not None:
            self._dense = self._records.dense()
        return self._dense

    @property
    def records(self) -> SepsetRecords | None:
        if self._records is None and self._dense is not None:
            self._records = SepsetRecords.from_dense(self._dense)
        return self._records


def _next_pow2(v: int) -> int:
    return 1 << max(0, (v - 1).bit_length())


def _pad8(d: int) -> int:
    return max(8, -(-int(d) // 8) * 8)


def _l1_route_local(deg: np.ndarray, vp: int) -> bool:
    """True when level 1 should take the list route
    (`cigwas_tpu.skeleton.cupc._l1_route_local`): always while the padded
    max degree is at most L1_LOCAL_MAX_WIDTH; above it, when the degree
    buckets' sum(d_pad^2) slots, charged L1_LOCAL_COST_RATIO each, cost less
    than the dense route's vp^3."""
    dmax = int(deg.max()) if deg.size else 0
    if _pad8(dmax) <= L1_LOCAL_MAX_WIDTH:
        return True
    active = deg >= 2
    if not active.any():
        return True
    d_pad = np.maximum(8, ((deg[active].astype(np.int64) + 7) // 8) * 8)
    return int((d_pad * d_pad).sum()) * L1_LOCAL_COST_RATIO < vp**3


def _level_route(l: int, deg: np.ndarray, vp: int) -> str:
    """The route of host-loop level l: ``local`` (the local-sweep kernels
    over degree buckets), ``dense`` (level 1's dense sweep) or
    ``combinatorial`` (the colex scan), chosen as the JAX package chooses."""
    if l == 1:
        if _l1_route_local(deg, vp):
            return "local"
        if vp <= DENSE_L1_MAX:
            return "dense"
    return "local" if l <= 3 and l in LOCAL_LEVELS else "combinatorial"


def _count_tests(stats: dict | None, l: int, deg: np.ndarray,
                 scanned: dict | None = None) -> None:
    """Adds level l's (x, S, y) evaluations to ``stats["ci_tests"]``, as the
    JAX package counts them, and to ``stats["ci_tests_level"][l]`` (so the
    levels' counts sum to ``ci_tests``): each node x with deg_x >= l + 1
    tests each of its conditioning sets S against its deg_x neighbours y,
    all comb(deg_x, l) sets, or scanned[x] of them where the combinatorial
    route's waves stopped x early. deg holds the degrees at the start of
    the level (PC-stable). A Python int: comb(152, 14) alone is past int64."""
    if stats is None:
        return
    if scanned is None:
        vals, reps = np.unique(deg[deg >= l + 1], return_counts=True)
        n = sum(math.comb(int(d), l) * int(d) * int(r) for d, r in zip(vals, reps))
    else:
        n = sum(k * int(deg[x]) for x, k in scanned.items())
    count(stats, "ci_tests", n)
    count(stats, ("ci_tests_level", l), n)


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


def _upload_lists(nodes: np.ndarray, nbrs: np.ndarray, deg: np.ndarray, vp: int, dev):
    """(nodes, nbrs, deg) as device tensors, their index range checked here
    on the host so that the kernel launches they feed need not wait for the
    device to check it."""
    check_index_range("skeleton", vp, nbrs.shape[1], nodes, nbrs, deg)
    return tuple(torch.from_numpy(a).to(dev) for a in (nodes, nbrs, deg))


def panel_from_numpy(C: np.ndarray, v_real: int, device) -> torch.Tensor:
    """A host panel as a device tensor, zero-padded to a PANEL_ALIGN multiple
    (pads have corr 0 with everything, so level 0 isolates them)."""
    C = np.asarray(C, dtype=np.float32)[:v_real, :v_real]
    pad = (-v_real) % PANEL_ALIGN
    return torch.from_numpy(np.pad(C, ((0, pad), (0, pad)))).to(device)


def _host_pass(stats: dict | None) -> span:
    """The span of a host pass between launches: degree sums, removal masks
    and adjacency updates over (n, n) arrays, the sepsets' appends."""
    return span(stats, "host_pass_s", "cigwas.skeleton.host_pass")


def _level_buckets(G: np.ndarray, l: int, dev, stats: dict | None):
    """The launches of a level l <= 3: for each degree bucket of the nodes
    with more than l neighbours, yields (nodes, nbrs, deg, (nodes, nbrs, deg)
    on the device with their index range checked, or None for dev None, det).
    det = {compact_s, sweep_s} accumulates the host compaction, check and
    upload here; the caller adds its sweep time. stats, if given, collects
    ``launches`` and ``level_detail`` of the level and, from level 2 on,
    its ``ci_tests``."""
    with _host_pass(stats):
        deg_all = G.sum(axis=1)
    active = np.where(deg_all >= l + 1)[0]
    det = {"compact_s": 0.0, "sweep_s": 0.0}
    if stats is not None:
        stats.setdefault("level_detail", {})[l] = det
        if l >= 2:
            _count_tests(stats, l, deg_all)
    for d_pad, nodes in _degree_buckets(deg_all, active):
        with span(det, "compact_s", "cigwas.skeleton.compact"):
            nbrs, deg = _compact_neighbors(G, nodes, d_pad)
            on_dev = None if dev is None else _upload_lists(nodes, nbrs, deg, G.shape[0], dev)
        if stats is not None:
            stats.setdefault("launches", {}).setdefault(l, []).append(
                (int(d_pad), int(len(nodes)))
            )
        yield nodes, nbrs, deg, on_dev, det


def _shard_parts(engine, C, nodes: np.ndarray, nbrs: np.ndarray) -> list:
    """[(shard, slice)] of a launch's nodes: the engine's parts (see
    :meth:`cigwas_tpu_torch.parallel.sharded.ShardedEngine.parts`), or one
    part of everything without an engine."""
    if engine is None:
        return [(None, slice(0, len(nodes)))]
    return engine.parts(C, nodes, nbrs)


def _part_args(engine, panels: tuple, k, nodes, nbrs, deg, on_dev, vectors: tuple,
               kernel: str) -> tuple:
    """(panels, (node_ixs, nbrs, deg) on the device, vectors) that one part
    launches on: without an engine the caller's own, else shard k's
    (:meth:`cigwas_tpu_torch.parallel.sharded.ShardedEngine.local`)."""
    if engine is None:
        return panels, on_dev, vectors
    return engine.local(panels, k, nodes, nbrs, deg, vectors, kernel)


def _hit_mask(stat: torch.Tensor, cut: float, deg_t: torch.Tensor) -> torch.Tensor:
    """The live slots whose statistic is below cut, on the device."""
    slot_ok = torch.arange(stat.shape[1], device=stat.device)[None, :] < deg_t[:, None]
    return (stat < cut) & slot_ok


def _hits(stat: torch.Tensor, cut: float, deg_t: torch.Tensor):
    """(row, slot) of the live slots whose statistic is below cut, on the device."""
    return torch.nonzero(_hit_mask(stat, cut, deg_t), as_tuple=True)


def _fisher_z_inplace(c: np.ndarray) -> None:
    """c <- fisher_z(c) (`utils.stats.fisher_z`: |0.5 log|(1+c)/(1-c)||, the
    same float32 operations in the same order, so the same bits) with one
    temporary instead of five: at an 11k block each is a 0.5 GB host
    array."""
    with np.errstate(invalid="ignore", divide="ignore"):
        z = 1 + c
        np.subtract(1, c, out=c)
        np.divide(z, c, out=c)
        np.abs(c, out=c)
        np.log(c, out=c)
        np.multiply(0.5, c, out=c)
        np.abs(c, out=c)


def _run_level_local(C, G: np.ndarray, l: int, rho_threshold: float,
                     stats: dict | None = None, want_rho: bool = False, engine=None):
    """All level-l tests (l <= 3) as one kernel launch per degree bucket
    (per part of it on each shard, with an engine; every part is launched
    before any hit is fetched).

    Returns (removed (n, n) bool, xs, ys, sep (k, l), rho (k,) or None): the
    ordered pairs condemned from x's side, their minimizing conditioning
    variables and, with want_rho, their min |rho| (fetched only then)."""
    n = G.shape[0]
    xs_l, ys_l, sep_l, rho_l = [], [], [], []
    dev = None if engine is not None else C.device
    for nodes, nbrs, deg, on_dev, det in _level_buckets(G, l, dev, stats):
        with span(det, "sweep_s", "cigwas.skeleton.sweep"):  # ends in the hits' fetch
            launched = []
            for k, sl in _shard_parts(engine, C, nodes, nbrs):
                (Ck,), lists, _ = _part_args(engine, (C,), k, nodes[sl], nbrs[sl], deg[sl],
                                             on_dev, (), f"local_sweep_l{l}")
                rho, pos = local_sweep(Ck, *lists, l, index_range_checked=True)
                launched.append((sl, rho, pos, lists[2]))
            fetched = []
            for sl, rho, pos, deg_t in launched:
                ri, ci = _hits(rho, rho_threshold, deg_t)
                pos_h = to_host(pos[ri, ci], stats, "hits")
                if want_rho:
                    rho_l.append(to_host(rho[ri, ci], stats, "hits"))
                fetched.append((to_host(ri, stats, "hits") + sl.start,
                                to_host(ci, stats, "hits"), pos_h))
        for ri, ci, pos_h in fetched:
            xs_l.append(nodes[ri])
            ys_l.append(nbrs[ri, ci])
            sep_l.append(nbrs[ri[:, None], pos_h])  # positions -> variable indices
    xs = np.concatenate(xs_l) if xs_l else np.empty(0, np.int64)
    ys = np.concatenate(ys_l) if ys_l else np.empty(0, np.int64)
    sep = np.concatenate(sep_l) if sep_l else np.empty((0, l), np.int32)
    rho_sel = None
    if want_rho:
        rho_sel = np.concatenate(rho_l) if rho_l else np.empty(0, np.float32)
    with _host_pass(stats):
        removed = np.zeros((n, n), dtype=bool)
        removed[xs, ys] = True
        removed[ys, xs] = True
    return removed, xs, ys, sep, rho_sel


def _run_level_local_hetcor(C, N, t_ix, G: np.ndarray, l: int, th: float,
                            stats: dict | None = None, engine=None) -> np.ndarray:
    """All hetcor level-l tests (l <= 3) as one kernel launch per degree
    bucket (per part of it on each shard, with an engine); returns the
    symmetric removal mask (margin < 0 from either side).

    Only the hits leave the device. Several nodes' pad slots may point at the
    same variable, so the hits alone are written (an idempotent scatter), never
    the misses."""
    with _host_pass(stats):
        cond = np.zeros(G.shape, dtype=bool)
    dev = None if engine is not None else C.device
    for nodes, nbrs, deg, on_dev, det in _level_buckets(G, l, dev, stats):
        with span(det, "sweep_s", "cigwas.skeleton.sweep"):  # ends in the hits' fetch
            launched = []
            for k, sl in _shard_parts(engine, C, nodes, nbrs):
                (Ck, Nk), lists, (tk,) = _part_args(engine, (C, N), k, nodes[sl], nbrs[sl],
                                                    deg[sl], on_dev, (t_ix,),
                                                    f"hetcor_sweep_l{l}")
                margin = hetcor_local_sweep(Ck, Nk, tk, *lists, th, l, index_range_checked=True)
                launched.append((sl, margin, lists[2]))
            fetched = [(sl.start, *(to_host(t, stats, "hits") for t in _hits(margin, 0.0, deg_t)))
                       for sl, margin, deg_t in launched]
        for start, ri, ci in fetched:
            cond[nodes[ri + start], nbrs[ri + start, ci]] = True
    with _host_pass(stats):
        cond &= G
        return cond | cond.T


def _run_level_dense1(C, G: np.ndarray, rho_threshold: float, engine=None,
                      stats: dict | None = None):
    """Level 1 by the dense route (`cigwas_tpu.skeleton.cupc.
    _run_level_dense1` / `_run_level_dense1_engine`): one dense launch per
    x-row slab (per slab of each shard with an engine), only the hits
    fetched. Returns (removed, xs, ys, sep (k, 1), rho_sel) as
    :func:`_run_level_local` returns them."""
    sweeps = (pcorr.dense1_sweeps if engine is None else engine.dense1_sweeps)(C, G)
    _, xs, ys, s_sel, rho_sel = pcorr.dense1_screen(sweeps, G.shape[0], rho_threshold,
                                                    stats=stats)
    with _host_pass(stats):
        removed = np.zeros(G.shape, dtype=bool)
        removed[xs, ys] = True
        removed[ys, xs] = True
    return removed, xs, ys, s_sel.astype(np.int32)[:, None], rho_sel


def _device_levels(Gd: torch.Tensor, lmax: int, route_of, sweep, verbose: bool,
                   stats: dict | None) -> tuple[np.ndarray, int]:
    """Levels 1..min(3, lmax) of either skeleton with the adjacency Gd on the
    device (the JAX package's device-resident loop), cleared in place by
    each level's hits once all of them exist (PC-stable). Each level
    fetches the n degrees (site ``loop_lists``) and stops where the graph
    runs out of tests; route_of(l, deg, d_pad) then names the level's
    route from those degrees and the padded max degree d_pad, or None to
    leave the level to the caller's host loop. For every route but
    ``dense`` the lists of the nodes with a test (degree >= l + 1) are
    compacted on the device at the width d_pad
    (:func:`~cigwas_tpu_torch.ops.kernels.compact_rows.compact_rows`);
    sweep(l, lists) makes the level's one launch over (nodes, nbrs, deg),
    or over the whole adjacency for ``dense`` (lists None), and returns the
    hits (xs, ys) on the device. Every hit lies on an edge, since its list
    came from Gd, so clearing it is all the update there is. Returns (Gd on
    the host, fetched once, and the first level left to the host loop)."""
    n = Gd.shape[0]
    l = 1
    while l <= min(3, lmax):
        deg = to_host(Gd.sum(dim=1, dtype=torch.int32), stats, "loop_lists")
        nprime = int(deg.max()) if n else 0
        if nprime - 1 < l:
            break
        d_pad = _pad8(nprime)
        route = route_of(l, deg, d_pad)
        if route is None:
            break
        if verbose:
            print(f"[skeleton] level {l}: max degree {nprime} ({route} on the device)")
        with span(stats, ("level_wall_s", l), f"cigwas.skeleton.level{l}"):
            if l >= 2:
                _count_tests(stats, l, deg)
            lists = None
            if route != "dense":
                nodes = torch.from_numpy(np.flatnonzero(deg >= l + 1).astype(np.int32))
                nodes = nodes.to(Gd.device)
                # in range by construction: every entry a column of Gd or the
                # pad 0, and no degree above d_pad, the level's max
                lists = (nodes, *compact_rows(Gd, nodes, d_pad, index_range_checked=True))
            xs, ys = sweep(l, lists)
            Gd[xs, ys] = False
            Gd[ys, xs] = False
        if stats is not None:
            stats.setdefault("level_route", {})[l] = route
            if lists is not None:
                stats.setdefault("launches", {})[l] = [(d_pad, int(lists[0].numel()))]
        l += 1
    with span(stats, "final_fetch_s", "cigwas.skeleton.final_fetch"):
        return to_host(Gd, stats, "final_adjacency"), l


def _loop_route(n: int, l: int, deg: np.ndarray, d_pad: int) -> str | None:
    """:func:`skeleton`'s route_of for :func:`_device_levels`: the loop takes
    every level 1-3 of a panel of at most DEV_RESIDENT_MAX variables whose
    padded width is at most _DEV_RESIDENT_WIDTH, before the level-1 gate
    (the JAX package checks the gate first, to dispatch a dense level 1
    early; on the card the loop won). Degrees only fall, so a panel that
    passes at level 1 passes at levels 2-3."""
    if LOCAL_LEVELS == (2, 3) and n <= DEV_RESIDENT_MAX and d_pad <= _DEV_RESIDENT_WIDTH:
        return "device_loop"
    return None


def _loop_sweep(C: torch.Tensor, th: np.ndarray, records: SepsetRecords,
                pmax: np.ndarray | None, stats: dict | None, l: int, lists: tuple):
    """:func:`skeleton`'s sweep for :func:`_device_levels`: one local-sweep
    launch; the hits' (x, y, sepset variables) and, for pMax, their rho are
    fetched (site ``loop_lists``), appended to records (and written into
    pmax) on the host. Returns the hits on the device."""
    nodes, nbrs, deg = lists
    rho, pos = local_sweep(C, nodes, nbrs, deg, l, index_range_checked=True)
    ri, ci = _hits(rho, float(np.float32(np.tanh(float(th[l])))), deg)
    xs, ys = nodes[ri], nbrs[ri, ci]
    sep = nbrs[ri[:, None], pos[ri, ci].long()]  # positions -> variable indices
    hits = to_host(torch.cat((xs[:, None], ys[:, None], sep), dim=1), stats, "loop_lists")
    rho = None if pmax is None else to_host(rho[ri, ci], stats, "loop_lists")
    with _host_pass(stats):
        records.append(l, hits[:, 0], hits[:, 1], hits[:, 2:])
        if pmax is not None:
            pmax[hits[:, 0], hits[:, 1]] = fisher_z(rho)
    return xs.long(), ys.long()


def _run_level(C, G: np.ndarray, l: int, rho_threshold: float | None,
               hetcor_args=None, engine=None, chunk: int = CHUNK,
               stats: dict | None = None):
    """All level-l tests (any l >= 1) over colex chunks of conditioning
    sets, the combinatorial route; returns (removed, rho_min_full,
    rank_full) like `cigwas_tpu.skeleton.cupc._run_level`. stats, if
    given, gets the tests the waves scanned added to ``ci_tests``, at
    every level this route runs, level 1 included, as the JAX package's
    scan counts them.

    rho_threshold is tanh(Th[l]) for the plain skeleton. For hetcor it is
    None and hetcor_args = (N, t_ix, th): the scan returns margins, removal
    is margin < 0, and there are no ranks.

    Each node tile's local panels come from the gather kernel (one panel, or
    two matched panels for hetcor) and feed the scan on gathered panels: for
    hetcor one launch of ``csrc/hetcor_scan.cu`` covers the tile's wave.
    With an engine each tile is split into the shards' parts (the tile is
    ndev times longer), every part launched before any result is fetched.

    Waves: every bucket scans its next chunk * n_chunks combos, then nodes
    whose combos are exhausted or whose edges are all condemned stop. The
    wave sizes follow the JAX package exactly and come from the whole
    bucket, because where a node stops decides which later sets it never
    tests, and so its sepsets."""
    n = G.shape[0]
    with _host_pass(stats):
        deg_all = G.sum(axis=1)
    active = np.where(deg_all >= l + 1)[0]
    if active.size == 0:
        with _host_pass(stats):
            return np.zeros((n, n), dtype=bool), None, None
    dev = None if engine is not None else C.device
    cut = 0.0 if hetcor_args is not None else rho_threshold
    panels, vectors = (C,), ()
    if hetcor_args is not None:
        N, t_ix, th = hetcor_args
        panels, vectors = (C, N), (t_ix,)
    kernel = "panel_gather2" if hetcor_args is not None else "panel_gather"
    total_combos = {int(x): math.comb(int(deg_all[x]), l) for x in active}
    rank_dtype = (
        object if max(total_combos.values(), default=0) > (1 << 62) else np.int64
    )
    with _host_pass(stats):
        stat_full = np.full((n, n), np.inf, dtype=np.float32)
        rank_full = np.zeros((n, n), dtype=rank_dtype)
    buckets: dict = {}
    for x in active:
        buckets.setdefault(_next_pow2(max(int(deg_all[x]), 8)), []).append(int(x))
    work = [(d_pad, buckets[d_pad], 0) for d_pad in sorted(buckets)]
    scanned: dict = {}  # node -> conditioning sets scanned up to its last wave
    while work:
        next_work = []
        for d_pad, remaining, offset in work:
            nodes = np.array(remaining, dtype=np.int32)
            node_tile = max(1, min(len(nodes), ELEM_BUDGET // (chunk * d_pad * l)))
            if engine is not None:
                node_tile = min(len(nodes), node_tile * engine.ndev)
            max_left = max(total_combos[x] - offset for x in remaining)
            n_chunks = _next_pow2(
                min(MAX_CHUNKS_PER_LAUNCH, max(1, -(-min(max_left, 1 << 30) // chunk)))
            )
            for x in remaining:
                scanned[x] = min(total_combos[x], offset + chunk * n_chunks)
            combos = torch.from_numpy(
                colex_combinations_chunk(offset, chunk * n_chunks, l)
                .reshape(n_chunks, chunk, l).astype(np.int64)
            )
            combos_of = ({dev: combos.to(dev)} if engine is None
                         else engine.replicate(combos))
            for s0 in range(0, len(nodes), node_tile):
                tile = nodes[s0 : s0 + node_tile]
                nbrs, deg = _compact_neighbors(G, tile, d_pad)
                totals = np.array(
                    [min(total_combos[int(x)] - offset, chunk * n_chunks) for x in tile],
                    dtype=np.int64,
                )
                bases = chunk * np.arange(n_chunks, dtype=np.int64)[:, None]
                left = np.clip(totals[None, :] - bases, 0, chunk)
                on_dev = None if engine is not None else _upload_lists(tile, nbrs, deg, n, dev)
                launched = []
                for k, sl in _shard_parts(engine, C, tile, nbrs):
                    pk, (tile_t, nbrs_t, deg_t), vk = _part_args(
                        engine, panels, k, tile[sl], nbrs[sl], deg[sl], on_dev, vectors, kernel)
                    pdev = pk[0].device
                    combos_seq = combos_of[pdev]
                    left_seq = torch.from_numpy(left[:, sl]).to(pdev)
                    if hetcor_args is None:
                        Cb, qb = gather_local_panels(pk[0], tile_t, nbrs_t, deg_t,
                                                     index_range_checked=True)
                        launched.append(pcorr.level_scan_minrho_pre(
                            Cb, qb, deg_t.long(), combos_seq, left_seq, l
                        ))
                    else:
                        (t_k,) = vk
                        Cb, qb, Nb, nr = gather_local_panels2(
                            pk[0], pk[1], tile_t, nbrs_t, deg_t, index_range_checked=True)
                        launched.append((hetcor_scan(
                            Cb, qb, Nb, nr, t_k[nbrs_t.long()].float(),
                            t_k[tile_t.long()].float(), deg_t, combos_seq, left_seq, th, l,
                        ), None))
                rho_c = np.concatenate([to_host(r, stats, "hits") for r, _ in launched])
                rank_c = None
                if hetcor_args is None:
                    ranks = [to_host(r, stats, "hits") for _, r in launched]
                    rank_c = np.concatenate(ranks).astype(rank_dtype) + offset
                valid = np.arange(d_pad)[None, :] < deg[:, None]
                x_idx = np.repeat(tile, d_pad).reshape(len(tile), d_pad)[valid]
                y_idx = nbrs[valid]
                vals = rho_c[valid]
                better = vals < stat_full[x_idx, y_idx]
                stat_full[x_idx[better], y_idx[better]] = vals[better]
                if rank_c is not None:
                    rank_full[x_idx[better], y_idx[better]] = rank_c[valid][better]
            next_work.append((d_pad, remaining, offset + chunk * n_chunks))
        with _host_pass(stats):
            cond = (stat_full < cut) & G
            live_edge = G & ~(cond | cond.T)
        work = []
        for d_pad, remaining, offset in next_work:
            nxt = [
                x for x in remaining
                if total_combos[x] > offset and live_edge[x].any()
            ]
            if nxt:
                work.append((d_pad, nxt, offset))
    _count_tests(stats, l, deg_all, scanned)
    with _host_pass(stats):
        cond = (stat_full < cut) & G
        return cond | cond.T, stat_full, rank_full


def skeleton(C, thresholds: np.ndarray, max_level: int, device="cuda",
             n_var: int | None = None, verbose: bool = False,
             stats: dict | None = None, want_pmax: bool = True,
             engine=None, chunk: int = CHUNK) -> SkeletonResult:
    """PC-stable skeleton over a dense correlation panel (`Skeleton`,
    `cuPC-S.cu:61-450`; level 0 overwrites the adjacency from C).

    C: a numpy panel (padded here, see :func:`panel_from_numpy`) or a device
    tensor; n_var marks a tensor that is already padded with inert
    variables (the `ops.corr` panels). stats, if given, collects
    ``l0_wall_s``, ``sepset_alloc_s`` (the set-up of the sepset's
    :class:`SepsetRecords`), ``level_wall_s`` {level: s},
    ``level_route`` {level: local, dense, combinatorial or device_loop}, the
    per-bucket ``launches`` {level: [(d_pad, nodes)]} and, for levels 1-3 of
    the list route, ``level_detail`` {level: {compact_s, sweep_s}} (host
    compaction and upload; kernel launches up to the fetch of their hits);
    on one card ``final_fetch_s`` (the adjacency's one fetch, after the
    device-resident loop or where the host loop starts at level 1); with
    want_pmax also ``c_fetch_wall_s`` (the fetch of the panel and of the
    level-0 adjacency for level 0's pMax) and ``pmax_wall_s`` (level 0's
    pMax and the final pass, on the host). On
    every route also ``ci_tests``, the exact number of (x, S, y) evaluations
    of levels >= 2 (and of level 1 where it takes the combinatorial route),
    a Python int, and ``ci_tests_level`` {level: its share of them}
    (:func:`_count_tests`); ``preamble_s``, entry to the start
    of the host's level loop (level 0, the sepset records' set-up, the
    panel's fetch and the device-resident loop); ``skeleton_wall_s``, entry
    to return; ``host_pass_s``, the host passes over (n, n) arrays between
    launches (degree sums, removal masks, adjacency updates, the sepsets'
    appends, the final cast); ``sepset_records``, the removals recorded
    with a separating set (and, once the result is reduced,
    ``sepset_kept``, see :class:`SepsetRecords`); ``d2h_bytes`` {site:
    bytes} of its fetches (on
    one card: the degrees of each device level and the loop's hits under
    ``loop_lists``, the adjacency once under ``final_adjacency``, the level-0
    adjacency under ``l0_adjacency`` only for pMax). Each
    wall is a :class:`~cigwas_tpu_torch.utils.timing.span`, named
    ``cigwas.skeleton.*`` in a profiler's trace; each fetch goes through
    :func:`~cigwas_tpu_torch.utils.timing.to_host` (the engines' own fetches
    are not counted).

    want_pmax (the JAX package's default) also returns pMax
    (`cuPC-S.cu:424-442`): level 0 writes the Fisher z of C on the pairs it
    deletes, computed on the host from the fetched panel of the real
    variables, as the JAX package computes it; levels >= 1 write
    the Fisher z of the min |rho| of each ordered pair condemned from x's
    side (levels 1-3 then also fetch the hits' rho); then the max of both
    sides, PMAX_RETAINED on the kept edges and 1.0 on the diagonal. The
    pipelines pass want_pmax=False: they never read pMax, and it costs the
    panel's fetch and two (n, n) host arrays.

    engine: a :class:`cigwas_tpu_torch.parallel.sharded.ShardedEngine` (or
    ``RowShardedEngine``) runs every level over its shards (C may then be
    the engine's own panel, with n_var); the results are the one-device
    path's, bit for bit, and ``device`` is not used.

    chunk: conditioning sets per chunk of the combinatorial route.

    The result's sepsets are its ``records``, one a removal; its
    ``sepset``, the (v, v, depth) array of the JAX package's result, is
    built from them on first access. The pipelines reduce the records and
    never build the array.

    The routes of levels 1-3 (the module attributes LOCAL_LEVELS,
    DENSE_L1_MAX, DEV_RESIDENT_MAX, L1_LOCAL_MAX_WIDTH, L1_LOCAL_COST_RATIO
    choose them, see the module docstring) all decide the same.
    """
    with span(stats, "skeleton_wall_s", "cigwas.skeleton.pc"):
        with span(stats, "preamble_s", "cigwas.skeleton.preamble"):
            require_full_f32()  # the combinatorial route's one-hot selections must be exact
            th = np.asarray(thresholds, dtype=np.float32)
            C, G, v_real = _level0(C, th, device, n_var, engine, stats)
            n = G.shape[0]
            lmax = min(ML, max_level)
            with span(stats, "sepset_alloc_s", "cigwas.skeleton.sepset_fill"):
                records = SepsetRecords(v_real, max(1, lmax), stats)
            pmax = None
            if want_pmax:
                # level 0: the Fisher z of C on the pairs it deleted, 0 elsewhere,
                # over the real variables only (pads never re-enter)
                with span(stats, "c_fetch_wall_s", "cigwas.skeleton.pmax_fetch"):
                    if engine is None:
                        pmax = to_host(C[:v_real, :v_real], stats, "pmax_panel", copy=True)
                        kept0 = to_host(G[:v_real, :v_real], stats, "l0_adjacency")
                    else:
                        pmax, kept0 = engine.fetch(C, v_real), G[:v_real, :v_real]
                with span(stats, "pmax_wall_s", "cigwas.skeleton.pmax"):
                    _fisher_z_inplace(pmax)
                    pmax[kept0] = 0.0
                    np.fill_diagonal(pmax, 0.0)
            start_l = 1
            if engine is None:
                G, start_l = _device_levels(
                    G, lmax, functools.partial(_loop_route, n),
                    functools.partial(_loop_sweep, C, th, records, pmax, stats), verbose, stats)
        G, final_level = _host_levels(C, G, th, start_l, lmax, records, pmax, verbose, stats,
                                      engine, chunk)
        if pmax is not None:  # both sides' max; the kept edges' sentinel; 1 on the diagonal
            with span(stats, "pmax_wall_s", "cigwas.skeleton.pmax"):
                pmax = np.maximum(pmax, pmax.T)
                pmax[G[:v_real, :v_real]] = PMAX_RETAINED
                np.fill_diagonal(pmax, 1.0)
        with _host_pass(stats):
            G_out = _cast(G[:v_real, :v_real], torch.int32)
        return SkeletonResult(G=G_out, sepset=records, final_level=final_level, pmax=pmax)


def _level0(C, th: np.ndarray, device, n_var: int | None, engine, stats: dict | None):
    """:func:`skeleton`'s level 0: (C as the levels read it, the level-0
    adjacency, on the device, or on the host with an engine, the number of
    real variables)."""
    if engine is not None:
        v_real = n_var if n_var is not None else C.shape[0]
        C = engine.as_panel(C, v_real)
        with span(stats, "l0_wall_s", "cigwas.skeleton.level0"):
            G = engine.screen((C,), lambda c: pcorr.level0_keep(c, float(th[0])))
            np.fill_diagonal(G, False)
        return C, G, v_real
    device = resolve(device)
    if isinstance(C, torch.Tensor):
        v_real = n_var if n_var is not None else C.shape[0]
        C = C.to(device=device, dtype=torch.float32)
        if C.shape[0] == v_real and v_real % PANEL_ALIGN:
            pad = (-v_real) % PANEL_ALIGN
            C = torch.nn.functional.pad(C, (0, pad, 0, pad))
    else:
        v_real = n_var if n_var is not None else np.asarray(C).shape[0]
        C = panel_from_numpy(C, v_real, device)
    with span(stats, "l0_wall_s", "cigwas.skeleton.level0"):
        G = pcorr.level0_screen(C, float(th[0]))
    return C, G, v_real


def _host_levels(C, G: np.ndarray, th: np.ndarray, start_l: int, lmax: int,
                 records: SepsetRecords, pmax: np.ndarray | None, verbose: bool,
                 stats: dict | None, engine, chunk: int):
    """:func:`skeleton`'s host loop, levels start_l..lmax from the adjacency
    G (level 0's, or what :func:`_device_levels` hands over): each level's
    route, its deletions, their sepsets appended to records (and pMax).
    Returns (G, final level)."""
    n = G.shape[0]
    for l in range(start_l, lmax + 1):
        with _host_pass(stats):
            deg = G.sum(axis=1)
        nprime = int(deg.max()) if n else 0
        if nprime - 1 < l:
            return G, l - 1
        if verbose:
            print(f"[skeleton] level {l}: max degree {nprime}")
        with span(stats, ("level_wall_s", l), f"cigwas.skeleton.level{l}"):
            # f32-rounded threshold, compared in f32 on the device
            rho_th = float(np.float32(np.tanh(float(th[l]))))
            route = _level_route(l, deg, n)
            if route != "combinatorial":
                if route == "local":
                    removed, xs, ys, sep, rho_sel = _run_level_local(
                        C, G, l, rho_th, stats, want_rho=pmax is not None, engine=engine)
                else:
                    removed, xs, ys, sep, rho_sel = _run_level_dense1(C, G, rho_th, engine,
                                                                      stats)
                with _host_pass(stats):
                    records.append(l, xs, ys, sep)
                    if pmax is not None:
                        pmax[xs, ys] = fisher_z(rho_sel)
            else:
                removed, rho_min, rank = _run_level(C, G, l, rho_th, engine=engine,
                                                    chunk=chunk, stats=stats)
                if rho_min is not None:
                    with _host_pass(stats):
                        xs, ys = np.nonzero((rho_min < rho_th) & G)
                        if pmax is not None:
                            pmax[xs, ys] = fisher_z(rho_min[xs, ys])
                        sep = np.empty((xs.size, l), dtype=np.int32)
                        prev_x, nbr_x = -1, None
                        for i, (x, y) in enumerate(zip(xs, ys)):  # xs ascending from np.nonzero
                            if x != prev_x:
                                nbr_x = np.where(G[x])[0]
                                prev_x = x
                            sep[i] = nbr_x[colex_unrank(int(rank[x, y]), l)]
                        records.append(l, xs, ys, sep)
            with _host_pass(stats):
                G = G & ~removed
        if stats is not None:
            stats.setdefault("level_route", {})[l] = route
    return G, lmax


def _cast(a, dtype: torch.dtype) -> np.ndarray:
    """A host array cast to dtype (bool: nonzero), as numpy's astype casts,
    in torch's intra-op threads: an (n, n) adjacency cast is a pass over
    hundreds of MB."""
    a = np.asarray(a)
    if min(a.strides, default=0) < 0:  # torch takes no negative strides
        a = a.copy()
    return torch.from_numpy(a).to(dtype, memory_format=torch.contiguous_format).numpy()


def _as_panel(M, device) -> torch.Tensor:
    if isinstance(M, torch.Tensor):
        return M.to(device=device, dtype=torch.float32)
    return torch.from_numpy(np.ascontiguousarray(M, dtype=np.float32)).to(device)


def hetcor_skeleton(C, G: np.ndarray, N, threshold: float, max_level: int,
                    time_index: np.ndarray | None = None, device="cuda",
                    verbose: bool = False, ess_mode: str = "reference",
                    stats: dict | None = None, engine=None,
                    chunk: int = CHUNK) -> SkeletonResult:
    """Skeleton with per-pair effective sample sizes and time constraints
    (`cigwas_tpu.skeleton.cupc.hetcor_skeleton`; `hetcor-cuPC-S.cu:75-341`):
    honours the incoming adjacency (level 0 only deletes), uses per-test
    thresholds th / sqrt(mean_ess - l - 3), and returns the adjacency only.

    C, N: (v, v) numpy panels or tensors; they live on ``device`` from here
    on. Both are padded to a PANEL_ALIGN multiple, C with 0 and N with 10.0
    (inert: corr 0, finite ESS, no incoming edges).

    ess_mode selects the mean_ess of levels >= 1: ``"reference"`` truncates
    each pairwise ESS toward zero with NaN -> 0 and counts every pair (the
    reference's int conversion); ``"float"`` keeps full precision and leaves
    NaN pairs out of the mean. Level 0 always reads the raw per-pair N.

    stats, if given, collects ``l0_wall_s``, ``level_wall_s`` {level: s},
    ``level_route`` {level: local, dense or combinatorial}, the per-bucket
    ``launches`` {level: [(d_pad, nodes)]}, ``level_detail`` of levels
    1-3 on the list route, ``ci_tests`` and ``ci_tests_level`` as
    :func:`skeleton` counts them,
    ``skeleton_wall_s``, entry to return (the JAX package's starts after
    level 0), ``device_levels``, the levels that ran with the adjacency on
    the device (0 first; empty with an engine), with ``final_fetch_s``
    after them, and ``host_pass_s`` and ``d2h_bytes`` as :func:`skeleton`
    counts them (the device levels fetch their degrees under
    ``loop_lists`` and the adjacency once under ``final_adjacency``).
    Level 1 takes the list, dense or combinatorial route as
    :func:`skeleton`'s does (:func:`_level_route`), levels 2-3 the list
    route unless LOCAL_LEVELS leaves them out; all decide the same, on the
    device or the host.
    chunk: conditioning sets per chunk of the combinatorial route.

    engine: a :class:`cigwas_tpu_torch.parallel.sharded.ShardedEngine` (or
    ``RowShardedEngine``) places C and N as it keeps panels (padded to its
    own multiple) and runs every level over its shards; the adjacency is the
    one-device path's and ``device`` is not used.
    """
    if ess_mode not in ("reference", "float"):
        raise ValueError(f"unknown ess_mode: {ess_mode!r}")
    with span(stats, "skeleton_wall_s", "cigwas.skeleton.hetcor"):
        require_full_f32()  # the level >= 4 one-hot selections must be exact
        if engine is None:
            device = resolve(device)
            C = _as_panel(C, device)
            N_raw = _as_panel(N, device)
            v_real = C.shape[0]
            pad = (-v_real) % PANEL_ALIGN
            if pad:
                C = torch.nn.functional.pad(C, (0, pad, 0, pad))
                N_raw = torch.nn.functional.pad(N_raw, (0, pad, 0, pad), value=10.0)
        else:
            v_real = C.shape[0]
            C, N_raw = engine.put_panel(C), engine.put_panel(N, fill=10.0)
            pad = C.vp - v_real
        n = v_real + pad
        with _host_pass(stats):  # one card uploads G and pads it there
            G = _cast(G, torch.bool)
            if engine is not None:
                G = np.pad(G, ((0, pad), (0, pad)))
        if time_index is None:
            time_index = np.zeros(n, dtype=np.int32)
        else:
            time_index = np.pad(np.asarray(time_index, dtype=np.int32), (0, pad))
        if engine is None:
            t_ix = torch.from_numpy(time_index).to(device)
        else:
            t_ix = engine.replicate(torch.from_numpy(time_index))

        with span(stats, "l0_wall_s", "cigwas.skeleton.level0"):
            if engine is None:
                # after the screen's float temporaries are freed: the upload
                # adds no (n, n) array to the screen's peak
                deleted = pcorr.hetcor_l0_delete(C, N_raw, threshold)
                Gd = torch.zeros((n, n), dtype=torch.bool, device=device)
                Gd[:v_real, :v_real] = torch.from_numpy(G)
                Gd.logical_and_(deleted.logical_not_())
                Gd.diagonal().zero_()
                del deleted
                N_lvl = pcorr.trunc_ref_ess(N_raw) if ess_mode == "reference" else N_raw
            else:
                deleted = engine.screen((C, N_raw),
                                        lambda c, nn: pcorr.hetcor_l0_delete(c, nn, threshold))
                N_lvl = (engine.map(N_raw, pcorr.trunc_ref_ess) if ess_mode == "reference"
                         else N_raw)
                with _host_pass(stats):
                    G &= ~deleted
                    np.fill_diagonal(G, False)
                del deleted
            del N_raw

        lmax = min(ML, max_level)
        start_l = 1
        if engine is None:
            G, start_l = _device_levels(
                Gd, lmax, functools.partial(_hetcor_route, n),
                functools.partial(_hetcor_sweep, C, N_lvl, t_ix, Gd, float(threshold)),
                verbose, stats)
            del Gd
        if stats is not None:
            stats["device_levels"] = list(range(start_l)) if engine is None else []
        G, final_level = _hetcor_levels(C, N_lvl, t_ix, G, float(threshold), start_l, lmax,
                                        verbose, stats, engine, chunk)
        with _host_pass(stats):
            G_out = _cast(G[:v_real, :v_real], torch.int32)
        return SkeletonResult(G=G_out, sepset=None, final_level=final_level)


def _hetcor_route(n: int, l: int, deg: np.ndarray, d_pad: int) -> str | None:
    """:func:`hetcor_skeleton`'s route_of for :func:`_device_levels`: level
    l's own route (:func:`_level_route`) while it is dense, or local at a
    padded width of at most _DEV_RESIDENT_WIDTH."""
    route = _level_route(l, deg, n)
    if route == "combinatorial" or (route == "local" and d_pad > _DEV_RESIDENT_WIDTH):
        return None
    return route


def _hetcor_sweep(C, N_lvl, t_ix, Gd: torch.Tensor, th: float, l: int, lists: tuple | None):
    """:func:`hetcor_skeleton`'s sweep for :func:`_device_levels`: the dense
    level 1 over Gd (lists None) or one hetcor local-sweep launch; returns
    the hits (margin < 0) on the device."""
    if lists is None:
        hits = pcorr.dense1_device_hits(pcorr.dense1_sweeps(C, Gd, N_lvl, t_ix, th))
        return tuple(torch.cat([h[k] for h in hits]).long() for k in (0, 1))
    nodes, nbrs, deg = lists
    margin = hetcor_local_sweep(C, N_lvl, t_ix, nodes, nbrs, deg, th, l,
                                index_range_checked=True)
    ri, ci = _hits(margin, 0.0, deg)
    return nodes[ri].long(), nbrs[ri, ci].long()


def _hetcor_levels(C, N_lvl, t_ix, G: np.ndarray, th: float, start_l: int, lmax: int,
                   verbose: bool, stats: dict | None, engine, chunk: int):
    """:func:`hetcor_skeleton`'s levels start_l..lmax from the adjacency G
    (level 0's, or what :func:`_device_levels` hands over); returns (G,
    final level)."""
    n = G.shape[0]
    for l in range(start_l, lmax + 1):
        with _host_pass(stats):
            nprime = int(G.sum(axis=1).max()) if n else 0
        if nprime - 1 < l:
            return G, l - 1
        if verbose:
            print(f"[hetcor_skeleton] level {l}: max degree {nprime}")
        with span(stats, ("level_wall_s", l), f"cigwas.skeleton.level{l}"):
            with _host_pass(stats):
                deg = G.sum(axis=1)
            route = _level_route(l, deg, n)
            if route == "local":  # the hetcor sweep kernel
                removed = _run_level_local_hetcor(C, N_lvl, t_ix, G, l, th, stats, engine=engine)
            elif route == "dense":
                sweeps = (pcorr.dense1_sweeps if engine is None else engine.dense1_sweeps)(
                    C, G, N_lvl, t_ix, th)
                cond = pcorr.dense1_screen(sweeps, n, stats=stats)
                with _host_pass(stats):
                    removed = cond | cond.T
            else:
                removed, _, _ = _run_level(C, G, l, None, hetcor_args=(N_lvl, t_ix, th),
                                           engine=engine, chunk=chunk, stats=stats)
            with _host_pass(stats):
                G = G & ~removed
        if stats is not None:
            stats.setdefault("level_route", {})[l] = route
    return G, lmax
