"""The multi-device engines (`cigwas_tpu.parallel.sharded`): one block's
correlation panel and skeleton levels spread over the devices of a mesh axis.

One process drives every device of the axis (``engine.devices``, D entries;
a device may repeat, and then several shards share it). Collectives are
explicit copies between devices: the slabs of a panel gathered into a copy
per device, the stripes of a row-sharded panel passed round the shards, the
boundary rows of the banded correlation. Each shard runs the port's own
kernels on its part of the work:

* the correlation panel: shard k computes the Kendall rows of its slab of
  marker rows against every marker (exact int8 contingency counts); the
  marker-phen and phen-phen blocks are computed once, as the one-device
  panel of the block's size computes them, so every entry has the
  one-device bits;
* levels 1-3 (``local_sweep.cu``, ``hetcor_sweep.cu``) and levels >= 4
  (``panel_gather.cu`` feeding the plain scans): every degree bucket's node
  list (and every node tile of a level >= 4 wave) is split into D
  contiguous parts and part k is launched on shard k; the wave schedule is
  the whole bucket's, so a node stops where it stops on one device;
* :class:`ShardedEngine` keeps the panel replicated, one copy per distinct
  device; :class:`RowShardedEngine` keeps only (vp / D, vp) row stripes and
  builds, for each launch, the compact panel ``C[U, U]`` of the indices U
  its lists hold (pads included) from the stripes, remapping the lists to
  positions in U (order kept, so slot positions and colex ranks are the
  same); a part whose U is wider than a stripe holds is split into several
  launches. No device of the row-sharded engine holds a (vp, vp) tensor.

Level 1 takes the route the one-device skeleton takes (the same gate,
:func:`cigwas_tpu_torch.skeleton.cupc._level_route`). Its dense route
(``csrc/dense_l1.cu``) runs here as the JAX package's engines run it: the
replicated engine's shard k sweeps its x-row slab of the panel against
every y of its copy; the row-sharded engine's shard k sweeps its stripe's x
rows against each stripe's y columns in turn: the column block of R = 1 /
sqrt(|1 - C^2|) and P = C R gathered from every stripe's rows, N's rows of
that stripe transposed, both copied to shard k. Every (x, y) is swept over
all s in one launch, so no minimum depends on the order of the ring.

Every engine keeps a record of what it did (``engine.record``): each tensor
it placed (what, shard, device, shape), the bytes copied from one shard's
tensor into another shard's (``crossed_bytes``, counted between shards even
where they share a card) and from the host (``uploaded_bytes``), and its
calls per shard and kernel.
"""

from __future__ import annotations

import math
from collections import Counter

import numpy as np
import torch

from cigwas_tpu_torch.constants import PANEL_ALIGN
from cigwas_tpu_torch.device import require_full_f32, resolve
from cigwas_tpu_torch.ops.corr import (
    DECODE_ONCE_MAX_BYTES,
    DEFAULT_SAMPLE_CHUNK,
    _banded_tile,
    _banded_tile_abs_sums,
    _count_panel,
    _kendall_from_counts,
    _pad_rows,
    _prep_bytes,
    _sample_chunk,
    fused_trait_blocks,
    phen_phen_corr,
)
from cigwas_tpu_torch.ops.decode import (
    PAD_BYTE,
    contingency_counts,
    geno_onehot,
    unpack_bed_codes,
)
from cigwas_tpu_torch.ops import pcorr
from cigwas_tpu_torch.ops.kernels import dense_l1 as dk
from cigwas_tpu_torch.ops.kernels.checks import check_index_range
from cigwas_tpu_torch.parallel.mesh import Mesh, flat_mesh, visible_devices
from cigwas_tpu_torch.utils.timing import count


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def split_even(n: int, parts: int) -> list:
    """[(start, stop)] of n items in `parts` contiguous runs, the first
    n % parts one longer (numpy's array_split)."""
    q, r = divmod(n, parts)
    bounds = np.cumsum([0] + [q + (k < r) for k in range(parts)])
    return [(int(bounds[k]), int(bounds[k + 1])) for k in range(parts)]


class ShardedPanel:
    """A (vp, vp) float32 panel spread over an engine's shards: ``parts[k]``
    is shard k's copy of the whole panel (replicated; shards on one device
    share one tensor) or its (vp / D, vp) stripe of rows [k L, (k + 1) L)
    (row-sharded)."""

    def __init__(self, engine, parts: list, vp: int):
        self.engine = engine
        self.parts = parts
        self.vp = vp
        self.shape = (vp, vp)

    def submatrix(self, keep: np.ndarray) -> np.ndarray:
        """The kept (k, k) block on the host, gathered on the devices."""
        return self.engine.submatrix(self, keep)


class ShardedEngine:
    """Replicated-panel engine over the devices of one mesh axis; ``ndev``
    shards. A panel is computed in row slabs, one per shard, and copied to
    every distinct device once. See the module docstring."""

    rowsharded = False

    def __init__(self, mesh: Mesh, axis: str = "marker"):
        self.mesh = mesh
        self.axis = axis
        devices = []
        for dev in mesh.axis_devices(axis):
            dev = resolve(dev)
            if dev.type not in ("cpu", "cuda"):
                raise ValueError(f"unsupported engine device {dev}")
            if dev.type == "cuda":  # indexed, as the tensors on it report their device
                dev = torch.device("cuda", torch.cuda.current_device() if dev.index is None
                                   else dev.index)
                if dev.index >= torch.cuda.device_count():
                    raise ValueError(f"{dev} asked for, {torch.cuda.device_count()} cards visible")
            devices.append(dev)
        self.devices = tuple(devices)
        self.ndev = len(self.devices)
        # the first shard on each distinct device owns that device's copies
        self.owner = {}
        for k, dev in enumerate(self.devices):
            self.owner.setdefault(dev, k)
        self.reset_record()

    @classmethod
    def flat(cls, devices=None, axis: str = "marker", device="cuda"):
        """Engine over a 1-D mesh of the given devices (default: every
        visible card, or ``device``'s; a CPU engine needs them given)."""
        if devices is None:
            devices = visible_devices(None, device)
        return cls(flat_mesh(devices, axis), axis)

    def for_stage2(self):
        """Engine for the second cusk stage (the reduced panel)."""
        return self

    # --- the record ---------------------------------------------------------

    def reset_record(self) -> None:
        self.record = {"placed": [], "crossed_bytes": 0, "uploaded_bytes": 0,
                       "calls": [Counter() for _ in range(self.ndev)]}

    def _placed(self, what: str, k: int, t: torch.Tensor) -> torch.Tensor:
        self.record["placed"].append((what, k, str(t.device), tuple(t.shape)))
        return t

    def _copy(self, t: torch.Tensor, src: int | None, k: int) -> torch.Tensor:
        """t (on shard src's device, or the host for src None) on shard k's
        device; counts the bytes that leave their shard or the host."""
        if src is None:
            self.record["uploaded_bytes"] += _nbytes(t)
        elif src != k:
            self.record["crossed_bytes"] += _nbytes(t)
        return t.to(self.devices[k])

    def call(self, k: int, kernel: str) -> None:
        """Shard k is about to run `kernel` (counted per shard)."""
        self.record["calls"][k][kernel] += 1

    def parts(self, P: ShardedPanel, nodes: np.ndarray, nbrs: np.ndarray) -> list:
        """[(k, slice)]: the launches of a list of nodes over panel P, the
        D contiguous parts of it in order, empty ones left out."""
        return [(k, slice(a, b)) for k, (a, b) in enumerate(split_even(len(nodes), self.ndev))
                if b > a]

    # --- placement ----------------------------------------------------------

    def align(self) -> int:
        """Multiple the panels are padded to."""
        return PANEL_ALIGN

    def replicate(self, t: torch.Tensor, src: int | None = None) -> dict:
        """{device: t on it} for every distinct device, each one copy."""
        return {dev: self._copy(t, src, k) for dev, k in self.owner.items()}

    def _from_rows(self, vp: int, build, what: str) -> ShardedPanel:
        """A panel whose row slab [r0, r1) shard k builds as build(k, r0, r1)
        on its device: here gathered into one copy per distinct device."""
        full = {dev: self._placed(what, k, torch.empty((vp, vp), dtype=torch.float32, device=dev))
                for dev, k in self.owner.items()}
        for k, (r0, r1) in enumerate(split_even(vp, self.ndev)):
            if r1 == r0:
                continue
            slab = self._placed("slab", k, build(k, r0, r1))
            for dev, owner in self.owner.items():
                full[dev][r0:r1] = self._copy(slab, k, owner)
        return ShardedPanel(self, [full[dev] for dev in self.devices], vp)

    def _padded_size(self, v: int) -> int:
        return -(-v // self.align()) * self.align()

    def put_panel(self, x, fill: float = 0.0) -> ShardedPanel:
        """A (v, v) numpy panel or tensor placed as this engine keeps panels,
        padded to a multiple of :meth:`align` with `fill` (inert variables:
        corr 0, or a finite ESS): here padded where it lies and copied once
        to every distinct device."""
        v = x.shape[0]
        pad = self._padded_size(v) - v
        if isinstance(x, torch.Tensor):
            src = self.owner.get(x.device)
            padded = torch.nn.functional.pad(x.to(torch.float32), (0, pad, 0, pad), value=fill)
        else:
            src = None
            padded = torch.from_numpy(np.pad(np.asarray(x, dtype=np.float32), ((0, pad), (0, pad)),
                                             constant_values=fill))
        copies = self.replicate(padded, src)
        for dev, k in self.owner.items():
            self._placed("panel", k, copies[dev])
        return ShardedPanel(self, [copies[dev] for dev in self.devices], v + pad)

    def as_panel(self, C, v_real: int, fill: float = 0.0) -> ShardedPanel:
        """C itself if it is this engine's panel, else its real (v_real,
        v_real) part placed with :meth:`put_panel`."""
        if isinstance(C, ShardedPanel):
            if C.engine is not self:
                raise ValueError("the panel belongs to another engine")
            return C
        return self.put_panel(C[:v_real, :v_real], fill)

    def map(self, P: ShardedPanel, fn) -> ShardedPanel:
        """fn, elementwise, over every stored part of P."""
        done = {}
        parts = []
        for t in P.parts:
            if id(t) not in done:
                done[id(t)] = fn(t)
            parts.append(done[id(t)])
        return ShardedPanel(self, parts, P.vp)

    def screen(self, panels: tuple, fn) -> np.ndarray:
        """The host (vp, vp) bool of an elementwise test fn(*panels)."""
        return fn(*(P.parts[0] for P in panels)).cpu().numpy()

    def fetch(self, P: ShardedPanel, v: int) -> np.ndarray:
        """The real (v, v) part of P on the host."""
        return P.parts[0][:v, :v].to("cpu", copy=True).numpy()

    def submatrix(self, P: ShardedPanel, keep: np.ndarray) -> np.ndarray:
        kd = torch.from_numpy(np.asarray(keep, dtype=np.int64)).to(P.parts[0].device)
        return P.parts[0].index_select(0, kd).index_select(1, kd).cpu().numpy().astype(np.float32)

    def local(self, panels: tuple, k: int, nodes: np.ndarray, nbrs: np.ndarray,
              deg: np.ndarray, vectors: tuple = (), kernel: str = "") -> tuple:
        """What shard k launches a part of a level on: (panels, (node_ixs,
        nbrs, deg) int32 on its device with their index range checked,
        vectors). Replicated: the shard's copies, the lists as they are."""
        self.call(k, kernel)
        dev = self.devices[k]
        check_index_range("skeleton", panels[0].vp, nbrs.shape[1], nodes, nbrs, deg)
        lists = tuple(self._copy(torch.from_numpy(np.ascontiguousarray(a)), None, k)
                      for a in (nodes, nbrs, deg))
        return tuple(P.parts[k] for P in panels), lists, tuple(v[dev] for v in vectors)

    # --- the dense level 1 ----------------------------------------------------

    def _g_rows(self, G: np.ndarray, k: int, a: int, b: int) -> torch.Tensor:
        """Rows [a, b) of the host adjacency on shard k's device."""
        return self._copy(torch.from_numpy(np.ascontiguousarray(G[a:b], dtype=bool)), None, k)

    def dense1_sweeps(self, C: ShardedPanel, G: np.ndarray, N: ShardedPanel | None = None,
                      t_ix: dict | None = None, th: float = 0.0):
        """Every launch of a dense level 1 (`cigwas_tpu.parallel.sharded.
        make_level1_sharded` / `make_hetcor1_sharded`): shard k sweeps its
        x-row slab split_even(vp, D)[k] against every y of its copy of the
        panel (:func:`cigwas_tpu_torch.ops.pcorr.dense1_slab_sweeps`; t_ix
        the engine's replicated time index for hetcor). Fold them with
        ``pcorr.dense1_gather`` or ``pcorr.dense1_screen``."""
        factors = {}
        entry = "dense_l1" if N is None else "hetcor_dense_l1"
        for k, (a, b) in enumerate(split_even(C.vp, self.ndev)):
            if b == a:
                continue
            Ck = C.parts[k]
            if id(Ck) not in factors:  # one per distinct device, N transposed with them
                R, P = dk.factors(Ck)
                factors[id(Ck)] = (R, P) if N is None else (R, P, N.parts[k].T.contiguous())
            ys = factors[id(Ck)]
            yield from pcorr.dense1_slab_sweeps(
                Ck[a:b], ys[0][a:b], ys[1][a:b], self._g_rows(G, k, a, b), ys, a, 0,
                None if N is None else N.parts[k][a:b],
                None if N is None else t_ix[self.devices[k]], th,
                on_launch=lambda k=k: self.call(k, entry))

    def level1_dense_minrho(self, C: ShardedPanel, G: np.ndarray):
        """`pcorr.level1_dense_minrho` over the shards: (rho_min, s_argmin),
        (vp, vp) on the host."""
        return tuple(t.numpy() for t in pcorr.dense1_gather(self.dense1_sweeps(C, G), C.vp,
                                                            "cpu"))

    def hetcor1_dense_margin(self, C: ShardedPanel, N: ShardedPanel, t_ix: dict,
                             G: np.ndarray, th: float) -> np.ndarray:
        """`pcorr.hetcor1_dense_margin` over the shards, (vp, vp) on the host."""
        return pcorr.dense1_gather(self.dense1_sweeps(C, G, N, t_ix, th), C.vp, "cpu").numpy()

    # --- the correlation panel ------------------------------------------------

    def corr_panel_device(self, bed_bytes, phen: np.ndarray, marker_mean: np.ndarray,
                          marker_std: np.ndarray, num_samples: int,
                          mp_corr: np.ndarray | None = None,
                          sample_chunk: int = DEFAULT_SAMPLE_CHUNK,
                          stats: dict | None = None):
        """The block's panel (layout [m markers, p traits, inert pads], vp a
        multiple of :meth:`align`) built in one row slab per shard; returns
        (panel, v). Without mp_corr the trait blocks are
        :func:`~cigwas_tpu_torch.ops.corr.fused_trait_blocks` (the
        single-pass panel's); with mp_corr (the pre-screen's correlations)
        they are mp_corr and ``phen_phen_corr``, as the striped panel takes
        them. stats, if given, receives the one-device panel's counters
        (``panel_markers``, ``panel_samples``, ``panel_sample_chunks``, and
        ``panel_decode_bytes`` over every shard's decodes); the engine's
        copies are in its ``record``."""
        require_full_f32()
        bed_bytes = np.asarray(bed_bytes, dtype=np.uint8)
        phen = np.asarray(phen, dtype=np.float32)
        m, p = bed_bytes.shape[0], phen.shape[0]
        v = m + p
        vp = self._padded_size(v)
        dev0 = self.devices[0]
        if mp_corr is None:
            mp, pp = fused_trait_blocks(bed_bytes, phen, marker_mean, marker_std,
                                        num_samples, dev0, sample_chunk)
        else:
            mp = torch.from_numpy(np.asarray(mp_corr, dtype=np.float32)).to(dev0)
            pp = torch.from_numpy(phen_phen_corr(phen, dev0)).to(dev0)
        mp_of, pp_of = self.replicate(mp, 0), self.replicate(pp, 0)
        padded, n_chunks = _prep_bytes(bed_bytes, num_samples,
                                       _sample_chunk(bed_bytes.shape[1], sample_chunk))
        _count_panel(stats, m, num_samples, n_chunks)
        cb = padded.shape[1] // n_chunks
        host_cols = torch.tensor(padded)
        cols = {}  # per distinct device: the packed bytes and the decoded chunks

        def onehots(dev):
            if dev not in cols:
                t = self._copy(host_cols, None, self.owner[dev])

                def decode(c):
                    X = geno_onehot(unpack_bed_codes(t[:, c * cb : (c + 1) * cb])).reshape(
                        3 * m, -1)
                    count(stats, "panel_decode_bytes", X.numel())
                    return X

                once = 3 * m * 4 * padded.shape[1] <= DECODE_ONCE_MAX_BYTES
                cols[dev] = [decode(c) for c in range(n_chunks)] if once else decode
            got = cols[dev]
            return got if isinstance(got, list) else [got(c) for c in range(n_chunks)]

        def build(k, r0, r1):
            dev = self.devices[k]
            S = torch.zeros((r1 - r0, vp), dtype=torch.float32, device=dev)
            nm = max(0, min(r1, m) - r0)
            mp_k, pp_k = mp_of[dev], pp_of[dev]
            if nm:  # marker rows: Kendall against every marker, then marker-phen
                counts = torch.zeros((3 * nm, 3 * m), dtype=torch.int32, device=dev)
                for X in onehots(dev):
                    rows = torch.cat([X[a * m + r0 : a * m + r0 + nm] for a in range(3)])
                    counts += contingency_counts(rows, X)
                S[:nm, :m] = _kendall_from_counts(counts.to(torch.float32), nm, m)
                del counts
                S[:nm, m : m + p] = mp_k[r0 : r0 + nm]
            t0, t1 = max(r0, m), min(r1, v)
            if t1 > t0:  # trait rows: [mp.T | pp | 0]
                S[t0 - r0 : t1 - r0, :m] = mp_k[:, t0 - m : t1 - m].T
                S[t0 - r0 : t1 - r0, m : m + p] = pp_k[t0 - m : t1 - m]
            ix = torch.arange(r1 - r0, device=dev)
            S[ix, ix + r0] = 1.0
            return S

        return self._from_rows(vp, build, "panel"), v

    # --- the banded correlation of `block` -----------------------------------

    def _banded(self, bed_bytes, num_samples: int, corr_width: int, row_tile: int | None,
                sample_chunk: int, tile_fn):
        """Chromosome rows in whole row tiles over the shards (each shard a
        contiguous run of tiles), every tile computed as the one-device
        banded route computes it: shard k uploads its rows and takes the
        `corr_width` rows past its last one from the shards that hold them.
        Refuses shards thinner than the band, as the JAX package does.
        Returns [tile_fn(...)] per tile, in row order, on the host."""
        bed_bytes = np.asarray(bed_bytes, dtype=np.uint8)
        m = bed_bytes.shape[0]
        mloc = -(-m // self.ndev)
        if mloc < corr_width:
            raise ValueError(
                f"{self.ndev}-way sharding leaves {mloc} rows/shard < corr_width "
                f"{corr_width}; use fewer devices or the single-device path"
            )
        row_tile = mloc if row_tile is None else min(row_tile, m)
        padded, n_chunks = _prep_bytes(bed_bytes, num_samples,
                                       _sample_chunk(bed_bytes.shape[1], sample_chunk))
        n_tiles = -(-m // row_tile)
        mp = n_tiles * row_tile
        big = _pad_rows(padded, mp + corr_width, PAD_BYTE)[: mp + corr_width]
        spans = split_even(n_tiles, self.ndev)
        last = max(k for k, (a, b) in enumerate(spans) if b > a)
        # rows each shard holds: its tiles' (the last shard also the pad rows past mp)
        held = {}
        for k, (a, b) in enumerate(spans):
            if b > a:
                lo, hi = a * row_tile, (mp + corr_width if k == last else b * row_tile)
                held[k] = (lo, hi, self._copy(torch.from_numpy(big[lo:hi]), None, k))
        out = []
        for k, (lo, hi, own) in held.items():
            need = spans[k][1] * row_tile + corr_width
            pieces = [own]
            for j, (jlo, jhi, theirs) in held.items():  # the boundary rows, from their shards
                a, b = max(hi, jlo), min(need, jhi)
                if j != k and b > a:
                    pieces.append(self._copy(theirs[a - jlo : b - jlo], j, k))
            cols = torch.cat(pieces) if len(pieces) > 1 else own
            self.call(k, "banded")
            for t in range(*spans[k]):
                t0 = t * row_tile
                out.append(tile_fn(cols, t0 - lo, m - lo, row_tile, corr_width, n_chunks))
        return [o.cpu().numpy() for o in out], m

    def kendall_npn_corr_banded(self, bed_bytes, num_samples: int, corr_width: int,
                                row_tile: int | None = None,
                                sample_chunk: int = DEFAULT_SAMPLE_CHUNK) -> np.ndarray:
        """`ops.corr.kendall_npn_corr_banded` over the shards: the same band,
        bit for bit, as the one-device route with the same ``row_tile``
        (default: the shard length ceil(m / D))."""
        tiles, m = self._banded(bed_bytes, num_samples, corr_width, row_tile, sample_chunk,
                                _banded_tile)
        return np.concatenate(tiles)[:m]

    def banded_row_abs_sums(self, bed_bytes, num_samples: int, corr_width: int,
                            row_tile: int | None = None,
                            sample_chunk: int = DEFAULT_SAMPLE_CHUNK) -> np.ndarray:
        """`ops.corr.banded_row_abs_sums_streaming` over the shards: each
        tile's band reduced to its row sums on its shard's device, as the
        one-device route with the same ``row_tile`` reduces it."""
        tiles, m = self._banded(bed_bytes, num_samples, corr_width, row_tile, sample_chunk,
                                _banded_tile_abs_sums)
        return np.concatenate(tiles)[:m]


class RowShardedEngine(ShardedEngine):
    """Row-sharded engine: shard k holds only the (vp / D, vp) stripe of rows
    [k L, (k + 1) L) of a panel (vp a multiple of lcm(PANEL_ALIGN, D)). Each
    launch runs on the compact panel ``C[U, U]`` of the indices its lists
    hold, copied stripe by stripe round the shards (the rows of each stripe
    that lie in U, at the columns U). The second cusk stage runs on
    ``devices[0]`` alone (``for_stage2`` is None): the reduced panel is small."""

    rowsharded = True

    def for_stage2(self):
        return None

    def align(self) -> int:
        return math.lcm(PANEL_ALIGN, self.ndev)

    def _from_rows(self, vp: int, build, what: str) -> ShardedPanel:
        L = vp // self.ndev
        return ShardedPanel(
            self, [self._placed(what, k, build(k, k * L, (k + 1) * L)) for k in range(self.ndev)],
            vp)

    def put_panel(self, x, fill: float = 0.0) -> ShardedPanel:
        """Row-sharded: shard k receives only the rows of its stripe, padded
        on its own device."""
        v = x.shape[0]
        vp = self._padded_size(v)
        on_host = not isinstance(x, torch.Tensor)
        src = None if on_host else self.owner.get(x.device)

        def build(k, r0, r1):
            rows = x[r0:min(r1, v)]
            if on_host:
                rows = torch.from_numpy(np.ascontiguousarray(rows, dtype=np.float32))
            rows = self._copy(rows.to(torch.float32), src, k)
            return torch.nn.functional.pad(rows, (0, vp - v, 0, (r1 - r0) - rows.shape[0]),
                                           value=fill)

        return self._from_rows(vp, build, "panel")

    def map(self, P: ShardedPanel, fn) -> ShardedPanel:
        return ShardedPanel(self, [fn(t) for t in P.parts], P.vp)

    def screen(self, panels: tuple, fn) -> np.ndarray:
        out = [fn(*(P.parts[k] for P in panels)) for k in range(self.ndev)]
        return np.concatenate([t.cpu().numpy() for t in out])

    def fetch(self, P: ShardedPanel, v: int) -> np.ndarray:
        return np.concatenate([t[:, :v].cpu().numpy() for t in P.parts])[:v]

    def parts(self, P: ShardedPanel, nodes: np.ndarray, nbrs: np.ndarray) -> list:
        """The D contiguous parts, each split (in halves, recursively) into
        launches whose compact panel holds no more than a stripe: |U|^2 <=
        vp^2 / D, so a shard never holds more than its stripes and one such
        panel at a time (a node whose own list is wider gets a launch of its
        own)."""
        cap = math.isqrt(P.vp * P.vp // self.ndev)

        def fit(a, b):
            if b - a == 1 or len(np.unique(np.concatenate([nodes[a:b], nbrs[a:b].ravel()]))) <= cap:
                return [slice(a, b)]
            mid = (a + b) // 2
            return fit(a, mid) + fit(mid, b)

        return [(k, c) for k, sl in super().parts(P, nodes, nbrs) for c in fit(sl.start, sl.stop)]

    def _stripe_rows(self, P: ShardedPanel, k: int, ix: np.ndarray):
        """(lo, hi, local rows) of the sorted indices ix that lie in stripe k."""
        L = P.vp // self.ndev
        lo, hi = np.searchsorted(ix, [k * L, (k + 1) * L])
        return lo, hi, ix[lo:hi] - k * L

    def submatrix(self, P: ShardedPanel, keep: np.ndarray) -> np.ndarray:
        keep = np.asarray(keep, dtype=np.int64)
        out = []
        for k, stripe in enumerate(P.parts):
            lo, hi, rows = self._stripe_rows(P, k, keep)
            if hi > lo:
                dev = stripe.device
                out.append(stripe.index_select(0, torch.from_numpy(rows).to(dev))
                           .index_select(1, torch.from_numpy(keep).to(dev)).cpu().numpy())
        return np.concatenate(out).astype(np.float32)

    def compact(self, P: ShardedPanel, k: int, U: np.ndarray) -> torch.Tensor:
        """P[U, U] on shard k's device, from the stripes: a ring of D steps,
        step s copying the rows of stripe (k + s) mod D that lie in U."""
        dev = self.devices[k]
        out = torch.empty((len(U), len(U)), dtype=torch.float32, device=dev)
        cols = {}
        for s in range(self.ndev):
            src = (k + s) % self.ndev
            lo, hi, rows = self._stripe_rows(P, src, U)
            if hi == lo:
                continue
            sdev = self.devices[src]
            if sdev not in cols:
                cols[sdev] = torch.from_numpy(U).to(sdev)
            piece = P.parts[src].index_select(0, torch.from_numpy(rows).to(sdev))
            out[lo:hi] = self._copy(piece.index_select(1, cols[sdev]), src, k)
        return self._placed("compact", k, out)

    def dense1_sweeps(self, C: ShardedPanel, G: np.ndarray, N: ShardedPanel | None = None,
                      t_ix: dict | None = None, th: float = 0.0):
        """Row-sharded (`cigwas_tpu.parallel.sharded._dense1_ring_body` /
        `_hetcor1_ring_body`): shard k sweeps the x rows of its stripe
        against the y columns of stripe k, k + 1, ... (mod D) in turn: the
        column block of R and P over those y gathered from every stripe's
        rows (each stripe's (L, L) piece copied from its shard), and stripe
        src's rows of N transposed. Every (x, y) meets all its s in one
        launch."""
        L = C.vp // self.ndev
        factors = [dk.factors(part) for part in C.parts]  # elementwise: each stripe's rows
        entry = "dense_l1" if N is None else "hetcor_dense_l1"

        def column_block(i: int, src: int, k: int) -> torch.Tensor:
            cols = slice(src * L, (src + 1) * L)
            return torch.cat([self._copy(factors[o][i][:, cols], o, k)
                              for o in range(self.ndev)])

        for k in range(self.ndev):
            Gk = self._g_rows(G, k, k * L, (k + 1) * L)
            for step in range(self.ndev):
                src = (k + step) % self.ndev
                ys = [column_block(0, src, k), column_block(1, src, k)]
                if N is not None:
                    ys.append(self._copy(N.parts[src].T.contiguous(), src, k))
                yield from pcorr.dense1_slab_sweeps(
                    C.parts[k], *factors[k], Gk, ys, k * L, src * L,
                    None if N is None else N.parts[k],
                    None if N is None else t_ix[self.devices[k]], th,
                    on_launch=lambda k=k: self.call(k, entry))

    def local(self, panels: tuple, k: int, nodes: np.ndarray, nbrs: np.ndarray,
              deg: np.ndarray, vectors: tuple = (), kernel: str = "") -> tuple:
        """Row-sharded: the compact panels over U (the sorted indices the
        part's nodes and lists hold, pad slots included) and the lists
        remapped to positions in U; vectors (per-device (vp,) tensors) taken
        at U."""
        self.call(k, kernel)
        dev = self.devices[k]
        U = np.unique(np.concatenate([nodes, nbrs.ravel()])).astype(np.int64)
        nodes_c = np.searchsorted(U, nodes).astype(np.int32)
        nbrs_c = np.searchsorted(U, nbrs).astype(np.int32)
        check_index_range("skeleton", len(U), nbrs.shape[1], nodes_c, nbrs_c, deg)
        lists = tuple(self._copy(torch.from_numpy(np.ascontiguousarray(a)), None, k)
                      for a in (nodes_c, nbrs_c, deg))
        u_dev = torch.from_numpy(U).to(dev)
        return (tuple(self.compact(P, k, U) for P in panels), lists,
                tuple(v[dev][u_dev] for v in vectors))


def as_mesh(mesh) -> Mesh:
    """A :class:`~cigwas_tpu_torch.parallel.mesh.Mesh`, or a list of devices
    as a 1-D ``marker`` mesh."""
    return mesh if isinstance(mesh, Mesh) else flat_mesh(mesh)


def make_engine(mesh, panel_mode: str = "replicated", axis: str | None = None):
    """The engine of a mesh or device list (None for None):
    :class:`ShardedEngine` for the replicated panel, :class:`RowShardedEngine`
    for row stripes; the axis defaults to ``marker`` where the mesh has one,
    else its first."""
    if panel_mode not in ("replicated", "rowsharded"):
        raise ValueError(f"unknown panel_mode: {panel_mode!r}")
    if mesh is None:
        return None
    mesh = as_mesh(mesh)
    if axis is None:
        axis = "marker" if "marker" in mesh.axis_names else mesh.axis_names[0]
    cls = RowShardedEngine if panel_mode == "rowsharded" else ShardedEngine
    return cls(mesh, axis)
