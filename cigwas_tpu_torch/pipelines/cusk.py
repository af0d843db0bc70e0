"""Individual-level per-block skeleton pipeline and LD blocking
(`cigwas_tpu.pipelines.cusk`).

`make_blocks` tiles every chromosome into approximately unlinked marker
blocks from the banded correlations' row sums. `cusk` loads one LD block of
genotypes and standardized phenotypes, builds the correlation panel on the
device, runs the two-stage PC-stable skeleton with the ancestor reduction in
between, and writes the `.mdim/.ixs/.adj/.corr/.sep` block output — the same
files as the JAX package's `cusk`. With a mesh, both spread their work over
its devices (:mod:`cigwas_tpu_torch.parallel.sharded`) and write the same
bytes.
"""

from __future__ import annotations

import numpy as np
import torch

from cigwas_tpu_torch.blocking import block_chr
from cigwas_tpu_torch.device import resolve
from cigwas_tpu_torch.constants import ML
from cigwas_tpu_torch.io import (
    BedDims,
    BfilesBase,
    BimInfo,
    load_phen,
    make_path,
    read_blocks_from_file,
    read_floats_from_line_range,
    write_marker_blocks_to_file,
)
from cigwas_tpu_torch.io.bed import (
    check_path,
    check_prepped_bed_path,
    read_block_from_bed,
    read_chr_from_bed,
)
from cigwas_tpu_torch.ops.corr import (
    PANEL_ROW_TILE,
    banded_row_abs_sums,
    banded_row_abs_sums_streaming,
    corr_panel_device,
    corr_panel_device_tiled,
    kendall_npn_corr_banded,
    marker_phen_corr_from_sums,
    marker_phen_sums,
)
from cigwas_tpu_torch.skeleton import reduce_gcs, skeleton, subset_variables
from cigwas_tpu_torch.utils.stats import fisher_z, threshold_array
from cigwas_tpu_torch.utils.timing import span

# largest block built by the single-pass panel; larger ones go through stripes
FUSED_PANEL_MAX = 4096
# chromosomes with more markers reduce the band to its row sums on the device
STREAMING_MIN_MARKERS = 16384


def make_blocks(
    bed_base_path: str,
    max_block_size: int,
    corr_width: int,
    out_path: str | None = None,
    verbose: bool = True,
    device="cuda",
    streaming_min_markers: int = STREAMING_MIN_MARKERS,
    mesh=None,
) -> list:
    """Partition every chromosome into LD blocks (`make_blocks`,
    `cli.cpp:362-411`) and append them to ``out_path`` (default
    ``<bfiles>_m<max_block_size>.blocks``).

    The reference takes a device-memory budget to size its streaming
    batches; here the banded correlation tiles internally, so there is no
    such parameter. A chromosome of more than ``streaming_min_markers``
    markers has its band reduced to row sums on the device
    (:func:`banded_row_abs_sums_streaming`); a smaller one fetches the band
    and sums it on the host.

    mesh: a :class:`~cigwas_tpu_torch.parallel.mesh.Mesh` or a list of
    devices: each chromosome's row tiles are spread over them with the
    boundary rows exchanged between shards
    (:meth:`~cigwas_tpu_torch.parallel.sharded.ShardedEngine.banded_row_abs_sums`),
    the same tiles as on one device, so the same `.blocks` bytes; a
    chromosome thinner than the band per shard is refused. ``device`` is
    then not used."""
    engine = None
    if mesh is not None:
        from cigwas_tpu_torch.parallel.sharded import make_engine

        engine = make_engine(mesh)
    else:
        device = resolve(device)
    bfiles = BfilesBase(bed_base_path)
    dims = BedDims.from_bfiles(bfiles)
    bim = BimInfo(bfiles.bim())
    out_path = out_path or bfiles.blocks(max_block_size)

    all_blocks = []
    for cid in bim.chr_ids:
        if verbose:
            print(f"[chr {cid}] loading bed data")
        chr_bed = read_chr_from_bed(bfiles.bed(), cid, bim, dims)
        if verbose:
            print(f"[chr {cid}] computing banded correlations")
        streaming = chr_bed.shape[0] > streaming_min_markers
        if engine is not None and streaming:
            row_sums = engine.banded_row_abs_sums(chr_bed, dims.num_samples, corr_width,
                                                  row_tile=PANEL_ROW_TILE)
        elif engine is not None:
            row_sums = banded_row_abs_sums(engine.kendall_npn_corr_banded(
                chr_bed, dims.num_samples, corr_width, row_tile=PANEL_ROW_TILE))
        elif streaming:
            row_sums = banded_row_abs_sums_streaming(
                chr_bed, dims.num_samples, corr_width, device=device)
        else:
            band = kendall_npn_corr_banded(chr_bed, dims.num_samples, corr_width, device=device)
            row_sums = banded_row_abs_sums(band)
        blocks = block_chr(row_sums, cid, max_block_size)
        if verbose:
            print(f"[chr {cid}] partitioned into {len(blocks)} blocks")
        write_marker_blocks_to_file(blocks, out_path)
        all_blocks.extend(blocks)
    return all_blocks


def cusk(
    phen_path: str,
    bed_base_path: str,
    block_path: str,
    alpha: float,
    max_level: int,
    max_level_two: int,
    depth: int,
    outdir: str,
    block_index: int,
    verbose: bool = True,
    device="cuda",
    stats: dict | None = None,
    mesh=None,
    panel_mode: str = "replicated",
):
    """Two-stage skeleton for a single LD block (`cusk`, `cli.cpp:432-678`).

    Returns the written ReducedGCS, or None if the block was skipped because
    no marker–phenotype correlation is significant. stats, if given, collects
    phase walls: ``context_s`` (the :class:`CuskContext`: `.phen`, `.bim`,
    `.dim`, `.blocks`, thresholds; of it ``load_phen_s``), ``prepare_s``
    (host I/O; of it ``read_bed_s``) and those of :meth:`CuskContext.finish`.
    A solved block's top-level spans, which tile the call, are
    ``context_s``, ``prepare_s``, ``prescreen_s``, ``panel_s``,
    ``stage1["skeleton_wall_s"]``, ``reduce_s``, ``stage2_s`` and
    ``write_s``. mesh / panel_mode: see :class:`CuskContext`.
    """
    with span(None, None, "cigwas.pipeline.cusk"):
        with span(stats, "context_s", "cigwas.pipeline.context"):
            ctx = CuskContext(
                phen_path, bed_base_path, block_path, alpha, max_level, max_level_two,
                depth, outdir, verbose=verbose, device=device, mesh=mesh,
                panel_mode=panel_mode, stats=stats,
            )
        prep = ctx.prepare(block_index, stats=stats)
        return ctx.finish(prep, stats=stats)


class CuskContext:
    """Per-dataset state for running many cusk blocks.

    Loading `.phen`/`.bim`/`.dim` and validating the block list happens once;
    :meth:`prepare` does a block's host I/O and starts its marker-phen
    pre-screen sums on the device, :meth:`finish` does the rest.

    mesh: a :class:`~cigwas_tpu_torch.parallel.mesh.Mesh` (or a list of
    devices) runs every block's panel and skeleton levels over its devices
    (:mod:`cigwas_tpu_torch.parallel.sharded`); ``device`` is then its first
    device, where the pre-screen runs. panel_mode: ``"replicated"`` keeps the
    panel whole on every device, ``"rowsharded"`` in (vp / D, vp) row
    stripes (its second stage runs on the first device). The block outputs
    are byte-identical to the one-device run's. stats, if given, receives
    the `.phen` read's wall ``load_phen_s``.
    """

    def __init__(
        self,
        phen_path: str,
        bed_base_path: str,
        block_path: str,
        alpha: float,
        max_level: int,
        max_level_two: int,
        depth: int,
        outdir: str,
        verbose: bool = True,
        device="cuda",
        mesh=None,
        panel_mode: str = "replicated",
        stats: dict | None = None,
    ):
        if panel_mode not in ("replicated", "rowsharded"):
            raise ValueError(f"unknown panel_mode: {panel_mode!r}")
        self.engine = None
        if mesh is not None:
            from cigwas_tpu_torch.parallel.sharded import make_engine

            self.engine = make_engine(mesh, panel_mode)
            device = self.engine.devices[0]
        self.device = resolve(device)
        check_prepped_bed_path(bed_base_path)
        check_path(phen_path)
        check_path(block_path)
        check_path(outdir)

        with span(stats, "load_phen_s", "cigwas.io.load_phen"):
            self.phen = load_phen(phen_path)
        self.bfiles = BfilesBase(bed_base_path)
        self.dims = BedDims.from_file(self.bfiles.dim())
        if self.phen.num_samples != self.dims.num_samples:
            raise ValueError("different num samples in phen and dims")
        self.bim = BimInfo(self.bfiles.bim())
        self.max_level = max_level
        self.max_level_two = max_level_two
        self.depth = depth
        self.outdir = outdir
        self.verbose = verbose
        self.blocks = read_blocks_from_file(block_path)
        for b in self.blocks:
            if (
                b.first_marker_ix >= self.bim.get_num_markers_on_chr(b.chr_id)
                or b.last_marker_ix >= self.bim.get_num_markers_on_chr(b.chr_id)
            ):
                raise ValueError(
                    f"block out of bounds with first_ix: {b.first_marker_ix} "
                    f"last_ix: {b.last_marker_ix}"
                )
        self.Th = threshold_array(self.dims.num_samples, alpha)

    def prepare(self, block_index: int, stats: dict | None = None) -> dict:
        """Host I/O plus the pre-screen sums on the device (no fetch); its
        wall into ``stats["prepare_s"]`` if stats is given, the `.bed` read's
        into ``read_bed_s`` and the uploads' bytes into ``h2d_bytes``."""
        with span(stats, "prepare_s", "cigwas.pipeline.prepare"):
            block = self.blocks[block_index]
            num_markers = block.block_size()
            if self.verbose:
                print(
                    f"Processing block {block_index + 1} / {len(self.blocks)} "
                    f"({num_markers} markers)"
                )
            with span(stats, "read_bed_s", "cigwas.io.read_bed"):
                bedblock = read_block_from_bed(self.bfiles.bed(), block, self.dims, self.bim)
            chr_start = self.bim.get_global_chr_start(block.chr_id)
            first = chr_start + block.first_marker_ix
            last = chr_start + block.last_marker_ix
            means = read_floats_from_line_range(self.bfiles.means(), first, last)
            stds = read_floats_from_line_range(self.bfiles.stds(), first, last)
            if means.size != num_markers or stds.size != num_markers:
                raise ValueError("block size and number of means or stds differ")
            sums = marker_phen_sums(
                bedblock, self.phen.data, self.dims.num_samples, self.device, stats=stats
            )
            return {
                "block": block,
                "bedblock": bedblock,
                "means": means,
                "stds": stds,
                "mp_sums": sums,
            }

    def finish(self, prep: dict, stats: dict | None = None):
        """Pre-screen, panel, two-stage skeleton and output write.

        stats, if given, receives ``prescreen_s``, ``panel_s``, ``stage1``
        (the skeleton's stats, see :func:`skeleton`), ``reduce_s``,
        ``stage2`` (with its reduction's ``reduce_s``) and ``stage2_s``,
        ``retained_markers`` and the stages' ``final_level`` /
        ``final_level_two``, ``write_s`` (the block files), ``d2h_bytes``
        (the pre-screen's and the reductions' fetches; the stages count
        theirs), the panel's counters ``panel_markers``, ``panel_samples``,
        ``panel_sample_chunks``, ``panel_decode_bytes`` and (without a mesh)
        ``panel_kernel_launches``, its uploads'
        ``h2d_bytes`` (without a mesh) and with a mesh ``engine_record``
        (the engine's placements, calls and copies); walls are host seconds
        that end in a device synchronisation or a fetch."""
        with span(stats, "prescreen_s", "cigwas.pipeline.prescreen"):
            mp_corr = marker_phen_corr_from_sums(prep["mp_sums"], prep["means"], prep["stds"],
                                                 stats)
            with np.errstate(divide="ignore", invalid="ignore"):
                num_sig = int((fisher_z(mp_corr) >= self.Th[0]).sum())
        if num_sig == 0:
            if self.verbose:
                print("No significant correlations found. Skipping block.")
            return None
        if self.verbose:
            print(f"Found {num_sig} marker-phen correlations. Proceeding.")
        return self._run_block(prep, mp_corr, stats)

    def _sync(self):
        devices = self.engine.devices if self.engine is not None else (self.device,)
        for dev in dict.fromkeys(devices):
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

    def _run_block(self, prep: dict, mp_corr: np.ndarray, stats: dict | None):
        block = prep["block"]
        num_markers = block.block_size()
        num_phen = self.phen.num_phen
        num_var = num_markers + num_phen
        n = self.dims.num_samples
        stats = {} if stats is None else stats
        engine = self.engine
        if engine is not None:
            stats["engine_record"] = engine.record
        with span(stats, "panel_s", "cigwas.panel.build"):
            if engine is not None:  # slabs over the mesh; trait blocks as one device's route
                C, v_panel = engine.corr_panel_device(
                    prep["bedblock"], self.phen.data, prep["means"], prep["stds"], n,
                    mp_corr=None if num_markers <= FUSED_PANEL_MAX else mp_corr, stats=stats,
                )
            elif num_markers <= FUSED_PANEL_MAX:
                C, v_panel = corr_panel_device(
                    prep["bedblock"], self.phen.data, prep["means"], prep["stds"], n,
                    self.device, stats=stats,
                )
            else:
                C, v_panel = corr_panel_device_tiled(
                    prep["bedblock"], self.phen.data, prep["means"], prep["stds"], n,
                    self.device, mp_corr=mp_corr, stats=stats,
                )
            self._sync()
        stats["stage1"] = {}
        res1 = skeleton(
            C, self.Th, self.max_level, device=self.device, n_var=v_panel,
            verbose=self.verbose, stats=stats["stage1"], want_pmax=False, engine=engine,
        )
        with span(stats, "reduce_s", "cigwas.reduce.stage1"):
            keep = subset_variables(res1.G, num_var, num_markers, self.depth)
            # the records of the removals, reduced to the kept corner: no
            # (n, n, depth) sepset is built
            gcs = reduce_gcs(res1.G, C, res1.records, keep, num_var, num_phen, self.max_level,
                             stats=stats)
            stats["final_level"] = res1.final_level
            del C, res1

        # stage 2 (`reduced_gcs_cusk`, `cli.cpp:62-87`): re-screen from the
        # reduced correlations (its level 0 rebuilds the adjacency)
        if self.verbose:
            print("Starting second cusk stage")
        with span(stats, "stage2_s", "cigwas.pipeline.stage2"):
            stats["stage2"] = {}
            res2 = skeleton(
                gcs.C, self.Th, self.max_level_two, device=self.device,
                verbose=self.verbose, stats=stats["stage2"], want_pmax=False,
                engine=engine.for_stage2() if engine is not None else None,
            )
            with span(stats["stage2"], "reduce_s", "cigwas.reduce.stage2"):
                keep2 = subset_variables(res2.G, gcs.num_var, gcs.num_markers(), self.depth)
                gcs2 = reduce_gcs(
                    res2.G, gcs.C, res2.records, keep2, gcs.num_var, num_phen, ML,
                    index_map=gcs.new_to_old_indices, stats=stats,
                )
        stats["retained_markers"] = gcs2.num_markers()
        stats["final_level_two"] = res2.final_level
        if self.verbose:
            print(f"Retained {gcs2.num_markers()} markers")
        with span(stats, "write_s", "cigwas.pipeline.write"):
            gcs2.to_file(make_path(self.outdir, block.to_file_string(), ""))
        return gcs2
