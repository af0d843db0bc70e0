"""Summary-statistic skeleton pipeline (`cigwas_tpu.pipelines.cuskss`).

Equivalent of `cuskss` (`cli.cpp:194-346`) plus the flag derivation of
`mps.cpp:31-101`: build the dense correlation and effective-sample-size
panels from mxm/mxp/pxp inputs, then run the (optionally two-stage) hetcor
skeleton with the ancestor reduction after each stage (`run_cusk`,
`cli.cpp:29-60`). The panels are assembled on the device from the compact
inputs and stay there until the first reduction. With a mesh the hetcor
levels run over its devices (:mod:`cigwas_tpu_torch.parallel.sharded`); for
the row-sharded engine the panels are assembled on the host, so that no
device holds a whole one.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from cigwas_tpu_torch.constants import ML
from cigwas_tpu_torch.device import resolve
from cigwas_tpu_torch.io import (
    MarkerSummaryStats,
    MarkerTraitSummaryStats,
    TraitSummaryStats,
    make_path,
    read_blocks_from_file,
    read_ints_from_binary,
    read_ints_from_lines,
)
from cigwas_tpu_torch.io.results import ReducedGC
from cigwas_tpu_torch.skeleton import hetcor_skeleton, reduce_gc, subset_variables
from cigwas_tpu_torch.utils.stats import hetcor_threshold
from cigwas_tpu_torch.utils.timing import span


@dataclass
class CuskssArgs:
    """Mirror of `CuskssArgs` (`cli.h:10-31`); flags as derived in `mps.cpp:49-53`."""

    merged: bool
    hetcor: bool
    trait_only: bool
    two_stage: bool
    time_indexed: bool
    alpha: float
    pearson_sample_size: float
    max_level_one: int
    max_level_two: int
    depth: int
    block_ix: int
    block_path: str
    marker_ixs_path: str
    mxm_path: str
    mxp_path: str
    mxp_se_path: str
    pxp_path: str
    pxp_se_path: str
    time_index_path: str
    outdir: str
    # `mean_ess` semantics for hetcor levels >= 1 ("reference" = int
    # truncation quirk, "float" = intended math); see
    # `cigwas_tpu_torch.skeleton.cupc.hetcor_skeleton`.
    ess_mode: str = "reference"

    @classmethod
    def from_paths(
        cls,
        *,
        mxm: str = "NULL",
        mxp: str = "NULL",
        mxp_se: str = "NULL",
        pxp: str,
        pxp_se: str = "NULL",
        time_index: str = "NULL",
        block_index: int = 0,
        blockfile: str = "NULL",
        marker_indices: str = "NULL",
        alpha: float,
        max_level_one: int = 3,
        max_level_two: int = 14,
        max_depth: int = 1,
        num_samples: float,
        outdir: str = "./",
        ess_mode: str = "reference",
    ) -> "CuskssArgs":
        return cls(
            merged=marker_indices != "NULL",
            hetcor=mxp_se != "NULL",
            trait_only=mxm == "NULL",
            two_stage=max_level_two > 0,
            time_indexed=time_index != "NULL",
            alpha=alpha,
            pearson_sample_size=float(num_samples),
            max_level_one=max_level_one,
            max_level_two=max_level_two,
            depth=max_depth,
            block_ix=block_index,
            block_path=blockfile,
            marker_ixs_path=marker_indices,
            mxm_path=mxm,
            mxp_path=mxp,
            mxp_se_path=mxp_se,
            pxp_path=pxp,
            pxp_se_path=pxp_se,
            time_index_path=time_index,
            outdir=outdir,
            ess_mode=ess_mode,
        )


def make_square_cuskss_inputs(
    mxm: MarkerSummaryStats,
    mxp: MarkerTraitSummaryStats,
    pxp: TraitSummaryStats,
    pearson_sample_size: float,
    heterogeneous_sample_sizes: bool,
):
    """Dense correlation + ESS matrices on the host, markers first then
    traits (`make_square_cuskss_inputs`, `cli.cpp:89-173`)."""
    p = pxp.get_num_phen()
    m = mxm.get_num_markers()
    n = m + p
    sq_corrs = np.ones((n, n), dtype=np.float32)
    sq_ess = np.full((n, n), pearson_sample_size, dtype=np.float32)
    sq_corrs[:m, :m] = mxm.get_corrs()
    mp = mxp.get_corrs()
    sq_corrs[:m, m:] = mp
    sq_corrs[m:, :m] = mp.T
    sq_corrs[m:, m:] = pxp.get_corrs()
    if heterogeneous_sample_sizes:
        mp_ess = mxp.get_sample_sizes()
        sq_ess[:m, m:] = mp_ess
        sq_ess[m:, :m] = mp_ess.T
        sq_ess[m:, m:] = pxp.get_sample_sizes()
    return sq_corrs, sq_ess


def _tril_num_markers(size: int) -> int:
    """m with m (m + 1) / 2 == size, the marker count of an mxm triangle."""
    m = int((np.sqrt(8 * size + 1) - 1) / 2)
    if m * (m + 1) // 2 != size:
        raise ValueError("mxm tril size is not triangular")
    return m


def assemble_cuskss_panels_device(
    mxm_tril: np.ndarray,
    mxp: np.ndarray,
    pxp: np.ndarray,
    pearson_sample_size: float,
    mp_ess: np.ndarray | None = None,
    pp_ess: np.ndarray | None = None,
    device="cuda",
):
    """:func:`make_square_cuskss_inputs` on the device, from the compact parts.

    Uploads the (m(m+1)/2,) mxm lower triangle (the binary format of
    `marker_summary_stats.cpp:8-24`) plus the (m, p) and (p, p) blocks and
    assembles the dense (v, v) correlation and ESS panels there, so the two
    squares never exist on the host. NaN mxm entries become 0, as in the host
    loader. Returns (C, N), both (v, v) f32 tensors on ``device``, v = m + p.
    """
    device = resolve(device)
    mxm_tril = np.asarray(mxm_tril, dtype=np.float32)
    m = _tril_num_markers(mxm_tril.size)
    mxp_t = torch.from_numpy(np.asarray(mxp, dtype=np.float32)).to(device)
    pxp_t = torch.from_numpy(np.asarray(pxp, dtype=np.float32)).to(device)
    p = pxp_t.shape[0]
    v = m + p
    C = torch.ones((v, v), dtype=torch.float32, device=device)
    r, c = torch.tril_indices(m, m, device=device)
    flat = torch.nan_to_num(torch.from_numpy(mxm_tril).to(device), nan=0.0)
    C[r, c] = flat
    C[c, r] = flat
    C[:m, m:] = mxp_t
    C[m:, :m] = mxp_t.T
    C[m:, m:] = pxp_t
    N = torch.full((v, v), float(pearson_sample_size), dtype=torch.float32, device=device)
    if mp_ess is not None:
        mp_e = torch.from_numpy(np.asarray(mp_ess, dtype=np.float32)).to(device)
        N[:m, m:] = mp_e
        N[m:, :m] = mp_e.T
        N[m:, m:] = torch.from_numpy(np.asarray(pp_ess, dtype=np.float32)).to(device)
    return C, N


def run_cusk(
    gc: ReducedGC,
    threshold: float,
    max_depth: int,
    max_level: int,
    time_index_traits: list[int],
    verbose: bool = False,
    ess_mode: str = "reference",
    device="cuda",
    stats: dict | None = None,
    engine=None,
) -> ReducedGC:
    """One hetcor-skeleton stage + ancestor reduction (`run_cusk`,
    `cli.cpp:29-60`). gc.C and gc.S are numpy panels or device tensors; the
    result holds numpy. stats, if given, collects the skeleton's stats
    (:func:`cigwas_tpu_torch.skeleton.cupc.hetcor_skeleton`), ``reduce_s``
    and ``d2h_bytes`` of the reduction's fetches.
    engine: a sharded engine runs the hetcor levels over its shards (the same
    adjacency, see :func:`~cigwas_tpu_torch.pipelines.cuskss.cuskss`).
    """
    time_index = np.zeros(gc.num_var, dtype=np.int32)
    time_index[gc.num_markers() :] = np.asarray(time_index_traits, dtype=np.int32)
    res = hetcor_skeleton(
        gc.C, gc.G, gc.S, threshold, max_level, time_index=time_index,
        device=device, verbose=verbose, ess_mode=ess_mode, stats=stats, engine=engine,
    )
    with span(stats, "reduce_s", "cigwas.reduce.hetcor"):
        keep = subset_variables(res.G, gc.num_var, gc.num_markers(), max_depth)
        out = reduce_gc(
            res.G, gc.C, gc.S, keep, gc.num_var, gc.num_phen, ML,
            index_map=gc.new_to_old_indices, stats=stats,
        )
    if stats is not None:
        stats["final_level"] = res.final_level
    return out


def cuskss(args: CuskssArgs, verbose: bool = True, device="cuda",
           stats: dict | None = None, mesh=None,
           panel_mode: str = "replicated") -> ReducedGC:
    """Full cuskss workflow (`cuskss`, `cli.cpp:194-346`).

    Writes `.mdim/.ixs/.adj/.corr` under ``args.outdir`` (`trait_only`,
    `cuskss_merged` or the block's name) and returns the written ReducedGC.
    stats, if given, collects ``load_s`` (host file reads; inside it, for
    a merged input, ``merged_select_s``, the marker-trait tables' read and
    row selection), ``assemble_s`` (upload and panel assembly), ``init_s``
    (the starting adjacency and the ReducedGC), ``stage1`` / ``stage2``
    (:func:`run_cusk`'s stats) with ``stage1_s`` / ``stage2_s`` (each stage
    with its reduction) and ``write_s`` (the output files): the top-level
    spans, which tile the call; with a mesh also ``engine_record``, the
    engine's record of its placements, calls and copies.

    mesh: a :class:`~cigwas_tpu_torch.parallel.mesh.Mesh` (or a list of
    devices) runs the hetcor levels over its devices; ``device`` is then its
    first. panel_mode: ``"replicated"`` holds the correlation and ESS panels
    whole on every device (assembled on the first), ``"rowsharded"`` in
    (vp / D, vp) row stripes (assembled on the host; the second stage runs
    on the first device). The files are the one-device run's, byte for byte.
    """
    from cigwas_tpu_torch.parallel.sharded import make_engine

    engine = make_engine(mesh, panel_mode)
    if engine is not None:
        device = engine.devices[0]
    device = resolve(device)
    stats = {} if stats is None else stats
    if engine is not None:
        stats["engine_record"] = engine.record
    with span(None, None, "cigwas.pipeline.cuskss"):
        with span(stats, "load_s", "cigwas.pipeline.load"):
            inputs = _load(args, stats)
        th = hetcor_threshold(args.alpha)
        num_phen = inputs["pxp"].get_num_phen()

        def stage(gc, max_level, name):
            stats[name] = {}
            eng = engine if name == "stage1" or engine is None else engine.for_stage2()
            with span(stats, name + "_s", "cigwas.pipeline." + name):
                return run_cusk(
                    gc, th, args.depth, max_level, inputs["time_index_traits"],
                    verbose=verbose, ess_mode=args.ess_mode, device=device, stats=stats[name],
                    engine=eng,
                )

        if args.trait_only:
            pxp = inputs["pxp"]
            with span(stats, "init_s", "cigwas.pipeline.init"):
                gc = ReducedGC(
                    num_var=num_phen,
                    num_phen=num_phen,
                    max_level=args.max_level_one,
                    new_to_old_indices=np.arange(num_phen, dtype=np.int32),
                    G=np.ones((num_phen, num_phen), dtype=np.int32),
                    C=pxp.get_corrs(),
                    S=pxp.get_sample_sizes(),
                )
            gc = stage(gc, args.max_level_one, "stage1")
            with span(stats, "write_s", "cigwas.pipeline.write"):
                gc.to_file(make_path(args.outdir, "trait_only", ""))
            if verbose:
                print(f"Retained {gc.num_markers()} markers")
            return gc

        with span(stats, "assemble_s", "cigwas.panel.assemble"):
            # the row-sharded engine places stripes from panels assembled on the host
            mxp, pxp = inputs["mxp"], inputs["pxp"]
            C, N = assemble_cuskss_panels_device(
                inputs.pop("mxm_tril"), mxp.get_corrs(), pxp.get_corrs(),
                args.pearson_sample_size,
                mp_ess=mxp.get_sample_sizes() if args.hetcor else None,
                pp_ess=pxp.get_sample_sizes() if args.hetcor else None,
                device="cpu" if engine is not None and engine.rowsharded else device,
            )
            num_var = C.shape[0]
            if device.type == "cuda":
                torch.cuda.synchronize(device)

        with span(stats, "init_s", "cigwas.pipeline.init"):
            gc = ReducedGC(
                num_var=num_var,
                num_phen=num_phen,
                max_level=args.max_level_one,
                new_to_old_indices=np.arange(num_var, dtype=np.int32),
                G=np.ones((num_var, num_var), dtype=np.int32),
                C=C,
                S=N,
            )
            del C, N
        if verbose:
            print("Starting first cusk stage")
        gc = stage(gc, args.max_level_one, "stage1")
        if args.two_stage:
            if verbose:
                print("Starting second cusk stage")
            gc = stage(gc, args.max_level_two, "stage2")
        if verbose:
            print(f"Retained {gc.num_markers()} markers")
        with span(stats, "write_s", "cigwas.pipeline.write"):
            if args.merged:
                gc.to_file(make_path(args.outdir, "cuskss_merged", ""))
            else:
                gc.to_file(make_path(args.outdir, inputs["block"].to_file_string(), ""))
        return gc


def _load(args: CuskssArgs, stats: dict | None = None) -> dict:
    """:func:`cuskss`'s host reads: the traits' tables and time index and,
    unless trait_only, the mxm triangle, the marker-trait tables and the
    block (or None for a merged input), checked against each other. stats,
    if given, collects ``merged_select_s``: the read of a merged input's
    marker-trait tables and the selection of its rows."""
    if args.merged:
        marker_ixs = read_ints_from_binary(args.marker_ixs_path)
        block = None
    else:
        block = read_blocks_from_file(args.block_path)[args.block_ix]
        marker_ixs = None

    if args.hetcor:
        pxp = TraitSummaryStats(args.pxp_path, se_path=args.pxp_se_path)
    else:
        pxp = TraitSummaryStats(args.pxp_path, sample_size=args.pearson_sample_size)
    num_phen = pxp.get_num_phen()

    time_index_traits = [1] * num_phen
    if args.time_indexed:
        time_index_traits = read_ints_from_lines(args.time_index_path)
    out = {"pxp": pxp, "time_index_traits": time_index_traits, "block": block}
    if args.trait_only:
        return out

    mxm_tril = np.fromfile(args.mxm_path, dtype=np.float32)
    se_path = args.mxp_se_path if args.hetcor else None
    if args.merged:
        with span(stats, "merged_select_s", "cigwas.io.merged_select"):
            mxp = MarkerTraitSummaryStats(args.mxp_path, se_path=se_path,
                                          marker_ixs=marker_ixs)
    else:
        mxp = MarkerTraitSummaryStats(args.mxp_path, se_path=se_path, block=block)
    if pxp.get_num_phen() != mxp.get_num_phen():
        raise ValueError("Numbers of traits seem to differ between pxp and mxp")
    if _tril_num_markers(mxm_tril.size) != mxp.get_num_markers():
        raise ValueError("Numbers of markers seem to differ between mxm and mxp")
    return {**out, "mxm_tril": mxm_tril, "mxp": mxp}
