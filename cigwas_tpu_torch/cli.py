"""Top-level CLI of the port: the ci-gwas subcommands (`cigwas_tpu.cli`).

    ci-gwas-torch <subcommand> ...        python3 -m cigwas_tpu_torch.cli <subcommand> ...

Argument names, bounds and defaults mirror the reference's `ci-gwas.py`, so
existing workflows can switch directly. Every subcommand that touches the
device takes ``--device {cuda,cpu}`` (default ``cuda``): without a card the
default fails, it never carries on on the CPU. ``cusk``, ``cuskss`` and
``cusk-all`` take ``--mesh N`` (shard each block over N devices of
``--device``: N cards, or N CPU entries; 0 means every card) and
``--panel-mode {replicated,rowsharded}``. ``merge-block-outputs``,
``sepselect``, ``orient-v-structs``, ``srfci`` and ``mvivw`` run on the host.
"""

from __future__ import annotations

import argparse
import os
import sys


def _bounded(type_fn, name, min_val=None, max_val=None):
    def parse(val):
        v = type_fn(val)
        if min_val is not None and v < min_val:
            raise argparse.ArgumentTypeError(f"Minimum {name} is {min_val}")
        if max_val is not None and v > max_val:
            raise argparse.ArgumentTypeError(f"Maximum {name} is {max_val}")
        return v

    return parse


def _mesh_from_flag(args, partition_index: int | None = None):
    """--mesh N -> a 1-D "marker" mesh of N devices of --device (None without
    the flag): on cuda the first N cards, 0 meaning all of them, or with a
    partition index p the group [p N, (p + 1) N); on cpu N entries of the
    CPU. Asking for more cards than are visible, or for every card on the
    CPU or per partition, exits with a message: a mesh never shrinks."""
    if getattr(args, "mesh", None) is None:
        return None
    from cigwas_tpu_torch.parallel import partition_mesh
    from cigwas_tpu_torch.parallel.mesh import flat_mesh, visible_devices

    if args.mesh == 0 and args.device == "cpu":
        sys.exit("--mesh 0 (every card) needs --device cuda; give the CPU a count")
    if args.mesh == 0 and partition_index is not None:
        sys.exit("--mesh 0 with --partition-index: give each partition's device count")
    try:
        if partition_index is not None:
            return partition_mesh(args.mesh, partition_index, device=args.device)
        return flat_mesh(visible_devices(None if args.mesh == 0 else args.mesh, args.device))
    except (RuntimeError, ValueError) as err:
        sys.exit(f"--mesh {args.mesh}: {err}")


def cmd_prep_bed(args):
    from cigwas_tpu_torch.prep import prep_bed

    prep_bed(args.bfiles)


def cmd_block(args):
    from cigwas_tpu_torch.pipelines import make_blocks

    make_blocks(args.bfiles, args.max_block_size, args.corr_width, device=args.device)


def cmd_cusk(args):
    from cigwas_tpu_torch.pipelines import CuskContext

    mesh = _mesh_from_flag(args)
    ctx = CuskContext(
        args.phen, args.bfiles, args.blocks, args.alpha, args.max_level,
        args.max_level_two, args.max_depth, args.outdir, device=args.device,
        mesh=mesh, panel_mode=args.panel_mode,
    )
    ctx.finish(ctx.prepare(args.block_index))


def cmd_cuskss(args):
    from cigwas_tpu_torch.merge import reformat_cuskss_merged_output
    from cigwas_tpu_torch.pipelines import CuskssArgs, cuskss

    if args.blockfile == "NULL" and args.marker_indices == "NULL":
        sys.exit(
            "Either blockfile + block index or marker indices into the mxp file "
            "have to be provided for cuskss."
        )
    if sum([args.mxp_se == "NULL", args.pxp_se == "NULL"]) == 1:
        sys.exit("Please provide no or both pxp and mxp standard error files.")
    if sum([args.mxp == "NULL", args.mxm == "NULL"]) == 1:
        sys.exit("Please provide no or both mxp and mxm correlation files.")
    ca = CuskssArgs.from_paths(
        mxm=args.mxm,
        mxp=args.mxp,
        mxp_se=args.mxp_se,
        pxp=args.pxp,
        pxp_se=args.pxp_se,
        time_index=args.time_index,
        block_index=args.block_index,
        blockfile=args.blockfile,
        marker_indices=args.marker_indices,
        alpha=args.alpha,
        max_level_one=args.max_level_one,
        max_level_two=args.max_level_two,
        max_depth=args.max_depth,
        num_samples=args.num_samples,
        outdir=args.outdir,
        ess_mode=args.ess_mode,
    )
    cuskss(ca, device=args.device, mesh=_mesh_from_flag(args), panel_mode=args.panel_mode)
    if args.marker_indices != "NULL":
        reformat_cuskss_merged_output(cusk_dir=args.outdir).write_mm(
            basepath=os.path.join(args.outdir, "cuskss_merged")
        )


def cmd_cusk_all(args):
    from cigwas_tpu_torch.parallel import run_all_blocks

    # block parallelism x panel sharding: with a partition index, this
    # partition's blocks shard over its own device group
    mesh = _mesh_from_flag(args, args.partition_index)
    run_all_blocks(
        args.phen, args.bfiles, args.blocks, args.alpha, args.max_level,
        args.max_level_two, args.max_depth, args.outdir,
        num_partitions=args.num_partitions, partition_index=args.partition_index,
        device=args.device, mesh=mesh, panel_mode=args.panel_mode,
    )


def cmd_merge_blocks(args):
    from cigwas_tpu_torch.merge import merge_block_outputs

    out_dir = args.cusk_output_dir
    if not out_dir.endswith("/"):
        out_dir += "/"
    merged = merge_block_outputs(args.blockfile, out_dir)
    merged.write_mm(os.path.join(args.cusk_output_dir, "merged_blocks"))


def cmd_sepselect(args):
    from cigwas_tpu_torch.merge import sepselect_merged

    merged = sepselect_merged(args.cusk_result_stem, args.alpha, args.num_samples)
    merged.to_file(os.path.join(os.path.dirname(args.cusk_result_stem), "max_sep_min_pc"))
    print("Sepselect done.")


def cmd_orient_v_structs(args):
    from cigwas_tpu_torch.merge import orient_v_structures_merged

    merged = orient_v_structures_merged(
        args.cusk_result_stem, args.alpha, args.num_samples, args.orientation_prior
    )
    merged.to_file(os.path.join(os.path.dirname(args.cusk_result_stem), "max_sep_min_pc"))
    print("Sepselect / v-structs done.")


def cmd_srfci(args):
    from cigwas_tpu_torch.pag import estimate_pag

    estimate_pag(args.sepselect_result_stem, args.alpha, args.num_samples)


def cmd_mvivw(args):
    from cigwas_tpu_torch.io.tables import write_table
    from cigwas_tpu_torch.merge import get_iv_candidates
    from cigwas_tpu_torch.mr import run_mvivw

    write_table(f"{args.cusk_output_stem}_iv_candidates.csv",
                get_iv_candidates(args.cusk_output_stem))
    run_mvivw(
        args.cusk_output_stem,
        args.num_samples,
        use_skeleton=args.s,
        rm_counterfactual=args.orientation_prior is not None,
        orientation_prior=args.orientation_prior,
        out_path=f"{args.cusk_output_stem}_mvivw_results.tsv",
    )


def _add_device(p) -> None:
    p.add_argument(
        "--device", choices=("cuda", "cpu"), default="cuda",
        help="cuda (default): the first card, an error without one; cpu: the "
        "plain PyTorch versions of the kernels",
    )


def _add_mesh(p, mesh_help: str, panel_help: str) -> None:
    p.add_argument("--mesh", type=int, default=None, metavar="N", help=mesh_help)
    p.add_argument("--panel-mode", choices=("replicated", "rowsharded"),
                   default="replicated", help=panel_help)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="ci-gwas-torch",
        description=(
            "Causal inference for multiple risk factors and diseases from "
            "genomics data (PyTorch/CUDA port)"
        ),
    )
    sub = parser.add_subparsers(required=True, title="subcommands")

    p = sub.add_parser("prep-bed", help="Prepare PLINK bed file for cusk")
    p.add_argument("bfiles", type=str)
    p.set_defaults(func=cmd_prep_bed)

    p = sub.add_parser("block", help="Tile whole-genome LD matrix into blocks")
    p.add_argument("bfiles", type=str)
    p.add_argument(
        "max_block_size", type=_bounded(int, "max-block-size", 2), default=11000
    )
    p.add_argument(
        "device_mem_gb",
        type=_bounded(int, "device-mem-gb", 0),
        default=10,
        help="accepted for reference CLI compatibility; tiling is automatic",
    )
    p.add_argument("corr_width", type=_bounded(int, "corr-width", 2), default=2000)
    _add_device(p)
    p.set_defaults(func=cmd_block)

    p = sub.add_parser("cusk", help="Skeleton from individual-level data")
    p.add_argument("block_index", type=_bounded(int, "block-index", 0))
    p.add_argument("blocks", type=str)
    p.add_argument("bfiles", type=str)
    p.add_argument("phen", type=str)
    p.add_argument("alpha", type=_bounded(float, "alpha", 0.0, 1.0), default=1e-4)
    p.add_argument("max_level", type=_bounded(int, "max-level", 0, 14), default=3)
    p.add_argument("max_level_two", type=_bounded(int, "max-level", 0, 14), default=14)
    p.add_argument("max_depth", type=_bounded(int, "max-depth", 1), default=1)
    p.add_argument("outdir", type=str, default="./")
    _add_mesh(
        p, "run SPMD over a 1-D mesh of N local devices (0 = all)",
        "replicated: panel on every device; rowsharded: panel split "
        "into (vp/D, vp) stripes (for blocks larger than one chip's HBM)",
    )
    _add_device(p)
    p.set_defaults(func=cmd_cusk)

    p = sub.add_parser("cuskss", help="Skeleton from summary statistics")
    p.add_argument("--mxm", type=str, default="NULL")
    p.add_argument("--mxp", type=str, default="NULL")
    p.add_argument("--pxp", type=str, required=True)
    p.add_argument("--mxp-se", type=str, default="NULL")
    p.add_argument("--pxp-se", type=str, default="NULL")
    p.add_argument("--block-index", type=_bounded(int, "block-index", 0), default=0)
    p.add_argument("--blockfile", type=str, default="NULL")
    p.add_argument("--marker-indices", type=str, default="NULL")
    p.add_argument("--alpha", type=_bounded(float, "alpha", 0.0, 1.0), required=True)
    p.add_argument(
        "--max-level-one", type=_bounded(int, "max-level", 0, 14), default=3
    )
    p.add_argument(
        "--max-level-two", type=_bounded(int, "max-level-two", 0, 14), default=14
    )
    p.add_argument("--max-depth", type=_bounded(int, "max-depth", 1), default=1)
    p.add_argument("--time-index", type=str, default="NULL")
    p.add_argument(
        "--num-samples", type=_bounded(int, "num-samples", 1), required=True
    )
    p.add_argument("--outdir", type=str, default="./")
    p.add_argument(
        "--ess-mode",
        type=str,
        choices=["reference", "float"],
        default="reference",
        help="mean_ess semantics for hetcor levels >= 1: 'reference' "
        "reproduces the per-pair int truncation of hetcor-cuPC-S.cu:3068-3089 "
        "(default), 'float' uses full-precision NaN-aware means",
    )
    _add_mesh(
        p, "run the hetcor level kernels SPMD over a 1-D mesh of N local "
        "devices (0 = all)",
        "replicated: corr/ESS panels on every device; rowsharded: "
        "(vp/D, vp) stripes with ring-pass kernels",
    )
    _add_device(p)
    p.set_defaults(func=cmd_cuskss)

    p = sub.add_parser(
        "cusk-all",
        help="Run cusk for every block (this process's partition of the block list)",
    )
    p.add_argument("blocks", type=str)
    p.add_argument("bfiles", type=str)
    p.add_argument("phen", type=str)
    p.add_argument("alpha", type=_bounded(float, "alpha", 0.0, 1.0), default=1e-4)
    p.add_argument("max_level", type=_bounded(int, "max-level", 0, 14), default=3)
    p.add_argument("max_level_two", type=_bounded(int, "max-level", 0, 14), default=14)
    p.add_argument("max_depth", type=_bounded(int, "max-depth", 1), default=1)
    p.add_argument("outdir", type=str, default="./")
    p.add_argument("--num-partitions", type=int, default=None)
    p.add_argument("--partition-index", type=int, default=None)
    _add_mesh(
        p, "shard each block over a mesh of N devices; with "
        "--partition-index p the mesh is THIS partition's device group "
        "[p*N, (p+1)*N) (block-DP across groups, panel-TP inside)",
        "replicated: panel on every mesh device; rowsharded: (vp/D, vp) "
        "stripes",
    )
    _add_device(p)
    p.set_defaults(func=cmd_cusk_all)

    p = sub.add_parser(
        "merge-block-outputs", help="Merge per-block cusk/cuskss outputs"
    )
    p.add_argument("cusk_output_dir", type=str)
    p.add_argument("blockfile", type=str)
    p.set_defaults(func=cmd_merge_blocks)

    p = sub.add_parser("sepselect", help="Separation sets on merged skeletons")
    p.add_argument("cusk_result_stem", type=str)
    p.add_argument("alpha", type=_bounded(float, "alpha", 0.0, 1.0), default=1e-4)
    p.add_argument("num_samples", type=_bounded(int, "num-samples", 1))
    p.set_defaults(func=cmd_sepselect)

    p = sub.add_parser(
        "orient-v-structs", help="Orient v-structures on merged skeletons"
    )
    p.add_argument("cusk_result_stem", type=str)
    p.add_argument("alpha", type=_bounded(float, "alpha", 0.0, 1.0), default=1e-4)
    p.add_argument("num_samples", type=_bounded(int, "num-samples", 1))
    p.add_argument("--orientation-prior", type=str, default=None)
    p.set_defaults(func=cmd_orient_v_structs)

    p = sub.add_parser("srfci", help="Run sRFCI to infer a PAG")
    p.add_argument("sepselect_result_stem", type=str)
    p.add_argument("alpha", type=_bounded(float, "alpha", 0.0, 1.0), default=1e-4)
    p.add_argument("num_samples", type=_bounded(int, "num-samples", 1))
    p.set_defaults(func=cmd_srfci)

    p = sub.add_parser(
        "mvivw", help="Multivariable IVW Mendelian randomization"
    )
    p.add_argument("cusk_output_stem", type=str)
    p.add_argument("num_samples", type=_bounded(int, "num-samples", 1))
    p.add_argument("-s", action="store_true")
    p.add_argument("--orientation-prior", type=str, default=None)
    p.set_defaults(func=cmd_mvivw)

    return parser


def main(argv=None) -> None:
    parser = build_parser()
    args = parser.parse_args(argv)
    args.func(args)


if __name__ == "__main__":
    main()
