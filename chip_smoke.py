"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing one JSON line with its wall time; any failure raises
and the script exits non-zero:

1. environment: versions, the card's name and power limit (nvidia-smi);
   fails without a CUDA device;
2. build: compiles the CUDA sources under ``cigwas_tpu_torch/csrc`` in
   parallel and prints ptxas' registers and spills per kernel; then reads
   each sweep kernel's and the dense kernel's inner loop out of
   ``cuobjdump -sass`` (instructions per test, for ``issue_ms``);
3. kernels, each against its plain PyTorch version on the card, on seeded
   8192-variable panels with NaNs, LD-clustered and scattered neighbour
   lists, ragged degrees (one node with level + 1 neighbours, one with
   level: no test) on both sides of every route's shared-memory limit, and
   on panels of repeated variables, whose tied minima must resolve to the
   lowest colex rank:
   the levels 1-3 sweep (``local_sweep``; rho and positions bit-identical;
   also launches at one width over ragged degrees, as the device-resident
   loop makes them: one hub at the full width among light nodes, every
   node at the full width, NaN entries, ties across s; plus nodes of degree
   0 .. l, which have no test),
   the one- and two-panel gathers (``panel_gather``; int32 views equal, with
   the lists staged and read through the cache), with the main paths'
   8-node launches and bucket-sized launches (2048 nodes at widths 128, 48
   and 50) timed beside their bound, the sectors their lists address, the
   indexing call and an empty kernel's launch;
   the hetcor levels 1-3 sweep (``hetcor_sweep``; margins bit-identical,
   both ``ess_mode``s, a time index), with one launch the size of a
   level-2 and level-3 bucket (1024 nodes x width 48) timed beside its
   bound and beside the one-thread-per-slot route it replaced;
   the dense level-1 sweeps (``dense_l1``, ``hetcor_dense_l1``; rho, s and
   margins bit-identical) on x slabs against every y, ragged slabs, slabs
   of both ring widths, an LD band alone and scattered edges alone, ESS
   panels with +-inf, NaN and too small entries, and panels of repeated
   variables (the smallest s must win, across rows that share a copy and
   rows that hold one alone), a 256 x 8192 launch of each timed beside its
   bounds (for hetcor with the paths its tests take) and the live-s
   histogram of its slab;
   the hetcor combinatorial scan (``hetcor_scan``; margins bit-identical,
   one launch a call) at the 10k merged input's stage-2 shapes (16 hubs at
   widths 16 and 32, levels 1-14, each of levels 4-14 timed beside its f32
   bound and the plain version), on wide buckets (64, 128, 256), on a C
   panel with NaNs and on panels of duplicated variables (singular blocks);
   the row compaction of the hetcor device levels (``compact_rows``; lists
   and degrees bit-identical) on random, empty, full and single-edge rows
   at widths 8-152, with one launch over every row of a 10,112 x 16 and a
   12,288 x 152 adjacency timed cold beside its byte bound;
   the Kendall panel (``kendall_panel``; every value and NaN bit-identical
   to the plain version) at 11,000 x 16,384 and 11,000 x 262,144 (the two
   block cells), 3,000 x 16,384 (``corr_panel_device``'s blocks) and two
   ragged shapes, 5% missing calls, an all-missing and a monomorphic
   marker, junk codes past n; timed beside its bound, the plain version
   and the striped ``torch._int_mm`` route the panels ran before it;
4. the ``cusk`` slice: a small block on the card and on the CPU (plain
   versions) must write the same decisions, with every kernel launch of the
   card's run held bitwise to its plain version, and both devices must count
   the same ``ci_tests`` in each skeleton stage; then the reference's default
   block (11,000 markers x 16,384 individuals x 8 traits, AR(1) LD, planted
   marker->trait effects) on the card with the kernel launches counted, and
   its largest launch per kernel re-run through the plain version (the
   device-resident loop's launches with the shape of what they hold,
   `launch_shape`, level 3's time in launch order, `launch_order_ms`, and
   levels 2-3's time without their pair tests, `tables_only_ms`), its
   block panel's one launch of ``kendall_panel`` (counted, then re-run on
   the rows it read against the plain version and timed), and
   ``slice_cusk_rates``: each stage's ``level2plus_tests_per_sec``
   (``ci_tests`` over the sum of its level walls over levels >= 2, the
   formula of ``bench.py``) and stage 1's attribution of ``skeleton_wall_s``
   with its ``residual``, beside the card's name and power limit; then the
   block again with every sweep launch timed behind a spin kernel
   (``loop_totals_11k``, summed by level);
5. the ``cuskss`` slice: the fixture inputs on the card and on the CPU must
   write the same files (every launch checked likewise) and count the same
   ``ci_tests`` per stage; then a 10,000-marker x 8-trait summary-statistic
   input (AR(1) mxm as a binary triangle, planted mxp effects, SE files for
   a per-entry ESS in [3e5, 5e5]) through ``cuskss`` on the card, both
   stages, with the launches counted, the rates and attribution of
   ``slice_cuskss_rates`` as in 4., stage 1's levels 0-3 with the
   adjacency on the card (``device_levels``), and the largest launch per
   kernel re-run through the plain version (``compact_rows`` too);
6. a second, warm run of each slice under torch.profiler for the device
   time by kernel, the idle share, and ``total_ms``: the device time of all
   launches of each sweep level on its slice;
7. the shell entry points, each through ``cigwas_tpu_torch.cli.main``:
   ``prep-bed``, ``block``, ``cusk-all``, ``merge-block-outputs``,
   ``sepselect``, ``orient-v-structs``, ``srfci``, ``mvivw`` and ``mvivw
   -s`` over a small fileset (600 markers on 3 chromosomes x 2,000
   individuals, one planted trait edge) with ``--device cuda`` and with
   ``--device cpu``, which must leave the same ``.blocks`` bytes, block
   decision files, merged files, PAG and IV candidates (correlations within
   1e-6, the MVIVW tables' effects and p within 1e-5), every kernel launch
   checked; then the first five over one
   chromosome of 50,000 markers x 16,384 individuals x 8 traits with the
   CLI's defaults (the streaming route of ``block``, every block through
   ``cusk-all``), with each command's wall, the blocks, the int8 products'
   device time beside their bound, per-block walls and device memory, the
   launches of every kernel over the whole path, the files' sha256, and how
   many of the 40 planted markers are adjacent to their trait. With the
   planted markers uniform over the chromosome, as the generator gives
   them, no trait has the five marker neighbours that take stage 2 to level
   4, so ``cusk-all``, ``merge-block-outputs`` and ``sepselect`` then run
   again over the same blocks with a phenotype file whose planted markers
   share a locus per trait (a coverage input, shaped to reach the gather):
   that run's launches are counted apart, and the largest launch of each
   kernel on it is held bitwise to its plain version and timed beside its
   bound, as on the older slices;
8. the genome: four such chromosomes (200,000 markers, an 819.2 MB
   ``.bed``) x 16,384 individuals x 8 traits with a planted trait DAG, made
   and packed on the card from a seeded ``torch.Generator``, through all
   nine commands with the CLI's defaults and then ``estimate_ace``,
   ``check_ivs`` and ``run_mvivw_filtered`` through the Python API: walls
   per command and per block, device memory per block, launches, planted
   markers and trait edges recovered, the PAG's trait marks, each planted
   edge's MVIVW effect and p (positive and below 1e-3, or the run fails) and
   ACE, the files' sha256; then ``cusk-all`` again under torch.profiler for
   the device's idle share, every sweep launch of it timed behind a spin
   kernel (``loop_totals_genome``, summed by level); then the analysis API
   over its outputs
   (``genome_analysis``: pleiotropy, parent and ancestor sets, causal paths,
   both association tables with every planted marker found, the planted
   edges' ACE through ``load_ace``, ``cusk_second_stage`` on the merged
   skeleton, the planted T2 -> T3 path);
9. the rest of the one-card API, between the phases above: ``pmax_11k``
   (after the profiled runs: the 11k block's stage-1 panel, kept from the
   pipeline's run,
   through ``skeleton`` with pMax and without: equal decisions and
   launches, pMax's properties, the largest launch of each level bitwise
   equal to plain, pMax's extra wall split into the panel's fetch and the
   rest), ``pmax_stage2`` (that result reduced as the pipeline reduces it,
   through levels >= 4 with pMax on the card and the CPU),
   ``marker_pearson`` (the golden values, then the 11k block's bytes:
   cuda = cpu on 2,048 markers, the products' time beside their bound),
   ``sim_dag`` (after the small commands: ``gen_rand_dag`` at the
   reference's evaluation size through the skeleton with pMax on the card
   and the CPU, recall and precision, ``cusk_second_stage``) and
   ``sim_commands`` (``simulate_genotype_dataset``, its phenotypes split and
   merged again by ``make_merged_pheno_file``, the five commands; the
   planted structure recovered);
10. the multi-device engines (``mesh``, last, so that the phases above keep
   the process state they always ran in), every run on D shards of the one
   card (a mesh whose D entries all name ``cuda:0``: each shard's launches
   and copies run as they would on a card of its own), the launch counts
   set to 0 just before each engine run and read just after:
   ``mesh_small`` (the 1,500-marker block through ``cusk`` with both
   engines at D = 2 and 3 on the card and on the CPU: every file
   byte-identical to that device's one-device run, every shard launch on
   the card bitwise equal to plain); ``mesh_11k`` and ``mesh_10k`` (the 11k
   block through ``cusk`` and the 10k input through ``cuskss``, both
   engines at D = 4: the decision files' sha256 equal to the parent's,
   every file byte-equal to the one-device run's, the wall, per-level
   walls, calls per shard, the card's peak memory, each shard's panel and
   largest compact panel bytes, the bytes copied between shards, and each
   shard's largest launch of each kernel bitwise equal to plain);
   ``mesh_partitions`` (the 50k chromosome's blocks through two concurrent
   ``python -m cigwas_tpu_torch.parallel.distributed`` workers, then two
   processes of a gloo world of 2 whose ``run_all_blocks`` takes its
   partition from the world: merged and block files equal to the
   one-process ``cusk-all``'s); ``mesh_cli`` (``cusk --mesh 1``, ``cusk
   --mesh 0``, ``cusk-all --mesh 1 --partition-index 0``, ``cuskss --mesh 1
   --panel-mode rowsharded`` write the one-device files; ``--mesh`` past
   the visible cards exits with its message); ``mesh_make_blocks``
   (``make_blocks`` over 4 shards writes the chromosome's ``.blocks``
   bytes). Scaling across cards and copies between cards cannot be
   measured on one card;
11. the routes of levels 1-3 (``routes``, last of all), each forced by the
   skeleton's module attributes, with the launch counts set to 0 just
   before each run and read just after: ``routes_11k`` (the 11k block by
   the list route, the device-resident loop and the dense level 1: walls
   per level, the card's peak memory, every file equal to the default
   run's, sha256 equal to the parent's, each level's hits and their rho
   bitwise equal to the list route's), ``routes_10k`` (the 10k input by
   the list route and the hetcor dense level 1: likewise, the level-1 hit
   margins bitwise), ``routes_small`` (the 1,500-marker block through
   every route, the combinatorial levels 1-3 included, on the card and
   the CPU, every card launch bitwise equal to plain: files equal to the
   default run's), ``routes_engines`` (both engines over 4 shards of the
   card with the list route at level 1, where the mesh phase ran their
   default, the dense level 1, the 11k block and the 10k input: files
   equal to one device's, each shard's largest launch bitwise equal to
   plain), ``routes_spmd`` (``build_multichip_cusk_step`` over 2 blocks x
   2,048 markers of the 11k block x 16,384 x 8 traits on a (2, 2, 2) mesh
   of the card, equal to the (1, 1, 1) mesh's; a small step equal on cuda
   and cpu), ``routes_hetcor_wide`` (the hetcor skeleton on AR(1) panels
   of 16,384 and 24,576 variables, past the block loop's 12,288, on the
   card with levels 0-3 on the device and through an engine over the card
   with the adjacency on the host: the same adjacency, each path's wall,
   peak memory, level walls and fetched bytes); then the kernel line's
   entries of the dense kernel: its
   launches in the dense 11k and 10k runs and their device time in all
   (``total_ms``, CUDA events behind a spin kernel that hides the host's
   gaps; the mesh phase's engines likewise), the largest launch
   held bitwise to plain and timed beside its bounds with its slab's live-s
   histogram, a ring-sized slab beside it; and
   the list route's largest sweep launches at the 11k block (levels 1-3)
   and the 10k input (level 1), which the default routes no longer make
   there, held to plain and timed under ``list_route_largest``.

Both older slices print the sha256 of their decision files beside those of
the commit before the gather's redesign, so two versions of the kernels can
be held to the same decisions; the chromosome's and the genome's merged
decision files must equal those of the commit before the routes of levels
1-3. The plain version of a largest launch is timed on the one run that
the kernel is compared with.

Every kernel's line gives its time beside ``bound_ms``, the least time the
card could take for the same work: the larger of the bytes the function must
move (every distinct panel entry that the launch's lists address read once,
however many nodes share it; the lists read once; outputs written once) over
3.35 TB/s and its float32 operations over 67 TFLOP/s (NVIDIA's H100 SXM data
sheet). ``max_abs_err`` is the NaN-aware largest |kernel - plain| measured on
that launch. The sweeps also carry ``issue_ms``, a second yardstick that an
IEEE sqrt and division can be held to: tests x SASS instructions of the
inner loop's fast path per test over 132 SMs x 128 lanes x the maximum SM
clock (``static_issue_ms`` with the loop's static count, slow paths
included: the earlier yardstick); for
``hetcor_dense_l1`` the test path's instructions per test, plus the queue
branch's for each warp that enters it (``branch_entries``) and the
evaluation loop's for each test evaluated in full (``full_tests``: the
others share the threshold computed once per pair). The gathers carry ``sector_ms`` (the distinct 32-byte sectors their lists
address, since a 4-byte read moves a sector, plus lists and outputs, over
3.35 TB/s), ``launch_floor_ms`` (an empty kernel timed the same way) and
``device_ms`` (the kernel's own time from the profiler's records, with how
many of the timed launches it kept a record of). The kernels of the
chromosome's path carry its launches (``launches_chr50k``, and
``launches_chr50k_uniform`` for the uniform phenotypes) and, under
``chr50k``, the same measurements on its largest launch; they and the
one-panel gather also carry the genome's (``launches_genome``, 0 allowed for
the gather) and the pMax phases' (``launches_pmax_11k``,
``launches_pmax_stage2``, ``launches_sim_dag``) and every entry the mesh
phase's (``launches_mesh_11k_{replicated,rowsharded}``,
``launches_mesh_10k_{replicated,rowsharded}``), except ``kendall_panel``,
the last entry: the 11k block's one launch, bound by its int8 operations
over 1,979 TOP/s (``roofline_pct``), beside the striped ``torch._int_mm``
route (``library_ms``).

``--kernels-only`` stops after phase 3; ``--hetcor-scan-only`` builds
``hetcor_scan`` and the gather and runs the scan's checks alone;
``--routes-only`` runs phase 3, the
small reference block, both slices' default runs and phase 11;
``--kendall-panel-only`` builds ``kendall_panel`` and runs its checks alone.

The last lines are the kernel summary (JSON), the ``nvidia-smi`` name and
power limit, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import hashlib
import importlib
import io
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
from scipy.io import mmread

from cigwas_tpu_torch import analysis, require_cuda
from cigwas_tpu_torch.cli import main as cli_main
from cigwas_tpu_torch.constants import BED_PREFIX_COL_MAJ, PMAX_RETAINED
from cigwas_tpu_torch.io import (
    MarkerBlock,
    ReducedGC,
    ReducedGCS,
    read_blocks_from_file,
    write_marker_blocks_to_file,
)
from cigwas_tpu_torch.io.bed import encode_bed_values
from cigwas_tpu_torch.io.binary import write_coo_mtx
from cigwas_tpu_torch.io.phen import load_phen
from cigwas_tpu_torch.ops import corr as corr_ops
from cigwas_tpu_torch.ops import pcorr
from cigwas_tpu_torch.ops.corr import DEFAULT_SAMPLE_CHUNK, marker_pearson_corr
from cigwas_tpu_torch.ops.corr import PANEL_ROW_TILE as ROW_TILE
from cigwas_tpu_torch.ops.kernels import build
from cigwas_tpu_torch.ops.kernels import compact_rows as cr
from cigwas_tpu_torch.ops.kernels import dense_l1 as dk
from cigwas_tpu_torch.ops.kernels import hetcor_sweep as hs
from cigwas_tpu_torch.ops.kernels import kendall_panel as kp
from cigwas_tpu_torch.ops.kernels import local_sweep as ls
from cigwas_tpu_torch.ops.kernels import panel_gather as pg
from cigwas_tpu_torch.merge import check_ivs, merge_block_outputs
from cigwas_tpu_torch.parallel import build_multichip_cusk_step, make_mesh, sharded
from cigwas_tpu_torch.mr import run_mvivw_filtered
from cigwas_tpu_torch.pag.davs import estimate_ace
from cigwas_tpu_torch.phen_prep import PhenotypesFile, make_merged_pheno_file
from cigwas_tpu_torch.pipelines import CuskssArgs, cusk, cuskss, make_blocks
from cigwas_tpu_torch.pipelines.cusk import CuskContext
from cigwas_tpu_torch.prep import prep_bed
from cigwas_tpu_torch.sim import gen_rand_dag, simulate_genotype_dataset
from cigwas_tpu_torch.skeleton import cupc, reduce_gcs, subset_variables
from cigwas_tpu_torch.skeleton.second_stage import cusk_second_stage
from cigwas_tpu_torch.utils.combinatorics import colex_combinations_chunk
from cigwas_tpu_torch.utils.stats import fisher_z, hetcor_threshold, threshold_array

# the pipeline module (the package exports its `cusk` function under that name)
cusk_pipeline = importlib.import_module("cigwas_tpu_torch.pipelines.cusk")

# file:line of the function that reaches pl.pallas_call, per kernel
PALLAS = "cigwas_tpu/ops/pallas/panel_gather.py"
REPLACES = {"local_sweep": f"{PALLAS}:671", "panel_gather": f"{PALLAS}:138",
            "panel_gather2": f"{PALLAS}:615", "hetcor_sweep": f"{PALLAS}:615",
            # no Pallas kernel: the JAX package's plain XLA dense sweeps
            "dense_l1": "cigwas_tpu/ops/pcorr.py:820",
            "hetcor_dense_l1": "cigwas_tpu/ops/pcorr.py:900",
            # no Pallas kernel: the JAX device loop's sort of masked columns
            "compact_rows": "cigwas_tpu/skeleton/cupc.py:431",
            # no Pallas kernel: XLA's int8 dot of decoded one-hots
            "kendall_panel": "cigwas_tpu/ops/corr.py (XLA int8 dot)",
            # no Pallas kernel: the plain XLA scan of colex chunks
            "hetcor_scan": "cigwas_tpu/ops/pcorr.py:1111 (plain XLA level_scan_hetcor_pre)"}
# the reference's default block and CLI parameters
M11K, N11K, P11K = 11000, 16384, 8
ALPHA, MAX_LEVEL, MAX_LEVEL_TWO, DEPTH = 1e-4, 3, 14, 1
# the summary-statistic input (the configuration of bench.py's cuskss phase)
MSS, PSS, NSS = 10000, 8, 5.0e5
FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "data",
                        "test_files")
# the chromosome of the shell entry points: `block`'s defaults (`cli.py`)
MCHR, MAX_BLOCK, CORR_WIDTH = 50000, 11000, 2000
# markers within which a trait's five planted markers lie in that chromosome's
# coverage phenotypes (`sim_locus.phen`)
LOCUS = 3000
# NVIDIA H100 SXM data sheet: HBM3 bytes/s, float32 FLOP/s outside the tensor
# cores, dense int8 operations/s in them
PEAK_BYTES, PEAK_F32, PEAK_INT8, SMS = 3.35e12, 67e12, 1979e12, 132
# sha256 of the two older slices' decision files at the commit before the
# gather's redesign (NVIDIA H100 80GB HBM3, 700.00 W), printed beside this run's
PARENT_SHA256 = {
    "cusk": {".adj": "0410412a33cf945cf2085f27ef12932869a5bc06e543b27ae07883b146ee4086",
             ".ixs": "bd4c8da12abf1ca6c689b4dd11c644879b526286c3cd4b4cc4bc191909a8e407",
             ".mdim": "e5e89faa00a9fa70b58ecb32b13b7a24ce8c24894af0f17d4d184f4ec53714de",
             ".sep": "7e6802f0c0b69bf3335c367a034bbc080c2f7eb4f9ead6284d983d6815d42021"},
    "cuskss": {".adj": "dd8726c43ce6c5a1eda98c9f5ecf5c64be0ac670db861a4fbf02bca59c8b0ed6",
               ".ixs": "ae50a24e2dd5ea43fa670fa68b3797d26f8889bb6de3e380a01abf85bef7bd3a",
               ".mdim": "780b845574304e5b44ffde556510b7a81ddba11354bb7d315a9ed20dbe547ab2"},
    # the chromosome's and the genome's merged decision files at the commit
    # before the routes of levels 1-3 (the list route throughout), which
    # every route must reproduce
    "chr50k_uniform": {
        "blocks":
            "692a8acd8e8ebe3a95776d7a5dfda4714db1e3ec02a0977b4a654a9aff627718",
        "max_sep_min_pc.atr":
            "e3b0c44298fc1c149afbf4c8996fb92427ae41e4649b934ca495991b7852b855",
        "max_sep_min_pc.mdim":
            "cadbca3add2501e20698796dcfbfcf65c9faa7c1ed1cabe5a231a05a0e4f810f",
        "max_sep_min_pc.ssm":
            "da7b085b3c0adeff1835a30bfc2dc48124e682d21197361f35e37f98756433a8",
        "max_sep_min_pc.ut":
            "baa88d0c2118ca2b257968a36bfc1af180d7474b3c7baa113c5474d86f707de2",
        "max_sep_min_pc_sam.mtx":
            "52648be664e5f850c3bc15d4040216b5392c7d099ad2a46982a9070965a7e112",
        "max_sep_min_pc_scm.mtx":
            "550808fcc833b00b18ee6ae5e1fd06ea40517d1d6e688d45087940fe7bae86da",
        "max_sep_min_pc_spm.mtx":
            "ad985dfa1e7769cf3128ded7571055c5e1417e2cfa0e0b9e53f62f428bb1b6ad",
        "merged_blocks.ixs":
            "6a069d2e2a3dab17d89750e328ccd285eb82323ddb91b5c033e4fa426741da67",
        "merged_blocks.mdim":
            "ca97dc7374c8b944155873d5408aa123772a911b3e08cfe9855afe5d8cba9f62",
        "merged_blocks_sam.mtx":
            "1a0fa5a888932747daeeb7f2635f8900766b41fffc1cca497f9016b0b9cb1475",
        "merged_blocks_scm.mtx":
            "1fdb1617ba4e879609236e6745be4730d39e7ba29b412631211a548d852d73c8",
    },
    "chr50k_locus": {
        "blocks":
            "692a8acd8e8ebe3a95776d7a5dfda4714db1e3ec02a0977b4a654a9aff627718",
        "max_sep_min_pc.atr":
            "77c98c59757be7d0c7adaf43bf33e7e5647be7cc281946cde339e576c2fd9e77",
        "max_sep_min_pc.mdim":
            "b63071ddb3cd0b43dd845d79dfe402abc4b2ce1dbf109d326ed22229d6dc35aa",
        "max_sep_min_pc.ssm":
            "b0e22b446d00dbb7b143bb827a46838ad311ddfbd26e6e34dcf975a1d3dc258b",
        "max_sep_min_pc.ut":
            "b5823372026d44a07dcb4cbfc3fb46711d6c0a8556f8611378989114f9948cab",
        "max_sep_min_pc_sam.mtx":
            "88bdd9ad3d05dd69140973e8c1a1d0cdad823671f1290a19728b3f34d8e4d801",
        "max_sep_min_pc_scm.mtx":
            "230b87ae334bd88e8245c51daab14ecb7f61f255a5d0c64b55ced0854f5ab59a",
        "max_sep_min_pc_spm.mtx":
            "44ead37f3ed6c174f03921530ee680f812535efcc05fc17ab6d4e2c8eedbb666",
        "merged_blocks.ixs":
            "8e6dd683a1d91bb8aaf7aa2e6c2895b68848ec348c62285937ca26bd8d8e1bc2",
        "merged_blocks.mdim":
            "078b6c320a7de8a0b1eaf1e26b7c89e33730567bdc32fbf2c78df0a6a3989257",
        "merged_blocks_sam.mtx":
            "931eea2787021a1c620b3866c739d536968a1ff5919bc32f856bea7efa5b133b",
        "merged_blocks_scm.mtx":
            "e91548ac89c0ab8ede6a75c101edd1209d9bbfff3a6e15b1dda552c707932094",
    },
    "genome": {
        "blocks":
            "88fa1310cd21a9dd9e7ba511c513ead5de2f634ab7188c5df2f0d655908750ff",
        "max_sep_min_pc.atr":
            "247c171c533ad51bb800455636bd3e548f2bed5a3e1221687ebcf5f744b597e4",
        "max_sep_min_pc.mdim":
            "4516e1068dd50588de363cec43002d74e11474c1425801df97c79edf253edce5",
        "max_sep_min_pc.ssm":
            "68ca7d50a63fe3d6b4b3a415f68c4ad537935cf1aa9274e470b5928a3436e20e",
        "max_sep_min_pc.ut":
            "7f04a7940494f01f4db87feb476e6155e3d9ce2be81948e27c078dfee1fdc8f9",
        "max_sep_min_pc_estimated_pag.mtx":
            "471c53784a425f63660417859eaf547692d10eb408cefe6ab29c386e4193cc59",
        "max_sep_min_pc_sam.mtx":
            "23414474f8a81f7be414896e519a37b25bf55f714dbc20e57ecc66a9e395f807",
        "max_sep_min_pc_scm.mtx":
            "e56c3dbe4bd7a25f13ae551d9f896550cc9c65ba9515bef846439b16bcf1daa4",
        "max_sep_min_pc_spm.mtx":
            "8782441431e51cb834509bfd43c6b4a9da7066de39c19d5806b877c046e70703",
        "merged_blocks.ixs":
            "b41f53a53b2cb6313a36e1342449fac5a9e71eccb6ce933b0715106731a92452",
        "merged_blocks.mdim":
            "784053c456418bf77976e8a9efe0c66ff7b6b8bf6dfd644d5a02865624a0ea40",
        "merged_blocks_sam.mtx":
            "bad451feed23b9133fe2c841eec529c3fffd70e73ac7f4ed56667784e2bb9ff4",
        "merged_blocks_scm.mtx":
            "36e5ca7ddddd7038f9c959f06a55174e4276766f39c4a1039d57a94b787c711a",
    },
}
# float32 operations per test, read off the kernels' inner loops (a sqrt, a
# division and a tanh count as one each): the rho recursion and the compare
# for local_sweep; plus validity and time checks, the ESS sums and counts
# (four per term), the threshold (six) and the margin for hetcor_sweep
SWEEP_OPS = {1: 12, 2: 15, 3: 19}
HETCOR_OPS = {1: 29, 2: 49, 3: 69}
# the same for a test of the dense level-1 kernel (R and P come precomputed):
# three products, a difference, an absolute value, the compare; for hetcor
# also the ESS sums and counts of three terms (four per term), the threshold
# (a division, a difference, a sqrt, a division, a tanh), the margin and the
# time and finiteness checks
DENSE_OPS = {"dense_l1": 6, "hetcor_dense_l1": 26}
# the build of local_sweep.cu without the table route's pair tests, timed
# beside the full build to split a level-2/3 launch (`tables_only_ms`)
TABLES_ONLY = ("SWEEP_PAIR_TESTS=0",)
# the kernel entries that the pMax phases launch, whose counts the `kernels`
# line carries under those phases' keys
PMAX_KERNELS = ("local_sweep_l1", "local_sweep_l2", "local_sweep_l3", "panel_gather")


def emit(phase: str, t0: float, **kw) -> None:
    print(json.dumps({"phase": phase, "wall_s": time.perf_counter() - t0, **kw}), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def ptxas_summary(log: str) -> list:
    """[{kernel, registers, spill_stores, spill_loads}] from nvcc -Xptxas=-v."""
    out = []
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = re.search(r"\d((?:h?sweep|panel|dense)\w*?_kernel(?:I(?:L[ib]\d+E)+)?)",
                             m.group(1))
            out.append({"kernel": name.group(1) if name else m.group(1)})
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and out:
            out[-1].update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and out:
            out[-1]["registers"] = int(m.group(1))
    return out


def sass_of(lib) -> str:
    """The machine code of a built library, as `cuobjdump -sass` prints it
    (the CUDA toolkit's tool, beside nvcc)."""
    tool = os.path.join(os.path.dirname(build.nvcc()), "cuobjdump")
    return subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout


_SASS_INSTR = re.compile(r"^\s+/\*([0-9a-f]{4,})\*/\s+(.*?);")
_SASS_BRANCH = re.compile(r"\bBRA\s+(?:\w+,\s*)?0x([0-9a-f]+)")


def sass_functions(text: str) -> dict:
    """{mangled kernel name: [(address, instruction), ...]} of a SASS dump."""
    out: dict = {}
    cur = None
    for line in text.splitlines():
        if "Function :" in line:
            cur = out.setdefault(line.split("Function :")[1].strip(), [])
        elif cur is not None:
            m = _SASS_INSTR.match(line)
            if m:
                cur.append((int(m.group(1), 16), m.group(2).strip()))
    return out


def _backward_loops(instrs: list) -> list:
    """(first, last) address of every loop of a SASS function: a branch back
    to an address at or before its own."""
    out = []
    for addr, text in instrs:
        m = _SASS_BRANCH.search(text)
        if m and int(m.group(1), 16) <= addr:
            out.append((int(m.group(1), 16), addr))
    return out


def _rare_ranges(instrs: list, lo: int, hi: int, load_op: str) -> list:
    """The ranges (a, b) inside the loop [lo, hi] that a forward branch
    skips and that hold a CALL but no load of kind load_op: the slow paths
    of the IEEE sqrt and division (and a local_sweep chunk's exact
    recomputation, which takes them on the values already loaded), entered
    only for operands outside the fast paths. A skipped range with a test's
    load in it is a test that some lanes skip, not a slow path."""
    out = []
    for addr, text in instrs:
        m = _SASS_BRANCH.search(text)
        if not (lo <= addr <= hi and m and addr < int(m.group(1), 16) <= hi + 0x10):
            continue
        tgt = int(m.group(1), 16)
        ops = [re.sub(r"^@!?U?P\d+\s+", "", t).split()[0] for a, t in instrs if addr < a < tgt]
        if any(o.startswith("CALL") for o in ops) and not any(o.startswith(load_op) for o in ops):
            out.append((addr, tgt))
    return out


def test_loop(instrs: list, load_op: str) -> dict:
    """The loop over the conditioning sets of one kernel, found in its SASS:
    the innermost loop (a backward branch with no other inside it) that takes
    square roots (MUFU.RSQ) and stores, synchronises and reduces nothing;
    where the compiler made several copies, the one with the most roots.
    Every test makes exactly one load of kind load_op (its panel entry from
    global memory at level 1, its 128-bit table entry at levels 2-3), which
    counts the tests of one pass. Returns the static count of instructions
    in the loop's body (`loop_instructions`, the rarely taken fallbacks for
    operands outside the fast paths of sqrt and division included; the
    earlier yardstick) and the instructions per test of the fast path alone
    (`instructions_per_test`: the body without the slow paths that
    `_rare_ranges` finds, which a test runs only for operands outside the
    fast paths' ranges), beside the static count per test."""
    loops = _backward_loops(instrs)
    best = None
    for lo, hi in loops:
        if any(lo <= a and b <= hi and (a, b) != (lo, hi) for a, b in loops):
            continue
        body = [(a, t) for a, t in instrs if lo <= a <= hi]
        ops = [re.sub(r"^@!?U?P\d+\s+", "", t).split()[0] for _, t in body]
        roots = sum(o.startswith("MUFU.RSQ") for o in ops)
        if roots and not any(o.startswith(("STS", "STG", "ST.", "BAR", "ATOM", "RED"))
                             for o in ops) and (best is None or roots > best["roots"]):
            rare = _rare_ranges(instrs, lo, hi, load_op)
            fast = [o for (a, _), o in zip(body, ops) if not any(r0 < a < r1 for r0, r1 in rare)]
            tests = sum(o.startswith(load_op) for o in ops)
            assert tests > 0, f"no {load_op} in the loop at {lo:#x}"
            best = {"roots": roots, "loop_instructions": len(body), "loop": f"{lo:#x}-{hi:#x}",
                    "tests_per_pass": tests, "fast_path_instructions": len(fast),
                    "instructions_per_test": len(fast) / tests,
                    "static_instructions_per_test": len(body) / tests}
    assert best is not None, "no test loop found in the SASS"
    return best


def inner_loops(libs: dict) -> dict:
    """{(kernel, level): test_loop} of the kernels the main-path widths run:
    the level-1 direct kernels and the level 2-3 table kernels."""
    out = {}
    for kernel, prefix in (("local_sweep", "sweep"), ("hetcor_sweep", "hsweep")):
        fns = sass_functions(sass_of(libs[kernel]))
        for l in (1, 2, 3):
            want = f"{prefix}1_direct_kernelE" if l == 1 else f"{prefix}_table_kernelILi{l}E"
            (name,) = [n for n in fns if re.search(rf"\d{want}", n)]
            out[(kernel, l)] = {"function": name,
                                **test_loop(fns[name], "LDG" if l == 1 else "LDS.128")}
    return out


def sm_clock_hz() -> float:
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    return float(out.stdout.split()[0]) * 1e6


def issue_bound(tests: int, loop: dict, clock_hz: float) -> dict:
    """The second yardstick: the time to issue the inner loop's fast path
    for every test at one instruction per lane and cycle on 132 SMs x 128
    lanes, at the card's maximum SM clock; `static_issue_ms` the same with
    the loop's static count, fallbacks included (the earlier yardstick)."""
    rate = SMS * 128 * clock_hz / 1e3
    return {"issue_ms": tests * loop["instructions_per_test"] / rate,
            "static_issue_ms": tests * loop["static_instructions_per_test"] / rate,
            "instructions_per_test": loop["instructions_per_test"],
            "static_instructions_per_test": loop["static_instructions_per_test"],
            "loop_instructions": loop["loop_instructions"],
            "fast_path_instructions": loop["fast_path_instructions"],
            "tests_per_pass": loop["tests_per_pass"], "sm_clock_mhz": clock_hz / 1e6}


def level_totals(totals: dict, prefix: str) -> dict:
    """{level: (device ms of all launches, launches)} of the sweep kernels
    named <prefix>1_direct_kernel, <prefix>_table_kernel<L> and
    <prefix>_rows_kernel<L, ..> in a profiled run."""
    out = {1: [0.0, 0], 2: [0.0, 0], 3: [0.0, 0]}
    for key, v in totals.items():
        m = re.search(r"::(\w+_kernel)(?:<(\d))?", key)
        if not m:
            continue
        if m.group(1) == f"{prefix}1_direct_kernel":
            l = 1
        elif m.group(1) in (f"{prefix}_table_kernel", f"{prefix}_rows_kernel"):
            l = int(m.group(2))
        else:
            continue
        out[l][0] += v["total_ms"]
        out[l][1] += v["launches"]
    return out


def cuda_ms(fn, reps: int) -> float:
    """Mean device milliseconds of fn() over reps runs, after one warm-up."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def once_ms(fn) -> tuple:
    """(fn(), device milliseconds of that one call): for the plain versions
    of the largest launches, which take seconds, so that the run that is
    compared is the run that is timed."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def kernel_device_ms(fn, reps: int, pattern: str) -> dict:
    """Mean device milliseconds of the kernels whose name matches pattern
    over reps runs of fn(), from torch.profiler's kernel records: the time
    on the card alone, where `cuda_ms` of a short kernel measures how fast
    the host can enqueue it. `device_records` is how many of the reps
    launches the profiler kept a record of: the mean is over those, and
    device_ms is None where it kept none."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and re.search(pattern, e.key)]
    # the profiler drops some records of launches this close together (2 of 20
    # were seen kept late in a run, and none after the genome's profiled
    # run): the mean is over those it kept
    count = sum(e.count for e in events)
    assert count <= reps, (pattern, [(e.key, e.count) for e in events])
    return {"device_ms": sum(e.self_device_time_total for e in events) / 1e3 / count
            if count else None, "device_records": count, "device_reps": reps}


def bound(n_bytes: float, n_ops: float) -> dict:
    """The least time the card could take: bytes over the memory rate or
    operations over the float32 rate, whichever is larger."""
    b_ms, o_ms = n_bytes / PEAK_BYTES * 1e3, n_ops / PEAK_F32 * 1e3
    return {"bound_ms": max(b_ms, o_ms), "bound_by": "bytes" if b_ms >= o_ms else "operations",
            "bytes": n_bytes, "operations": n_ops}


def addressed(node_ixs, nbrs, deg, vp: int, pads_read_node: bool) -> tuple[int, int, int]:
    """What a launch's lists address in a (vp, vp) panel, counted on the card:
    the distinct (row, col) entries among every node's (nb_j, nb_k) and
    (x, nb_k), the distinct variables, and the distinct 32-byte sectors
    (runs of 8 entries from the panel's start) that hold those entries. An
    entry, variable or sector that many nodes share (overlapping LD
    neighbourhoods) counts once. Slots j >= deg are left out (the sweeps
    never read them) or read as the node itself (the gathers)."""
    dev = nbrs.device
    nt, d = nbrs.shape
    entry = torch.zeros(vp * vp, dtype=torch.bool, device=dev)
    var = torch.zeros(vp, dtype=torch.bool, device=dev)
    slot = torch.arange(d, device=dev)[None, :]
    step = max(1, (1 << 25) // (d * d))
    for i in range(0, nt, step):
        x = node_ixs[i : i + step].long()[:, None]
        nb = nbrs[i : i + step].long()
        live = slot < deg[i : i + step, None]
        if pads_read_node:
            nb, live = torch.where(live, nb, x), torch.ones_like(live)
        pair = live[:, :, None] & live[:, None, :]
        entry[(nb[:, :, None] * vp + nb[:, None, :])[pair]] = True
        entry[(x * vp + nb)[live]] = True
        var[nb[live]] = True
        var[x[:, 0]] = True
    whole = entry.numel() // 8 * 8
    sectors = int(entry[:whole].view(-1, 8).any(1).sum()) + int(entry[whole:].any())
    return int(entry.sum()), int(var.sum()), sectors


def sweep_bound(node_ixs, nbrs, deg, vp: int, l: int, panels: int, ops: dict) -> dict:
    """Bound of a levels 1-3 launch from its real lists: every slot y of a
    node meets each conditioning set of its other deg - 1 neighbours once (a
    node of degree l or less none);
    the distinct panel entries the lists address are read once from each
    panel (and, for hetcor, the time index of each distinct variable), the
    index lists once, the (nt, d) outputs written once. sector_ms counts 32
    bytes for every distinct sector of those entries instead of 4 for every
    entry: what the memory system must move for the scattered reads."""
    dg = deg.cpu().numpy().astype(np.int64)
    nt, d = nbrs.shape
    tests = int(sum(int(g) * math.comb(max(int(g) - 1, 0), l) for g in dg))
    entries, variables, sectors = addressed(node_ixs, nbrs, deg, vp, pads_read_node=False)
    rest = 4 * (nt * d + 2 * nt) + (4 * variables if panels == 2 else 0)
    n_out = 4 * nt * d * ((1 + l) if panels == 1 else 1)
    return {**bound(4 * panels * entries + rest + n_out, tests * ops[l]), "tests": tests,
            "distinct_entries": entries, "distinct_sectors": sectors,
            "sector_ms": (32 * panels * sectors + rest + n_out) / PEAK_BYTES * 1e3}


def gather_bound(node_ixs, nbrs, deg, vp: int, panels: int) -> dict:
    """Bound of a gather launch: nothing but bytes, the distinct panel
    entries the lists address read once from each panel, the index lists
    once, and (d^2 + d) entries per node and panel written once. sector_ms
    counts 32 bytes for every distinct sector instead of 4 for every entry:
    what the memory system moves for scattered 4-byte reads."""
    nt, d = nbrs.shape
    entries, _, sectors = addressed(node_ixs, nbrs, deg, vp, pads_read_node=True)
    rest = 4 * panels * nt * (d * d + d) + 4 * (nt * d + 2 * nt)
    return {**bound(4 * panels * entries + rest, 0), "distinct_entries": entries,
            "distinct_sectors": sectors,
            "sector_ms": (32 * panels * sectors + rest) / PEAK_BYTES * 1e3}


def max_abs_diff(a: torch.Tensor, b: torch.Tensor) -> float:
    """NaN-aware largest |a - b|: elements with equal bits or equal values
    count 0 (a NaN against the same NaN, a sentinel against itself), a NaN
    against anything else counts inf."""
    if a.numel() == 0:
        return 0.0
    same = (a.view(torch.int32) == b.view(torch.int32)) | (a == b)
    diff = torch.where(same, torch.zeros_like(a), (a - b).abs())
    return float(torch.nan_to_num(diff, nan=math.inf, posinf=math.inf).max())


def compare(tag: str, rho_k, pos_k, rho_p, pos_p, deg, rho_th: float) -> float:
    """Require bit-identical rho and identical positions; returns the
    measured max |rho_k - rho_p|."""
    if torch.equal(rho_k, rho_p) and torch.equal(pos_k, pos_p):
        return max_abs_diff(rho_k, rho_p)
    diff = (rho_k != rho_p) | (pos_k != pos_p).any(-1)
    i, j = (int(v) for v in torch.nonzero(diff)[0])
    rk, rp = float(rho_k[i, j]), float(rho_p[i, j])
    raise AssertionError(
        f"{tag}: kernel != plain at node {i} slot {j} (deg {int(deg[i])}): "
        f"rho {rk!r} vs {rp!r}, pos {pos_k[i, j].tolist()} vs {pos_p[i, j].tolist()}, "
        f"margins to tanh(th) {rk - rho_th:.3e} / {rp - rho_th:.3e}"
    )


def compare_bits(tag: str, got, exp) -> float:
    """Require equal int32 views of every tensor (NaN payloads included);
    returns the measured max |got - exp| over all of them."""
    for i, (g, e) in enumerate(zip(got, exp)):
        if g.shape != e.shape or not torch.equal(g.view(torch.int32), e.view(torch.int32)):
            raise AssertionError(f"{tag}: output {i} differs from the plain gather")
    return max(max_abs_diff(g, e) for g, e in zip(got, exp))


def compare_margin(tag: str, m_k, m_p) -> tuple[int, float]:
    """Require bit-identical margins (and so identical hit bits, margin < 0);
    returns the number compared and the measured max |m_k - m_p|."""
    same = m_k.view(torch.int32) == m_p.view(torch.int32)
    if m_k.shape != m_p.shape or not bool(same.all()):
        i, j = (int(v) for v in torch.nonzero(~same)[0])
        raise AssertionError(
            f"{tag}: kernel != plain margin at node {i} slot {j}: {float(m_k[i, j])!r} vs "
            f"{float(m_p[i, j])!r}; {int((~same).sum())} of {same.numel()} differ, "
            f"{int(((m_k < 0) != (m_p < 0)).sum())} hit bits among them"
        )
    return same.numel(), max_abs_diff(m_k, m_p)


def check_panels():
    """The 8192-variable panels of the kernel checks: a symmetric C with 1%
    NaNs, a matched per-pair ESS with 15% NaNs, a time index in {0, 1, 2}."""
    rng = np.random.default_rng(0)
    vp = 8192
    C = (0.3 * rng.standard_normal((vp, vp), dtype=np.float32))
    C = (C + C.T) * np.float32(0.5)
    C[rng.random((vp, vp), dtype=np.float32) < 0.01] = np.nan
    np.fill_diagonal(C, 1.0)
    N = rng.uniform(3e3, 1.2e4, (vp, vp)).astype(np.float32)
    N = (N + N.T) * np.float32(0.5)
    hole = np.triu(rng.random((vp, vp), dtype=np.float32) < 0.15, 1)
    N[hole | hole.T] = np.nan
    t_ix = rng.integers(0, 3, vp).astype(np.int32)
    return (rng, vp, torch.from_numpy(C).cuda(), torch.from_numpy(N).cuda(),
            torch.from_numpy(t_ix).cuda())


def neighbour_lists(rng, vp: int, nt: int, d: int, clustered: bool, distinct: bool = True,
                    level: int | None = None, lo: int | None = None):
    """Ragged ascending neighbour lists on the card: clustered in a window of
    2d + 1 variables around the node, or scattered over the panel. Degrees
    are uniform in [lo, d] (lo = d // 2 unless given), the first node's is d;
    with a level, the second node has level + 1 neighbours (one set per slot)
    and the third has level (no test: every slot returns the sentinel)."""
    node_ixs = rng.choice(vp, nt, replace=False).astype(np.int32)
    deg = rng.integers(max(1, d // 2) if lo is None else lo, d + 1, nt).astype(np.int32)
    deg[0] = d
    if level is not None and nt >= 3:
        deg[1], deg[2] = min(d, level + 1), min(d, level)
    nbrs = np.zeros((nt, d), np.int32)
    for i, x in enumerate(node_ixs):
        if clustered:
            lo = max(0, min(int(x) - d, vp - 2 * d - 1))
            pool = np.arange(lo, min(vp, lo + 2 * d + 1))
        else:
            pool = np.arange(vp)
        pool = pool[pool != x]
        nbrs[i, : deg[i]] = np.sort(rng.choice(pool, deg[i], replace=not distinct))
    return [torch.from_numpy(a).cuda() for a in (node_ixs, nbrs, deg)]


def loop_lists(rng, vp: int, nt: int, d: int, l: int, full: bool, clustered: bool):
    """Lists at one width d over ragged degrees, as a launch of the
    device-resident loop holds them: all nodes of degree d (full), or
    (mixed) one hub of degree d, light nodes of degree l + 1 .. max(l + 1,
    d // 3) and, beyond what the loop sends, two nodes of each degree 0 .. l
    (no test); the slots past a degree keep other valid indices."""
    node_ixs, nbrs, deg = neighbour_lists(rng, vp, nt, d, clustered, lo=d)
    if not full:
        g = rng.integers(l + 1, max(l + 1, d // 3) + 1, nt)
        g[: 2 * (l + 1)] = np.repeat(np.arange(l + 1), 2)
        g[2 * (l + 1)] = d
        deg = torch.from_numpy(rng.permutation(g).astype(np.int32)).cuda()
    return [node_ixs, nbrs, deg]


def tied_panels(Cd, Nd, td):
    """1024-variable panels in which every variable stands four times
    (variable i is variable i // 4 of the source panels): conditioning sets
    that differ only in which copy they hold give bitwise equal statistics,
    so a minimum is attained by several sets at once and the one of lowest
    colex rank has to win."""
    ix = torch.arange(1024, device=Cd.device) // 4
    return Cd[ix][:, ix].contiguous(), Nd[ix][:, ix].contiguous(), td[ix].contiguous()


def scratch_plan(module, d: int) -> dict:
    """The plan of the route that keeps its per-slot rows in global scratch,
    forced at a width the card can hold against the plain version (the
    wrappers' own plans reach it only past d = 19370 / 10777 at level 1)."""
    threads, per_node = ls.split_slots(d)
    return {"route": ls.ROUTE_ROWS_SCRATCH, "threads": threads, "nodes_per_cta": 1,
            "ctas_per_node": per_node, "smem_bytes": 0,
            "scratch_floats_per_node": per_node * module.WORK_ROWS * d}


def rows_plan(module, l: int, d: int, panels: int) -> dict:
    """The plan of the one-thread-per-slot route with the panel(s) staged in
    shared memory, forced at a width whose own plan is the table route: the
    design the table route replaced, timed beside it."""
    threads, per_node = ls.split_slots(d)
    return {"route": ls.ROUTE_ROWS_STAGED, "threads": threads, "nodes_per_cta": 1,
            "ctas_per_node": per_node,
            "smem_bytes": 4 * (module.WORK_ROWS * d + panels * d * (d + 1)),
            "scratch_floats_per_node": 0}


def phase_kernels(rho_th: dict, panels) -> None:
    """local_sweep vs plain, levels 1-3, clustered and scattered lists, ragged
    degrees with a node of level + 1 and a node of level neighbours, at d in
    {8, 40, 64, 112, 120, 136, 144, 232, 240, 256, 300}: both sides of the
    table routes' limits (d = 138 at level 2, 120 at level 3) and of the
    staged panel's (d = 236); level-1 nodes of width 6600 (52 CTAs a node),
    the same through the global-scratch route; and panels of repeated
    variables, where tied minima must resolve to the lowest colex rank.
    Then launches at one width over ragged degrees, as the device-resident
    loop makes them, at its widths 8, 56, 80 and 152: light nodes (and nodes
    of degree 0 .. l, no test) and one hub at the full width, every node at
    the full width, and mixed degrees on the repeated variables."""
    t0 = time.perf_counter()
    rng, vp, Cd, Nd, td = panels
    cases = [(d, l, None) for d in (8, 40, 64, 112, 120, 136, 144, 232, 240, 256, 300)
             for l in (1, 2, 3)]
    cases += [(6600, 1, None), (6600, 1, scratch_plan(ls, 6600))]
    n_cmp, max_err, routes = 0, 0.0, set()
    for clustered in (True, False):
        for d, l, forced in cases:
            if clustered and 2 * d + 1 > vp:
                continue
            args = neighbour_lists(rng, vp, 2 if d > 1000 else (3 if d > 144 else 6), d,
                                   clustered, level=l)
            rho_k, pos_k = ls.local_sweep(Cd, *args, l, launch_plan=forced)
            rho_p, pos_p = pcorr.local_sweep_plain(Cd, *args, l)
            torch.cuda.synchronize()
            tag = f"{'clustered' if clustered else 'scattered'} d={d} l={l}"
            max_err = max(max_err, compare(tag, rho_k, pos_k, rho_p, pos_p, args[2], rho_th[l]))
            routes.add((l, (forced or ls.plan(l, d))["route"]))
            n_cmp += 1
    Ct = tied_panels(Cd, Nd, td)[0]
    n_tied = 0
    for d, l in [(d, l) for d in (8, 24, 48) for l in (1, 2, 3)] + [(144, 2), (120, 3)]:
        args = neighbour_lists(rng, 1024, 6, d, False, level=l)
        rho_k, pos_k = ls.local_sweep(Ct, *args, l)
        rho_p, pos_p = pcorr.local_sweep_plain(Ct, *args, l)
        max_err = max(max_err, compare(f"ties d={d} l={l}", rho_k, pos_k, rho_p, pos_p,
                                       args[2], rho_th[l]))
        n_tied += int((rho_p < pcorr.RHO_BIG).sum())
        n_cmp += 1
    assert n_tied > 0, "the panels of repeated variables gave no valid test"
    # launches at one width over ragged degrees, as the device-resident loop
    # makes them
    loop_cases = 0
    for l in (1, 2, 3):
        for d in (8, 56, 80, 152):
            for full, C_, clustered in ((False, Cd, True), (True, Cd, True), (False, Ct, False)):
                args = loop_lists(rng, C_.shape[0], 96, d, l, full, clustered)
                rho_k, pos_k = ls.local_sweep(C_, *args, l)
                rho_p, pos_p = pcorr.local_sweep_plain(C_, *args, l)
                torch.cuda.synchronize()
                tag = (f"loop layout d={d} l={l} {'full' if full else 'mixed'}"
                       f"{' ties' if C_ is Ct else ''}")
                max_err = max(max_err, compare(tag, rho_k, pos_k, rho_p, pos_p, args[2],
                                               rho_th[l]))
                routes.add((l, ls.plan(l, d)["route"]))
                loop_cases += 1
    emit("kernels_local_sweep", t0, cases=n_cmp + loop_cases, loop_layout_cases=loop_cases,
         bit_identical=True, max_abs_err=max_err, routes=sorted(routes), tied_slots=n_tied)


def launch_floor_ms() -> float:
    """Device milliseconds between launches of a kernel that does nothing,
    timed as every kernel here is: what a launch alone costs."""
    return cuda_ms(pg.launch_empty, reps=200)


def gather_timing(tag: str, panels_d: tuple, args: list, vp: int, reps: int) -> dict:
    """One gather launch, bit-identical to the plain version, timed as the
    skeleton launches it, beside the bound, the sectors and the
    advanced-indexing call that computes the same panels. `ms` is by CUDA
    events around the calls, so for a launch shorter than the wrapper's host
    work it is the enqueue rate; `device_ms` is the kernel's own time from
    the profiler's records."""
    two = len(panels_d) == 2
    kern = pg.gather_local_panels2 if two else pg.gather_local_panels
    plain = pg.gather_local_panels2_plain if two else pg.gather_local_panels_plain
    node_ixs, nbrs, deg = args
    nt, d = nbrs.shape
    err = compare_bits(tag, kern(*panels_d, *args), plain(*panels_d, *args))
    nb = pg.remap_pad_slots(*args).long()
    x = node_ixs.long()[:, None]
    run = lambda: kern(*panels_d, *args, index_range_checked=True)  # noqa: E731
    return {
        "nodes": int(nt), "width": int(d), "panels": len(panels_d), "max_abs_err": err,
        "plan": pg.plan(d, len(panels_d)), **gather_bound(*args, vp, len(panels_d)),
        "ms": cuda_ms(run, reps), **kernel_device_ms(run, 20, "panel_rows_kernel"),
        "library_ms": cuda_ms(
            lambda: [(P[nb[:, :, None], nb[:, None, :]], P[x, nb]) for P in panels_d], reps),
    }


def phase_gather_kernel(panels) -> None:
    """panel_gather vs plain, one and two panels, at d in {1, 3, 8, 40, 50,
    136, 256, 300, 1000}, clustered and scattered, ragged degrees, in the
    row design and the same with its lists read through the cache; one node
    of width 13000 with repeated neighbours
    (a 52 KB list: shared memory by opt-in, and through the cache). Then the
    timed launches: the main paths' 8 x 8 one-panel and 8 x 16 two-panel
    launches and bucket-sized two-panel launches of 2048 nodes at widths
    128, 48 and 50 (d % 4 != 0: scalar stores)."""
    t0 = time.perf_counter()
    rng, vp, Cd, Nd, _ = panels
    n_cmp, max_err = 0, 0.0

    def unstaged(d, n_panels):
        return {**pg.plan(d, n_panels), "staged": 0, "smem_bytes": 0}

    for clustered in (True, False):
        for d in (1, 3, 8, 40, 50, 136, 256, 300, 1000):
            args = neighbour_lists(rng, vp, 3 if d >= 1000 else 6, d, clustered)
            tag = f"{'clustered' if clustered else 'scattered'} d={d}"
            one, two = (pg.gather_local_panels_plain(Cd, *args),
                        pg.gather_local_panels2_plain(Cd, Nd, *args))
            for name, plan1, plan2 in (("rows", None, None),
                                       ("unstaged", unstaged(d, 1), unstaged(d, 2))):
                max_err = max(
                    max_err,
                    compare_bits(f"{tag} one panel {name}",
                                 pg.gather_local_panels(Cd, *args, launch_plan=plan1), one),
                    compare_bits(f"{tag} two panels {name}",
                                 pg.gather_local_panels2(Cd, Nd, *args, launch_plan=plan2), two))
                torch.cuda.synchronize()
                n_cmp += 2
    args = neighbour_lists(rng, vp, 1, 13000, False, distinct=False)
    expect = pg.gather_local_panels_plain(Cd, *args)
    for name, forced in (("rows", None), ("unstaged", unstaged(13000, 1))):
        max_err = max(max_err, compare_bits(
            f"scattered d=13000 {name}", pg.gather_local_panels(Cd, *args, launch_plan=forced),
            expect))
        torch.cuda.synchronize()
        n_cmp += 1
    del expect
    timed = [
        gather_timing("8 x 8 one panel", (Cd,), neighbour_lists(rng, vp, 8, 8, True), vp, 200),
        gather_timing("8 x 16 two panels", (Cd, Nd), neighbour_lists(rng, vp, 8, 16, True),
                      vp, 200),
    ]
    # beyond the main paths' few-node tiles: launches the size of a bucket
    for d in (128, 48, 50):
        timed.append(gather_timing(f"2048 x {d} two panels", (Cd, Nd),
                                   neighbour_lists(rng, vp, 2048, d, True), vp, 20))
    emit("kernels_panel_gather", t0, cases=n_cmp + len(timed), bit_identical=True,
         max_abs_err=max_err, launch_floor_ms=launch_floor_ms(), timed=timed)


def phase_hetcor_kernel(panels) -> list:
    """hetcor_sweep vs plain, levels 1-3, clustered and scattered lists,
    ragged degrees with a node of level + 1 and a node of level neighbours,
    ESS with 15% NaNs as it is ("float") and truncated ("reference"), time
    indices in {0, 1, 2}, at d in {8, 40, 64, 104, 112, 120} and {160, 168,
    240, 300}: both sides of the table route's limits (d = 119 at level 2,
    106 at level 3) and of the staged panels' (d = 166); the four widest
    sizes alternate the ESS mode between the clustered and the scattered
    lists. Level-1 nodes of width 4600 (36 CTAs a node), the same through the
    global-scratch route, and panels of repeated variables (tied margins).
    Then one launch the size of a level-2 or level-3 bucket, 1024 nodes x
    width 48 with degrees 24-48, the whole launch against the plain version,
    timed beside its bound and beside the one-thread-per-slot route."""
    t0 = time.perf_counter()
    rng, vp, Cd, Nd, td = panels
    N_mode = {"float": Nd, "reference": pcorr.trunc_ref_ess(Nd)}
    th = hetcor_threshold(ALPHA)
    n_cmp, n_all, n_hits, max_err, routes = 0, 0, 0, 0.0, set()

    def check(tag, C, N, t, args, l, forced=None):
        nonlocal n_cmp, n_all, n_hits, max_err
        m_k = hs.hetcor_local_sweep(C, N, t, *args, th, l, launch_plan=forced)
        m_p = pcorr.hetcor_local_sweep_plain(C, N, t, *args, th, l)
        torch.cuda.synchronize()
        count, err = compare_margin(tag, m_k, m_p)
        n_all, max_err = n_all + count, max(max_err, err)
        n_hits += int((m_k < 0).sum())
        routes.add((l, (forced or hs.plan(l, args[1].shape[1]))["route"]))
        n_cmp += 1

    for clustered in (True, False):
        cases = [(d, l, m, None) for d in (8, 40, 64, 104, 112, 120) for l in (1, 2, 3)
                 for m in ("float", "reference")]
        cases += [(d, l, "float" if clustered else "reference", None)
                  for d in (160, 168, 240, 300) for l in (1, 2, 3)]
        if not clustered:
            cases += [(4600, 1, "float", None), (4600, 1, "float", scratch_plan(hs, 4600))]
        for d, l, mode, forced in cases:
            args = neighbour_lists(rng, vp, 2 if d > 1000 else (3 if d > 120 else 4), d,
                                   clustered, level=l)
            check(f"{'clustered' if clustered else 'scattered'} d={d} l={l} {mode}",
                  Cd, N_mode[mode], td, args, l, forced)
    Ct, Nt, tt = tied_panels(Cd, Nd, td)
    for d, l in [(d, l) for d in (8, 24, 48) for l in (1, 2, 3)]:
        check(f"ties d={d} l={l}", Ct, Nt, tt,
              neighbour_lists(rng, 1024, 6, d, False, level=l), l)
    assert 0 < n_hits < n_all, f"degenerate cases: {n_hits} hits of {n_all} margins"

    bucket = []
    for l in (2, 3):
        args = neighbour_lists(rng, vp, 1024, 48, True, lo=24)
        full = (Cd, Nd, td, *args, th, l)
        count, err = compare_margin(f"bucket-sized l={l}", hs.hetcor_local_sweep(*full),
                                    pcorr.hetcor_local_sweep_plain(*full))
        bucket.append({
            "level": l, "nodes": 1024, "width": 48, "margins_bit_identical": count,
            "max_abs_err": err, **sweep_bound(*args, vp, l, 2, HETCOR_OPS),
            "ms": cuda_ms(lambda: hs.hetcor_local_sweep(
                *full, index_range_checked=True), reps=5),
            "rows_route_ms": cuda_ms(lambda: hs.hetcor_local_sweep(
                *full, index_range_checked=True, launch_plan=rows_plan(hs, l, 48, 2)), reps=5),
        })
    emit("kernels_hetcor_sweep", t0, cases=n_cmp, bit_identical=True, max_abs_err=max_err,
         margins=n_all, hits=n_hits, routes=sorted(routes), bucket_sized=bucket)
    return bucket


def scan_ops(l: int) -> tuple[int, int]:
    """(f32 operations a set, a test) that csrc/hetcor_scan.cu's work needs
    at the least (a division, sqrt or tanh as one): a set's inverse (the
    closed form at l <= 3; Gauss-Jordan above it: at step k a multiplier and
    2 (2l - k - 1) updates for each of the l - 1 other rows, then l^2
    divisions), t = M2^-1 C[S, x] and H00 (2 l^2 + 2 l + 1), the S-S and x-S
    ESS terms (a value and a count each) and S's latest time (l - 1); a
    test's H01 (2 l + 1), H11 as 1 - r.(M2^-1 r) (2 l^2 + 2 l + 1; the
    kernel sums r_i m_ij r_j, 3 l^2), rho (5), the y-S and x-y ESS terms
    (2 l + 2), the mean, threshold and margin (11)."""
    if l <= 3:
        inv = {1: 1, 2: 7, 3: 41}[l]
    else:
        inv = sum((l - 1) * (1 + 2 * (2 * l - k - 1)) for k in range(l)) + l * l
    per_set = inv + 2 * l * l + 2 * l + 1 + l * (l - 1) + 2 * l + (l - 1)
    return per_set, 2 * l * l + 6 * l + 20


def scan_work(args) -> dict:
    """What a scan launch's inputs need: the valid sets (the first left of
    each chunk), their tests (the node's other deg - l neighbours each) and
    the f32 operations of both (`scan_ops`), and the bound those put on the
    card (operations over 67 TFLOP/s; the panels' bytes bound it far lower)."""
    deg, left, l = args[6].long(), args[8], args[-1]
    sets = left.sum(0)  # (nt,)
    tests = int((sets * torch.clamp(deg - l, min=0)).sum())
    n_sets = int(sets.sum())
    per_set, per_test = scan_ops(l)
    nbytes = 4 * (2 * args[0].numel() + 4 * args[1].numel())
    return {"sets": n_sets, "tests": tests, **bound(nbytes, n_sets * per_set + tests * per_test)}


def scan_wave(rng, C, N, t_ix, nt: int, d: int, l: int, lo: int, hi: int) -> tuple:
    """One scan launch as `cupc._run_level` makes it: nt nodes of degree lo..hi
    at bucket width d (the slots past a degree keep other valid indices),
    their panels gathered, and the first wave of level-l sets: the next
    power of two of 512-set chunks that holds the largest node's sets, at
    most 256."""
    vp = C.shape[0]
    node_ixs, nbrs, _ = neighbour_lists(rng, vp, nt, d, False, lo=d)
    deg_np = rng.integers(lo, hi + 1, nt).astype(np.int32)
    deg = torch.from_numpy(deg_np).cuda()
    sets = np.array([math.comb(int(g), l) for g in deg_np], dtype=np.int64)
    chunk = cupc.CHUNK
    n_ch = 1 << max(0, math.ceil(math.log2(max(1, -(-int(sets.max()) // chunk)))))
    n_ch = min(n_ch, cupc.MAX_CHUNKS_PER_LAUNCH)
    combos = torch.from_numpy(colex_combinations_chunk(0, n_ch * chunk, l).astype(np.int64)
                              .reshape(n_ch, chunk, l)).cuda()
    totals = np.minimum(sets, n_ch * chunk)
    left = torch.from_numpy(np.clip(totals[None, :] - chunk * np.arange(n_ch)[:, None], 0,
                                    chunk)).cuda()
    Cb, qb, Nb, nr = pg.gather_local_panels2(C, N, node_ixs, nbrs, deg)
    return (Cb, qb, Nb, nr, t_ix[nbrs.long()].float(), t_ix[node_ixs.long()].float(), deg,
            combos, left, hetcor_threshold(ALPHA), l)


def factor_panel_cuda(v: int, seed: int, n: int = 900, k: int = 4) -> torch.Tensor:
    """Correlations of v variables on k shared factors (half the loadings
    zero) plus noise of sd 1.5, from n samples made on the card: the
    well-conditioned blocks of tests/torch_parity.py's `factor_panel`."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    F = torch.randn(k, n, generator=g, device="cuda")
    W = torch.randn(v, k, generator=g, device="cuda")
    W = W * (torch.rand(v, k, generator=g, device="cuda") < 0.5)
    X = W @ F + 1.5 * torch.randn(v, n, generator=g, device="cuda")
    return torch.corrcoef(X).float().contiguous()


def phase_hetcor_scan(panels) -> list:
    """hetcor_scan (`csrc/hetcor_scan.cu`) vs its plain version on the card,
    margins bit for bit, one launch per call: at the shapes of the 10k
    merged input's stage 2 (16 hubs, width 16 at degrees 14-16 and width 32
    at 17-18, levels 4-14, each timed beside its bound and the plain
    version) and at levels 1-3 there, on wide buckets (64, 128, 256 at
    levels 1-5, the panels through L2), on a panel whose C holds 1% NaNs
    (no test counts) and on one with a variable stored twice (singular
    blocks), over a 4,096-variable factor panel with the check panels'
    NaN-holed ESS and time indices."""
    t0 = time.perf_counter()
    rng, vp, Cd, Nd, td = panels
    v = 4096
    C = factor_panel_cuda(v, seed=21)
    N, t_ix = Nd[:v, :v].contiguous(), td[:v].contiguous()
    n_cmp, n_all, n_hits, n_big, timed = 0, 0, 0, 0, []

    def check(tag, args, time_it=False):
        nonlocal n_cmp, n_all, n_hits, n_big
        before = hs.launches["hetcor_scan"]
        m_k = hs.hetcor_scan(*args)
        assert hs.launches["hetcor_scan"] == before + 1, tag
        m_p, plain_ms = once_ms(lambda: pcorr.level_scan_hetcor_pre(*args))
        count, _ = compare_margin(tag, m_k, m_p)
        n_cmp, n_all = n_cmp + 1, n_all + count
        n_hits += int((m_k < 0).sum())
        n_big += int((m_k >= pcorr.MARGIN_BIG).sum())
        if time_it:
            nt, d = args[1].shape
            timed.append({
                "level": args[-1], "nodes": nt, "width": d, "chunks": int(args[7].shape[0]),
                "plan": hs.scan_plan(args[-1], d),
                "ctas_per_node": hs.scan_ctas_per_node(nt, args[7].shape[0] * args[7].shape[1]),
                "ms": cuda_ms(lambda: hs.hetcor_scan(*args), reps=5), "plain_ms": plain_ms,
                "hits": int((m_k < 0).sum()), **scan_work(args),
                **kernel_device_ms(lambda: hs.hetcor_scan(*args), 5, r"hetcor_scan_kernel"),
            })
        return m_k

    for d, lo, hi in ((16, 14, 16), (32, 17, 18)):
        for l in range(1, 15):
            check(f"hubs d={d} l={l}", scan_wave(rng, C, N, t_ix, 16, d, l, lo, hi),
                  time_it=l >= 4)
    for d in (64, 128, 256):
        for l in range(1, 6):
            check(f"wide d={d} l={l}", scan_wave(rng, C, N, t_ix, 4, d, l, d // 2, d))
    args = scan_wave(rng, Cd, Nd, td, 16, 32, 5, 17, 18)
    m = check("C with 1% NaN", args)
    holed = ~(torch.isfinite(args[0]).all(2).all(1) & torch.isfinite(args[1]).all(1))
    assert bool(holed.any()) and bool((m[holed] >= pcorr.MARGIN_BIG).all())
    ix = torch.arange(v, device="cuda") // 2 * 2  # variable 2i + 1 stands for variable 2i
    check("every variable twice", scan_wave(rng, C[ix][:, ix].contiguous(), N, t_ix, 16, 32,
                                           6, 17, 18))
    assert 0 < n_hits < n_all - n_big, (n_hits, n_all, n_big)
    emit("kernels_hetcor_scan", t0, cases=n_cmp, bit_identical=True, margins=n_all,
         hits=n_hits, sentinels=n_big, hubs=timed)
    return timed


def scan_entry(tag: str, rec: Recorder, launches: dict) -> dict:
    """The largest hetcor_scan launch of a run (by slots x sets), kernel vs
    plain bit for bit on the same tensors, timed beside its bound, the plain
    version and the profiler's device time alone."""
    args = rec.largest[("hetcor_scan",)][1]
    plain, plain_ms = once_ms(lambda: pcorr.level_scan_hetcor_pre(*args))
    count, err = compare_margin(f"{tag} hetcor_scan", hs.hetcor_scan(*args), plain)
    nt, d = args[1].shape
    work = scan_work(args)
    run = lambda: hs.hetcor_scan(*args)  # noqa: E731
    return {**kernel_entry(
        "hetcor_scan", hs, "hetcor_scan", launches["hetcor_scan"], err, cuda_ms(run, reps=5),
        plain_ms, work, None, {"level": args[-1], "nodes": nt, "width": d,
                               "chunks": int(args[7].shape[0]), "sets": work["sets"]},
        margins_bit_identical=count, **kernel_device_ms(run, 5, r"hetcor_scan_kernel")),
        "source": hs.SCAN_SOURCE}


def phase_compact_kernel(dev: str = "cuda", sizes: tuple = ((10112, 16), (12288, 152)),
                         reps: int = 50) -> list:
    """compact_rows vs plain, bit for bit: random (density 0.1), empty,
    full and single-edge rows of n in {77, 1000, 1024, 10112} (rows not all
    whole 16-byte loads), widths 8 to 152 below and above the rows' degrees,
    rows in any order and repeated. Then one launch over every row of a
    banded (n, n) adjacency at the width of the 10k input's stage 1 and of
    a scattered one at the widest the device levels take (`sizes`), each
    timed beside its byte bound (the rows read once, the lists and degrees
    written once), the L2 cleared before each of `reps` launches (median):
    the skeleton finds its adjacency cold."""
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(11)
    cases = 0
    for n in (77, 1000, 1024, 10112):
        ix = torch.arange(n, device=dev)
        for kind in ("random", "empty", "full", "single"):
            if kind == "random":
                G = torch.rand((n, n), generator=gen, device=dev) < 0.1
            elif kind == "single":
                G = torch.zeros((n, n), dtype=torch.bool, device=dev)
                G[ix, (ix * 7 + n - 1) % n] = True
            else:
                G = torch.full((n, n), kind == "full", dtype=torch.bool, device=dev)
            rows = torch.cat([torch.randperm(n, generator=gen, device=dev)[:300],
                              ix.new_tensor([5, 5, n - 1])]).to(torch.int32)
            for d in (8, 16, 40, 128, 152):
                compare_bits(f"compact_rows n={n} {kind} d={d}", cr.compact_rows(G, rows, d),
                             cr.compact_rows_plain(G, rows, d))
                cases += 1
    sized = []
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    for n, d in sizes:
        ix = torch.arange(n, device=dev)
        if d <= 16:  # a band of d neighbours a row, as AR(1) LD gives
            G = (ix[:, None] - ix[None, :]).abs() <= d // 2
        else:  # scattered edges, degrees to about d
            G = torch.rand((n, n), generator=gen, device=dev) < (d - 40) / (2 * n)
            G |= G.T.clone()
        G.diagonal().zero_()
        rows = ix.to(torch.int32)
        got = cr.compact_rows(G, rows, d)
        compare_bits(f"compact_rows every row {n} x {d}", got, cr.compact_rows_plain(G, rows, d))
        ms = []
        for _ in range(reps if dev == "cuda" else 0):
            flush.zero_()
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            cr.compact_rows(G, rows, d, index_range_checked=True)
            end.record()
            torch.cuda.synchronize()
            ms.append(start.elapsed_time(end))
        sized.append({"rows": n, "n": n, "width": d, "max_degree": int(got[1].max()),
                      "ms": sorted(ms)[len(ms) // 2] if ms else None,
                      "min_ms": min(ms) if ms else None, "reps": len(ms),
                      **bound(n * n + 4 * n * (d + 1), 0)})
    emit("kernels_compact_rows", t0, cases=cases, bit_identical=True, full_sized=sized)
    return sized


def packed_codes(m: int, n: int, seed: int, dev: str = "cuda") -> torch.Tensor:
    """(m, nb) packed genotypes made on the card, nb = ceil(n / 4) rounded up
    to the kernel's ROW_ALIGN: codes 11 / 10 / 00 / 01 at 25 / 45 / 25 / 5%,
    marker 1 all missing, marker 2 monomorphic, random junk past n."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    nb = -(-(-(-n // 4)) // kp.ROW_ALIGN) * kp.ROW_ALIGN
    codes = torch.empty((m, 4 * nb), dtype=torch.uint8, device=dev)
    for r0 in range(0, m, 1024):  # in slabs: the draws of a whole block take GBs
        u = torch.rand((min(1024, m - r0), 4 * nb), generator=gen, device=dev)
        c = torch.where(u < 0.25, 3, torch.where(u < 0.70, 2, torch.where(u < 0.95, 0, 1)))
        if r0 == 0 and m > 2:
            c[1] = 1
            c[2] = 2
        codes[r0 : r0 + len(c)] = c.to(torch.uint8)
    codes[:, n:] = torch.randint(0, 4, (m, 4 * nb - n), generator=gen, device=dev,
                                 dtype=torch.uint8)
    q = codes.view(m, nb, 4)
    return q[..., 0] | q[..., 1] << 2 | q[..., 2] << 4 | q[..., 3] << 6


def int_mm_route(codes: torch.Tensor, n: int) -> torch.Tensor:
    """The striped route the block panels ran before the kernel, on the
    card: rows padded to a 2,048 multiple, 131,072-sample chunks, the int8
    one-hot decoded once where it fits 2 GiB (else again by every stripe),
    each 2,048-row stripe's ``torch._int_mm`` against every marker summed in
    int32, the Kendall map."""
    m = codes.shape[0]
    assert 4 * codes.shape[1] == n, "the route takes rows of whole bytes, no codes past n"
    m_pad = -(-m // ROW_TILE) * ROW_TILE
    x = torch.full((m_pad, codes.shape[1]), 0x55, dtype=torch.uint8, device=codes.device)
    x[:m] = codes
    cb = min(DEFAULT_SAMPLE_CHUNK // 4, x.shape[1])
    x = torch.cat([x, x.new_full((m_pad, (-x.shape[1]) % cb), 0x55)], 1)
    n_chunks = x.shape[1] // cb

    def decode(c):
        return corr_ops.geno_onehot(corr_ops.unpack_bed_codes(
            x[:, c * cb : (c + 1) * cb])).reshape(3 * m_pad, -1)

    once = [decode(c) for c in range(n_chunks)] if 3 * m_pad * 4 * x.shape[1] <= 2 << 30 else None
    C = torch.zeros((m_pad, m_pad), dtype=torch.float32, device=x.device)
    for t0 in range(0, m_pad, ROW_TILE):
        counts = torch.zeros((3 * ROW_TILE, 3 * m_pad), dtype=torch.int32, device=x.device)
        for c in range(n_chunks):
            X = once[c] if once is not None else decode(c)
            rows = torch.cat([X[a * m_pad + t0 : a * m_pad + t0 + ROW_TILE] for a in range(3)])
            counts += corr_ops.contingency_counts(rows, X)
        C[t0 : t0 + ROW_TILE] = kp.kendall_from_counts(counts.to(torch.float32), ROW_TILE, m_pad)
        del counts
    return C[:m, :m]


def phase_kendall_panel(dev: str = "cuda", reps: int = 5) -> list:
    """kendall_panel vs its plain version on the card, every value and NaN
    position bit for bit, nothing outside out[:m, :m] written; at the
    shapes of the block cells and of `corr_panel_device`'s blocks also the
    kernel's ms (CUDA events, median of reps), its bound (the distinct
    pairs' int8 operations, `h100bench/roofline.py`), the plain version's
    ms and the striped `torch._int_mm` route's (the library yardstick,
    checked bit for bit too)."""
    from h100bench.roofline import int8_panel_seconds

    t0 = time.perf_counter()
    out = []
    kp.reset_launches()
    for m, n, timed in ((200, 777, False), (65, 1001, False), (3000, 16384, True),
                        (11000, 16384, True), (11000, 262144, True)):
        codes = packed_codes(m, n, seed=m + n, dev=dev)
        got = torch.full((m + 1, m + 3), -7.0, device=dev)
        kp.kendall_panel(codes, n, got)
        torch.cuda.synchronize()
        assert (got[m:] == -7).all() and (got[:, m:] == -7).all(), (m, n)
        got = got[:m, :m].clone()
        want = torch.empty((m, m), dtype=torch.float32, device=dev)
        _, plain_ms = once_ms(lambda: kp.kendall_panel_plain(codes, n, want))
        compare_bits(f"kendall_panel {m} x {n}", (got,), (want,))
        rec = {"markers": m, "samples": n, "bit_identical": True,
               "nan": int(torch.isnan(got).sum()), "plain_ms": plain_ms}
        if timed:
            del want
            torch.cuda.empty_cache()
            ms = []
            for _ in range(reps):
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record()
                kp.kendall_panel(codes, n, got)
                end.record()
                torch.cuda.synchronize()
                ms.append(start.elapsed_time(end))
            lib, library_ms = once_ms(lambda: int_mm_route(codes, n))
            compare_bits(f"int_mm route {m} x {n}", (got,), (lib,))
            del lib
            bound_ms = 1e3 * int8_panel_seconds(m, n)
            k_ms = sorted(ms)[len(ms) // 2]
            rec.update(ms=k_ms, min_ms=min(ms), reps=reps, bound_ms=bound_ms,
                       roofline_pct=100.0 * bound_ms / k_ms, library_ms=library_ms)
        out.append(rec)
        del codes, got
        torch.cuda.empty_cache()
    emit("kernels_kendall_panel", t0, launches=dict(kp.launches), shapes=out,
         nvidia_smi=nvidia_smi())
    return out


def write_block(d: str, G: np.ndarray, Y: np.ndarray) -> tuple[str, str]:
    """PLINK files + prep + a one-block `.blocks` file; returns (stem, blocks)."""
    m, n = G.shape
    stem = os.path.join(d, "sim")
    with open(stem + ".bed", "wb") as f:
        f.write(BED_PREFIX_COL_MAJ)
        f.write(encode_bed_values(G).tobytes())
    with open(stem + ".bim", "w") as f:
        f.writelines(f"1\trs{i}\t0\t{100 * i}\tA\tG\n" for i in range(m))
    with open(stem + ".fam", "w") as f:
        f.writelines(f"F{i} I{i} 0 0 0 -9\n" for i in range(n))
    write_phen(stem + ".phen", Y)
    prep_bed(stem)
    blocks = stem + ".blocks"
    write_marker_blocks_to_file([MarkerBlock("1", 0, m - 1)], blocks)
    return stem, blocks


def ar1_block(m: int, n: int, p: int, seed: int):
    """The 11k generator of bench.py: AR(1) LD (ar 0.92), genotypes from a
    logistic allele frequency, 5 planted markers per trait at effect 0.2."""
    rng = np.random.default_rng(seed)
    noise = rng.normal(size=(m, n)).astype(np.float32)
    ar = 0.92
    prev = np.empty((m, n), dtype=np.float32)
    acc = noise[0]
    prev[0] = acc
    scale = np.sqrt(1 - ar**2)
    for i in range(1, m):
        acc = ar * acc + scale * noise[i]
        prev[i] = acc
    del noise
    pfreq = 1 / (1 + np.exp(-prev * 0.8))
    del prev
    u1 = rng.random((m, n)).astype(np.float32)
    u2 = rng.random((m, n)).astype(np.float32)
    G = (u1 < pfreq).astype(np.float32) + (u2 < pfreq)
    del u1, u2, pfreq
    Y = rng.normal(size=(p, n)).astype(np.float32)
    planted = []
    for t in range(p):
        for k in rng.integers(0, m, 5):
            Y[t] += 0.2 * (G[k] - G[k].mean()) / G[k].std()
            planted.append(int(k))
    Y = (Y - Y.mean(1, keepdims=True)) / Y.std(1, keepdims=True)
    return G, Y, planted


def held_sha(which: str, got: dict) -> None:
    """The merged decision files' sha256 (the MR tables apart) equal to
    PARENT_SHA256[which]."""
    want = PARENT_SHA256[which]
    differ = sorted(f for f in want if got.get(f) != want[f])
    assert not differ, f"{which}: {differ} differ from the parent's"


def file_hashes(base: str, exts) -> dict:
    """sha256 of the decision files base + ext: two runs that decide alike
    print the same digests."""
    return {ext: hashlib.sha256(open(base + ext, "rb").read()).hexdigest() for ext in exts}


def hashes_beside_parent(which: str, got: dict) -> dict:
    """This run's digests, the parent's, and whether they are equal."""
    return {"sha256": got, "parent_sha256": PARENT_SHA256[which],
            "sha256_equal_to_parent": got == PARENT_SHA256[which]}


def block_files(outdir: str) -> dict:
    return {f: open(os.path.join(outdir, f), "rb").read() for f in sorted(os.listdir(outdir))}


def assert_same_outputs(tag: str, cuda: dict, cpu: dict) -> float:
    """Decision files byte-identical, .corr within 1e-6; returns the largest
    |difference| of the .corr files. The decision files are held first, so
    that a run that kept other variables says so and not that their
    correlations differ; a .corr beyond the tolerance says where and by how
    much."""
    assert cuda.keys() == cpu.keys() and cpu, (tag, sorted(cuda), sorted(cpu))
    differ = [f for f, data in cpu.items() if not f.endswith(".corr") and cuda[f] != data]
    assert not differ, f"{tag}: {differ} differ between cuda and cpu"
    worst = 0.0
    for f, data in cpu.items():
        if f.endswith(".corr"):
            a, b = np.frombuffer(cuda[f], np.float32), np.frombuffer(data, np.float32)
            assert a.shape == b.shape, f"{tag}: {f} holds {a.size} values on cuda, {b.size} on cpu"
            diff = np.abs(a - b)
            k = int(np.argmax(np.where(np.isnan(diff), np.inf, diff)))
            assert np.allclose(a, b, rtol=0, atol=1e-6), (
                f"{tag}: {f} entry {k} of {a.size}: cuda {float(a[k])!r}, cpu {float(b[k])!r}; "
                f"{int((~(diff <= 1e-6)).sum())} entries beyond 1e-6, "
                f"NaNs {int(np.isnan(a).sum())} / {int(np.isnan(b).sum())}")
            worst = max(worst, float(diff.max()))
    return worst


# the kernel wrappers the skeleton calls through `cupc`
WRAPPED = ("local_sweep", "hetcor_local_sweep", "gather_local_panels",
                  "gather_local_panels2", "compact_rows", "hetcor_scan")
# the dense level-1 entries, which the skeleton and the engines call through
# the wrapper's module, and their plain versions
DENSE = ("dense_l1", "hetcor_dense_l1")
DENSE_PLAIN = {"dense_l1": dk.dense_l1_plain, "hetcor_dense_l1": dk.hetcor_dense_l1_plain}


def dense_slab(name: str, args: tuple) -> tuple:
    """(nx, ny, x0, y0) of a dense launch's arguments."""
    if name == "dense_l1":
        return args[0].shape[0], args[4].shape[1], int(args[6]), int(args[7])
    return args[0].shape[0], args[5].shape[1], int(args[9]), int(args[10])


class EveryLaunchChecked:
    """While it is open, every levels 1-3 launch, every gather launch and
    every row compaction the skeleton makes on the card is held bitwise
    against its plain version on the same tensors (the small runs are cheap
    enough for that), so that a cuda run that decides otherwise than the cpu
    run is traced to the launch at fault, if one is. `names` narrows the check to those wrappers (the
    genome's gathers)."""

    def __init__(self, names: tuple = WRAPPED + DENSE):
        self.checked = 0
        self.names = names
        self.saved = {n: getattr(cupc, n) for n in WRAPPED}
        self.saved_dense = {n: getattr(dk, n) for n in DENSE}

    def __enter__(self):
        saved = self.saved

        def local_sweep(C, node_ixs, nbrs, deg, l, **kw):
            rho, pos = saved["local_sweep"](C, node_ixs, nbrs, deg, l, **kw)
            if C.is_cuda:
                rho_p, pos_p = pcorr.local_sweep_plain(C, node_ixs, nbrs, deg, l)
                compare(f"launch {self.checked}: local_sweep l={l} {tuple(nbrs.shape)}",
                        rho, pos, rho_p, pos_p, deg, math.nan)
                self.checked += 1
            return rho, pos

        def hetcor_local_sweep(C, N, t_ix, node_ixs, nbrs, deg, th, l, **kw):
            m = saved["hetcor_local_sweep"](C, N, t_ix, node_ixs, nbrs, deg, th, l, **kw)
            if C.is_cuda:
                compare_margin(f"launch {self.checked}: hetcor_sweep l={l} {tuple(nbrs.shape)}", m,
                               pcorr.hetcor_local_sweep_plain(C, N, t_ix, node_ixs, nbrs, deg, th, l))
                self.checked += 1
            return m

        def gather_local_panels(C, node_ixs, nbrs, deg, **kw):
            out = saved["gather_local_panels"](C, node_ixs, nbrs, deg, **kw)
            if C.is_cuda:
                compare_bits(f"launch {self.checked}: panel_gather {tuple(nbrs.shape)}", out,
                             pg.gather_local_panels_plain(C, node_ixs, nbrs, deg))
                self.checked += 1
            return out

        def gather_local_panels2(C, N, node_ixs, nbrs, deg, **kw):
            out = saved["gather_local_panels2"](C, N, node_ixs, nbrs, deg, **kw)
            if C.is_cuda:
                compare_bits(f"launch {self.checked}: panel_gather2 {tuple(nbrs.shape)}", out,
                             pg.gather_local_panels2_plain(C, N, node_ixs, nbrs, deg))
                self.checked += 1
            return out

        def compact_rows(G, rows, d, **kw):
            out = saved["compact_rows"](G, rows, d, **kw)
            if G.is_cuda:
                compare_bits(f"launch {self.checked}: compact_rows {(rows.numel(), d)}", out,
                             cr.compact_rows_plain(G, rows, d))
                self.checked += 1
            return out

        def hetcor_scan(*args):
            m = saved["hetcor_scan"](*args)
            if args[0].is_cuda:
                compare_margin(f"launch {self.checked}: hetcor_scan l={args[-1]} "
                               f"{tuple(args[1].shape)} x {tuple(args[7].shape[:2])}", m,
                               pcorr.level_scan_hetcor_pre(*args))
                self.checked += 1
            return m

        def dense(name):
            kern, plain = self.saved_dense[name], DENSE_PLAIN[name]

            def run(*args):
                out = kern(*args)
                if args[0].is_cuda:
                    tag = f"launch {self.checked}: {name} (nx, ny, x0, y0) {dense_slab(name, args)}"
                    if name == "dense_l1":
                        compare_bits(tag, out, plain(*args))
                    else:
                        compare_margin(tag, out, plain(*args))
                    self.checked += 1
                return out
            return run

        for n, fn in (("local_sweep", local_sweep), ("hetcor_local_sweep", hetcor_local_sweep),
                      ("gather_local_panels", gather_local_panels),
                      ("gather_local_panels2", gather_local_panels2),
                      ("compact_rows", compact_rows), ("hetcor_scan", hetcor_scan)):
            if n in self.names:
                setattr(cupc, n, fn)
        for n in DENSE:
            if n in self.names:
                setattr(dk, n, dense(n))
        return self

    def __exit__(self, *exc):
        for n, fn in self.saved.items():
            setattr(cupc, n, fn)
        for n, fn in self.saved_dense.items():
            setattr(dk, n, fn)


def phase_small_reference(tmp: str) -> None:
    """A 1,500-marker block through cusk on the card and on the CPU (plain
    versions throughout): identical decisions, .corr within 1e-6; every
    kernel launch of the card's run bit-identical to its plain version."""
    t0 = time.perf_counter()
    G, Y, _ = ar1_block(1500, 2000, 3, seed=1)
    small = os.path.join(tmp, "small")
    os.makedirs(small)
    stem, blocks = write_block(small, G, Y)
    outs, counts = {}, {}
    with EveryLaunchChecked() as chk:
        for dev in ("cuda", "cpu"):
            out = os.path.join(tmp, f"small_{dev}")
            os.makedirs(out)
            stats: dict = {}
            cusk(stem + ".phen", stem, blocks, ALPHA, MAX_LEVEL, MAX_LEVEL_TWO, DEPTH,
                 out, 0, verbose=False, device=dev, stats=stats)
            outs[dev] = block_files(out)
            counts[dev] = stage_counts(stats)
    assert chk.checked > 0, "the small block launched no kernel"
    worst = assert_same_outputs("small block", outs["cuda"], outs["cpu"])
    assert_same_counts("small block", counts)
    emit("small_reference", t0, files=sorted(outs["cpu"]), cuda_equals_cpu=True,
         corr_max_abs_diff=worst, launches_bit_identical=chk.checked, ci_tests=counts["cpu"])


def stage_counts(stats: dict) -> dict:
    """{stage: ci_tests} of a cusk or cuskss run's skeleton stages."""
    return {s: stats[s].get("ci_tests", 0) for s in ("stage1", "stage2") if s in stats}


def assert_same_counts(tag: str, counts: dict) -> None:
    """The card's skeletons count the CPU's tests, stage by stage."""
    if counts["cuda"] != counts["cpu"] or "stage1" not in counts["cpu"]:
        raise AssertionError(f"{tag}: ci_tests on cuda {counts['cuda']}, on cpu {counts['cpu']}")


def emit_rates(phase: str, t0: float, stages: dict) -> None:
    """Each skeleton stage's level2plus_tests_per_sec (ci_tests over the sum
    of its level_wall_s over levels >= 2, bench.py's formula) and both
    stages' together, then stage 1's attribution of skeleton_wall_s with the
    residual (skeleton_wall_s less the attributed parts), beside the card's
    name and power limit."""
    rates, tests_all, deep_all = {}, 0, 0.0
    for name, st in stages.items():
        lvl = st.get("level_wall_s", {})
        deep = sum(w for l, w in lvl.items() if l >= 2)
        tests = st.get("ci_tests", 0)
        assert tests > 0 or not any(l >= 2 for l in lvl), (phase, name, tests, sorted(lvl))
        assert st["skeleton_wall_s"] >= sum(lvl.values()), (phase, name)
        rates[name] = {"ci_tests": tests, "level2plus_wall_s": deep,
                       "level2plus_tests_per_sec": tests / deep if deep > 0 else None,
                       "skeleton_wall_s": st["skeleton_wall_s"],
                       "preamble_s": st.get("preamble_s")}
        tests_all += tests
        deep_all += deep
    s1 = stages["stage1"]
    attrib = {"l0_screen": s1["l0_wall_s"], "sepset_alloc": s1.get("sepset_alloc_s", 0.0),
              "levels": sum(s1["level_wall_s"].values()),
              "final_fetch": s1.get("final_fetch_s", 0.0)}
    attrib["residual"] = s1["skeleton_wall_s"] - sum(attrib.values())
    emit(phase, t0, stages=rates,
         level2plus_tests_per_sec=tests_all / deep_all if deep_all > 0 else None,
         stage1_attrib_s=attrib, nvidia_smi=nvidia_smi())


class Recorder:
    """Wraps the kernel wrappers the skeleton calls so that the largest
    launch of each kernel (by work) is kept for the kernel-vs-plain re-run.
    The wrappers themselves count the launches. The re-runs are timed as the
    skeleton launches them, with the lists' range already checked. A row
    compaction keeps a copy of the rows it reads (by bytes read): the
    skeleton clears hits in its adjacency right after it."""

    def __init__(self):
        self.largest: dict = {}
        self.saved = {n: getattr(cupc, n) for n in WRAPPED}
        self.saved_dense = {n: getattr(dk, n) for n in DENSE}

    def _keep(self, key, work, args):
        if work > self.largest.get(key, (0,))[0]:
            self.largest[key] = (work, args)

    def __enter__(self):
        saved = self.saved

        def local_sweep(C, node_ixs, nbrs, deg, l, **kw):
            self._keep(("local_sweep", l), nbrs.shape[0] * nbrs.shape[1] ** (l + 1),
                       (C, node_ixs, nbrs, deg, l))
            return saved["local_sweep"](C, node_ixs, nbrs, deg, l, **kw)

        def hetcor_local_sweep(C, N, t_ix, node_ixs, nbrs, deg, th, l, **kw):
            self._keep(("hetcor_sweep", l), nbrs.shape[0] * nbrs.shape[1] ** (l + 1),
                       (C, N, t_ix, node_ixs, nbrs, deg, th, l))
            return saved["hetcor_local_sweep"](C, N, t_ix, node_ixs, nbrs, deg, th, l, **kw)

        def gather_local_panels(C, node_ixs, nbrs, deg, **kw):
            self._keep(("panel_gather",), nbrs.shape[0] * nbrs.shape[1] ** 2,
                       (C, node_ixs, nbrs, deg))
            return saved["gather_local_panels"](C, node_ixs, nbrs, deg, **kw)

        def gather_local_panels2(C, N, node_ixs, nbrs, deg, **kw):
            self._keep(("panel_gather2",), nbrs.shape[0] * nbrs.shape[1] ** 2,
                       (C, N, node_ixs, nbrs, deg))
            return saved["gather_local_panels2"](C, N, node_ixs, nbrs, deg, **kw)

        def compact_rows(G, rows, d, **kw):
            work = rows.numel() * G.shape[1]
            if work > self.largest.get(("compact_rows",), (0,))[0]:
                self._keep(("compact_rows",), work,
                           (G[rows.long()].clone(), rows.clone(), d, G.shape[0]))
            return saved["compact_rows"](G, rows, d, **kw)

        def hetcor_scan(*args):
            self._keep(("hetcor_scan",), args[1].numel() * args[7].shape[0] * args[7].shape[1],
                       args)
            return saved["hetcor_scan"](*args)

        def dense(name):
            kern = self.saved_dense[name]

            def run(*args):
                nx, ny, _, _ = dense_slab(name, args)
                self._keep((name,), nx * ny, args)
                return kern(*args)
            return run

        for n, fn in (("local_sweep", local_sweep), ("hetcor_local_sweep", hetcor_local_sweep),
                      ("gather_local_panels", gather_local_panels),
                      ("gather_local_panels2", gather_local_panels2),
                      ("compact_rows", compact_rows), ("hetcor_scan", hetcor_scan)):
            setattr(cupc, n, fn)
        for n in DENSE:
            setattr(dk, n, dense(n))
        return self

    def __exit__(self, *exc):
        for n, fn in self.saved.items():
            setattr(cupc, n, fn)
        for n, fn in self.saved_dense.items():
            setattr(dk, n, fn)


def reset_all_launches() -> None:
    ls.reset_launches()
    hs.reset_launches()
    pg.reset_launches()
    dk.reset_launches()
    cr.reset_launches()
    kp.reset_launches()


def all_launches() -> dict:
    """The launch count of every kernel entry, sweeps by level."""
    return {**{f"local_sweep_l{l}": n for l, n in ls.launches.items()}, **pg.launches,
            **hetcor_launches(), **dk.launches, **cr.launches, **kp.launches}


def hetcor_launches() -> dict:
    """hetcor_sweep's launches by level and the scan's, flattened as the
    benchmark harness flattens them."""
    return {k if isinstance(k, str) else f"hetcor_sweep_l{k}": n for k, n in hs.launches.items()}


def kernel_entry(name: str, module, replaces: str, launches: int, err: float, ms: float,
                 plain_ms: float, bnd: dict, library_ms, shape: dict, **more) -> dict:
    return {
        **more,
        "name": name, "route": "cuda", "source": module.SOURCE, "replaces": REPLACES[replaces],
        "launches": launches, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bnd["bound_ms"], "bound_by": bnd["bound_by"], "library_ms": library_ms,
        "shape": {**shape, **{k: v for k, v in bnd.items()
                              if k in ("tests", "bytes", "operations", "distinct_entries",
                                       "distinct_sectors")}},
    }


def sweep_entries(tag: str, rec: Recorder, launches: dict, rho_th: dict, loops: dict,
                  clock_hz: float) -> list:
    """The largest local_sweep launch of a run at each level 1-3, kernel vs
    plain (bit-identical) on the same tensors, timed beside its bound, its
    sector bound (`sector_ms`), its issue bound and, at levels 2-3, the
    one-thread-per-slot route and the table route without its pair tests
    (`tables_only_ms`); level 3 on the table route also in launch order
    (`launch_order_ms`, without the wrapper's degree order). Each carries
    the shape of what it holds (`launch_shape`)."""
    kernels = []
    for l in (1, 2, 3):
        C, node_ixs, nbrs, deg, _ = rec.largest[("local_sweep", l)][1]
        d = int(nbrs.shape[1])
        rho_k, pos_k = ls.local_sweep(C, node_ixs, nbrs, deg, l)
        (rho_p, pos_p), plain_ms = once_ms(
            lambda: pcorr.local_sweep_plain(C, node_ixs, nbrs, deg, l))
        err = compare(f"{tag} level {l}", rho_k, pos_k, rho_p, pos_p, deg, rho_th[l])
        bnd = sweep_bound(node_ixs, nbrs, deg, C.shape[0], l, 1, SWEEP_OPS)
        pl = ls.plan(l, d)
        run = lambda: ls.local_sweep(  # noqa: E731
            C, node_ixs, nbrs, deg, l, index_range_checked=True)
        more = {"plan": pl, "sector_ms": bnd["sector_ms"],
                "launch_shape": launch_shape(deg, l, d),
                **issue_bound(bnd["tests"], loops[("local_sweep", l)], clock_hz)}
        if l > 1:  # the design the table route replaced, in the same call
            forced = rows_plan(ls, l, d, 1)
            more["rows_route_ms"] = cuda_ms(lambda: ls.local_sweep(
                C, node_ixs, nbrs, deg, l, index_range_checked=True, launch_plan=forced), reps=5)
        if pl["route"] == ls.ROUTE_TABLE:
            more["tables_only_ms"] = tables_only_ms(run)
            if ls.work_order(l, deg, d, pl) is not None:
                more["launch_order_ms"] = launch_order_ms(run)
        kernels.append(kernel_entry(
            f"local_sweep_l{l}", ls, "local_sweep", launches[f"local_sweep_l{l}"], err,
            cuda_ms(run, reps=5), plain_ms,
            bnd, None, {"nodes": int(nbrs.shape[0]), "width": d}, **more,
        ))
    return kernels


def tables_only_ms(run) -> float:
    """ms of a table-route launch (back to back over 5) by the build without
    its pair tests (TABLES_ONLY): the panel staging, the table builds and the
    barriers alone; their outputs are not read."""
    lib = ctypes.CDLL(str(build.build("local_sweep", TABLES_ONLY)))
    saved = build.load("local_sweep")
    build._loaded["local_sweep"] = lib
    try:
        return cuda_ms(run, reps=5)
    finally:
        build._loaded["local_sweep"] = saved


def launch_order_ms(run) -> float:
    """ms of a level-3 table-route launch (back to back over 5) with its CTAs
    in launch order, the wrapper's degree order left out."""
    saved = ls.work_order
    ls.work_order = lambda *args: None
    try:
        return cuda_ms(run, reps=5)
    finally:
        ls.work_order = saved


def launch_shape(deg: torch.Tensor, l: int, d: int) -> dict:
    """What one launch holds (for the device-resident loop's, every node of
    the block with a test at the level's width): its nodes' degrees by
    classes of 8, the nodes with no test (degree <= l), tests per
    node (quantiles, the largest, the share of the top 1% of nodes) and, at
    level 1, the live lanes (slots y < deg) over the lanes launched (the
    plan's threads for each node)."""
    g = np.clip(deg.cpu().numpy().astype(np.int64), 0, d)
    live = g > l
    tests = np.array([int(x) * math.comb(int(x) - 1, l) for x in g[live]], dtype=np.float64)
    top = np.sort(tests)[::-1][: max(1, len(tests) // 100)]
    classes = np.bincount(-(-g // 8), minlength=1)
    out = {"nodes": int(len(g)), "width": d, "no_test": int((~live).sum()),
           "degree_by_8": {f"{8 * k - 7}-{8 * k}" if k else "0": int(n)
                           for k, n in enumerate(classes) if n},
           "tests": int(tests.sum()),
           "tests_per_node_quantiles_0.1_0.5_0.9_0.99": (
               np.quantile(tests, [0.1, 0.5, 0.9, 0.99]).tolist() if len(tests) else []),
           "tests_per_node_max": float(tests.max()) if len(tests) else 0.0,
           "tests_top_1pct_share": float(top.sum() / tests.sum()) if len(tests) else 0.0}
    if l == 1:
        pl = ls.plan(1, d)
        lanes = pl["threads"] * pl["ctas_per_node"] / pl["nodes_per_cta"]
        out["live_lanes_over_launched"] = float(g.sum() / (len(g) * lanes))
    return out


def gather_entries(tag: str, rec: Recorder, launches: dict) -> list:
    """The largest gather launch of a run, kernel vs plain (bit-identical)
    and vs the advanced-indexing call that computes the same panels."""
    out = []
    for name, panels in (("panel_gather", 1), ("panel_gather2", 2)):
        if (name,) not in rec.largest:
            continue
        args = rec.largest[(name,)][1]
        kern = pg.gather_local_panels if panels == 1 else pg.gather_local_panels2
        plain = pg.gather_local_panels_plain if panels == 1 else pg.gather_local_panels2_plain
        err = compare_bits(f"{tag} largest {name}", kern(*args), plain(*args))
        node_ixs, nbrs, deg = args[-3:]
        nb = pg.remap_pad_slots(node_ixs, nbrs, deg).long()
        x = node_ixs.long()[:, None]

        def indexing():
            return [(P[nb[:, :, None], nb[:, None, :]], P[x, nb]) for P in args[:panels]]

        nt, d = nbrs.shape
        bnd = gather_bound(node_ixs, nbrs, deg, args[0].shape[0], panels)
        run = lambda: kern(*args, index_range_checked=True)  # noqa: E731
        out.append(kernel_entry(
            name, pg, name, launches[name], err, cuda_ms(run, reps=200),
            cuda_ms(lambda: plain(*args), reps=20), bnd,
            cuda_ms(indexing, reps=20), {"nodes": int(nt), "width": int(d)},
            plan=pg.plan(int(d), panels), sector_ms=bnd["sector_ms"],
            launch_floor_ms=launch_floor_ms(),
            **kernel_device_ms(run, 20, "panel_rows_kernel"),
        ))
    return out


class KendallRecorder:
    """Keeps the packed rows and the sample count of every launch of the
    Kendall panel kernel that the block panels make while it is open."""

    def __enter__(self):
        self.launches = []
        saved = self.saved = corr_ops.kendall_panel

        def kendall_panel(codes, num_samples, out):
            self.launches.append((codes, num_samples))
            return saved(codes, num_samples, out)

        corr_ops.kendall_panel = kendall_panel
        return self

    def __exit__(self, *exc):
        corr_ops.kendall_panel = self.saved


def kendall_entry(tag: str, codes: torch.Tensor, n: int, launches: int) -> dict:
    """A block panel's launch of the Kendall panel kernel again on the rows
    it read, kernel vs plain (bit-identical), timed beside its bound (the
    distinct pairs' int8 operations, `h100bench/roofline.py`) and the
    striped `torch._int_mm` route the panels ran before it."""
    from h100bench.roofline import int8_panel_seconds

    m = codes.shape[0]
    got = torch.empty((m, m), dtype=torch.float32, device=codes.device)
    kp.kendall_panel(codes, n, got)

    def plain():
        want = torch.empty_like(got)
        kp.kendall_panel_plain(codes, n, want)
        return want

    want, plain_ms = once_ms(plain)
    err = compare_bits(f"{tag} kendall_panel", (got,), (want,))
    del want
    lib, library_ms = once_ms(lambda: int_mm_route(codes, n))
    compare_bits(f"{tag} int_mm route", (got,), (lib,))
    del lib, got
    torch.cuda.empty_cache()
    bound_ms = 1e3 * int8_panel_seconds(m, n)
    out = torch.empty((m, m), dtype=torch.float32, device=codes.device)
    ms = cuda_ms(lambda: kp.kendall_panel(codes, n, out), reps=5)
    return kernel_entry(
        "kendall_panel", kp, "kendall_panel", launches, err, ms, plain_ms,
        {"bound_ms": bound_ms, "bound_by": "int8 operations"}, library_ms,
        {"markers": m, "samples": n}, roofline_pct=100.0 * bound_ms / ms)


def phase_slice(tmp: str, rho_th: dict, loops: dict, clock_hz: float):
    t0 = time.perf_counter()
    G, Y, planted = ar1_block(M11K, N11K, P11K, seed=0)
    b11k = os.path.join(tmp, "b11k")
    os.makedirs(b11k)
    stem, blocks = write_block(b11k, G, Y)
    del G
    emit("slice_data", t0, markers=M11K, individuals=N11K, traits=P11K)

    out = os.path.join(tmp, "out11k")
    os.makedirs(out)
    stats: dict = {}
    torch.cuda.reset_peak_memory_stats()
    with Recorder() as rec, CapturePanels() as capture, KendallRecorder() as panels:
        reset_all_launches()
        t1 = time.perf_counter()
        res = cusk(stem + ".phen", stem, blocks, ALPHA, MAX_LEVEL, MAX_LEVEL_TWO,
                   DEPTH, out, 0, verbose=False, device="cuda", stats=stats)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        launches = {**{f"local_sweep_l{l}": n for l, n in ls.launches.items()}, **pg.launches,
                    **dk.launches, **kp.launches, **cr.launches}
    # the block's panel: one launch of the Kendall panel kernel over its rows
    assert launches["kendall_int8_panel"] == 1 == len(panels.launches), launches
    assert (stats["panel_kernel_launches"], stats["panel_decode_bytes"]) == (1, 0), (
        stats["panel_kernel_launches"], stats["panel_decode_bytes"])

    s1, s2 = stats["stage1"], stats["stage2"]
    ran = set(s1.get("level_wall_s", {})) | set(s2.get("level_wall_s", {}))
    assert stats["final_level"] == 3, f"stage 1 stopped at level {stats['final_level']}"
    for l in (1, 2, 3):
        if l in ran:
            assert launches[f"local_sweep_l{l}"] > 0, f"level {l} ran without a kernel launch"
    assert max(ran) >= 4 and launches["panel_gather"] > 0, (
        f"levels {sorted(ran)} ran with {launches['panel_gather']} gather launches")
    # the device-resident loop compacts the lists of the nodes with a test
    # on the card, one launch a level of either stage
    loop = [l for st in (s1, s2) for l, r in st["level_route"].items() if r == "device_loop"]
    assert 0 < len(loop) == launches["compact_rows"], (loop, launches["compact_rows"])
    assert res is not None
    base = os.path.join(out, "1_0_10999")
    for ext in (".mdim", ".ixs", ".adj", ".corr", ".sep"):
        assert os.path.getsize(base + ext) > 0, base + ext
    back = ReducedGCS.from_file(base)
    k = back.num_var
    assert back.G.shape == (k, k) and back.S.shape == (k, k, 14)
    assert np.array_equal(back.G, back.G.T) and not back.G.diagonal().any()
    assert np.all(np.isfinite(back.C)) and np.all(np.abs(back.C) <= 1.0 + 1e-6)
    kept = set(back.new_to_old_indices[: back.num_markers()].tolist())
    recovered = float(np.mean([k in kept for k in planted]))
    assert recovered >= 0.5, f"only {recovered:.2f} of the planted markers retained"
    emit(
        "slice_cusk", t0, cusk_wall_s=wall, prepare_s=stats["prepare_s"],
        prescreen_s=stats["prescreen_s"], panel_s=stats["panel_s"],
        l0_s=s1["l0_wall_s"], sepset_alloc_s=s1["sepset_alloc_s"],
        level_wall_s=s1["level_wall_s"], level_route=s1["level_route"],
        level_detail=s1.get("level_detail", {}), final_fetch_s=s1.get("final_fetch_s"),
        reduce_s=stats["reduce_s"], stage2_s=stats["stage2_s"],
        stage2_level_wall_s=s2.get("level_wall_s", {}),
        launches=launches, buckets={l: len(v) for l, v in s1["launches"].items()},
        retained_markers=stats["retained_markers"], final_level=stats["final_level"],
        final_level_two=stats["final_level_two"], planted_recovered=recovered,
        peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30,
        **hashes_beside_parent("cusk", file_hashes(base, (".adj", ".ixs", ".mdim", ".sep"))),
    )
    emit_rates("slice_cusk_rates", time.perf_counter(), {"stage1": s1, "stage2": s2})

    # the largest launch of each kernel, kernel vs plain on the card
    t0 = time.perf_counter()
    kernels = sweep_entries("11k", rec, launches, rho_th, loops, clock_hz)
    kernels += gather_entries("11k", rec, launches)
    kendall = kendall_entry("11k", *panels.launches[0], launches["kendall_int8_panel"])
    del panels
    emit("largest_launch_cusk", t0, kernels=kernels + [kendall])

    def again(name: str = "out11k_profiled"):
        out2 = os.path.join(tmp, name)
        os.makedirs(out2, exist_ok=True)  # profile_sweeps may run it again
        cusk(stem + ".phen", stem, blocks, ALPHA, MAX_LEVEL, MAX_LEVEL_TWO, DEPTH,
             out2, 0, verbose=False, device="cuda")

    # every local_sweep launch of a run (stage 1's loop, stage 2's) timed
    # behind a spin kernel, summed by level
    t0 = time.perf_counter()
    with GatedTimer.sweeps() as timer:
        again("out11k_gated")
    totals = timer.totals()
    emit("loop_totals_11k", t0, totals=totals)
    for k in kernels:
        if k["name"] in totals:
            k["gated_total_ms"], k["gated_total_launches"] = (
                totals[k["name"]]["total_ms"], totals[k["name"]]["timed_launches"])

    return kernels, again, wall, capture, kendall


def write_sumstats(d: str) -> tuple[dict, list]:
    """The summary-statistic input as files: a binary lower triangle of the
    AR(1) marker correlations 0.92^|i-j|, an mxp table with 5 planted markers
    per trait at 0.03 (smeared over their LD neighbourhood) plus N(0, 1/5e5)
    noise, a pxp table at 0.1, SE tables that give every mxp and pxp entry an
    ESS uniform in [3e5, 5e5], and one block over all markers. Returns the
    `CuskssArgs.from_paths` keywords and the planted markers."""
    rng = np.random.default_rng(2)
    m, p = MSS, PSS
    r, c = np.tril_indices(m)
    (0.92 ** np.arange(m)).astype(np.float32)[r - c].tofile(os.path.join(d, "mxm.bin"))
    del r, c
    ii = np.arange(m)
    mxp = rng.normal(size=(m, p)) / np.sqrt(NSS)
    planted = []
    for t in range(p):
        for k in rng.integers(0, m, 5):
            mxp[:, t] += 0.03 * 0.92 ** np.abs(ii - k)
            planted.append(int(k))
    mxp_se = (1.0 - mxp**2) / np.sqrt(rng.uniform(3e5, 5e5, size=(m, p)))
    pxp = np.full((p, p), 0.1) + 0.9 * np.eye(p)
    pxp_se = (1.0 - pxp**2) / np.sqrt(rng.uniform(3e5, 5e5, size=(p, p)))
    pxp_se = np.triu(pxp_se) + np.triu(pxp_se, 1).T
    np.fill_diagonal(pxp_se, 1.0)  # rho = 1 has no SE; the diagonal's ESS is never read
    traits = [f"T{t}" for t in range(p)]
    for name, tab in (("mxp", mxp), ("mxp_se", mxp_se)):
        with open(os.path.join(d, name + ".txt"), "w") as f:
            f.write("chr snp ref " + " ".join(traits) + "\n")
            body = np.char.mod("%.9e", tab)
            f.writelines(f"1 rs{i} A " + " ".join(body[i]) + "\n" for i in range(m))
    for name, tab in (("pxp", pxp), ("pxp_se", pxp_se)):
        with open(os.path.join(d, name + ".txt"), "w") as f:
            f.write(" ".join(traits) + "\n")
            body = np.char.mod("%.9e", tab)
            f.writelines(f"{traits[i]} " + " ".join(body[i]) + "\n" for i in range(p))
    write_marker_blocks_to_file([MarkerBlock("1", 0, m - 1)], os.path.join(d, "ss.blocks"))
    kw = dict(
        mxm=os.path.join(d, "mxm.bin"), mxp=os.path.join(d, "mxp.txt"),
        mxp_se=os.path.join(d, "mxp_se.txt"), pxp=os.path.join(d, "pxp.txt"),
        pxp_se=os.path.join(d, "pxp_se.txt"), blockfile=os.path.join(d, "ss.blocks"),
        block_index=0, alpha=ALPHA, max_level_one=MAX_LEVEL, max_level_two=MAX_LEVEL_TWO,
        max_depth=DEPTH, num_samples=NSS,
    )
    return kw, planted


def phase_small_cuskss(tmp: str) -> None:
    """The fixture inputs through cuskss on the card and on the CPU, Pearson
    and hetcor (SE files), both stages: same files."""
    t0 = time.perf_counter()
    p = lambda name: os.path.join(FIXTURES, name)  # noqa: E731
    se = {}
    for key, src, lead in (("mxp_se", "marker_trait_summary_stats.txt", 3),
                           ("pxp_se", "trait_summary_stats.txt", 1)):
        lines = open(p(src)).read().splitlines()
        se[key] = os.path.join(tmp, key + "_small.txt")
        with open(se[key], "w") as f:
            f.write(lines[0] + "\n")
            for line in lines[1:]:
                fields = line.split()
                f.write(" ".join(fields[:lead] + ["0.00001"] * (len(fields) - lead)) + "\n")
    worst, checked, counted = {}, {}, {}
    for tag, extra in (("pearson", {}), ("hetcor", se)):
        outs, counts = {}, {}
        with EveryLaunchChecked() as chk:
            for dev in ("cuda", "cpu"):
                out = os.path.join(tmp, f"ss_small_{tag}_{dev}")
                os.makedirs(out)
                stats: dict = {}
                cuskss(CuskssArgs.from_paths(
                    mxm=p("small_mxm.bin"), mxp=p("marker_trait_summary_stats.txt"),
                    pxp=p("trait_summary_stats.txt"), marker_indices=p("marker_indices.bin"),
                    alpha=ALPHA, num_samples=500000, max_level_one=3, max_level_two=1,
                    max_depth=1, outdir=out, **extra), verbose=False, device=dev, stats=stats)
                outs[dev] = block_files(out)
                counts[dev] = stage_counts(stats)
        worst[tag] = assert_same_outputs(f"small cuskss {tag}", outs["cuda"], outs["cpu"])
        assert_same_counts(f"small cuskss {tag}", counts)
        checked[tag], counted[tag] = chk.checked, counts["cpu"]
    emit("small_cuskss", t0, files=sorted(outs["cpu"]), cuda_equals_cpu=True,
         corr_max_abs_diff=worst, launches_bit_identical=checked, ci_tests=counted)


def phase_cuskss(tmp: str, loops: dict, clock_hz: float, bucket: list, compact_sized: list):
    t0 = time.perf_counter()
    ss = os.path.join(tmp, "ss")
    out = os.path.join(tmp, "out_ss")
    os.makedirs(ss)
    os.makedirs(out)
    kw, planted = write_sumstats(ss)
    emit("cuskss_data", t0, markers=MSS, traits=PSS, num_samples=NSS,
         mxm_bytes=os.path.getsize(kw["mxm"]))

    stats: dict = {}
    torch.cuda.reset_peak_memory_stats()
    with Recorder() as rec:
        reset_all_launches()
        t1 = time.perf_counter()
        res = cuskss(CuskssArgs.from_paths(outdir=out, **kw), verbose=False, device="cuda",
                     stats=stats)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        launches = {**hetcor_launches(), **pg.launches, **dk.launches, **cr.launches}

    s1, s2 = stats["stage1"], stats["stage2"]
    # stage 1's levels 0-3 on the card, a row compaction at each local level
    assert s1["device_levels"] == [0, 1, 2, 3], s1["device_levels"]
    assert launches["compact_rows"] > 0, launches
    ran = set(s1.get("level_wall_s", {})) | set(s2.get("level_wall_s", {}))
    for l in (1, 2, 3):
        assert l in ran and launches[f"hetcor_sweep_l{l}"] > 0, (
            f"level {l}: ran {l in ran}, {launches[f'hetcor_sweep_l{l}']} kernel launches")
    assert max(ran) >= 4 and launches["panel_gather2"] > 0, (
        f"levels {sorted(ran)} ran with {launches['panel_gather2']} two-panel gather launches")
    assert launches["hetcor_scan"] > 0, launches
    base = os.path.join(out, f"1_0_{MSS - 1}")
    for ext in (".mdim", ".ixs", ".adj", ".corr"):
        assert os.path.getsize(base + ext) > 0, base + ext
    back = ReducedGC.from_file(base)
    k = back.num_var
    assert k == res.num_var and back.num_phen == PSS and back.G.shape == (k, k)
    assert np.array_equal(back.G, res.G) and np.array_equal(back.C, res.C)
    assert np.array_equal(back.G, back.G.T) and not back.G.diagonal().any()
    assert np.all(np.isfinite(back.C)) and np.all(np.abs(back.C) <= 1.0 + 1e-6)
    assert np.all(np.isfinite(res.S)) and res.S.shape == (k, k)
    kept = set(back.new_to_old_indices[: back.num_markers()].tolist())
    recovered = float(np.mean([k in kept for k in planted]))
    assert recovered >= 0.5, f"only {recovered:.2f} of the planted markers retained"
    emit(
        "slice_cuskss", t0, cuskss_wall_s=wall, load_s=stats["load_s"],
        assemble_s=stats["assemble_s"], l0_s=s1["l0_wall_s"],
        level_wall_s=s1["level_wall_s"], level_route=s1["level_route"],
        level_detail=s1.get("level_detail", {}), reduce_s=s1["reduce_s"], stage2_l0_s=s2["l0_wall_s"],
        stage2_level_wall_s=s2["level_wall_s"], stage2_reduce_s=s2["reduce_s"],
        launches=launches, buckets={l: len(v) for l, v in s1["launches"].items()},
        final_level=s1["final_level"], final_level_two=s2["final_level"],
        device_levels=s1["device_levels"], device_levels_two=s2["device_levels"],
        retained_markers=res.num_markers(), planted_recovered=recovered,
        peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30,
        **hashes_beside_parent("cuskss", file_hashes(base, (".adj", ".ixs", ".mdim"))),
    )
    emit_rates("slice_cuskss_rates", time.perf_counter(), {"stage1": s1, "stage2": s2})

    # the largest launch of each kernel, kernel vs plain on the card
    t0 = time.perf_counter()
    kernels = hetcor_entries("cuskss", rec, launches, (1, 2, 3), loops, clock_hz, bucket)
    kernels += gather_entries("10k input", rec, launches)
    kernels.append(compact_entry("10k input", rec, launches, compact_sized))
    kernels.append(scan_entry("10k input", rec, launches))
    emit("largest_launch_cuskss", t0, kernels=kernels)

    def again():
        out2 = os.path.join(tmp, "out_ss_profiled")
        os.makedirs(out2)
        cuskss(CuskssArgs.from_paths(outdir=out2, **kw), verbose=False, device="cuda")

    return kernels, again, wall, kw


def compact_launch(args: tuple) -> tuple:
    """(G, rows, d) of a compact_rows launch a Recorder kept: the rows the
    launch read (the skeleton clears hits in the adjacency right after it)
    laid back into an (n, n) matrix whose other rows the kernel does not
    read."""
    rows_G, rows, d, n = args
    G = torch.zeros((n, n), dtype=torch.bool, device=rows_G.device)
    G[rows.long()] = rows_G
    return G, rows, d


def compact_entry(tag: str, rec: Recorder, launches: dict, sized: list) -> dict:
    """The largest compact_rows launch of a run (by bytes read), kernel vs
    plain bit for bit, timed beside its byte bound (the rows read once, the
    lists and degrees written once) and by the profiler's device time
    alone; the full-sized launches of the kernel checks beside it."""
    G, rows, d = compact_launch(rec.largest[("compact_rows",)][1])
    n = int(G.shape[0])
    got = cr.compact_rows(G, rows, d)
    plain, plain_ms = once_ms(lambda: cr.compact_rows_plain(G, rows, d))
    err = compare_bits(f"{tag} compact_rows", got, plain)
    nr = int(rows.numel())
    run = lambda: cr.compact_rows(G, rows, d, index_range_checked=True)  # noqa: E731
    return kernel_entry(
        "compact_rows", cr, "compact_rows", launches["compact_rows"], err,
        cuda_ms(run, reps=20), plain_ms, bound(nr * n + 4 * nr * (d + 1), 0), None,
        {"rows": nr, "n": n, "width": d, "max_degree": int(got[1].max())},
        **kernel_device_ms(run, 20, r"compact_rows_kernel"), full_sized=sized,
    )


def hetcor_entries(tag: str, rec: Recorder, launches: dict, levels, loops: dict,
                   clock_hz: float, bucket: list) -> list:
    """The largest hetcor_local_sweep launch of a run at each of `levels`,
    kernel vs plain (margins bitwise equal) on the same tensors, timed
    beside its bound and issue bound; at levels 2-3 the bucket-sized launch
    of the kernel checks beside it."""
    kernels = []
    for l in levels:
        args = rec.largest[("hetcor_sweep", l)][1]
        C, node_ixs, nbrs, deg = args[0], args[3], args[4], args[5]
        plain, plain_ms = once_ms(lambda: pcorr.hetcor_local_sweep_plain(*args))
        count, err = compare_margin(f"{tag} level {l}", hs.hetcor_local_sweep(*args), plain)
        bnd = sweep_bound(node_ixs, nbrs, deg, C.shape[0], l, 2, HETCOR_OPS)
        loop = loops[("hetcor_sweep", l)]
        more = {"plan": hs.plan(l, nbrs.shape[1]), **issue_bound(bnd["tests"], loop, clock_hz)}
        if l > 1:
            # this input's launches at levels 2-3 are a few nodes wide: the
            # bucket-sized launch of the kernel checks stands beside them
            more["bucket_sized"] = [
                {**b, **issue_bound(b["tests"], loop, clock_hz)} for b in bucket
                if b["level"] == l][0]
        kernels.append(kernel_entry(
            f"hetcor_sweep_l{l}", hs, "hetcor_sweep", launches[f"hetcor_sweep_l{l}"], err,
            cuda_ms(lambda: hs.hetcor_local_sweep(*args, index_range_checked=True), reps=5),
            plain_ms,
            bnd, None, {"nodes": int(nbrs.shape[0]), "width": int(nbrs.shape[1]),
                        "margins_bit_identical": count}, **more,
        ))
    return kernels


def pack_bed_rows(G: np.ndarray) -> np.ndarray:
    """(rows, n) uint8 genotypes in {0, 1, 2} -> packed .bed bytes, the
    layout of `encode_bed_values` without its float and int64 passes."""
    codes = np.array([3, 2, 0], np.uint8)[G]
    pad = (-codes.shape[1]) % 4
    if pad:
        codes = np.concatenate([codes, np.zeros((len(codes), pad), np.uint8)], axis=1)
    c = codes.reshape(len(codes), -1, 4)
    return c[:, :, 0] | (c[:, :, 1] << 2) | (c[:, :, 2] << 4) | (c[:, :, 3] << 6)


def write_ar1_fileset(d: str, chr_sizes: list, n: int, p: int, seed: int, chunk: int = 2000,
                      locus: int | None = None, trait_dag: dict | None = None):
    """The generator of `ar1_block` (AR(1) LD 0.92, genotypes from a logistic
    allele frequency, 5 planted markers per trait at effect 0.2) in row
    chunks that carry the AR(1) state and write the `.bed` as they go, so
    that no (m, n) array is ever held; markers spread over the chromosomes
    of chr_sizes. The planted markers are uniform over all markers
    (`sim.phen`). With a locus, a second phenotype file over the same
    genotypes and the same trait noise (`sim_locus.phen`) plants each trait's
    five markers within one window of that many markers whose start is
    uniform, so that they mostly share a block, as all planted markers of
    the 11k block do: a trait with five marker neighbours is what takes
    stage 2 to level 4, and so to the gather. That file is a coverage input,
    shaped for the kernel; the uniform one is what the generator gives.
    trait_dag ({child: [(parent, beta)]}, parents before children) adds
    trait -> trait effects on the standardised parents (`add_trait_dag`).
    Returns (stem, {"uniform" | "locus": (phen path, planted [(trait,
    marker)], Y)}, the planted markers' genotype rows)."""
    m = sum(chr_sizes)
    rng = np.random.default_rng(seed)
    noise_y = rng.normal(size=(p, n)).astype(np.float32)
    if locus is None:
        planted = {"uniform": [(t, int(k)) for t in range(p) for k in rng.integers(0, m, 5)]}
    else:  # the uniform set from a generator of its own: the genotypes do not depend on it
        planted = {"locus": [(t, int(k)) for t in range(p) for k in
                             rng.integers(0, m - locus) + rng.choice(locus, 5, replace=False)]}
        rng_u = np.random.default_rng([seed, 1])
        planted["uniform"] = [(t, int(k)) for t in range(p) for k in rng_u.integers(0, m, 5)]
    wanted = {k for pairs in planted.values() for _, k in pairs}
    rows_of = {}
    ar, scale = np.float32(0.92), np.float32(np.sqrt(1 - 0.92**2))
    stem = os.path.join(d, "sim")
    acc = None
    with open(stem + ".bed", "wb") as f:
        f.write(BED_PREFIX_COL_MAJ)
        for r0 in range(0, m, chunk):
            noise = rng.standard_normal((min(chunk, m - r0), n), dtype=np.float32)
            for i in range(len(noise)):
                acc = noise[i] if acc is None else ar * acc + scale * noise[i]
                noise[i] = acc
            pfreq = 1 / (1 + np.exp(-noise * np.float32(0.8)))
            G = (rng.random(noise.shape, dtype=np.float32) < pfreq).astype(np.uint8)
            G += rng.random(noise.shape, dtype=np.float32) < pfreq
            for k in wanted:
                if r0 <= k < r0 + len(G):
                    rows_of[k] = G[k - r0].astype(np.float32)
            f.write(pack_bed_rows(G).tobytes())
    write_bim_fam(stem, chr_sizes, n)
    sets = {}
    for name, pairs in planted.items():
        Y = noise_y.copy()
        for t, k in pairs:
            Y[t] += 0.2 * (rows_of[k] - rows_of[k].mean()) / rows_of[k].std()
        Y = add_trait_dag(Y, trait_dag or {})
        Y = (Y - Y.mean(1, keepdims=True)) / Y.std(1, keepdims=True)
        phen = stem + (".phen" if name == "uniform" else f"_{name}.phen")
        write_phen(phen, Y)
        sets[name] = (phen, pairs, Y)
    return stem, sets, rows_of


def write_bim_fam(stem: str, chr_sizes: list, n: int) -> None:
    """`.bim` of the markers over chromosomes "1", "2", ... (chr_sizes) and
    `.fam` of n individuals."""
    chrom = np.repeat(np.arange(1, len(chr_sizes) + 1), chr_sizes)
    with open(stem + ".bim", "w") as f:
        f.writelines(f"{chrom[i]}\trs{i}\t0\t{100 * i}\tA\tG\n" for i in range(len(chrom)))
    with open(stem + ".fam", "w") as f:
        f.writelines(f"F{i} I{i} 0 0 0 -9\n" for i in range(n))


def add_trait_dag(Y, trait_dag: dict):
    """Y[t] += beta * standardised Y[s] for every edge s -> t of the trait
    DAG {t: [(s, beta)]}, children after their parents."""
    for t in sorted(trait_dag):
        for s, beta in trait_dag[t]:
            Y[t] = Y[t] + beta * (Y[s] - Y[s].mean()) / Y[s].std()
    return Y


def write_phen(path: str, Y: np.ndarray) -> None:
    """A `.phen` of traits Y (p, n): header, two ID columns, %.6f values."""
    p, n = Y.shape
    with open(path, "w") as f:
        f.write("FID\tIID\t" + "\t".join(f"T{t}" for t in range(p)) + "\n")
        body = np.char.mod("%.6f", Y.T)
        f.writelines(f"F{i}\tI{i}\t" + "\t".join(body[i]) + "\n" for i in range(n))


COMMANDS = ("prep-bed", "block", "cusk-all", "merge-block-outputs", "sepselect")
# the host chain after sepselect: orient-v-structs rewrites max_sep_min_pc
# with the v-structures (sepselect alone leaves its PAG empty), srfci orients
# the trait PAG, mvivw writes the MR tables (plain, then -s)
CHAIN = COMMANDS + ("orient-v-structs", "srfci", "mvivw", "mvivw -s")
PLAIN_MVIVW = "merged_blocks_mvivw_results_plain.tsv"


def run_commands(stem: str, out: str, max_block: int, corr_width: int, alpha: float, n: int,
                 device: str, phen: str | None = None,
                 only: tuple = COMMANDS) -> tuple[dict, str, str]:
    """The commands of CHAIN that `only` names, in CHAIN's order, through
    the CLI with its defaults for the levels and `stem.phen` unless another
    phenotype file is given; the plain mvivw table, which `mvivw -s`
    overwrites, is kept as PLAIN_MVIVW in out. Returns each command's wall
    (ending in a device synchronisation), the `.blocks` path and what
    cusk-all printed."""
    blocks = f"{stem}_m{max_block}.blocks"
    dev = ["--device", device]
    merged, pag = os.path.join(out, "merged_blocks"), os.path.join(out, "max_sep_min_pc")
    argv_of = {
        "prep-bed": ["prep-bed", stem],
        "block": ["block", stem, str(max_block), "10", str(corr_width), *dev],
        "cusk-all": ["cusk-all", blocks, stem, phen or stem + ".phen", str(alpha),
                     str(MAX_LEVEL), str(MAX_LEVEL_TWO), str(DEPTH), out, *dev],
        "merge-block-outputs": ["merge-block-outputs", out, blocks],
        "sepselect": ["sepselect", merged, str(alpha), str(n)],
        "orient-v-structs": ["orient-v-structs", merged, str(alpha), str(n)],
        "srfci": ["srfci", pag, str(alpha), str(n)],
        "mvivw": ["mvivw", merged, str(n)],
        "mvivw -s": ["mvivw", merged, str(n), "-s"],
    }
    walls, printed = {}, io.StringIO()
    for name in CHAIN:
        if name not in only:
            continue
        t = time.perf_counter()
        with contextlib.redirect_stdout(printed if name == "cusk-all" else sys.stdout):
            cli_main(argv_of[name])
        if device == "cuda":
            torch.cuda.synchronize()
        walls[name] = time.perf_counter() - t
        if name == "mvivw":
            shutil.copy(merged + "_mvivw_results.tsv", os.path.join(out, PLAIN_MVIVW))
    return walls, blocks, printed.getvalue()


def read_tsv(data: bytes) -> tuple[list, list]:
    """(header, rows as lists of strings) of a tab-separated table."""
    lines = data.decode().splitlines()
    return lines[0].split("\t"), [line.split("\t") for line in lines[1:]]


def assert_same_mvivw(tag: str, a: bytes, b: bytes, tol: float = 1e-5) -> float:
    """Two `_mvivw_results.tsv`: the same header and rows, equal integer and
    TRUE/FALSE columns, effect and p within tol; returns the largest
    |difference|."""
    (ha, ra), (hb, rb) = read_tsv(a), read_tsv(b)
    assert ha == hb == ["source", "sink", "effect", "p", "sk_adj", "num_snps"], (tag, ha, hb)
    assert len(ra) == len(rb) and ra, f"{tag}: {len(ra)} rows against {len(rb)}"
    worst = 0.0
    for x, y in zip(ra, rb):
        assert [x[i] for i in (0, 1, 4, 5)] == [y[i] for i in (0, 1, 4, 5)], (tag, x, y)
        for i in (2, 3):
            u, v = float(x[i] or "nan"), float(y[i] or "nan")
            same_nan = math.isnan(u) and math.isnan(v)
            assert same_nan or abs(u - v) <= tol, f"{tag}: {x} against {y}"
            worst = max(worst, 0.0 if same_nan else abs(u - v))
    return worst


def assert_same_text_matrix(tag: str, a: bytes, b: bytes) -> float:
    """Two MatrixMarket files of correlations: the same header, the same
    (row, col) in the same order, values within 1e-6; returns the largest
    |difference|."""
    la, lb = a.decode().splitlines(), b.decode().splitlines()
    assert la[:2] == lb[:2] and len(la) == len(lb), f"{tag}: headers or lengths differ"
    worst = 0.0
    for x, y in zip(la[2:], lb[2:]):
        (i, j, u), (k, l, v) = x.split(), y.split()
        assert (i, j) == (k, l), f"{tag}: entry {x!r} against {y!r}"
        diff = abs(float(u) - float(v))
        assert diff <= 1e-6, f"{tag}: entry ({i}, {j}): {u} against {v}"
        worst = max(worst, diff)
    return worst


SMALL_TRAIT_DAG = {1: [(0, 0.5)]}  # T0 -> T1, as the verify drive plants it


def phase_small_commands(tmp: str) -> None:
    """The whole chain (CHAIN: prep-bed to mvivw -s) over 600 markers on 3
    chromosomes x 2,000 individuals x 3 traits with one planted trait edge
    T0 -> T1 (blocks of at most 64 markers, band width 16: the two-step
    route of `block`) with --device cuda and with --device cpu, each on its
    own copy of the fileset: the same `.blocks` bytes, block decision files,
    merged and sepselect files, PAG and IV candidates, every correlation
    within 1e-6 and both mvivw tables' effects and p within 1e-5 (the merged
    correlations may already differ by 1e-6); every kernel launch of the
    card's run bit-identical to its plain version."""
    t0 = time.perf_counter()
    src = os.path.join(tmp, "cmd_small")
    os.makedirs(src)
    write_ar1_fileset(src, [250, 200, 150], 2000, 3, seed=13, chunk=256,
                      trait_dag=SMALL_TRAIT_DAG)
    files, walls, blocks_bytes = {}, {}, {}
    with EveryLaunchChecked() as chk:
        for dev in ("cuda", "cpu"):
            d = os.path.join(tmp, f"cmd_small_{dev}")
            shutil.copytree(src, d)
            out = os.path.join(d, "out")
            os.makedirs(out)
            walls[dev], blocks, _ = run_commands(os.path.join(d, "sim"), out, 64, 16, ALPHA,
                                                  2000, dev, only=CHAIN)
            blocks_bytes[dev] = open(blocks, "rb").read()
            files[dev] = block_files(out)
    assert chk.checked > 0, "the small fileset launched no kernel"
    assert blocks_bytes["cuda"] == blocks_bytes["cpu"], ".blocks differ between cuda and cpu"
    n_blocks = blocks_bytes["cpu"].count(b"\n")
    assert n_blocks >= 9 and len({line.split()[0] for line in
                                  blocks_bytes["cpu"].decode().splitlines()}) == 3
    text = [f for f in files["cpu"] if f.endswith("_scm.mtx")]
    assert sorted(text) == ["max_sep_min_pc_scm.mtx", "merged_blocks_scm.mtx"], sorted(files["cpu"])
    tables = ["merged_blocks_mvivw_results.tsv", PLAIN_MVIVW]
    for f in ("max_sep_min_pc_estimated_pag.mtx", "merged_blocks_iv_candidates.csv", *tables):
        assert f in files["cpu"], (f, sorted(files["cpu"]))
    worst = assert_same_outputs(
        "small commands", {f: b for f, b in files["cuda"].items() if f not in text + tables},
        {f: b for f, b in files["cpu"].items() if f not in text + tables})
    for f in text:
        worst = max(worst, assert_same_text_matrix(f, files["cuda"][f], files["cpu"][f]))
    mr_worst = max(assert_same_mvivw(f, files["cuda"][f], files["cpu"][f]) for f in tables)
    _, rows = read_tsv(files["cpu"][PLAIN_MVIVW])
    planted = [r for r in rows if r[:2] == ["1", "2"]][0]
    pag = mmread(io.BytesIO(files["cpu"]["max_sep_min_pc_estimated_pag.mtx"])).toarray()
    emit("small_commands", t0, blocks=n_blocks, files=len(files["cpu"]), cuda_equals_cpu=True,
         corr_max_abs_diff=worst, mvivw_max_abs_diff=mr_worst,
         launches_bit_identical=chk.checked, wall_s_by_command=walls,
         planted_edge_mvivw={"effect": float(planted[2]), "p": float(planted[3])},
         trait_pag=pag[:3, :3].astype(int).tolist())


def profile_block(stem: str, blocks: str, out_path: str, unprofiled_wall_s: float) -> dict:
    """A second run of `block`'s work (`make_blocks` into another file, which
    must come out the same) under torch.profiler: device time of the int8
    products beside their bound, and the idle share against the unprofiled
    wall of the command."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        make_blocks(stem, MAX_BLOCK, CORR_WIDTH, out_path=out_path, verbose=False, device="cuda")
        torch.cuda.synchronize()
    assert open(out_path, "rb").read() == open(blocks, "rb").read(), "a second block run differs"
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    rows = sorted(((e.key, e.self_device_time_total, e.count) for e in events),
                  key=lambda r: -r[1])
    busy_s = sum(us for _, us, _ in rows) / 1e6
    gemm = [r for r in rows if re.search(r"(?i)gemm|cutlass|xmma|cublas|imma|i8", r[0])]
    tiles = -(-MCHR // ROW_TILE)
    ops = tiles * 9 * ROW_TILE * (ROW_TILE + CORR_WIDTH) * N11K * 2
    # what the band alone needs: every marker against the `width` after it;
    # the rest of each tile's rectangle, and the last tile's pad rows, are
    # computed and thrown away
    band_ops = MCHR * CORR_WIDTH * 9 * N11K * 2
    return {
        "int8_products": {"kernels": [{"name": k[:80], "ms": us / 1e3, "launches": c}
                                      for k, us, c in gemm],
                          "device_ms": sum(us for _, us, _ in gemm) / 1e3,
                          "bound_ms": ops / PEAK_INT8 * 1e3, "operations": ops, "tiles": tiles,
                          "band_operations": band_ops,
                          "band_bound_ms": band_ops / PEAK_INT8 * 1e3,
                          "bound_source": "NVIDIA H100 SXM data sheet, 1,979 TOP/s dense int8"},
        "device_busy_s": busy_s, "device_idle_share": 1.0 - busy_s / unprofiled_wall_s,
        "top": [{"name": k[:80], "ms": us / 1e3, "launches": c} for k, us, c in rows[:8]],
    }


_BLOCK_LINE = re.compile(
    r"\[run_all_blocks\] \[(\S+)\] retained (\d+|no) markers, prepare ([\d.]+) s, "
    r"finish ([\d.]+) s, device memory ([\d.]+) GiB now, ([\d.]+) GiB at most")


def block_lines(printed: str) -> list:
    """The per-block lines `cusk-all` printed: retained markers (None for a
    block its pre-screen skipped), prepare and finish walls, device memory
    after the block and at most."""
    return [
        {"block": g[0], "retained_markers": None if g[1] == "no" else int(g[1]),
         "prepare_s": float(g[2]), "finish_s": float(g[3]), "device_memory_gib": float(g[4]),
         "max_device_memory_gib": float(g[5])} for g in _BLOCK_LINE.findall(printed)]


def chromosome_run(tag: str, stem: str, out: str, phen_set: tuple, rows_of: dict, only: tuple,
                   held: bool) -> tuple[dict, str, dict]:
    """The commands `only` names over the 50,000-marker chromosome with one
    phenotype file, the launch counts set to 0 just before and read just
    after; checks the blocks, the per-block lines, the device memory (unless
    the launches' tensors are held for the comparison afterwards) and the
    merged skeleton, and prints the phase's line. Returns the launches of
    every kernel, the `.blocks` path and the commands' walls."""
    t0 = time.perf_counter()
    phen, planted, Y = phen_set
    os.makedirs(out)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_all_launches()
    walls, blocks, printed = run_commands(stem, out, MAX_BLOCK, CORR_WIDTH, ALPHA, N11K, "cuda",
                                           phen=phen, only=only)
    launches = all_launches()
    sys.stdout.write(printed)
    per_block = block_lines(printed)

    sizes = [b.block_size() for b in read_blocks_from_file(blocks)]
    assert sum(sizes) == MCHR and max(sizes) <= MAX_BLOCK and len(sizes) >= 5, sizes
    assert len(per_block) == len(sizes), (len(per_block), printed[-2000:])
    # a block without a significant marker-trait correlation is skipped by design
    assert sum(b["retained_markers"] is not None for b in per_block) >= 5, per_block
    for name in ("local_sweep_l1", "local_sweep_l2", "local_sweep_l3"):
        assert launches[name] > 0, f"{name} was never launched over the chromosome: {launches}"
    if not held:  # the allocation must not grow from block to block
        grown = per_block[-1]["device_memory_gib"] - per_block[0]["device_memory_gib"]
        assert grown < 0.25, f"device memory grew by {grown} GiB over the blocks: {per_block}"

    gm = merge_block_outputs(blocks, out)
    sparse_of = {row: ix for ix, row in gm.gmi.items()}
    adjacent = sum(
        k in sparse_of and ((sparse_of[k], t + 1) in gm.sam or (t + 1, sparse_of[k]) in gm.sam)
        for t, k in planted)
    # what a plain threshold screen of the planted pairs' correlations gives
    th0 = threshold_array(N11K, ALPHA)[0]
    screen = sum(fisher_z(np.corrcoef(rows_of[k], Y[t])[0, 1]) >= th0 for t, k in planted)
    assert adjacent > 0, "no planted marker is adjacent to its trait"
    assert gm.num_phen == P11K and gm.num_var == P11K + sum(
        b["retained_markers"] or 0 for b in per_block)
    merged = {f: hashlib.sha256(data).hexdigest() for f, data in block_files(out).items()
              if f.startswith(("merged_blocks", "max_sep_min_pc"))}
    assert len(merged) >= 8, sorted(merged)
    sha = {"blocks": hashlib.sha256(open(blocks, "rb").read()).hexdigest(), **merged}
    held_sha(f"chr50k_{tag}", sha)
    emit("chr50k_commands_" + tag, t0, phen=os.path.basename(phen), wall_s_by_command=walls,
         blocks=len(sizes), block_sizes=sizes,
         largest_block_within_tol=MAX_BLOCK - max(sizes) <= 100, per_block=per_block,
         launches=launches, merged_variables=gm.num_var, merged_edges=len(gm.sam),
         planted_adjacent=int(adjacent), planted=len(planted), planted_pass_plain_screen=int(screen),
         peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30, sha256=sha,
         sha256_equal_to_parent=True)
    return launches, blocks, walls


def phase_chromosome(tmp: str, rho_th: dict, loops: dict, clock_hz: float) -> dict:
    """One chromosome of 50,000 markers x 16,384 individuals x 8 traits
    through the shell entry points on the card, with the CLI's defaults.
    First the five commands with the generator's own phenotypes (planted
    markers uniform over the chromosome): the walls, the blocks and the
    launches as they come. Then `cusk-all`, `merge-block-outputs` and
    `sepselect` again over the same blocks with the phenotypes whose planted
    markers share a locus, the input that takes stage 2 to level 4 and so to
    the gather: its launches are counted apart, `local_sweep` and
    `panel_gather` must both be launched, and the largest launch of each is
    held bitwise to its plain version on the same tensors and timed beside
    its bound. Returns, per kernel name, what the `kernels` line carries
    under the chromosome's keys."""
    t0 = time.perf_counter()
    d = os.path.join(tmp, "chr50k")
    os.makedirs(d)
    stem, sets, rows_of = write_ar1_fileset(d, [MCHR], N11K, P11K, seed=4, locus=LOCUS)
    emit("chr50k_data", t0, markers=MCHR, individuals=N11K, traits=P11K,
         bed_bytes=os.path.getsize(stem + ".bed"), locus=LOCUS)

    uniform, blocks, walls = chromosome_run("uniform", stem, os.path.join(d, "out"),
                                            sets["uniform"], rows_of, COMMANDS, held=False)
    with Recorder() as rec:
        locus, _, _ = chromosome_run("locus", stem, os.path.join(d, "out_locus"), sets["locus"],
                                     rows_of, COMMANDS[2:], held=True)
    assert locus["panel_gather"] > 0, f"the gather was never launched over the chromosome: {locus}"

    # the largest launch of each kernel on this path, kernel vs plain on the card
    t0 = time.perf_counter()
    entries = (sweep_entries("chr50k", rec, locus, rho_th, loops, clock_hz)
               + gather_entries("chr50k", rec, locus))
    del rec
    torch.cuda.empty_cache()
    emit("largest_launch_chr50k", t0, kernels=entries)

    t0 = time.perf_counter()
    emit("profile_block", t0, unprofiled_wall_s=walls["block"],
         **profile_block(stem, blocks, os.path.join(d, "again.blocks"), walls["block"]))
    drop = ("name", "route", "source", "replaces", "launches")
    return {k["name"]: {"launches_chr50k": k["launches"],
                        "launches_chr50k_uniform": uniform[k["name"]],
                        "chr50k": {key: v for key, v in k.items() if key not in drop}}
            for k in entries}


# the genome: four chromosomes of the 50k chromosome's size, and a planted
# trait DAG: a collider T0 -> T2 <- T1, then T2 -> T3, and T4 -> T5 (T6 and
# T7 have no trait parent), each at 0.3 on the standardised parent
GENOME_CHRS = [MCHR] * 4
GENOME_DAG = {2: [(0, 0.3), (1, 0.3)], 3: [(2, 0.3)], 5: [(4, 0.3)]}
GENOME_EDGES = [(s, t) for t in sorted(GENOME_DAG) for s, _ in GENOME_DAG[t]]
# seed 5 plants a marker at row 203, in the genome's first block: merge takes
# the trait-trait edges from the first block alone (the reference's
# behaviour, `merge/merge_blocks.py`), and the pre-screen skips a block that
# holds no marker associated with a trait
GENOME_SEED = 5
GENOME_MIN_BLOCKS = 20


def pack_bed_rows_device(G: torch.Tensor) -> torch.Tensor:
    """`pack_bed_rows` on the tensor's device: (rows, n) uint8 genotypes in
    {0, 1, 2} -> packed `.bed` bytes (codes 3, 2, 0, four to a byte)."""
    codes = 3 - G - (G == 2).to(torch.uint8)
    pad = (-codes.shape[1]) % 4
    if pad:
        codes = torch.cat([codes, codes.new_zeros(len(codes), pad)], dim=1)
    c = codes.view(len(codes), -1, 4)
    return c[:, :, 0] | (c[:, :, 1] << 2) | (c[:, :, 2] << 4) | (c[:, :, 3] << 6)


def write_genome_fileset(d: str):
    """The generator of `write_ar1_fileset` (AR(1) LD 0.92, genotypes from a
    logistic allele frequency, 5 planted markers per trait at effect 0.2,
    uniform over all markers) over GENOME_CHRS x N11K individuals x P11K
    traits with GENOME_DAG, made on the card from a `torch.Generator` seeded
    with GENOME_SEED and packed there, so that only the packed rows cross to
    the host. Each chromosome starts its AR(1) chain from a stationary
    state; within a chunk of rows the chain is one product with the
    lower-triangular matrix of the AR weights. The planted markers come from
    numpy's generator of the same seed. Returns (stem, planted [(trait,
    marker)], Y (p, n) as written, the planted markers' genotype rows on the
    card)."""
    dev, n, p, chunk = torch.device("cuda"), N11K, P11K, 1024
    gen = torch.Generator(device=dev)
    gen.manual_seed(GENOME_SEED)
    rng = np.random.default_rng(GENOME_SEED)
    planted = [(t, int(k)) for t in range(p) for k in rng.integers(0, sum(GENOME_CHRS), 5)]
    wanted = sorted({k for _, k in planted})
    ar = 0.92
    i = torch.arange(chunk, dtype=torch.float64, device=dev)
    W = (math.sqrt(1 - ar**2) * ar ** (i[:, None] - i[None, :]).clamp(min=0)).tril().float()
    carry = (ar ** (i + 1)).float()
    rows_of = {}
    stem = os.path.join(d, "sim")
    with open(stem + ".bed", "wb") as f:
        f.write(BED_PREFIX_COL_MAJ)
        r0 = 0
        for size in GENOME_CHRS:
            acc = torch.randn(n, generator=gen, device=dev)
            for c0 in range(0, size, chunk):
                k = min(chunk, size - c0)
                z = torch.randn((k, n), generator=gen, device=dev)
                X = torch.addmm(carry[:k, None] * acc[None, :], W[:k, :k], z)
                acc = X[-1]
                pfreq = torch.sigmoid(0.8 * X)
                G = (torch.rand((k, n), generator=gen, device=dev) < pfreq).to(torch.uint8)
                G += (torch.rand((k, n), generator=gen, device=dev) < pfreq).to(torch.uint8)
                for j in wanted:
                    if r0 <= j < r0 + k:
                        rows_of[j] = G[j - r0].float()
                f.write(pack_bed_rows_device(G).cpu().numpy().tobytes())
                r0 += k
    write_bim_fam(stem, GENOME_CHRS, n)
    Y = torch.randn((p, n), generator=gen, device=dev)
    for t, j in planted:
        g = rows_of[j]
        Y[t] += 0.2 * (g - g.mean()) / g.std(unbiased=False)
    Y = add_trait_dag(Y.cpu().numpy(), GENOME_DAG)
    Y = (Y - Y.mean(1, keepdims=True)) / Y.std(1, keepdims=True)
    write_phen(stem + ".phen", Y)
    return stem, planted, Y, rows_of


def mvivw_rows(path: str) -> dict:
    """{(source, sink) 0-based: (effect, p)} of an `_mvivw_results.tsv`."""
    _, rows = read_tsv(open(path, "rb").read())
    return {(int(r[0]) - 1, int(r[1]) - 1): (float(r[2] or "nan"), float(r[3] or "nan"))
            for r in rows}


def phase_genome(tmp: str, rho_th: dict, loops: dict, clock_hz: float) -> dict:
    """A genome of four 50,000-marker chromosomes x 16,384 individuals x 8
    traits with the planted trait DAG, made on the card, through the whole
    chain of commands (CHAIN) with the CLI's defaults, then through the
    Python API: `estimate_ace` for every planted trait edge, `check_ivs`
    and `run_mvivw_filtered` on its instruments. The launch counts are set
    to 0 just before the commands and read just after. Checks (loose on
    purpose): at least GENOME_MIN_BLOCKS blocks, every one with a line of
    its own from cusk-all and the first one skeletonised, device memory flat
    over the blocks, every sweep level launched, every planted trait edge in
    the merged skeleton and a positive plain-mvivw effect at p < 1e-3 on
    each. Prints the walls of the data, each command and the API calls,
    per-block walls and memory, launches, the merged skeleton, planted
    markers adjacent to their traits beside a plain threshold screen, the
    PAG's trait marks beside the planted DAG, each planted edge's MVIVW
    (plain, -s, filtered) and ACE estimates, the false positives at
    p < 1e-3 and the sha256 of every merged, PAG and MR file. Then cusk-all
    again under torch.profiler for the device's idle share, its launches
    equal to the first run's: every gather launch of it is held bitwise to
    its plain version as it comes, and the largest launch of each kernel is
    kept, held bitwise to plain afterwards and timed beside its bound.
    Returns, per kernel name, what the `kernels` line carries under the
    genome's keys."""
    t0 = time.perf_counter()
    d = os.path.join(tmp, "genome")
    os.makedirs(d)
    stem, planted, Y, rows_of = write_genome_fileset(d)
    torch.cuda.synchronize()
    emit("genome_data", t0, markers=sum(GENOME_CHRS), chromosomes=len(GENOME_CHRS),
         individuals=N11K, traits=P11K, bed_bytes=os.path.getsize(stem + ".bed"),
         planted_markers=planted,
         trait_dag=[f"T{s}->T{t} {b}" for t, ps in sorted(GENOME_DAG.items()) for s, b in ps])

    t0 = time.perf_counter()
    out = os.path.join(d, "out")
    os.makedirs(out)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_all_launches()
    walls, blocks, printed = run_commands(stem, out, MAX_BLOCK, CORR_WIDTH, ALPHA, N11K, "cuda",
                                          only=CHAIN)
    launches = all_launches()
    sys.stdout.write(printed)
    per_block = block_lines(printed)
    sizes = [b.block_size() for b in read_blocks_from_file(blocks)]
    assert sum(sizes) == sum(GENOME_CHRS) and max(sizes) <= MAX_BLOCK, sizes
    assert len(sizes) >= GENOME_MIN_BLOCKS, f"{len(sizes)} blocks, fewer than {GENOME_MIN_BLOCKS}"
    assert len(per_block) == len(sizes), (len(per_block), printed[-2000:])
    for name in ("local_sweep_l1", "local_sweep_l2", "local_sweep_l3"):
        assert launches[name] > 0, f"{name} was never launched over the genome: {launches}"
    grown = per_block[-1]["device_memory_gib"] - per_block[0]["device_memory_gib"]
    assert grown < 0.25, f"device memory grew by {grown} GiB over the blocks: {per_block}"
    assert per_block[0]["retained_markers"] is not None, (
        f"data: the pre-screen skipped the first block ({per_block[0]['block']}), which holds "
        f"none of the planted markers {planted}, and merge takes the trait-trait edges from "
        "the first block alone: choose a GENOME_SEED that plants a marker there")

    gm = merge_block_outputs(blocks, out)
    sparse_of = {row: ix for ix, row in gm.gmi.items()}
    adjacent = sum(
        k in sparse_of and ((sparse_of[k], t + 1) in gm.sam or (t + 1, sparse_of[k]) in gm.sam)
        for t, k in planted)
    th0 = threshold_array(N11K, ALPHA)[0]
    screen = sum(fisher_z(np.corrcoef(rows_of[k].cpu().numpy(), Y[t])[0, 1]) >= th0
                 for t, k in planted)
    in_skeleton = {f"T{s}->T{t}": (s + 1, t + 1) in gm.sam or (t + 1, s + 1) in gm.sam
                   for s, t in GENOME_EDGES}
    assert all(in_skeleton.values()), f"planted trait edges missing: {in_skeleton}"
    pag_stem, merged = os.path.join(out, "max_sep_min_pc"), os.path.join(out, "merged_blocks")
    pag = mmread(pag_stem + "_estimated_pag.mtx").toarray().astype(int)
    plain = mvivw_rows(os.path.join(out, PLAIN_MVIVW))
    skel = mvivw_rows(merged + "_mvivw_results.tsv")
    for s, t in GENOME_EDGES:
        effect, p = plain[(s, t)]
        assert effect > 0 and p < 1e-3, f"mvivw T{s}->T{t}: effect {effect}, p {p}"
    false_pos = sorted(f"T{s}->T{t}" for (s, t), (_, p) in plain.items()
                       if p < 1e-3 and (s, t) not in GENOME_EDGES)

    t1 = time.perf_counter()
    ace = {f"T{s}->T{t}": estimate_ace(pag_stem, pag_stem + "_estimated_pag.mtx", s, t, N11K,
                                       ALPHA)
           for s, t in GENOME_EDGES}
    ivs = check_ivs(merged, N11K, ALPHA, ALPHA)
    filt_dir = os.path.join(d, "filtered")
    os.makedirs(filt_dir)
    for ext in ("_sam.mtx", "_scm.mtx", ".mdim", ".ixs"):
        shutil.copy(merged + ext, os.path.join(filt_dir, "cuskss_merged" + ext))
    filtered = {(r["source"] - 1, r["sink"] - 1): (r["effect"], r["p"])
                for r in run_mvivw_filtered(filt_dir, N11K, ivs)}
    api_wall = time.perf_counter() - t1
    hashes = {f: hashlib.sha256(data).hexdigest() for f, data in block_files(out).items()
              if f.startswith(("merged_blocks", "max_sep_min_pc"))}
    sha = {"blocks": hashlib.sha256(open(blocks, "rb").read()).hexdigest(), **hashes}
    held_sha("genome", sha)
    emit("genome_commands", t0, wall_s_by_command=walls, api_wall_s=api_wall,
         blocks=len(sizes), block_sizes=sizes, per_block=per_block,
         blocks_without_retained_markers=sum(b["retained_markers"] is None for b in per_block),
         launches=launches, merged_variables=gm.num_var, merged_edges=len(gm.sam),
         planted_adjacent=int(adjacent), planted=len(planted),
         planted_pass_plain_screen=int(screen), trait_edges_in_skeleton=in_skeleton,
         trait_pag=pag[:P11K, :P11K].tolist(),
         planted_pag_marks={f"T{s}->T{t}": [int(pag[s, t]), int(pag[t, s])]
                            for s, t in GENOME_EDGES},
         mvivw={f"T{s}->T{t}": {"plain": plain[(s, t)], "s": skel[(s, t)],
                                 "filtered": filtered[(s, t)]} for s, t in GENOME_EDGES},
         mvivw_false_positives_p_1e3=false_pos, iv_rows=len(ivs), ace=ace,
         peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30, sha256=sha,
         sha256_equal_to_parent=True)

    def again():
        out2 = os.path.join(d, "out_profiled")
        os.makedirs(out2)
        with contextlib.redirect_stdout(io.StringIO()):
            run_commands(stem, out2, MAX_BLOCK, CORR_WIDTH, ALPHA, N11K, "cuda",
                         only=("cusk-all",))

    reset_all_launches()
    t0 = time.perf_counter()
    # the sweep's launches also timed behind a spin kernel each (sums by
    # level; the spins add ~0.5 ms of device time a launch to the profile)
    with (GatedTimer.sweeps() as timer, EveryLaunchChecked(("gather_local_panels",)) as chk,
          Recorder() as rec):
        profile_run("genome_cusk_all", again, walls["cusk-all"], cpu=False)
    totals = timer.totals()
    emit("loop_totals_genome", t0, totals=totals)
    assert all_launches() == launches, (all_launches(), launches)
    assert chk.checked == launches["panel_gather"], (chk.checked, launches)

    # the largest launch of each kernel on the genome, kernel vs plain on the card
    t0 = time.perf_counter()
    entries = (sweep_entries("genome", rec, launches, rho_th, loops, clock_hz)
               + gather_entries("genome", rec, launches))
    del rec
    torch.cuda.empty_cache()
    emit("largest_launch_genome", t0, gather_launches_bit_identical=chk.checked, kernels=entries)
    phase_genome_analysis(d, stem, out, blocks, planted, ace)
    drop = ("name", "route", "source", "replaces", "launches")
    of_entry = {k["name"]: {key: v for key, v in k.items() if key not in drop} for k in entries}
    return {name: {"launches_genome": launches[name],
                   **({"genome": of_entry[name]} if name in of_entry else {}),
                   **({"gated_total_ms_genome": totals[name]["total_ms"]} if name in totals
                      else {})}
            for name in ("local_sweep_l1", "local_sweep_l2", "local_sweep_l3", "panel_gather")}


# --- the rest of the one-card API: pMax, the second stage, sim, phen_prep,
# --- analysis and the marker Pearson panel. The phases take the device (and
# --- their sizes) as arguments so that they can be rehearsed on the CPU at a
# --- small size; main() runs them on the card at full size.


class CapturePanels:
    """While it is open, keeps the panel and n_var of every `skeleton` call
    the cusk pipeline makes (stage 1: the device panel, stage 2: the reduced
    host panel), so that the pMax phases run on the pipeline's own panels."""

    def __init__(self):
        self.calls: list = []
        self.saved = cusk_pipeline.skeleton

    def __enter__(self):
        def skeleton(C, thresholds, max_level, **kw):
            self.calls.append((C, kw.get("n_var")))
            return self.saved(C, thresholds, max_level, **kw)

        cusk_pipeline.skeleton = skeleton
        return self

    def __exit__(self, *exc):
        cusk_pipeline.skeleton = self.saved


def sync(dev: str) -> None:
    if dev == "cuda":
        torch.cuda.synchronize()


class HostPeak:
    """The process's peak resident memory while it is open, sampled every
    5 ms from /proc/self/status by a thread of its own (VmHWM cannot be
    reset where /proc/self/clear_refs is refused); `gb` is that peak and
    `start_gb` the resident memory when it opened."""

    def __init__(self):
        self.gb = self.start_gb = None
        self._stop = threading.Event()

    @staticmethod
    def _rss_gb() -> float:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) / 2**20
        raise RuntimeError("no VmRSS in /proc/self/status")

    def _sample(self):
        while not self._stop.wait(0.005):
            self.gb = max(self.gb, self._rss_gb())

    def __enter__(self):
        self.gb = self.start_gb = self._rss_gb()
        self._thread = threading.Thread(target=self._sample, daemon=True)
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join(timeout=5)
        self.gb = max(self.gb, self._rss_gb())


def sweep_launches() -> dict:
    return {**{f"local_sweep_l{l}": n for l, n in ls.launches.items()}, **pg.launches}


def assert_pmax_properties(tag: str, res) -> None:
    """pMax holds PMAX_RETAINED exactly on the kept edges, 1.0 on the
    diagonal, is symmetric, finite and >= 0 elsewhere."""
    G, pm = res.G.astype(bool), res.pmax
    assert pm is not None and pm.shape == G.shape and pm.dtype == np.float32, tag
    assert np.all(pm[G] == PMAX_RETAINED), f"{tag}: a kept edge without PMAX_RETAINED"
    assert np.all(np.diag(pm) == 1.0), f"{tag}: diagonal"
    assert np.array_equal(pm, pm.T), f"{tag}: not symmetric"
    off = ~G & ~np.eye(len(G), dtype=bool)
    assert np.all(np.isfinite(pm[off])) and np.all(pm[off] >= 0), f"{tag}: deleted pairs"


def device_peak_reset(dev: str) -> None:
    if dev == "cuda":
        torch.cuda.reset_peak_memory_stats()


def device_peak_gb(dev: str):
    return torch.cuda.max_memory_allocated() / 2**30 if dev == "cuda" else None


def skeleton_pair(tag: str, C, th, max_level: int, n_var=None, dev: str = "cuda"):
    """The skeleton with pMax on the card, every launch held bitwise to
    plain, then on the CPU: identical decisions, pMax within 1e-6. Returns
    (card result, its launches, its wall, largest |pMax difference|)."""
    reset_all_launches()
    with EveryLaunchChecked() as chk:
        t = time.perf_counter()
        res = cupc.skeleton(C, th, max_level, device=dev, n_var=n_var)
        sync(dev)
        wall = time.perf_counter() - t
    launches = sweep_launches()
    C_host = C.cpu().numpy() if isinstance(C, torch.Tensor) else C
    t = time.perf_counter()
    ref = cupc.skeleton(C_host, th, max_level, device="cpu", n_var=n_var)
    cpu_wall = time.perf_counter() - t
    assert res.final_level == ref.final_level, (tag, res.final_level, ref.final_level)
    assert np.array_equal(res.G, ref.G), f"{tag}: adjacency differs between cuda and cpu"
    assert np.array_equal(res.sepset, ref.sepset), f"{tag}: sepsets differ between cuda and cpu"
    diff = float(np.max(np.abs(res.pmax.astype(np.float64) - ref.pmax), initial=0.0))
    assert diff <= 1e-6, f"{tag}: pMax differs by {diff} between cuda and cpu"
    if dev == "cuda":
        # the check holds the device loop's row compactions to plain too
        checked = sum(launches.values()) + cr.launches["compact_rows"]
        assert chk.checked == checked, (tag, chk.checked, launches, cr.launches)
    assert_pmax_properties(tag, res)
    return res, launches, {"cuda_wall_s": wall, "cpu_wall_s": cpu_wall,
                           "launches_bit_identical": chk.checked}, diff


def phase_pmax(capture: CapturePanels, th: np.ndarray, rho_th: dict, markers: int = M11K,
               traits: int = P11K, dev: str = "cuda") -> dict:
    """pmax_11k: the 11k block's stage-1 panel (the pipeline's own, kept by
    `capture`) through `skeleton(C, th, 3)` with pMax and without: the same
    adjacency, sepsets and launches per level; pMax's properties; the
    largest launch of each level of the pMax run held bitwise to plain; both
    walls, pMax's extra seconds split into the panel's fetch and the rest,
    peak device and host memory. pmax_stage2: that result reduced as the
    pipeline reduces it (`subset_variables`, `reduce_gcs`; the reduced panel
    must be the one the pipeline's stage 2 received) through `skeleton(...,
    14)` with pMax on the card and on the CPU. Returns the launches of both
    under the `kernels` line's keys."""
    t0 = time.perf_counter()
    (C, v), (C2_pipeline, _) = capture.calls[0], capture.calls[1]
    runs = {}
    for want in (True, False):
        stats: dict = {}
        reset_all_launches()
        device_peak_reset(dev)
        with (Recorder() if want else contextlib.nullcontext()) as rec, HostPeak() as host:
            t = time.perf_counter()
            res = cupc.skeleton(C, th, MAX_LEVEL, device=dev, n_var=v, stats=stats,
                                want_pmax=want)
            sync(dev)
            wall = time.perf_counter() - t
        runs[want] = {"res": res, "wall": wall, "stats": stats, "launches": sweep_launches(),
                      "buckets": {l: len(b) for l, b in stats["launches"].items()},
                      "device_peak_gb": device_peak_gb(dev),
                      "host_peak_gb": host.gb, "host_start_gb": host.start_gb, "rec": rec}
    on, off = runs[True], runs[False]
    assert off["res"].pmax is None
    assert np.array_equal(on["res"].G, off["res"].G), "pMax changed the adjacency"
    assert np.array_equal(on["res"].sepset, off["res"].sepset), "pMax changed the sepsets"
    assert on["launches"] == off["launches"] and on["buckets"] == off["buckets"], (
        on["launches"], off["launches"])
    assert_pmax_properties("pmax_11k", on["res"])
    largest = {}
    for l in (1, 2, 3) if dev == "cuda" else ():
        Ck, node_ixs, nbrs, deg, _ = on["rec"].largest[("local_sweep", l)][1]
        rho_k, pos_k = ls.local_sweep(Ck, node_ixs, nbrs, deg, l)
        rho_p, pos_p = pcorr.local_sweep_plain(Ck, node_ixs, nbrs, deg, l)
        largest[l] = {"nodes": int(nbrs.shape[0]), "width": int(nbrs.shape[1]),
                      "max_abs_err": compare(f"pmax_11k level {l}", rho_k, pos_k, rho_p, pos_p,
                                             deg, rho_th[l])}
    del on["rec"]
    launches1 = on["launches"]
    fetch = on["stats"]["c_fetch_wall_s"]
    extra = on["wall"] - off["wall"]
    res = on["res"]
    deleted = ~res.G.astype(bool) & ~np.eye(len(res.G), dtype=bool)
    emit("pmax_11k", t0, variables=int(v), wall_s_pmax=on["wall"], wall_s_no_pmax=off["wall"],
         pmax_extra_s=extra, pmax_panel_fetch_s=fetch, pmax_extra_rest_s=extra - fetch,
         pmax_host_steps_s=on["stats"]["pmax_wall_s"],
         level_wall_s={"pmax": on["stats"]["level_wall_s"],
                       "no_pmax": off["stats"]["level_wall_s"]},
         launches=on["launches"], launches_equal=True, decisions_equal=True,
         largest_launch_bit_identical=largest,
         device_peak_gb={"pmax": on["device_peak_gb"], "no_pmax": off["device_peak_gb"]},
         host_peak_gb={"pmax": on["host_peak_gb"], "no_pmax": off["host_peak_gb"]},
         host_start_gb={"pmax": on["host_start_gb"], "no_pmax": off["host_start_gb"]},
         kept_edges=int(res.G.sum() // 2), pmax_deleted_max=float(res.pmax[deleted].max()),
         pmax_deleted_mean=float(res.pmax[deleted].mean()))

    t0 = time.perf_counter()
    keep = subset_variables(res.G, v, markers, DEPTH)
    gcs = reduce_gcs(res.G, C, res.records, keep, v, traits, MAX_LEVEL)
    assert np.array_equal(gcs.C, C2_pipeline), "the reduced panel is not the pipeline's"
    del runs, on, off, res
    res2, launches2, walls2, diff2 = skeleton_pair("pmax_stage2", gcs.C, th, MAX_LEVEL_TWO,
                                                   dev=dev)
    assert dev != "cuda" or launches2["panel_gather"] >= 1, (
        f"stage 2 made no gather launch: {launches2}")
    emit("pmax_stage2", t0, variables=int(gcs.num_var), final_level=res2.final_level,
         launches=launches2, pmax_max_abs_diff=diff2, cuda_equals_cpu=True, **walls2)
    return {name: {"launches_pmax_11k": launches1[name], "launches_pmax_stage2": launches2[name]}
            for name in PMAX_KERNELS}


def phase_marker_pearson(stem: str, blocks: str, dev: str = "cuda") -> None:
    """`marker_pearson_corr` on the card: the reference's golden bmt2
    values within 1e-5; then the 11k block's bytes, its first 2,048 markers
    bitwise equal to the CPU's result on the same bytes (exact integer sums,
    the same host quotient), the products' device time beside their bound
    at the int8 peak."""
    t0 = time.perf_counter()
    gold = np.load(os.path.join(os.path.dirname(FIXTURES), "bed_marker.npz"))
    iu = np.triu_indices(7, k=1)
    exp = np.eye(7, dtype=np.float32)
    exp[iu] = exp[(iu[1], iu[0])] = gold["bmt2_marker_corrs_pearson"]
    got = marker_pearson_corr(gold["bmt2_marker_vals"].reshape(7, 25), gold["bmt2_marker_mean"],
                              gold["bmt2_marker_std"], 100, device=dev)
    golden_err = float(np.abs(got - exp).max())
    assert golden_err <= 1e-5, f"bmt2 Pearson off by {golden_err}"

    ctx = CuskContext(stem + ".phen", stem, blocks, ALPHA, MAX_LEVEL, MAX_LEVEL_TWO, DEPTH,
                      os.path.dirname(stem), verbose=False, device=dev)
    prep = ctx.prepare(0)
    del prep["mp_sums"]
    bb, means, stds, n = prep["bedblock"], prep["means"], prep["stds"], ctx.dims.num_samples
    sync(dev)
    t = time.perf_counter()
    C = marker_pearson_corr(bb, means, stds, n, device=dev)
    wall = time.perf_counter() - t
    k = 2048
    t = time.perf_counter()
    C_cpu = marker_pearson_corr(bb[:k], means[:k], stds[:k], n, device="cpu")
    cpu_wall = time.perf_counter() - t
    assert np.array_equal(C[:k, :k].view(np.int32), C_cpu.view(np.int32)), (
        "marker_pearson_corr differs between cuda and cpu")
    finite = np.isfinite(C)
    assert finite.mean() > 0.999 and np.all(np.abs(C[finite]) <= 1.0 + 1e-5)
    padded, n_chunks = corr_ops._prep_bytes(bb, n, corr_ops._sample_chunk(bb.shape[1],
                                                                        DEFAULT_SAMPLE_CHUNK))
    rows = torch.tensor(padded, device=dev)
    products_ms = one_product_ms = None
    if dev == "cuda":
        products_ms = cuda_ms(lambda: corr_ops._marker_pearson_sums(rows, n_chunks), reps=3)
        codes = corr_ops.unpack_bed_codes(rows)
        valid = (codes != 1).to(torch.int8)
        del codes
        # one of the two products alone, without the decode around it
        one_product_ms = cuda_ms(lambda: corr_ops.contingency_counts(valid, valid), reps=3)
        del valid
    m, samples = bb.shape[0], padded.shape[1] * 4
    ops = 2 * 2 * m * m * samples  # two int8 products (m x samples) @ (samples x m)
    emit("marker_pearson", t0, golden_max_abs_err=golden_err, markers=m, individuals=n,
         wall_s=wall, cpu_wall_s_2048=cpu_wall, cuda_equals_cpu_2048=True,
         products_ms=products_ms, one_product_ms=one_product_ms,
         products_bound_ms=ops / PEAK_INT8 * 1e3,
         products_bound_by="operations", products_int8_ops=ops,
         non_finite=int((~finite).sum()))


# `gen_rand_dag` at the size of the reference's accuracy evaluation
# (`simulate_dag.R` at n=16000 and 1,600 SNPs, tests/test_sim.py:3-4), with
# that test's other parameters
SIM_DAG = dict(n=16000, num_snp=1600, num_trait=6, num_latent=1, deg=3, prob_pleio=0.2,
               lo_mp=0.1, hi_mp=0.3, lo_pp=0.1, hi_pp=0.4, seed=7)


def phase_sim_dag(sizes: dict = SIM_DAG, dev: str = "cuda") -> dict:
    """The reference's accuracy evaluation at its own size: the simulated
    DAG's observed correlation panel through `skeleton(C, Th(1e-3), 14)`
    with pMax on the card (every launch held bitwise to plain) and on the
    CPU (identical decisions, pMax within 1e-6); recall (> 0.8, as
    tests/test_sim.py asks) and precision against the true skeleton of the
    observed variables; then `cusk_second_stage` on the panel and the
    skeleton's adjacency."""
    t0 = time.perf_counter()
    dag = gen_rand_dag(**sizes)
    obs = dag.observed()
    C = np.corrcoef(obs, rowvar=False).astype(np.float32)
    data_s = time.perf_counter() - t0
    th = threshold_array(obs.shape[0], 1e-3)
    res, launches, walls, diff = skeleton_pair("sim_dag", C, th, 14, dev=dev)
    keep = np.r_[np.arange(dag.num_snp), np.arange(dag.num_snp + dag.num_latent, dag.pq)]
    true_dir = dag.G[np.ix_(keep, keep)] != 0
    true_skel = true_dir | true_dir.T
    iu = np.triu_indices(len(keep), 1)
    est = res.G.astype(bool)[iu]
    tp, fn, fp = (int(np.sum(est & true_skel[iu])), int(np.sum(~est & true_skel[iu])),
                  int(np.sum(est & ~true_skel[iu])))
    recall, precision = tp / max(tp + fn, 1), tp / max(tp + fp, 1)
    assert recall > 0.8, f"recall {recall}"
    t = time.perf_counter()
    try:
        ss = cusk_second_stage(C, res.G, th)
        second = {"wall_s": time.perf_counter() - t,
                  "pairs_with_sepset": int((ss.sepset[..., 0] >= 0).sum()),
                  "edges": int(ss.G.sum() // 2)}
    except ValueError as e:  # the reference's degree cap
        second = {"wall_s": time.perf_counter() - t, "refused": str(e)}
    emit("sim_dag", t0, variables=int(C.shape[0]), samples=int(obs.shape[0]), data_s=data_s,
         final_level=res.final_level, launches=launches, pmax_max_abs_diff=diff,
         cuda_equals_cpu=True, true_edges=tp + fn, recall=recall, precision=precision,
         second_stage=second, **walls)
    return {name: {"launches_sim_dag": launches[name]} for name in PMAX_KERNELS}


def phase_sim_commands(tmp: str, num_markers: int = 10000, num_samples: int = 4000,
                       dev: str = "cuda") -> None:
    """`sim` and `phen_prep` where pandas is absent: `simulate_genotype_dataset`
    with its default planted structure (markers spread over the chromosome,
    the first at marker 0, trait edge T0 -> T1), its `.phen` split into a
    space-separated FID IID file of T0, T1 and an IID FID file of T2 in
    another row order, merged back with `make_merged_pheno_file` (it must
    read as the `.phen` does), then the five commands with the merged file
    and the CLI's defaults: at least 6 of the 7 planted markers adjacent to
    their trait, and the T0 - T1 edge."""
    t0 = time.perf_counter()
    d = os.path.join(tmp, "sim_commands")
    stem = simulate_genotype_dataset(d, num_samples=num_samples, num_markers=num_markers)
    lines = open(stem + ".phen").read().splitlines()
    rows = [ln.split("\t") for ln in lines]
    a, b, merged = stem + "_a.txt", stem + "_b.txt", stem + "_merged.phen"
    with open(a, "w") as f:
        f.writelines(" ".join(r[:4]) + "\n" for r in rows)
    order = np.random.default_rng(0).permutation(len(rows) - 1) + 1
    with open(b, "w") as f:
        f.write("IID FID T2\n")
        f.writelines(f"{rows[i][1]} {rows[i][0]} {rows[i][4]}\n" for i in order)
    make_merged_pheno_file([PhenotypesFile(a, ["T0", "T1"]), PhenotypesFile(b, ["T2"])],
                           stem + ".fam", merged)
    assert np.array_equal(load_phen(merged).data, load_phen(stem + ".phen").data)
    data_s = time.perf_counter() - t0
    out = os.path.join(d, "out")
    os.makedirs(out)
    reset_all_launches()
    walls, blocks, _ = run_commands(stem, out, MAX_BLOCK, CORR_WIDTH, ALPHA, num_samples, dev,
                                    phen=merged)
    gm = merge_block_outputs(blocks, out)
    sparse_of = {row: ix for ix, row in gm.gmi.items()}
    picks = np.linspace(0, num_markers - 1, 8).astype(int)
    planted = [(0, int(k)) for k in picks[:4]] + [(1, int(k)) for k in picks[4:7]]
    adjacent = sum(k in sparse_of and ((sparse_of[k], t + 1) in gm.sam
                                       or (t + 1, sparse_of[k]) in gm.sam) for t, k in planted)
    trait_edge = (1, 2) in gm.sam or (2, 1) in gm.sam
    assert adjacent >= 6, f"{adjacent} of {len(planted)} planted markers adjacent"
    assert trait_edge, "the planted T0 - T1 edge is missing"
    emit("sim_commands", t0, markers=num_markers, individuals=num_samples, data_s=data_s,
         merged_phen_equals_sim_phen=True, wall_s_by_command=walls,
         blocks=len(read_blocks_from_file(blocks)), merged_variables=gm.num_var,
         planted_adjacent=int(adjacent), planted=len(planted), trait_edge_t0_t1=trait_edge,
         launches=all_launches())


def phase_genome_analysis(d: str, stem: str, out: str, blocks: str, planted: list,
                          ace: dict) -> None:
    """The analysis API over the genome's outputs: the pleiotropy matrices
    and sets, parent and ancestor sets, causal paths and edge tallies of the
    PAG, both association tables (every planted marker's rsID among its
    trait's associations), the planted edges' ACE through a trait x trait
    `.mtx` and `load_ace`, and `cusk_second_stage` on the merged skeleton;
    the planted T2 -> T3 edge must be a causal path."""
    t0 = time.perf_counter()
    walls: dict = {}

    def timed(name, fn, *args, **kw):
        t = time.perf_counter()
        r = fn(*args, **kw)
        walls[name] = time.perf_counter() - t
        return r

    phen = stem + ".phen"
    names = analysis.get_pheno_codes(phen)
    merged = os.path.join(out, "merged_blocks")
    pag_path = os.path.join(out, "max_sep_min_pc_estimated_pag.mtx")
    epm = timed("global_epm", analysis.global_epm, blocks, out)
    upm = timed("global_upm", analysis.global_upm, blocks, out)
    eps = timed("global_eps", analysis.global_eps, blocks, out)
    parents = timed("global_parent_sets", analysis.global_parent_sets, blocks, out)
    ancestors = timed("global_ancestor_sets", analysis.global_ancestor_sets, blocks, out)
    paths = timed("get_causal_paths", analysis.get_causal_paths, pag_path, phen)
    possible = timed("get_possibly_causal_paths", analysis.get_possibly_causal_paths,
                     pag_path, phen)
    edge_types = timed("pag_edge_types", analysis.pag_edge_types, pag_path, phen)
    assoc = timed("marker_pheno_associations", analysis.marker_pheno_associations,
                  stem + ".bim", merged + "_scm.mtx", merged + "_sam.mtx", merged + ".ixs",
                  pheno_path=phen)
    assoc2 = timed("marker_pheno_associations_with_pnames",
                   analysis.marker_pheno_associations_with_pnames, blocks, out, names,
                   stem + ".bim")
    rsid = {int(k): f"rs{k}" for _, k in planted}
    found = {(r["phenotype"], r["rsID"]) for r in assoc}
    missing = [(t, k) for t, k in planted if (names[t], rsid[k]) not in found]
    assert not missing, f"planted markers missing from the associations: {missing}"
    assert paths[2, 3] == 1, f"T2 -> T3 is no causal path: {paths.tolist()}"
    ace_mat = np.zeros((P11K, P11K))
    for key, value in ace.items():
        s, t = (int(x) for x in key.replace("T", "").split("->"))
        ace_mat[s, t] = value
    ace_path = os.path.join(d, "planted_ace.mtx")
    write_coo_mtx(ace_path, ace_mat)
    ace_back = timed("load_ace", analysis.load_ace, ace_path, phen)
    directed = timed("load_ace_directed_only", analysis.load_ace_directed_only, ace_path,
                     pag_path, phen)
    assert np.allclose(ace_back, ace_mat, rtol=1e-6, atol=0, equal_nan=True)
    C = mmread(merged + "_scm.mtx").toarray().astype(np.float32)
    G = (mmread(merged + "_sam.mtx").toarray() != 0).astype(np.int32)
    np.fill_diagonal(C, 1.0)
    t = time.perf_counter()
    try:
        ss = cusk_second_stage(C, G, threshold_array(N11K, ALPHA))
        second = {"wall_s": time.perf_counter() - t, "variables": int(C.shape[0]),
                  "pairs_with_sepset": int((ss.sepset[..., 0] >= 0).sum()),
                  "edges": int(ss.G.sum() // 2)}
    except ValueError as e:  # the reference's degree cap
        second = {"wall_s": time.perf_counter() - t, "refused": str(e)}
    emit("genome_analysis", t0, wall_s_by_call=walls,
         epm_pairs=len(epm), upm_pairs=len(upm), eps_markers=sum(len(v) for v in eps.values()),
         parent_markers=sum(len(v) for v in parents.values()),
         ancestor_markers=sum(len(v) for v in ancestors.values()),
         causal_paths=np.argwhere(paths[:P11K, :P11K] == 1).tolist(),
         possibly_causal_paths=int(possible.sum()),
         edge_types={f"{a}{b}": c for (a, b), c in sorted(edge_types.items())},
         associations=len(assoc), associations_with_pnames=len(assoc2),
         planted_in_associations=len(planted) - len(missing),
         ace_directed_only=directed[np.nonzero(directed)].tolist(), second_stage=second)


# --- the multi-device engines: D shards of one card ---------------------------

MESH_D = 4
MESH_MODES = ("replicated", "rowsharded")
# the decision files of a cusk block and a cuskss run
CUSK_FILES, CUSKSS_FILES = (".adj", ".ixs", ".mdim", ".sep"), (".adj", ".ixs", ".mdim")
MERGED_FILES = ("merged_blocks_sam.mtx", "merged_blocks_scm.mtx", "merged_blocks.mdim",
                "merged_blocks.ixs")


def mesh_of(dev: str, D: int) -> list:
    """D shards: D entries of the first card, or of the CPU."""
    return [torch.device("cuda", 0) if dev == "cuda" else torch.device("cpu")] * D


class ShardRecorder(Recorder):
    """A Recorder keyed by shard as well: the largest launch of each kernel
    on each shard of an engine (the engines name the shard of each launch
    through `call`)."""

    def __enter__(self):
        self.shard = None
        self.saved_call = sharded.ShardedEngine.call
        saved, rec = self.saved_call, self

        def call(engine, k, kernel):
            rec.shard = k
            return saved(engine, k, kernel)

        sharded.ShardedEngine.call = call
        return super().__enter__()

    def __exit__(self, *exc):
        sharded.ShardedEngine.call = self.saved_call
        return super().__exit__(*exc)

    def _keep(self, key, work, args):
        super()._keep(key + (self.shard,), work, args)


def shard_checks(tag: str, rec: ShardRecorder) -> list:
    """Each shard's largest launch of each kernel, run again through the
    kernel and through its plain version on the same tensors: bitwise equal
    (the compare functions raise otherwise)."""
    out = []
    for key in sorted(rec.largest, key=str):
        args = rec.largest[key][1]
        name, shard = key[0], key[-1]
        label = f"{tag} shard {shard} largest {name}{'' if len(key) == 2 else key[1]}"
        if name == "local_sweep":
            C, node_ixs, nbrs, deg, l = args
            rho_k, pos_k = ls.local_sweep(C, node_ixs, nbrs, deg, l)
            err = compare(label, rho_k, pos_k, *pcorr.local_sweep_plain(C, node_ixs, nbrs, deg, l),
                          deg, math.nan)
            entry = f"local_sweep_l{l}"
        elif name == "hetcor_sweep":
            _, err = compare_margin(label, hs.hetcor_local_sweep(*args),
                                    pcorr.hetcor_local_sweep_plain(*args))
            C, nbrs, entry = args[0], args[4], f"hetcor_sweep_l{args[7]}"
        elif name in DENSE:
            out.append({"kernel": name, "shard": shard, **dense_check(label, name, args)})
            continue
        elif name == "hetcor_scan":
            _, err = compare_margin(label, hs.hetcor_scan(*args),
                                    pcorr.level_scan_hetcor_pre(*args))
            out.append({"kernel": name, "shard": shard, "level": args[-1],
                        "nodes": int(args[1].shape[0]), "width": int(args[1].shape[1]),
                        "bit_identical": True, "max_abs_err": err})
            continue
        elif name == "compact_rows":  # the row-sharded engine's stage 2 runs on one card
            G, rows, d = compact_launch(args)
            err = compare_bits(label, cr.compact_rows(G, rows, d),
                               cr.compact_rows_plain(G, rows, d))
            out.append({"kernel": name, "shard": shard, "nodes": int(rows.numel()),
                        "width": d, "panel": int(G.shape[0]), "bit_identical": True,
                        "max_abs_err": err})
            continue
        else:
            kern, plain = ((pg.gather_local_panels, pg.gather_local_panels_plain)
                           if name == "panel_gather" else
                           (pg.gather_local_panels2, pg.gather_local_panels2_plain))
            err = compare_bits(label, kern(*args), plain(*args))
            C, nbrs, entry = args[0], args[-2], name
        out.append({"kernel": entry, "shard": shard, "nodes": int(nbrs.shape[0]),
                    "width": int(nbrs.shape[1]), "panel": int(C.shape[0]),
                    "bit_identical": True, "max_abs_err": err})
    return out


def engine_memory(record: dict) -> dict:
    """From an engine's record: the bytes of panel parts each shard holds
    (its stripes, or the copies its device owns) and its largest compact
    panel; the bytes that crossed between shards and came from the host."""
    held = [0] * len(record["calls"])
    compact = [0] * len(record["calls"])
    for what, k, _, shape in record["placed"]:
        nbytes = 4 * math.prod(shape)
        if what == "panel":
            held[k] += nbytes
        elif what == "compact":
            compact[k] = max(compact[k], nbytes)
    return {"panel_bytes_per_shard": held, "largest_compact_bytes_per_shard": compact,
            "crossed_bytes": record["crossed_bytes"], "uploaded_bytes": record["uploaded_bytes"],
            "calls_per_shard": [dict(c) for c in record["calls"]]}


def device_peaks(dev: str) -> dict:
    """Peak allocated bytes of every card since the last reset."""
    if dev != "cuda":
        return {}
    return {f"cuda:{i}": torch.cuda.max_memory_allocated(i)
            for i in range(torch.cuda.device_count())}


def mesh_small(tmp: str, dev: str = "cuda") -> dict:
    """The 1,500-marker block of `phase_small_reference` through cusk with
    each engine over D = 2 and 3 shards (uneven parts) of the card and of the
    CPU: every file byte-identical to that device's one-device run, every
    shard launch on the card bitwise equal to its plain version."""
    stem, blocks = os.path.join(tmp, "small", "sim"), os.path.join(tmp, "small", "sim.blocks")
    one = {d: block_files(os.path.join(tmp, f"small_{d}")) for d in (dev, "cpu")}
    checked = {}
    for d in dict.fromkeys((dev, "cpu")):
        for D in (2, 3):
            for mode in MESH_MODES:
                out = os.path.join(tmp, f"small_mesh_{d}_{mode}_{D}")
                os.makedirs(out)
                with EveryLaunchChecked() as chk:
                    cusk(stem + ".phen", stem, blocks, ALPHA, MAX_LEVEL, MAX_LEVEL_TWO, DEPTH,
                         out, 0, verbose=False, mesh=mesh_of(d, D), panel_mode=mode)
                got = block_files(out)
                differ = [f for f in one[d] if got.get(f) != one[d][f]]
                assert got.keys() == one[d].keys() and not differ, (d, mode, D, differ)
                checked[f"{d}_{mode}_{D}"] = chk.checked
    assert all(n > 0 for k, n in checked.items() if k.startswith("cuda")), checked
    return {"files": sorted(one["cpu"]), "equal_to_one_device": True,
            "launches_bit_identical": checked}


def mesh_engine_runs(tag: str, run, one_dir: str, base: str, exts: tuple, parent: dict | None,
                     dev: str = "cuda") -> tuple[dict, dict]:
    """run(mode, outdir, stats) for both panel modes over MESH_D shards,
    the launch counts set to 0 just before each and read just after: its
    wall, per-level walls, the engine's record (the pipeline puts it into
    stats), the dense entries' device time over all their launches, the
    card's peak memory, the decision files' sha256 (equal to
    `parent` where given) and every file byte-equal to the one-device run's
    in `one_dir`; then each shard's largest launch of each kernel held
    bitwise to plain. Returns the phase's lines and the launches per mode."""
    lines, launches = {}, {}
    one = block_files(one_dir)
    for mode in MESH_MODES:
        out = os.path.join(os.path.dirname(one_dir), f"{tag}_mesh_{mode}")
        os.makedirs(out)
        stats: dict = {}
        if dev == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        with GatedTimer() as timer, ShardRecorder() as rec:
            reset_all_launches()
            t1 = time.perf_counter()
            run(mode, out, stats)
            if dev == "cuda":
                torch.cuda.synchronize()
            wall = time.perf_counter() - t1
            launches[mode] = all_launches()
        dense_ms = timer.totals() if dev == "cuda" else {}
        peaks = device_peaks(dev)
        got = block_files(out)
        differ = [f for f in one if got.get(f) != one[f]]
        assert got.keys() == one.keys() and not differ, f"{tag} {mode}: {differ} differ"
        sha = file_hashes(os.path.join(out, base), exts)
        if parent is not None:
            assert sha == parent, f"{tag} {mode}: decision files differ from the parent's"
        t1 = time.perf_counter()
        checks = shard_checks(f"{tag} {mode}", rec)
        del rec
        s1 = stats.get("stage1", {})
        lines[mode] = {
            "wall_s": wall, "level_wall_s": s1.get("level_wall_s", {}),
            "level_route": s1.get("level_route", {}),
            "stage2_level_wall_s": stats.get("stage2", {}).get("level_wall_s", {}),
            "launches": launches[mode], "dense_total_ms": dense_ms, "device_peak_bytes": peaks,
            **engine_memory(stats["engine_record"]),
            "files_equal_to_one_device": True, "sha256": sha,
            "sha256_equal_to_parent": parent is not None and sha == parent,
            "largest_per_shard": checks, "checks_wall_s": time.perf_counter() - t1,
        }
    return lines, launches


def mesh_cusk_runner(stem: str, blocks: str, dev: str = "cuda"):
    def run(mode, out, stats):
        cusk(stem + ".phen", stem, blocks, ALPHA, MAX_LEVEL, MAX_LEVEL_TWO, DEPTH, out, 0,
             verbose=False, stats=stats, mesh=mesh_of(dev, MESH_D), panel_mode=mode)
    return run


def mesh_cuskss_runner(kw: dict, dev: str = "cuda"):
    def run(mode, out, stats):
        cuskss(CuskssArgs.from_paths(outdir=out, **kw), verbose=False, stats=stats,
               mesh=mesh_of(dev, MESH_D), panel_mode=mode)
    return run


# one process of a gloo world of 2: its partition comes from the world
PARTITION_CHILD = """
import sys
import torch.distributed as dist
from cigwas_tpu_torch.parallel import init_distributed, process_partition, run_all_blocks
port, rank, phen, stem, blocks, alpha, max_level, max_level_two, depth, out, dev = sys.argv[1:]
init_distributed(f"127.0.0.1:{port}", 2, int(rank))
assert process_partition() == (2, int(rank)), process_partition()
run_all_blocks(phen, stem, blocks, float(alpha), int(max_level), int(max_level_two),
               int(depth), out, verbose=False, device=dev)
dist.barrier()
dist.destroy_process_group()
"""


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_children(argvs: list, timeout: int = 600) -> list:
    """Start every argv at once (the repo on PYTHONPATH), wait for all, fail
    on any non-zero exit; returns their standard outputs."""
    env = dict(os.environ, PYTHONPATH=os.path.dirname(os.path.abspath(__file__)))
    procs = [subprocess.Popen([sys.executable, *a], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, env=env) for a in argvs]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            assert p.returncode == 0, f"child {p.args[:4]} exit {p.returncode}: {err[-3000:]}"
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


def mesh_partitions(chr_dir: str, dev: str = "cuda") -> dict:
    """The 50,000-marker chromosome's blocks through two concurrent partition
    workers (`python -m cigwas_tpu_torch.parallel.distributed`, partitions 0
    and 1 on `dev`), then through two processes of a gloo world of 2 whose
    `run_all_blocks` takes its partition from the world: both merge to the
    one-process `cusk-all` files byte for byte (block files too)."""
    stem = os.path.join(chr_dir, "sim")
    blocks = f"{stem}_m{MAX_BLOCK}.blocks"
    one = block_files(os.path.join(chr_dir, "out"))
    block_names = [f for f in one if not f.startswith(("merged_blocks", "max_sep_min_pc"))]
    res = {}
    for tag in ("workers", "gloo_world"):
        out = os.path.join(chr_dir, f"out_{tag}")
        os.makedirs(out)
        t1 = time.perf_counter()
        if tag == "workers":
            lines = run_children([
                ["-m", "cigwas_tpu_torch.parallel.distributed", stem + ".phen", stem, blocks,
                 str(ALPHA), str(MAX_LEVEL), str(MAX_LEVEL_TWO), str(DEPTH), out, "2", str(p),
                 "--device", dev] for p in (0, 1)])
            walls = [json.loads(o.strip().splitlines()[-1])["wall_s"] for o in lines]
        else:
            port = free_port()
            run_children([["-c", PARTITION_CHILD, str(port), str(r), stem + ".phen", stem, blocks,
                           str(ALPHA), str(MAX_LEVEL), str(MAX_LEVEL_TWO), str(DEPTH), out, dev]
                          for r in (0, 1)])
            walls = None
        wall = time.perf_counter() - t1
        merge_block_outputs(blocks, out).write_mm(os.path.join(out, "merged_blocks"))
        got = block_files(out)
        differ = [f for f in block_names + list(MERGED_FILES) if got.get(f) != one[f]]
        assert not differ and set(block_names) <= set(got), f"{tag}: {differ} differ"
        res[tag] = {"wall_s": wall, "worker_walls_s": walls, "block_files": len(block_names),
                    "merged_equal_to_one_process": True}
    return res


def mesh_cli(tmp: str, dev: str = "cuda") -> dict:
    """The CLI with --mesh on the card: `cusk --mesh 1`, `cusk --mesh 0` and
    `cusk-all --mesh 1 --num-partitions 1 --partition-index 0` over the small
    block write its one-device files; `cuskss --mesh 1 --panel-mode
    rowsharded` over the fixture input writes the files of the same command
    without --mesh; `--mesh` past the visible cards exits non-zero with its
    message and writes nothing."""
    stem, blocks = os.path.join(tmp, "small", "sim"), os.path.join(tmp, "small", "sim.blocks")
    levels = [str(ALPHA), str(MAX_LEVEL), str(MAX_LEVEL_TWO), str(DEPTH)]
    small = [stem + ".phen", *levels, "{out}"]
    p = lambda name: os.path.join(FIXTURES, name)  # noqa: E731
    cuskss_argv = [
        "cuskss", "--mxm", p("small_mxm.bin"), "--mxp", p("marker_trait_summary_stats.txt"),
        "--pxp", p("trait_summary_stats.txt"), "--marker-indices", p("marker_indices.bin"),
        "--alpha", str(ALPHA), "--num-samples", "500000", "--max-level-one", "3",
        "--max-level-two", "1", "--max-depth", "1", "--outdir", "{out}"]
    runs = {
        "cusk --mesh 1": ["cusk", "0", blocks, stem, *small, "--mesh", "1"],
        "cusk --mesh 0": ["cusk", "0", blocks, stem, *small, "--mesh", "0"],
        "cusk-all --mesh 1 --partition-index 0": [
            "cusk-all", blocks, stem, *small, "--mesh", "1", "--num-partitions", "1",
            "--partition-index", "0"],
        "cuskss": cuskss_argv,
        "cuskss --mesh 1 --panel-mode rowsharded": cuskss_argv + [
            "--mesh", "1", "--panel-mode", "rowsharded"],
    }
    if dev == "cpu":  # every card: refused on the CPU
        del runs["cusk --mesh 0"]
    one = block_files(os.path.join(tmp, f"small_{dev}"))
    res, files = {}, {}
    for i, (name, argv) in enumerate(runs.items()):
        out = os.path.join(tmp, f"mesh_cli_{i}")
        os.makedirs(out)
        if name.startswith("cuskss"):  # the merged index map its reformat step reads
            n_ix = np.fromfile(p("marker_indices.bin"), dtype=np.int32).size
            np.arange(n_ix, dtype=np.int32).tofile(os.path.join(out, "merged_blocks.ixs"))
        cli_main([a.format(out=out) for a in argv] + ["--device", dev])
        files[name] = block_files(out)
        exp = files["cuskss"] if name.startswith("cuskss") else one
        differ = [f for f in exp if files[name].get(f) != exp[f]]
        assert files[name].keys() >= exp.keys() and not differ, (
            f"{name}: {differ} differ from the one-device run")
        res[name] = {"files": len(exp), "equal_to_one_device": True}
    too_many = torch.cuda.device_count() + 1 if dev == "cuda" else 0
    out = os.path.join(tmp, "mesh_cli_refused")
    os.makedirs(out)
    try:
        cli_main(["cusk", "0", blocks, stem, *small[:-1], out, "--mesh", str(too_many),
                  "--device", dev])
    except SystemExit as refused:
        assert refused.code not in (0, None) and str(refused.code).startswith(
            f"--mesh {too_many}"), refused.code
        res[f"cusk --mesh {too_many}"] = {"refused": str(refused.code)}
    else:
        raise AssertionError(f"--mesh {too_many} ran on {torch.cuda.device_count()} card(s)")
    assert not os.listdir(out)
    return res


def mesh_make_blocks(chr_dir: str, dev: str = "cuda") -> dict:
    """`make_blocks(mesh=[card] * MESH_D)` over the 50,000-marker chromosome
    writes the one-device `block` command's `.blocks` bytes."""
    stem = os.path.join(chr_dir, "sim")
    one = open(f"{stem}_m{MAX_BLOCK}.blocks", "rb").read()
    out = os.path.join(chr_dir, "mesh.blocks")
    t1 = time.perf_counter()
    make_blocks(stem, MAX_BLOCK, CORR_WIDTH, out_path=out, verbose=False,
                mesh=mesh_of(dev, MESH_D))
    wall = time.perf_counter() - t1
    assert open(out, "rb").read() == one, "the mesh's .blocks differ from one device's"
    return {"wall_s": wall, "blocks_equal_to_one_device": True, "shards": MESH_D}


def phase_mesh(tmp: str, ss_kw: dict, chr_dir: str) -> dict:
    """The multi-device engines over MESH_D (and 2, 3) shards of the one
    card: the small block, the 11k block, the 10k summary-statistic input,
    the chromosome's block partitions in two processes, the CLI with --mesh
    and make_blocks over a mesh. Returns, per kernel entry, its launches
    under the `mesh_*` keys (and the dense entries' device time over them)."""
    t0 = time.perf_counter()
    emit("mesh_small", t0, shards=[2, 3], **mesh_small(tmp))

    t0 = time.perf_counter()
    b11k = os.path.join(tmp, "b11k")
    lines11, l11k = mesh_engine_runs(
        "11k", mesh_cusk_runner(os.path.join(b11k, "sim"), os.path.join(b11k, "sim.blocks")),
        os.path.join(tmp, "out11k"), f"1_0_{M11K - 1}", CUSK_FILES, PARENT_SHA256["cusk"])
    emit("mesh_11k", t0, shards=MESH_D, engines=lines11)

    t0 = time.perf_counter()
    lines10, l10k = mesh_engine_runs("ss", mesh_cuskss_runner(ss_kw), os.path.join(tmp, "out_ss"),
                                     f"1_0_{MSS - 1}", CUSKSS_FILES, PARENT_SHA256["cuskss"])
    emit("mesh_10k", t0, shards=MESH_D, engines=lines10)

    t0 = time.perf_counter()
    emit("mesh_partitions", t0, **mesh_partitions(chr_dir))
    t0 = time.perf_counter()
    emit("mesh_cli", t0, commands=mesh_cli(tmp))
    t0 = time.perf_counter()
    emit("mesh_make_blocks", t0, **mesh_make_blocks(chr_dir))

    of = {name: {**{f"launches_mesh_11k_{m}": l11k[m][name] for m in MESH_MODES},
                 **{f"launches_mesh_10k_{m}": l10k[m][name] for m in MESH_MODES}}
          for name in all_launches()}
    # the engines' level 1 takes the dense route at both inputs (the gates)
    for names, run in ((("dense_l1", "local_sweep_l2", "local_sweep_l3", "panel_gather"),
                        "11k"),
                       (("hetcor_dense_l1", "hetcor_sweep_l2", "hetcor_sweep_l3",
                         "panel_gather2"), "10k")):
        for name in names:
            assert all(of[name][f"launches_mesh_{run}_{m}"] > 0 for m in MESH_MODES), (
                name, of[name])
    for name, lines in (("dense_l1", lines11), ("hetcor_dense_l1", lines10)):
        for m in MESH_MODES:  # the device time of all its launches in the engine's run
            of[name][f"total_ms_mesh_{m}"] = lines[m]["dense_total_ms"][name]["total_ms"]
    return of


# --- the dense level-1 kernel and the routes of levels 1-3 ---------------------


def _global_load(op: str) -> bool:
    """A load from global memory (LDG; not LDGSTS, the copies into shared
    memory)."""
    return re.match(r"^LDG(\.|$)", op) is not None


def _shared_load(op: str) -> bool:
    """A load from shared memory (LDS; not LDSM)."""
    return re.match(r"^LDS(\.|$)", op) is not None


def _queue_branch(instrs: list, lo: int, hi: int) -> tuple:
    """(first, last) address of the queue branch inside hetcor's test loop
    [lo, hi]: the block that the branch after the loop's `__any_sync`
    (VOTE.ANY into a predicate) skips when no lane of the warp needs the
    full threshold."""
    body = [(a, t) for a, t in instrs if lo <= a <= hi]
    for i, (a, t) in enumerate(body):
        m = re.match(r"^VOTE\.ANY\s+(P\d+),", t)
        if not m:
            continue
        for b, u in body[i + 1:]:
            if re.search(r"\bBRA\b", u):
                j = re.match(rf"^@!{m.group(1)}\s+BRA\s+(?:\w+,\s*)?0x([0-9a-f]+)", u)
                if j and b < int(j.group(1), 16) <= hi + 0x10:
                    return b + 0x10, int(j.group(1), 16) - 0x10
                break
    raise AssertionError(f"no queue branch after a VOTE.ANY in the loop {lo:#x}-{hi:#x}")


def dense_loop(instrs: list, arrays: int, het: bool, ypl: int) -> dict:
    """The test loop of a dense kernel's SASS, which broadcasts by shuffle
    (SHFL) and reads the y side of its tests (`arrays` values each: R_sy,
    P_sy and, for hetcor, N_ys). dense_l1: the innermost such loop, over
    groups of live s, each y value loaded from global memory, the loads
    counting its tests; its static instruction count over its tests is the
    instructions per test. hetcor: the loop over one row's live s of a
    chunk (`ypl` tests a lane, the y values read from shared memory), whose
    only inner loop is the queue's evaluation loop (innermost, with
    MUFU.RSQ: 32 tests evaluated in full, one a lane, a pass). Its
    instructions are split by the path that runs them: the test path every
    pass takes (`instructions_per_test`, over its `ypl` tests), the queue
    branch a warp enters only where one of its tests needs the full
    threshold (`instructions_per_branch`, without the evaluation loop), and
    the evaluation loop's body (`instructions_per_evaluation`). Static
    counts: a conditional block inside a path counts in full."""
    # not the branches back from the out-of-line paths past the last EXIT
    # (a warp that diverged at a shuffle or a vote rejoins there), which
    # would pass for loops spanning everything between
    end = max(a for a, t in instrs if re.search(r"\bEXIT\b", t))
    loops = [(lo, hi) for lo, hi in _backward_loops(instrs) if hi < end]

    def ops_in(lo, hi):
        return [re.sub(r"^@!?U?P\d+\s+", "", t).split()[0] for a, t in instrs if lo <= a <= hi]

    def innermost(lo, hi):
        return not any(lo <= a and b <= hi and (a, b) != (lo, hi) for a, b in loops)

    evals = [(lo, hi) for lo, hi in loops if innermost(lo, hi)
             and any(o.startswith("MUFU.RSQ") for o in ops_in(lo, hi))] if het else []
    load = _shared_load if het else _global_load
    found = []
    for lo, hi in loops:
        inner = [(a, b) for a, b in loops if lo <= a and b <= hi and (a, b) != (lo, hi)]
        ops = ops_in(lo, hi)
        if (any(l not in evals for l in inner) or (het and not inner)
                or not any(o.startswith("SHFL") for o in ops)):
            continue
        inner_ops = [ops_in(a, b) for a, b in inner]
        loads = sum(load(o) for o in ops) - sum(load(o) for io in inner_ops for o in io)
        tests = ypl if het else loads // arrays
        if loads < arrays * ypl:
            continue
        entry = {"loads": loads, "loop_instructions": len(ops), "loop": f"{lo:#x}-{hi:#x}",
                 "tests_per_pass": tests}
        if het:
            b0, b1 = _queue_branch(instrs, lo, hi)
            branch = len(ops_in(b0, b1))
            entry.update(
                queue_branch=f"{b0:#x}-{b1:#x}",
                instructions_per_test=(len(ops) - branch) / tests,
                instructions_per_branch=branch - sum(
                    len(io) for (a, b), io in zip(inner, inner_ops) if b0 <= a and b <= b1),
                instructions_per_evaluation=max(len(io) for io in inner_ops))
        else:
            entry["instructions_per_test"] = len(ops) / tests
        found.append(entry)
    assert found, ("no test loop found in the dense kernel's SASS", [
        (f"{lo:#x}-{hi:#x}", sorted(set(ops_in(lo, hi)))[:40]) for lo, hi in loops])
    # the loop with the most tests a pass (dense_l1 has one for the last few
    # live s of 32) and, of the copies the kernel has (segments inside and
    # across the y slab's end; a warp's rows), the shortest
    return max(found, key=lambda f: (f["tests_per_pass"], -f["instructions_per_test"]))


def dense_loops(lib) -> dict:
    """{entry: dense_loop} of the two kernels of csrc/dense_l1.cu."""
    fns = sass_functions(sass_of(lib))
    out = {}
    for entry, pattern, arrays in (("dense_l1", r"\ddense_l1_kernelE", 2),
                                   ("hetcor_dense_l1", r"\dhetcor_dense_l1_kernelE", 3)):
        (name,) = [n for n in fns if re.search(pattern, n)]
        out[entry] = {"function": name, **dense_loop(fns[name], arrays,
                                                     entry == "hetcor_dense_l1", 2)}
    return out


def dense_issue(tests: int, paths: dict, loop: dict, clock_hz: float) -> dict:
    """issue_bound of a dense launch, each path at the instructions it runs:
    every counted test at the test path's instructions per test; for hetcor
    also each entry of a warp into the queue branch (32 lanes) and each test
    evaluated in full (one lane), as `hetcor_paths` counts them."""
    per_branch = loop.get("instructions_per_branch", 0)
    per_eval = loop.get("instructions_per_evaluation", 0)
    instr = (tests * loop["instructions_per_test"] + 32 * per_branch * paths.get(
        "branch_entries", 0) + per_eval * paths.get("full_tests", 0))
    return {"issue_ms": instr / (SMS * 128 * clock_hz) * 1e3,
            **{k: v for k, v in loop.items() if k.startswith("instructions_per_")},
            "loop_instructions": loop["loop_instructions"],
            "tests_per_pass": loop["tests_per_pass"], "sm_clock_mhz": clock_hz / 1e6}


def hetcor_paths(args: tuple) -> dict:
    """Where the counted tests of a hetcor_dense_l1 launch go in the kernel,
    counted on the card from its inputs: a test whose ESS sums (x, y) + (x,
    s) + (y, s) equal those of the triple (N_xy, N_xy, N_xy) takes the
    threshold computed once per (x, y); the others (`full_tests`, within the
    time index and s != y) are evaluated in full, and each warp's pass over
    one s of its row and its 64 y (a CTA's columns) that holds one of them
    enters the queue branch once (`branch_entries`)."""
    C_x, N_x, NT_y, t_ix, x0, y0 = args[0], args[4], args[7], args[8], args[9], args[10]
    nx, vp = C_x.shape
    ny = NT_y.shape[1]
    dev = C_x.device
    cols = dk.CTA_COLS["hetcor_dense_l1"]
    nseg = -(-ny // cols)
    yg = y0 + torch.arange(ny, device=dev)
    t = t_ix.long()
    nxy = N_x[:, y0 : y0 + ny]
    exy, ecy = torch.nan_to_num(nxy), (~torch.isnan(nxy)).float()
    totc, cntc = (exy + exy) + exy, (ecy + ecy) + ecy
    t_pair = torch.maximum(t[x0 : x0 + nx, None], t[yg][None, :])
    full = torch.zeros((), dtype=torch.int64, device=dev)
    entries = torch.zeros((), dtype=torch.int64, device=dev)
    for i in range(nx):
        live = args[3][i].clone()
        live[x0 + i] = False  # x's neighbours other than x
        s = torch.nonzero(live).flatten()
        nys = NT_y[s]
        exs = torch.nan_to_num(N_x[i, s])[:, None]
        ecs = (~torch.isnan(N_x[i, s])).float()[:, None]
        tot = (exy[i] + exs) + torch.nan_to_num(nys)
        cnt = (ecy[i] + ecs) + (~torch.isnan(nys)).float()
        need = (~((tot == totc[i]) & (cnt == cntc[i])) & (s[:, None] != yg[None, :])
                & ~(t[s][:, None] > t_pair[i][None, :]))
        full += need.sum()
        pad = torch.nn.functional.pad(need, (0, nseg * cols - ny))
        entries += pad.view(-1, nseg, cols).any(-1).sum()
    return {"full_tests": int(full), "branch_entries": int(entries)}


def dense_bound(name: str, args: tuple) -> dict:
    """Bound of a dense launch from its real slabs: each x row meets every y
    of the y slab once for each of its live s (a neighbour, not x; s == y
    skipped), which is what the kernel evaluates. Bytes: each entry the
    kernel reads, once. Every mask byte of the x rows; C_xy (and N_xy) of
    the slab's pairs; R_xs, P_xs (and N_xs) of each live (x, s); the y
    columns of R and P (and N) in the rows of the s live for any x row of
    the slab, but (s, y) with s == y; for hetcor the time index of the x
    rows, the y and those s. The (nx, ny) outputs written once."""
    nx, ny, x0, y0 = dense_slab(name, args)
    G_x, vp = args[3], args[0].shape[1]
    dev = G_x.device
    s_ix = torch.arange(vp, device=dev)
    x_ix = x0 + torch.arange(nx, device=dev)
    live = G_x & (s_ix[None, :] != x_ix[:, None])
    n_live = int(live.sum())
    tests = n_live * ny - int(live[:, y0 : y0 + ny].sum())
    used = live.any(dim=0)  # the s some x row of the slab reads
    y_rows = int(used.sum()) * ny - int(used[y0 : y0 + ny].sum())
    het = name == "hetcor_dense_l1"
    n_in = nx * vp + (4 + 4 * het) * nx * ny + (8 + 4 * het) * n_live + (8 + 4 * het) * y_rows
    if het:
        t_read = used.clone()
        t_read[x0 : x0 + nx] = True
        t_read[y0 : y0 + ny] = True
        n_in += 4 * int(t_read.sum())
    n_out = nx * ny * (4 if het else 8)
    return {**bound(n_in + n_out, tests * DENSE_OPS[name]), "tests": tests,
            "live_s": int(used.sum())}


def dense_check(tag: str, name: str, args: tuple) -> dict:
    """One dense launch against its plain version on the same tensors:
    bitwise equal (rho and s, or the margins); returns its shape, max error
    and the plain version's device milliseconds in that one call."""
    kern, plain = getattr(dk, name), DENSE_PLAIN[name]
    want, plain_ms = once_ms(lambda: plain(*args))
    if name == "dense_l1":
        err = compare_bits(tag, kern(*args), want)
    else:
        err = compare_margin(tag, kern(*args), want)[1]
    nx, ny, x0, y0 = dense_slab(name, args)
    return {"x_rows": nx, "y_rows": ny, "x0": x0, "y0": y0, "panel": int(args[0].shape[1]),
            "bit_identical": True, "max_abs_err": err, "plain_ms": plain_ms}


def dense_timed(tag: str, name: str, args: tuple, loops: dict, clock_hz: float) -> dict:
    """dense_check, then the launch timed by CUDA events beside its plain
    version (and as GatedTimer times a launch of a run: `gated_ms`), its
    bound and its issue bound; for hetcor with the paths its tests take
    (`hetcor_paths`) beside the tests that count."""
    kern = getattr(dk, name)
    out = dense_check(tag, name, args)
    bnd = dense_bound(name, args)
    paths = hetcor_paths(args) if name == "hetcor_dense_l1" else {}
    return {**out, "ms": cuda_ms(lambda: kern(*args), reps=5),
            "gated_ms": GatedTimer.one_ms(name, args), **bnd, **paths,
            **dense_issue(bnd["tests"], paths, loops[name], clock_hz),
            "plan": dk.plan(name, out["x_rows"], out["y_rows"], out["panel"])}


def dense_args(name: str, C, G, x0: int, x1: int, y0: int, y1: int, N=None, t_ix=None,
               th: float = 0.0) -> tuple:
    """The arguments of a dense launch over rows [x0, x1) x columns [y0, y1)
    of a whole panel on the card."""
    R, P = dk.factors(C)
    xs = (C[x0:x1], R[x0:x1], P[x0:x1], G[x0:x1])
    ys = (R[:, y0:y1].contiguous(), P[:, y0:y1].contiguous())
    if name == "dense_l1":
        return (*xs, *ys, x0, y0)
    return (*xs, N[x0:x1], *ys, N[y0:y1].T.contiguous(), t_ix, x0, y0, th)


def live_histogram(G_x, x0: int) -> dict:
    """How the live s of a dense launch's x slab are shared: for each s, the
    rows of the slab it is live in (a neighbour, not the row itself), as a
    histogram of s and of (x, s) pairs (tests per y) by that row count;
    the distance |s - x| of the pairs whose s is live in one row against
    more, and of the rows that share an s with fewer than 9 rows from the
    first of them; for groups of 8 to 256 consecutive rows (a CTA's rows,
    as the kernels have them or might), the pairs per distinct s of a
    group: how often a y segment copied once per CTA would be read."""
    nx, vp = G_x.shape
    dev = G_x.device
    live = G_x & (torch.arange(vp, device=dev)[None, :]
                  != (x0 + torch.arange(nx, device=dev))[:, None])
    rows = live.sum(0)
    edges = [1, 2, 3, 5, 9, 17, 33, 65, 129, max(nx, 129) + 1]
    bins = []
    for lo, hi in zip(edges, edges[1:]):
        sel = (rows >= lo) & (rows < hi)
        bins.append({"rows": f"{lo}-{hi - 1}", "s": int(sel.sum()), "pairs": int(rows[sel].sum())})
    xi, si = torch.nonzero(live, as_tuple=True)
    dist = (si - (x0 + xi)).abs().float()
    alone = rows[si] == 1
    q = torch.tensor([0.5, 0.9, 0.99], device=dev)

    def quantiles(d):
        return [float(v) for v in torch.quantile(d, q)] if d.numel() else []

    # rows sharing a far s: their spread from the first row that has it
    few = (rows[si] >= 2) & (rows[si] <= 8)
    first = torch.full((vp,), nx, dtype=torch.long, device=dev).scatter_reduce(
        0, si, xi, reduce="amin")
    spread = (xi - first[si])[few].float()
    reuse = {}
    for group in (8, 32, 64, 128, 256):
        distinct = sum(int(live[g0 : g0 + group].any(0).sum()) for g0 in range(0, nx, group))
        reuse[group] = {"distinct_s_summed_over_groups": distinct,
                        "pairs_per_distinct_s": int(live.sum()) / max(distinct, 1)}
    return {"x_rows": nx, "panel": vp, "live_s": int((rows > 0).sum()), "pairs": int(live.sum()),
            "rows_per_s": bins,
            "distance_of_pairs_quantiles_0.5_0.9_0.99": {
                "s_in_one_row": quantiles(dist[alone]), "s_in_more_rows": quantiles(dist[~alone])},
            "rows_from_first_sharing_row_quantiles_s_in_2_to_8_rows": quantiles(spread),
            "by_group_rows": reuse}


def straddling_ties(Gd):
    """An adjacency over the 1024-variable tied panels whose ties cross rows:
    rows 0 .. 255 in pairs (x, x + 1), x even, with personal variables w =
    64 + x % 32 and w' = 64 + (x + 1) % 32; x has copies 0 and 1 of w and
    copy 2 of w', x + 1 copies 2 and 3 of w' and copy 1 of w. Copies 1 and 2
    are live in both rows of a pair (one warp brings their y values in, the
    other reads them again), copies 0 and 3 in one. Where w minimises rho
    for x, copy 0 must win over copy 1; where w' does for x + 1, copy 2 over
    copy 3."""
    G = torch.zeros((1024, 1024), dtype=torch.bool, device=Gd.device)
    for x in range(0, 256, 2):
        w, w2 = 64 + x % 32, 64 + (x + 1) % 32
        G[x, [4 * w, 4 * w + 1, 4 * w2 + 2]] = True
        G[x + 1, [4 * w2 + 2, 4 * w2 + 3, 4 * w + 1]] = True
    return G


def edge_ess(Nd, gen):
    """The ESS panel with the entries a threshold must survive: 1% +inf, 1%
    -inf, 3% in [0, 6) (mean - 4 <= 0 where they weigh), and rows 0 .. 63
    wholly in [2, 10)."""
    N = Nd.clone()
    u = torch.rand(N.shape, generator=gen, device=N.device)
    N[u < 0.01] = math.inf
    N[(u >= 0.01) & (u < 0.02)] = -math.inf
    small = (u >= 0.02) & (u < 0.05)
    N[small] = 6.0 * torch.rand(N.shape, generator=gen, device=N.device)[small]
    N[:64] = 2.0 + 8.0 * torch.rand((64, N.shape[1]), generator=gen, device=N.device)
    return N


def phase_dense_kernel(panels, loops: dict, clock_hz: float) -> dict:
    """dense_l1 and hetcor_dense_l1 vs plain, bitwise, on the 8192-variable
    panels with NaNs (made symmetric, then one row perturbed so that C[s, y]
    != C[y, s] there: the kernel must read the entries the list route
    reads), a time index in {0, 1, 2}, under an adjacency of an LD band
    (|x - s| <= 60) plus 0.2% scattered edges: x slabs of 256 rows against
    every y, ragged slabs (100 x 2,000 at an offset, 333 x 6,924, the last
    77 rows), ring-sized slabs of both ring widths (256 x 2,048, 3,072 and
    2,528 against other columns), both ESS modes for hetcor; a slab under
    the band alone (s shared by many rows) and under the scattered edges
    alone (s held by one or two); hetcor with +-inf ESS entries, entries
    that make mean - 4 <= 0, rows of small ESS and a time index in 0 .. 5;
    panels of repeated variables, where tied minima must resolve to the
    smallest s, with ties across rows that share a copy and rows that hold
    one alone. Then the 256 x 8192 launch of each entry timed beside its
    plain version and its bounds."""
    t0 = time.perf_counter()
    rng, vp, Cd, Nd, td = panels
    Cd = Cd.clone()
    Cd[100] = Cd[100] * 0.999  # row 100 no longer equals column 100
    ix = torch.arange(vp, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(3)
    band = ((ix[:, None] - ix[None, :]).abs() <= 60) & (ix[:, None] != ix[None, :])
    far = torch.rand((vp, vp), generator=gen, device="cuda") < 0.002
    far = (far | far.T) & (ix[:, None] != ix[None, :])
    G = band | far
    th = hetcor_threshold(ALPHA)
    N_mode = {"float": Nd, "reference": pcorr.trunc_ref_ess(Nd)}
    slabs = [(0, 256, 0, vp), (5000, 5100, 1234, 3234), (13, 346, 77, 7001), (vp - 77, vp, 0, vp),
             (2048, 2304, 6144, 8192), (2048, 2304, 4096, 7168), (2048, 2304, 1000, 3528)]
    checked = []

    def both(tag, Gc, x0, x1, y0, y1, modes=N_mode, C=Cd, t_ix=td):
        checked.append(dense_check(f"dense_l1 {tag} {x0}:{x1} x {y0}:{y1}", "dense_l1",
                                   dense_args("dense_l1", C, Gc, x0, x1, y0, y1)))
        for mode, N in modes.items():
            checked.append(dense_check(
                f"hetcor_dense_l1 {tag} {mode} {x0}:{x1} x {y0}:{y1}", "hetcor_dense_l1",
                dense_args("hetcor_dense_l1", C, Gc, x0, x1, y0, y1, N, t_ix, th)))

    for x0, x1, y0, y1 in slabs:
        both("band+far", G, x0, x1, y0, y1)
    both("band only", band, 0, 256, 0, vp)
    both("far only", far, 0, 256, 0, vp)
    both("edge ESS", G, 0, 256, 0, vp, modes={"float": edge_ess(Nd, gen)})
    both("edge ESS, time index 0..5", G, 4000, 4256, 0, vp, modes={"float": edge_ess(Nd, gen)},
         t_ix=torch.randint(0, 6, (vp,), generator=gen, device="cuda", dtype=torch.int32))
    Ct, Nt, tt = tied_panels(Cd, Nd, td)
    both("ties", G[:1024, :1024], 0, 256, 0, 1024, modes={"float": Nt}, C=Ct, t_ix=tt)
    rho, _ = dk.dense_l1(*dense_args("dense_l1", Ct, G[:1024, :1024], 0, 256, 0, 1024))
    assert bool((rho < pcorr.RHO_BIG).any()), "the tied panels gave no valid test"
    Gs = straddling_ties(G)
    both("ties across rows", Gs, 0, 256, 0, 1024, modes={"float": Nt}, C=Ct, t_ix=tt)
    _, s_k = dk.dense_l1(*dense_args("dense_l1", Ct, Gs, 0, 256, 0, 1024))
    x = torch.arange(256, device="cuda")[:, None]
    copy, w = s_k % 4, s_k // 4
    won_own = int(((x % 2 == 0) & (copy == 0) & (w == 64 + x % 32)).sum())
    won_shared = int(((x % 2 == 1) & (copy == 2) & (w == 64 + x % 32)).sum())
    assert won_own > 0 and won_shared > 0, (won_own, won_shared)
    timed = {name: dense_timed(f"{name} 256 x {vp}", name, dense_args(
        name, Cd, G, 0, 256, 0, vp, Nd, td, th), loops, clock_hz) for name in DENSE}
    emit("kernels_dense_l1", t0, cases=len(checked), bit_identical=True,
         max_abs_err=max(c["max_abs_err"] for c in checked),
         ties_across_rows={"own_copy_won": won_own, "shared_copy_won": won_shared},
         histogram_256_rows=live_histogram(G[:256], 0),
         timed=timed)
    return timed


class GatedTimer:
    """While it is open, every launch of the wrapped kernel entries on the
    card is timed by CUDA events around its wrapper's call (for the dense
    entries hetcor's memset, the pre-pass and the sweep; for the sweep the
    level-3 order's sort and the launch), so that a run gives each entry's
    device time over all its launches. A spin kernel of GATE_CYCLES clocks
    goes on the stream before the first event: the card spins while the host
    makes the call (the scratch allocations, the ctypes call, the launches),
    so the events span the work on the card and not the host's gaps
    (`gated_ms` of a largest launch, beside its `ms` back to back, shows
    that they do). The spins themselves fall outside the events. Open it
    before other wrappers of the entries, so that it times the call alone.
    By default the dense entries of `dk` by name; `sweeps()` the levels of
    the local sweep that the skeleton calls (`cupc.local_sweep`)."""

    GATE_CYCLES = 1_000_000  # ~0.5 ms at 1980 MHz

    @staticmethod
    def one_ms(name: str, args: tuple, reps: int = 5) -> float:
        """The mean over reps single launches of a dense entry timed as the
        open timer times each launch of a run."""
        with GatedTimer() as timer:
            for _ in range(reps):
                getattr(dk, name)(*args)
        return timer.totals()[name]["total_ms"] / reps

    @classmethod
    def sweeps(cls):
        return cls(cupc, ("local_sweep",), lambda name, args: f"local_sweep_l{args[4]}")

    def __init__(self, owner=dk, names: tuple = DENSE, key=None):
        self.owner, self.names = owner, names
        self.key = key or (lambda name, args: name)
        self.events: dict = {}
        self.saved = {n: getattr(owner, n) for n in names}

    def __enter__(self):
        def timed(name):
            kern = self.saved[name]

            def run(*args, **kw):
                if not args[0].is_cuda:
                    return kern(*args, **kw)
                a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                torch.cuda._sleep(self.GATE_CYCLES)
                a.record()
                out = kern(*args, **kw)
                b.record()
                self.events.setdefault(self.key(name, args), []).append((a, b))
                return out
            return run

        for n in self.names:
            setattr(self.owner, n, timed(n))
        return self

    def __exit__(self, *exc):
        for n, fn in self.saved.items():
            setattr(self.owner, n, fn)

    def totals(self) -> dict:
        torch.cuda.synchronize()
        return {k: {"total_ms": sum(a.elapsed_time(b) for a, b in ev), "timed_launches": len(ev)}
                for k, ev in sorted(self.events.items())}


class HitRecorder:
    """While it is open, keeps the hits of every levels 1-3 launch, by panel
    size and level: the ordered pairs (x, y) that a launch
    condemns from x's side and their statistic (|rho| below tanh(Th[l]), or
    a negative hetcor margin), as the list route's sweeps, the device loop's
    launches and the dense route's slabs find them. Two routes that decide
    alike give the same pairs; rho or margins bitwise equal say that no
    test's value depends on the route or the launch width."""

    def __init__(self, rho_th: dict):
        self.rho_th = rho_th
        self.hits: dict = {}
        self.saved = {n: getattr(cupc, n) for n in ("local_sweep", "hetcor_local_sweep")}
        self.saved_dense = {n: getattr(dk, n) for n in DENSE}

    def _add(self, vp: int, l: int, x, y, stat) -> None:
        self.hits.setdefault(vp, {}).setdefault(l, []).append((x.long() * vp + y.long(), stat))

    def __enter__(self):
        saved, dense = self.saved, self.saved_dense

        def local_sweep(C, node_ixs, nbrs, deg, l, **kw):
            rho, pos = saved["local_sweep"](C, node_ixs, nbrs, deg, l, **kw)
            i, j = torch.nonzero(cupc._hit_mask(rho, self.rho_th[l], deg), as_tuple=True)
            self._add(C.shape[0], l, node_ixs[i], nbrs[i, j], rho[i, j])
            return rho, pos

        def hetcor_local_sweep(C, N, t_ix, node_ixs, nbrs, deg, th, l, **kw):
            m = saved["hetcor_local_sweep"](C, N, t_ix, node_ixs, nbrs, deg, th, l, **kw)
            i, j = torch.nonzero(cupc._hit_mask(m, 0.0, deg), as_tuple=True)
            self._add(C.shape[0], l, node_ixs[i], nbrs[i, j], m[i, j])
            return m

        def dense_l1(*args):
            rho, s = dense["dense_l1"](*args)
            nx, ny, x0, y0 = dense_slab("dense_l1", args)
            xs, ys, _, r = pcorr.dense1_hits(rho, s, args[3][:, y0 : y0 + ny], x0, y0,
                                             self.rho_th[1])
            self._add(args[0].shape[1], 1, xs, ys, r)
            return rho, s

        def hetcor_dense_l1(*args):
            m = dense["hetcor_dense_l1"](*args)
            nx, ny, x0, y0 = dense_slab("hetcor_dense_l1", args)
            xs, ys = pcorr.hetcor1_hits(m, args[3][:, y0 : y0 + ny], x0, y0)
            self._add(args[0].shape[1], 1, xs, ys, m[xs - x0, ys - y0])
            return m

        cupc.local_sweep, cupc.hetcor_local_sweep = local_sweep, hetcor_local_sweep
        dk.dense_l1, dk.hetcor_dense_l1 = dense_l1, hetcor_dense_l1
        return self

    def __exit__(self, *exc):
        for n, fn in self.saved.items():
            setattr(cupc, n, fn)
        for n, fn in self.saved_dense.items():
            setattr(dk, n, fn)

    def by_level(self) -> dict:
        """{level: (pair keys ascending, their statistics)} on the host, of
        the widest panel's launches (stage 1's)."""
        out = {}
        for l, parts in self.hits.get(max(self.hits, default=0), {}).items():
            keys = torch.cat([k.cpu() for k, _ in parts]).numpy()
            stat = torch.cat([v.cpu() for _, v in parts]).numpy()
            order = np.argsort(keys, kind="stable")
            out[l] = (keys[order], stat[order])
        return out


def same_hits(tag: str, got: dict, ref: dict, levels) -> dict:
    """The hits of two routes at the given levels: the same pairs, their
    statistics bitwise equal; returns the pairs per level."""
    out = {}
    assert len(ref.get(1, ((),))[0]) > 0, f"{tag}: the reference route recorded no level-1 hit"
    for l in levels:
        (kg, vg), (kr, vr) = got.get(l, (np.empty(0),) * 2), ref.get(l, (np.empty(0),) * 2)
        assert np.array_equal(kg, kr), f"{tag} level {l}: {len(kg)} hit pairs against {len(kr)}"
        same = vg.astype(np.float32).view(np.int32) == vr.astype(np.float32).view(np.int32)
        if not same.all():
            k = int(np.argmin(same))
            raise AssertionError(f"{tag} level {l}: pair key {int(kg[k])} (x vp + y): "
                                 f"statistic {float(vg[k])!r} against {float(vr[k])!r}")
        out[l] = len(kg)
    return out


# the gate values that force each route (cupc's module attributes)
BIG = 1 << 60
ROUTES = {
    "list": {"DEV_RESIDENT_MAX": 0, "L1_LOCAL_MAX_WIDTH": BIG},
    "device_loop": {"DEV_RESIDENT_MAX": BIG, "L1_LOCAL_MAX_WIDTH": BIG},
    "dense": {"DEV_RESIDENT_MAX": 0, "L1_LOCAL_MAX_WIDTH": 0, "L1_LOCAL_COST_RATIO": BIG,
              "DENSE_L1_MAX": BIG},
    "combinatorial": {"DEV_RESIDENT_MAX": 0, "LOCAL_LEVELS": (), "L1_LOCAL_MAX_WIDTH": 0,
                      "L1_LOCAL_COST_RATIO": BIG, "DENSE_L1_MAX": 0},
}
# the stage-1 level routes each forced route must show
ROUTE_OF = {"list": "local", "device_loop": "device_loop", "dense": "dense",
            "combinatorial": "combinatorial"}


@contextlib.contextmanager
def gates(route: str):
    saved = {k: getattr(cupc, k) for k in ROUTES[route]}
    for k, v in ROUTES[route].items():
        setattr(cupc, k, v)
    try:
        yield
    finally:
        for k, v in saved.items():
            setattr(cupc, k, v)


def assert_routes(tag: str, route: str, stage1: dict) -> None:
    """Stage 1's levels 1-3 took the forced route (levels 2-3 of the dense
    one the list route); level 1 ran."""
    got = stage1.get("level_route", {})
    assert 1 in got, f"{tag} {route}: level 1 did not run"
    for l in (1, 2, 3):
        want = "local" if route == "dense" and l > 1 else ROUTE_OF[route]
        assert l not in got or got[l] == want, f"{tag} {route}: level {l} took {got[l]}"


def route_run(tag: str, route: str, run, out: str, one: dict, parent: dict | None,
              base: str, exts: tuple, rho_th: dict) -> tuple:
    """run(out, stats) under the route's gates, the launch counts set to 0
    just before it and read just after: the wall, per-level walls and routes
    of both stages, launches, the dense entries' device time over all their
    launches, the card's peak memory; every file equal to
    the default route's run in `one` (the .corr files too), the decision
    files' sha256 equal to `parent` where given. Returns (its line, its
    hits by level, its Recorder)."""
    os.makedirs(out)
    stats: dict = {}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with gates(route), GatedTimer() as timer, Recorder() as rec, HitRecorder(rho_th) as hits:
        reset_all_launches()
        t1 = time.perf_counter()
        run(out, stats)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        launches = all_launches()
    got = block_files(out)
    differ = [f for f in one if got.get(f) != one[f]]
    assert got.keys() == one.keys() and not differ, f"{tag} {route}: {differ} differ"
    sha = file_hashes(os.path.join(out, base), exts)
    if parent is not None:
        assert sha == parent, f"{tag} {route}: decision files differ from the parent's"
    s1, s2 = stats.get("stage1", {}), stats.get("stage2", {})
    line = {"wall_s": wall, "level_wall_s": s1.get("level_wall_s", {}),
            "level_route": s1.get("level_route", {}), **gate_inputs(s1),
            "stage2_level_wall_s": s2.get("level_wall_s", {}),
            "final_fetch_s": s1.get("final_fetch_s"), "launches": launches,
            "dense_total_ms": timer.totals(),
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30,
            "files_equal_to_default": True, "sha256": sha,
            "sha256_equal_to_parent": parent is not None and sha == parent}
    return line, hits.by_level(), rec


def gate_inputs(stage1: dict) -> dict:
    """What the gates of a stage-1 run read: each level's widths (the
    device loop's one width, or the list route's bucket widths) and, for a
    list-route level 1, the bucketed sum(d_pad^2) slots that
    `cupc._l1_route_local` weighs against vp^3."""
    launches = stage1.get("launches", {})
    out = {"widths": {l: sorted({d for d, _ in v}) for l, v in launches.items()}}
    if 1 in launches and stage1.get("level_route", {}).get(1) == "local":
        out["l1_slots"] = int(sum(n * d * d for d, n in launches[1]))
    return out


def routes_11k(tmp: str, rho_th: dict) -> tuple:
    """The 11k block through cusk by the list route, the device-resident
    loop and the dense level 1: every file equal to the default run's, the
    decision files' sha256 equal to the parent's, the stage-1 hits of every
    level 1-3 of the loop and of level 1 of the dense route bitwise equal
    to the list route's. Returns (the lines, {route: its Recorder})."""
    b11k = os.path.join(tmp, "b11k")
    stem, blocks = os.path.join(b11k, "sim"), os.path.join(b11k, "sim.blocks")
    one = block_files(os.path.join(tmp, "out11k"))

    def run(out, stats):
        cusk(stem + ".phen", stem, blocks, ALPHA, MAX_LEVEL, MAX_LEVEL_TWO, DEPTH, out, 0,
             verbose=False, device="cuda", stats=stats)

    t0 = time.perf_counter()
    lines, hits, recs = {}, {}, {}
    for route in ("list", "device_loop", "dense"):
        lines[route], hits[route], recs[route] = route_run(
            "11k", route, run, os.path.join(tmp, f"routes11k_{route}"), one,
            PARENT_SHA256["cusk"], f"1_0_{M11K - 1}", CUSK_FILES, rho_th)
    emit("routes_11k", t0, routes=lines)  # before the checks, so that a failure has its walls
    for route in lines:
        assert_routes("11k", route, lines[route])
    emit("routes_11k_hits", t0, device_loop_equal_to_list=same_hits(
        "11k device loop", hits["device_loop"], hits["list"], (1, 2, 3)),
        dense_equal_to_list=same_hits("11k dense", hits["dense"], hits["list"], (1,)))
    return lines, recs


def routes_10k(tmp: str, ss_kw: dict) -> tuple:
    """The 10k summary-statistic input through cuskss by the list route and
    the dense level 1: files equal to the default run's, sha256 equal to the
    parent's, level-1 hits (margins < 0) bitwise equal. Returns (the lines,
    {route: its Recorder})."""
    one = block_files(os.path.join(tmp, "out_ss"))

    def run(out, stats):
        cuskss(CuskssArgs.from_paths(outdir=out, **ss_kw), verbose=False, device="cuda",
               stats=stats)

    t0 = time.perf_counter()
    lines, hits, recs = {}, {}, {}
    for route in ("list", "dense"):
        lines[route], hits[route], recs[route] = route_run(
            "10k", route, run, os.path.join(tmp, f"routes10k_{route}"), one,
            PARENT_SHA256["cuskss"], f"1_0_{MSS - 1}", CUSKSS_FILES, {})
    emit("routes_10k", t0, routes=lines)
    for route in lines:
        assert_routes("10k", route, lines[route])
    emit("routes_10k_hits", t0, dense_equal_to_list=same_hits(
        "10k dense", hits["dense"], hits["list"], (1,)))
    return lines, recs


def routes_small(tmp: str) -> dict:
    """The 1,500-marker block of `phase_small_reference` through every route
    (list, device loop, dense level 1, combinatorial levels 1-3) on the card
    and on the CPU, every launch on the card held bitwise to plain: every
    file equal to that device's default run. Walls per route and device."""
    stem, blocks = os.path.join(tmp, "small", "sim"), os.path.join(tmp, "small", "sim.blocks")
    out = {}
    for dev in ("cuda", "cpu"):
        one = block_files(os.path.join(tmp, f"small_{dev}"))
        for route in ROUTES:
            d = os.path.join(tmp, f"routes_small_{dev}_{route}")
            os.makedirs(d)
            stats: dict = {}
            with gates(route), EveryLaunchChecked() as chk:
                t1 = time.perf_counter()
                cusk(stem + ".phen", stem, blocks, ALPHA, MAX_LEVEL, MAX_LEVEL_TWO, DEPTH, d, 0,
                     verbose=False, device=dev, stats=stats)
                sync(dev)
                wall = time.perf_counter() - t1
            got = block_files(d)
            differ = [f for f in one if got.get(f) != one[f]]
            assert got.keys() == one.keys() and not differ, (dev, route, differ)
            assert_routes(f"small {dev}", route, stats["stage1"])
            out[f"{dev}_{route}"] = {
                "wall_s": wall, "level_wall_s": stats["stage1"].get("level_wall_s", {}),
                "level_route": stats["stage1"].get("level_route", {}),
                "launches_bit_identical": chk.checked, **gate_inputs(stats["stage1"])}
            if dev == "cuda":  # the checks above slow the card's run: once more, unchecked
                shutil.rmtree(d)
                os.makedirs(d)
                stats = {}
                with gates(route):
                    t1 = time.perf_counter()
                    cusk(stem + ".phen", stem, blocks, ALPHA, MAX_LEVEL, MAX_LEVEL_TWO, DEPTH,
                         d, 0, verbose=False, device=dev, stats=stats)
                    sync(dev)
                    out[f"{dev}_{route}"].update(
                        unchecked_wall_s=time.perf_counter() - t1,
                        unchecked_level_wall_s=stats["stage1"].get("level_wall_s", {}))
                assert block_files(d) == got, (dev, route)
    assert all(v["launches_bit_identical"] > 0 for k, v in out.items() if k.startswith("cuda"))
    return out


def routes_hetcor_wide(sizes: tuple = (16384, 24576), dev: str = "cuda") -> dict:
    """The hetcor skeleton on panels past the block loop's limit (12,288):
    an AR(1) 0.9 correlation panel with the sampling noise of a GWAS of
    4e5, ESS uniform in [3e5, 5e5], through levels 0-14 on one card (levels
    0-3 with the adjacency on the card) and through an engine over the same
    card (the adjacency on the host between launches): the same adjacency
    and final level; each path's wall, the card's peak memory, its level
    walls and routes, its host passes and fetched bytes."""
    th = hetcor_threshold(ALPHA)
    out = {}
    for v in sizes:
        gen = torch.Generator(device=dev).manual_seed(v)
        i = torch.arange(v, device=dev, dtype=torch.float32)
        noise = torch.randn((v, v), generator=gen, device=dev) / math.sqrt(2 * 4e5)
        C = 0.9 ** (i[:, None] - i[None, :]).abs() + noise + noise.T
        C.fill_diagonal_(1.0)
        N = 3e5 + 2e5 * torch.rand((v, v), generator=gen, device=dev)
        N = (N + N.T) / 2
        del noise, i
        runs, res = {}, {}
        for path, engine in (("one_card", None),
                             ("engine", sharded.ShardedEngine.flat(mesh_of(dev, 1)))):
            stats: dict = {}
            sync(dev)
            device_peak_reset(dev)
            t = time.perf_counter()
            res[path] = cupc.hetcor_skeleton(C, np.ones((v, v), np.int32), N, th, MAX_LEVEL_TWO,
                                             device=dev, stats=stats, engine=engine)
            sync(dev)
            runs[path] = {
                "wall_s": time.perf_counter() - t, "peak_gib": device_peak_gb(dev),
                "final_level": res[path].final_level, "device_levels": stats["device_levels"],
                "level_route": stats["level_route"], "l0_wall_s": stats["l0_wall_s"],
                "level_wall_s": stats["level_wall_s"], "host_pass_s": stats["host_pass_s"],
                "d2h_bytes": stats["d2h_bytes"], "ci_tests": stats.get("ci_tests", 0)}
            engine = None
        assert np.array_equal(res["one_card"].G, res["engine"].G), v
        assert res["one_card"].final_level == res["engine"].final_level, v
        assert runs["one_card"]["device_levels"][:2] == [0, 1], runs["one_card"]
        out[v] = {"edges": int(res["one_card"].G.sum()) // 2, **runs}
        del C, N
    return out


def routes_engines(tmp: str, ss_kw: dict) -> tuple:
    """Both engines over MESH_D shards of the card with the list route
    forced at level 1 (the mesh phase ran their default, the dense level
    1), the 11k block and the 10k input: files equal to the one-device
    run's, sha256 equal to the parent's, the bytes crossed between shards,
    each shard's largest launch of each kernel bitwise equal to plain.
    Returns (the lines, {run: launches})."""
    b11k = os.path.join(tmp, "b11k")
    lines, launches = {}, {}
    with gates("list"):
        for tag, run, one_dir, base, exts, parent in (
                ("11k", mesh_cusk_runner(os.path.join(b11k, "sim"),
                                         os.path.join(b11k, "sim.blocks")),
                 os.path.join(tmp, "out11k"), f"1_0_{M11K - 1}", CUSK_FILES,
                 PARENT_SHA256["cusk"]),
                ("ss", mesh_cuskss_runner(ss_kw), os.path.join(tmp, "out_ss"),
                 f"1_0_{MSS - 1}", CUSKSS_FILES, PARENT_SHA256["cuskss"])):
            got, l_of = mesh_engine_runs(f"routes_{tag}", run, one_dir, base, exts, parent)
            for mode in MESH_MODES:
                name = "local_sweep_l1" if tag == "11k" else "hetcor_sweep_l1"
                assert l_of[mode][name] > 0, (tag, mode, l_of[mode])
                assert got[mode]["level_route"].get(1) == "local", (tag, mode, got[mode])
                launches[f"{tag}_{mode}"] = l_of[mode]
            lines[tag] = got
    return lines, launches


def spmd_inputs(tmp: str, B: int, m: int):
    """B blocks of m consecutive markers of the 11k block's `.bed` as 2-bit
    codes (B, m, N11K) and its traits (B, P11K, N11K), on the card."""
    stem = os.path.join(tmp, "b11k", "sim")
    raw = np.fromfile(stem + ".bed", dtype=np.uint8, offset=3).reshape(M11K, N11K // 4)
    codes = corr_ops.unpack_bed_codes(torch.from_numpy(raw[: B * m]).cuda())
    phen = torch.from_numpy(load_phen(stem + ".phen").data).cuda()
    return (codes.reshape(B, m, N11K).to(torch.int32),
            phen[None].expand(B, -1, -1).contiguous())


def routes_spmd(tmp: str) -> dict:
    """build_multichip_cusk_step over 2 blocks x 2,048 markers of the 11k
    block x 16,384 individuals x 8 traits on a (block 2, marker 2, sample 2)
    mesh of the card: G equal to the same step on a (1, 1, 1) mesh; then 2
    blocks x 256 markers x 2,048 individuals, the (2, 2, 2) mesh of the card
    against that of the CPU: equal."""
    card = torch.device("cuda", 0)
    th = threshold_array(N11K, ALPHA)
    res = {}
    codes, phen = spmd_inputs(tmp, 2, 2048)
    Gs = {}
    for shape in ((2, 2, 2), (1, 1, 1)):
        mesh = make_mesh(math.prod(shape), *shape, devices=[card] * math.prod(shape))
        step = build_multichip_cusk_step(mesh, float(th[0]), float(th[1]))
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        Gs[shape] = step(codes, phen)
        torch.cuda.synchronize()
        res[f"wall_s_{'x'.join(map(str, shape))}"] = time.perf_counter() - t1
    G8, G1 = Gs[(2, 2, 2)], Gs[(1, 1, 1)]
    assert G8.shape == (2, 2056, 2056), G8.shape
    flips = int((G8 != G1).sum())
    assert flips == 0, f"{flips} adjacency entries differ between the (2,2,2) and (1,1,1) meshes"
    res.update(edges=int(G8.sum()) // 2, equal_to_one_device=True)
    th_small = threshold_array(2048, ALPHA)
    small = (codes[:, :256, :2048].contiguous(), phen[:, :, :2048].contiguous())
    Gd = {}
    for dev in (card, torch.device("cpu")):
        mesh = make_mesh(8, 2, 2, 2, devices=[dev] * 8)
        step = build_multichip_cusk_step(mesh, float(th_small[0]), float(th_small[1]))
        Gd[dev.type] = step(*(t.to(dev) for t in small)).cpu()
    assert torch.equal(Gd["cuda"], Gd["cpu"]), "the small step differs between cuda and cpu"
    res.update(small_edges=int(Gd["cpu"].sum()) // 2, small_cuda_equals_cpu=True)
    return res


def ring_slab(name: str, args: tuple) -> tuple:
    """A one-card launch's x slab (against every y) cut to the second of
    MESH_D stripes of its y columns: the slab pair a step of the
    row-sharded ring launches."""
    vp = args[0].shape[1]
    L = vp // MESH_D
    y = slice(L, 2 * L)
    if name == "dense_l1":
        return (*args[:4], args[4][:, y].contiguous(), args[5][:, y].contiguous(), args[6], L)
    return (*args[:5], *(a[:, y].contiguous() for a in args[5:8]), args[8], args[9], L,
            args[11])


def dense_entries(runs: dict, loops: dict, clock_hz: float, timed: dict) -> list:
    """The kernel line's entries of dense_l1 and hetcor_dense_l1 from their
    dense runs ({name: (Recorder, route_run line)}): the launches and the
    device time over all of them in that run; the largest launch (the 11k
    block's 256 x 12,288 slab, the 10k input's 256 x 10,112) held bitwise to
    plain and timed beside its bounds, its slab's live-s histogram; the
    row-sharded ring's slab of it (a quarter of the columns) likewise; the
    synthetic 256-row launch of phase_dense_kernel beside them."""
    kernels = []
    for name, (rec, run) in runs.items():
        args = rec.largest[(name,)][1]
        main = dense_timed(f"{name} largest", name, args, loops, clock_hz)
        nx, ny, x0, _ = dense_slab(name, args)
        more = {"plan": main["plan"], "tests": main["tests"],
                **{k: v for k, v in main.items() if k.startswith(("instructions_per_", "issue_"))
                   or k in ("full_tests", "branch_entries")},
                "gated_ms": main["gated_ms"], "total_ms": run["dense_total_ms"][name]["total_ms"],
                "total_launches": run["dense_total_ms"][name]["timed_launches"],
                "histogram": live_histogram(args[3], x0),
                "synthetic_256_rows": timed[name],
                "ring_slab": dense_timed(f"{name} ring", name, ring_slab(name, args),
                                         loops, clock_hz)}
        kernels.append(kernel_entry(
            name, dk, name, run["launches"][name], main["max_abs_err"], main["ms"],
            main["plain_ms"], main, None,
            {k: main[k] for k in ("x_rows", "y_rows", "x0", "y0", "panel", "live_s")}, **more))
    return kernels


def phase_routes(tmp: str, ss_kw: dict, rho_th: dict, loops: dict, clock_hz: float,
                 timed: dict) -> tuple:
    """Every route of levels 1-3 driven at full width and held to the
    default route (see routes_11k, routes_10k, routes_small, routes_engines,
    routes_spmd); then the kernel line's entries of dense_l1 and
    hetcor_dense_l1: their launches in the 11k / 10k runs by the dense
    route, the largest launch of each held bitwise to plain and timed beside
    its bounds, with the row-sharded engine's ring-sized launch beside it;
    and the list route's largest local_sweep (levels 1-3) and
    hetcor_local_sweep (level 1) launches at these inputs, where the
    default routes no longer launch them. Returns (the dense entries, the
    list route's entries by name)."""
    lines_11k, recs_11k = routes_11k(tmp, rho_th)
    lines_10k, recs_10k = routes_10k(tmp, ss_kw)
    t0 = time.perf_counter()
    emit("routes_small", t0, runs=routes_small(tmp))
    t0 = time.perf_counter()
    emit("routes_engines", t0, shards=MESH_D, engines=routes_engines(tmp, ss_kw)[0])
    t0 = time.perf_counter()
    emit("routes_spmd", t0, **routes_spmd(tmp))
    t0 = time.perf_counter()
    emit("routes_hetcor_wide", t0, panels=routes_hetcor_wide())

    t0 = time.perf_counter()
    kernels = dense_entries({"dense_l1": (recs_11k["dense"], lines_11k["dense"]),
                             "hetcor_dense_l1": (recs_10k["dense"], lines_10k["dense"])},
                            loops, clock_hz, timed)
    emit("largest_launch_dense", t0, kernels=kernels)

    t0 = time.perf_counter()
    listed = sweep_entries("11k list route", recs_11k["list"], lines_11k["list"]["launches"],
                           rho_th, loops, clock_hz)
    listed += hetcor_entries("10k list route", recs_10k["list"], lines_10k["list"]["launches"],
                             (1,), loops, clock_hz, [])
    emit("largest_launch_list_route", t0, kernels=listed)
    return kernels, {k["name"]: k for k in listed}


def profile_sweeps(tag: str, run, unprofiled_wall_s: float, prefix: str, launched: dict,
                   tries: int = 3) -> tuple:
    """profile_run of a slice and its sweep levels' level_totals, taken again
    (at most `tries` runs in all) while the profiler kept fewer records of a
    level's launches than `launched` ({level: launches of the first run}):
    torch.profiler drops some records of short launches (the slice's 8-node
    stage-2 sweeps), and a total must cover every launch."""
    for _ in range(tries):
        totals = profile_run(tag, run, unprofiled_wall_s)
        per_level = level_totals(totals, prefix)
        if all(per_level[l][1] == n for l, n in launched.items()):
            break
    return totals, per_level


def profile_run(tag: str, run, unprofiled_wall_s: float, cpu: bool = True) -> dict:
    """A second (warm) run of a slice under torch.profiler: device time by
    kernel name. The profiler slows the host, not the device, so the idle
    share is taken against the unprofiled run's wall. cpu=False records the
    device's activity alone, for runs long enough that the host's records
    would weigh on the run."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    activities = [ProfilerActivity.CPU] if cpu else []
    with profile(activities=activities + [ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    rows = sorted(((e.key, e.self_device_time_total) for e in events), key=lambda r: -r[1])
    busy_s = sum(us for _, us in rows) / 1e6
    # device time of all launches of each hand-written kernel on the slice
    totals = {e.key[:80]: {"total_ms": e.self_device_time_total / 1e3, "launches": e.count}
              for e in events
              if re.search(r"sweep\w*_kernel|panel_\w+_kernel|compact_rows_kernel|hetcor_scan_kernel",
                           e.key)}
    emit("profile_" + tag, t0, profiled_wall_s=wall, unprofiled_wall_s=unprofiled_wall_s,
         device_busy_s=busy_s, device_idle_share=1.0 - busy_s / unprofiled_wall_s,
         top=[{"name": k[:80], "ms": us / 1e3} for k, us in rows[:10]], kernel_totals=totals)
    return totals


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernels-only", action="store_true",
                    help="stop after the build and the kernel checks (prints no result line)")
    ap.add_argument("--kendall-panel-only", action="store_true",
                    help="build kendall_panel and run its checks alone (prints no result line)")
    ap.add_argument("--hetcor-scan-only", action="store_true",
                    help="build hetcor_scan and the gather and run the scan's checks alone "
                         "(prints no result line)")
    ap.add_argument("--routes-only", action="store_true",
                    help="after the kernel checks run only what the routes phase needs and "
                         "the routes phase (prints no result line)")
    opts = ap.parse_args()
    t0 = time.perf_counter()
    require_cuda()
    smi = nvidia_smi()
    emit("environment", t0, python=sys.version.split()[0], torch=torch.__version__,
         cuda=torch.version.cuda, device=torch.cuda.get_device_name(0),
         device_count=torch.cuda.device_count(), nvidia_smi=smi)

    if opts.kendall_panel_only:
        t0 = time.perf_counter()
        lib = build.build("kendall_panel")
        emit("build", t0, source="kendall_panel", library=lib.name,
             ptxas=ptxas_summary(lib.with_suffix(".log").read_text()))
        phase_kendall_panel()
        return 1
    if opts.hetcor_scan_only:
        t0 = time.perf_counter()
        for name in ("hetcor_scan", "panel_gather"):
            lib = build.build(name)
            emit("build", t0, source=name, library=lib.name,
                 ptxas=ptxas_summary(lib.with_suffix(".log").read_text()))
        phase_hetcor_scan(check_panels())
        return 1
    t0 = time.perf_counter()
    names = ("local_sweep", "panel_gather", "hetcor_sweep", "dense_l1", "compact_rows",
             "kendall_panel", "hetcor_scan")
    with ThreadPoolExecutor(len(names) + 1) as pool:  # one nvcc per build, together
        tables_only = pool.submit(build.build, "local_sweep", TABLES_ONLY)
        libs = list(pool.map(build.build, names))
        tables_only.result()
    for name, lib in zip(names, libs):
        log = lib.with_suffix(".log").read_text() if lib.with_suffix(".log").exists() else ""
        emit("build", t0, source=name, library=lib.name, ptxas=ptxas_summary(log))
    t0 = time.perf_counter()
    loops = inner_loops(dict(zip(names, libs)))
    dloops = dense_loops(libs[names.index("dense_l1")])
    clock_hz = sm_clock_hz()
    emit("inner_loops", t0, sm_clock_mhz=clock_hz / 1e6,
         loops={**{f"{k}_l{l}": v for (k, l), v in loops.items()}, **dloops})
    loops.update(dloops)

    th = threshold_array(N11K, ALPHA)
    rho_th = {l: float(np.float32(np.tanh(float(th[l])))) for l in (1, 2, 3)}
    panels = check_panels()
    phase_kernels(rho_th, panels)
    phase_gather_kernel(panels)
    bucket = phase_hetcor_kernel(panels)
    phase_hetcor_scan(panels)
    compact_sized = phase_compact_kernel()
    phase_kendall_panel()
    timed_dense = phase_dense_kernel(panels, loops, clock_hz)
    if opts.kernels_only:
        return 1
    del panels
    torch.cuda.empty_cache()

    expected = [f"local_sweep_l{l}" for l in (1, 2, 3)] + ["panel_gather"] + [
        f"hetcor_sweep_l{l}" for l in (1, 2, 3)] + ["panel_gather2", "compact_rows",
                                                    "hetcor_scan"] + list(DENSE) + ["kendall_panel"]
    tmp = tempfile.mkdtemp(prefix="cigwas_chip_smoke_")
    try:
        phase_small_reference(tmp)
        kernels, cusk_again, wall, capture, kendall = phase_slice(tmp, rho_th, loops, clock_hz)
        phase_small_cuskss(tmp)
        kernels_ss, cuskss_again, wall_ss, ss_kw = phase_cuskss(tmp, loops, clock_hz,
                                                               bucket, compact_sized)
        if opts.routes_only:
            del capture
            phase_routes(tmp, ss_kw, rho_th, loops, clock_hz, timed_dense)
            return 1
        kernels += kernels_ss
        # device time of all launches of each sweep level on its slice, from
        # the profiled second run, whose launches must repeat the first's
        launched = {k["name"]: k["launches"] for k in kernels}
        totals, per_level = {}, {}
        for run, again, w, kernel, prefix in (("cusk", cusk_again, wall, "local_sweep", "sweep"),
                                              ("cuskss", cuskss_again, wall_ss, "hetcor_sweep",
                                               "hsweep")):
            totals[run], per_level[kernel] = profile_sweeps(
                run, again, w, prefix, {l: launched[f"{kernel}_l{l}"] for l in (1, 2, 3)})
        # each slice launches one gather entry only: all its panel_rows_kernel
        # records; the row compaction's and the scan's entries are the cuskss
        # slice's
        gathers = {name: [v for key, v in totals[run].items() if kernel in key]
                   for name, run, kernel in (("panel_gather", "cusk", "panel_rows_kernel"),
                                             ("panel_gather2", "cuskss", "panel_rows_kernel"),
                                             ("compact_rows", "cuskss", "compact_rows_kernel"),
                                             ("hetcor_scan", "cuskss", "hetcor_scan_kernel"))}
        for k in kernels:
            m = re.fullmatch(r"(local_sweep|hetcor_sweep)_l(\d)", k["name"])
            if m:
                k["total_ms"], n = per_level[m.group(1)][int(m.group(2))]
                assert n == k["launches"], (k["name"], n, k["launches"])
            else:  # the profiler may miss a record of a kernel this short: say how many
                k["total_ms"] = sum(v["total_ms"] for v in gathers[k["name"]])
                k["total_records"] = sum(v["launches"] for v in gathers[k["name"]])
                assert 0 < k["total_records"] <= k["launches"], (k["name"], k["total_records"])
        # the API phases after the older slices' phases, which so run in the
        # process state they always ran in
        of_pmax = phase_pmax(capture, th, rho_th)
        del capture
        torch.cuda.empty_cache()
        phase_marker_pearson(os.path.join(tmp, "b11k", "sim"),
                             os.path.join(tmp, "b11k", "sim.blocks"))
        phase_small_commands(tmp)
        of_sim = phase_sim_dag()
        phase_sim_commands(tmp)
        shutil.rmtree(os.path.join(tmp, "sim_commands"))
        of_chr = phase_chromosome(tmp, rho_th, loops, clock_hz)
        for k in kernels:  # the chromosome's launches and checks under keys of their own
            k.update(of_chr.get(k["name"], {}))
        assert sorted(of_chr) == sorted(expected[:4]), sorted(of_chr)
        of_genome = phase_genome(tmp, rho_th, loops, clock_hz)
        for k in kernels:  # the sweep levels and the one-panel gather (0 launches allowed)
            k.update(of_genome.get(k["name"], {}))
        shutil.rmtree(os.path.join(tmp, "genome"))
        # the multi-device engines last, so that the older phases run in the
        # process state they always ran in
        of_mesh = phase_mesh(tmp, ss_kw, os.path.join(tmp, "chr50k"))
        for k in kernels:
            k.update(of_mesh[k["name"]])
        shutil.rmtree(os.path.join(tmp, "chr50k"))
        for k in kernels:  # the pMax phases' launches of the same entries
            k.update(of_pmax.get(k["name"], {}), **of_sim.get(k["name"], {}))
        # the forced routes of levels 1-3 last of all, so that every phase
        # above runs in the process state it always ran in
        dense, listed = phase_routes(tmp, ss_kw, rho_th, loops, clock_hz, timed_dense)
        for k in dense:  # the engines' default level 1 in the mesh phase
            k.update(of_mesh[k["name"]])
        keep = ("launches", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "shape",
                "issue_ms", "static_issue_ms", "sector_ms")
        for k in kernels:  # where the default routes no longer make the list route's launches
            if k["name"] in listed:
                k["list_route_largest"] = {key: v for key, v in listed[k["name"]].items()
                                           if key in keep}
        kernels += dense + [kendall]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    bad = sorted(k for k in sys.modules
                 if k.split(".")[0] in ("jax", "cigwas_tpu", "pandas", "matplotlib"))
    assert not bad, bad
    assert [k["name"] for k in kernels] == expected, [k["name"] for k in kernels]
    assert all(k["launches"] > 0 for k in kernels)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                   "count": torch.cuda.device_count()},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
