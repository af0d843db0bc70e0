"""The port's spans and transfer counters (`cigwas_tpu_torch.utils.timing`)
on the CPU: `span` accumulates and nests; `record_function` is entered only
while a profiler records; under a CPU torch.profiler a tiny `cusk` and a
tiny `cuskss` (one card, and an engine) show every top-level span as an
annotation inside the caller's; the top-level walls are all there and fit
in the call; the fetches' byte counts are the bytes their shapes imply;
`run_all_blocks` hands back each block's stats.
"""

import json
import os
import re
import time

import numpy as np
import pytest
import torch

from torch_parity import planted_dataset, rfdisease_input, set_threads

from cigwas_tpu_torch.constants import PANEL_ALIGN
from cigwas_tpu_torch.utils.timing import span, to_host

set_threads()

DATA = os.path.join(os.path.dirname(__file__), "data", "test_files")
MARKERS, TRAITS, SAMPLES = 160, 3, 1500

# top-level stats key of a solve -> the span's name in the trace
BLOCK_SPANS = {
    "context_s": "cigwas.pipeline.context",
    "prepare_s": "cigwas.pipeline.prepare",
    "prescreen_s": "cigwas.pipeline.prescreen",
    "panel_s": "cigwas.panel.build",
    ("stage1", "skeleton_wall_s"): "cigwas.skeleton.pc",
    "reduce_s": "cigwas.reduce.stage1",
    "stage2_s": "cigwas.pipeline.stage2",
    "write_s": "cigwas.pipeline.write",
}
INPUT_SPANS = {
    "load_s": "cigwas.pipeline.load",
    "assemble_s": "cigwas.panel.assemble",
    "init_s": "cigwas.pipeline.init",
    "stage1_s": "cigwas.pipeline.stage1",
    "stage2_s": "cigwas.pipeline.stage2",
    "write_s": "cigwas.pipeline.write",
}
ROOTS = {"block": "cigwas.pipeline.cusk", "input": "cigwas.pipeline.cuskss",
         "input_engine": "cigwas.pipeline.cuskss"}


def _padded(v: int) -> int:
    return -(-v // PANEL_ALIGN) * PANEL_ALIGN


def _get(stats: dict, key):
    for k in key if isinstance(key, tuple) else (key,):
        stats = stats[k]
    return stats


@pytest.fixture(scope="module")
def block_files(tmp_path_factory):
    """A prepared one-block fileset: MARKERS markers x SAMPLES samples x
    TRAITS traits with planted markers, and its `.blocks` file."""
    from cigwas_tpu_torch.prep import prep_bed

    tmp = tmp_path_factory.mktemp("tracing")
    stem = str(tmp / "sim")
    planted_dataset(stem, 5, SAMPLES, [MARKERS],
                    {0: [(10, 0.4), (90, 0.4)], 1: [(50, 0.4)], 2: [(120, 0.4)]},
                    {1: [(0, 0.5)]})
    prep_bed(stem)
    with open(stem + ".blocks", "w") as f:
        f.write(f"1\t0\t{MARKERS - 1}\n")
    return tmp, stem


def _solve_block(block_files, outdir) -> dict:
    from cigwas_tpu_torch.pipelines import cusk

    _, stem = block_files
    os.makedirs(outdir, exist_ok=True)
    stats: dict = {}
    res = cusk(stem + ".phen", stem, stem + ".blocks", 1e-3, 3, 14, 1, str(outdir), 0,
               verbose=False, device="cpu", stats=stats)
    assert res is not None, "the pre-screen skipped the block"
    return stats


def _se_files(tmp_path) -> dict:
    """Standard-error tables beside the fixtures' correlation tables (the
    hetcor route), as tests/test_torch_cuskss.py writes them."""
    out = {}
    for name, keep in (("marker_trait_summary_stats.txt", 3), ("trait_summary_stats.txt", 1)):
        lines = open(os.path.join(DATA, name)).read().splitlines()
        path = tmp_path / ("se_" + name)
        with open(path, "w") as f:
            f.write(lines[0] + "\n")
            for line in lines[1:]:
                fields = line.split()
                f.write(" ".join(fields[:keep] + ["0.00001"] * (len(fields) - keep)) + "\n")
        out["mxp_se" if keep == 3 else "pxp_se"] = str(path)
    return out


def _solve_input(tmp_path, outdir, mesh=None) -> dict:
    from cigwas_tpu_torch.pipelines import CuskssArgs, cuskss

    os.makedirs(outdir, exist_ok=True)
    args = CuskssArgs.from_paths(
        mxm=os.path.join(DATA, "small_mxm.bin"),
        mxp=os.path.join(DATA, "marker_trait_summary_stats.txt"),
        pxp=os.path.join(DATA, "trait_summary_stats.txt"),
        marker_indices=os.path.join(DATA, "marker_indices.bin"),
        alpha=1e-4, num_samples=500000, max_level_one=3, max_level_two=14, max_depth=1,
        outdir=str(outdir), **_se_files(tmp_path))
    stats: dict = {}
    cuskss(args, verbose=False, device="cpu", stats=stats, mesh=mesh)
    return stats


def test_span_accumulates_into_its_key_and_nests():
    stats: dict = {}
    for _ in range(3):
        with span(stats, "outer_s", "cigwas.test.outer"):
            with span(stats, ("level_wall_s", 2), "cigwas.test.inner"):
                time.sleep(0.002)
    assert set(stats) == {"outer_s", "level_wall_s"}
    assert stats["level_wall_s"][2] >= 0.006
    assert stats["outer_s"] >= stats["level_wall_s"][2]
    with span(None, "ignored_s", "cigwas.test.none"), span(stats, None, "cigwas.test.nokey"):
        pass
    assert set(stats) == {"outer_s", "level_wall_s"}
    with pytest.raises(ValueError), span(stats, "raised_s", "cigwas.test.raise"):
        raise ValueError("inside a span")
    assert stats["raised_s"] >= 0.0


def test_to_host_counts_bytes_whatever_the_device():
    stats: dict = {}
    a = to_host(torch.ones((5, 7), dtype=torch.bool), stats, "mask")
    b = to_host(torch.arange(12, dtype=torch.int32), stats, "lists")
    to_host(torch.zeros((3, 4), dtype=torch.float32), stats, "lists")
    assert stats == {"d2h_bytes": {"mask": 35, "lists": 12 * 4 + 12 * 4}}
    assert isinstance(a, np.ndarray) and a.dtype == np.bool_ and b.tolist() == list(range(12))
    src = torch.arange(4, dtype=torch.float32)
    out = to_host(src, None, "copied", copy=True)
    out[0] = 9.0
    assert src[0].item() == 0.0


def test_record_function_is_entered_only_while_a_profiler_records(monkeypatch, block_files,
                                                                  tmp_path):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered with no profiler running")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    stats: dict = {}
    with span(stats, "a_s", "cigwas.test.a"):
        to_host(torch.ones(3), stats, "x")
    assert stats["d2h_bytes"] == {"x": 12}
    _solve_block(block_files, tmp_path / "block")
    _solve_input(tmp_path, tmp_path / "input")


def _annotations(trace_path) -> list:
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    return [(e["name"], e["ts"], e["ts"] + e.get("dur", 0)) for e in events
            if e.get("ph") == "X" and e.get("cat") == "user_annotation"]


def _inside(inner, outer) -> bool:
    return outer[1] <= inner[1] and inner[2] <= outer[2]


@pytest.mark.parametrize("kind", ["block", "input", "input_engine"])
def test_top_level_spans_nest_in_the_callers_annotation(kind, block_files, tmp_path):
    """Under a CPU profiler, each solve's documented top-level spans appear
    inside the program's root span, which lies inside the caller's
    annotation; every program span and transfer lies inside the caller's.
    An engine (one CPU shard) keeps the hetcor adjacency on the host: its
    level-0 pass lies inside level 0 and only hits leave the shard."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("caller.solve"):
            if kind == "block":
                _solve_block(block_files, tmp_path / "out")
            else:
                _solve_input(tmp_path, tmp_path / "out",
                             mesh=["cpu"] if kind == "input_engine" else None)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = _annotations(path)
    (caller,) = [e for e in events if e[0] == "caller.solve"]
    (root,) = [e for e in events if e[0] == ROOTS[kind]]
    assert _inside(root, caller)
    program = [e for e in events if e[0].startswith("cigwas.")]
    assert all(_inside(e, caller) for e in program)
    for name in (BLOCK_SPANS if kind == "block" else INPUT_SPANS).values():
        got = [e for e in program if e[0] == name]
        assert got and all(_inside(e, root) for e in got), name
    names = {e[0] for e in program}
    # on one card both skeletons keep the adjacency on the device from level
    # 0 on: it leaves once, and the level-0 adjacency not at all
    fetches = {"block": {"cigwas.transfer.loop_lists", "cigwas.transfer.final_adjacency"},
               "input": {"cigwas.transfer.loop_lists", "cigwas.transfer.final_adjacency"},
               "input_engine": {"cigwas.transfer.hits"}}[kind]
    assert {"cigwas.skeleton.level0", "cigwas.skeleton.level1", "cigwas.skeleton.host_pass",
            "cigwas.transfer.reduce_panel", *fetches} <= names
    assert "cigwas.transfer.l0_adjacency" not in names
    assert any(re.fullmatch(r"cigwas\.skeleton\.level[2-9]", n) for n in names)
    level0 = [e for e in program if e[0] == "cigwas.skeleton.level0"]
    if kind == "input_engine":
        assert not names & {"cigwas.transfer.loop_lists", "cigwas.transfer.final_adjacency"}
        passes = [e for e in program if e[0] == "cigwas.skeleton.host_pass"]
        for e in level0:
            assert any(_inside(p, e) for p in passes)
    final = [e for e in program if e[0] == "cigwas.skeleton.final_fetch"]
    for fetch in (e for e in program if e[0] == "cigwas.transfer.final_adjacency"):
        assert any(_inside(fetch, e) for e in final)
    if kind == "block":
        assert {"cigwas.skeleton.sepset_fill", "cigwas.skeleton.preamble",
                "cigwas.transfer.prescreen", "cigwas.transfer.final_adjacency",
                "cigwas.transfer.loop_lists"} <= names


@pytest.mark.parametrize("kind", ["block", "input"])
def test_top_level_walls_are_present_and_fit_in_the_call(kind, block_files, tmp_path):
    t0 = time.perf_counter()
    if kind == "block":
        stats = _solve_block(block_files, tmp_path / "out")
    else:
        stats = _solve_input(tmp_path, tmp_path / "out")
    wall = time.perf_counter() - t0
    keys = BLOCK_SPANS if kind == "block" else INPUT_SPANS
    walls = [_get(stats, k) for k in keys]
    assert all(isinstance(w, float) and w >= 0.0 for w in walls)
    assert sum(walls) <= wall
    for stage in ("stage1", "stage2"):
        st = stats[stage]
        assert st["host_pass_s"] > 0.0
        assert st["skeleton_wall_s"] >= st["l0_wall_s"] + sum(st["level_wall_s"].values())
        if kind == "block":
            assert st["preamble_s"] >= st["sepset_alloc_s"] + st["l0_wall_s"]
            # the removals' records, and those of the kept corner the reduction wrote
            assert 0 <= st["sepset_kept"] <= st["sepset_records"]
    if kind == "block":
        assert stats["stage2_s"] >= (stats["stage2"]["skeleton_wall_s"]
                                     + stats["stage2"]["reduce_s"])
    else:
        assert stats["stage1_s"] >= (stats["stage1"]["skeleton_wall_s"]
                                     + stats["stage1"]["reduce_s"])


def test_block_fetches_count_the_bytes_of_their_shapes(block_files, tmp_path):
    """On the device-resident loop's route (the default at this size) both
    stages fetch no level-0 adjacency and the loop's final adjacency once,
    (vp, vp) bool; each loop level its n int32 degrees and its hits, an
    int32 x, y and l sepset variables each; the pre-screen fetches three
    (m, p) float32 sums, the first reduction the kept (k, k) float32
    panel."""
    stats = _solve_block(block_files, tmp_path / "out")
    top = stats["d2h_bytes"]
    assert top["prescreen"] == 3 * MARKERS * TRAITS * 4
    k1 = int(round((top["reduce_panel"] / 4) ** 0.5))
    assert 4 * k1 * k1 == top["reduce_panel"] and TRAITS <= k1 < MARKERS + TRAITS
    for stage, v in (("stage1", MARKERS + TRAITS), ("stage2", k1)):
        st = stats[stage]
        vp = _padded(v)
        got = st["d2h_bytes"]
        assert set(st["level_route"].values()) <= {"device_loop", "combinatorial"}
        assert set(got) == {"loop_lists", "final_adjacency"} | (
            {"hits"} if "combinatorial" in st["level_route"].values() else set()), stage
        assert got["final_adjacency"] == vp * vp, stage
        loop = [l for l, r in st["level_route"].items() if r == "device_loop"]
        assert loop == list(range(1, len(loop) + 1)), stage
        # one degree fetch a level, and one more where the graph ran out of tests
        hits = got["loop_lists"] - 4 * vp * min(len(loop) + 1, 3)
        assert hits >= 0 and hits % 4 == 0, stage
        assert stage == "stage2" or hits >= 12, stage


def test_input_fetches_count_the_bytes_of_their_shapes(tmp_path):
    """The hetcor skeleton fetches its adjacency once, (vp, vp) bool, in
    each stage (its levels 0-3 on the device), and no level-0 deletions;
    each reduction fetches the kept (k, k) float32 correlation and ESS
    panels of a device stage (stage 1 here: its panels are assembled on the
    device; stage 2 gets numpy panels)."""
    stats = _solve_input(tmp_path, tmp_path / "out")
    v = np.fromfile(os.path.join(DATA, "marker_indices.bin"), dtype=np.int32).size
    v += len(open(os.path.join(DATA, "trait_summary_stats.txt")).readline().split())
    s1, s2 = stats["stage1"]["d2h_bytes"], stats["stage2"]["d2h_bytes"]
    assert s1["final_adjacency"] == _padded(v) ** 2
    k1 = int(round((s1["reduce_panel"] / 8) ** 0.5))
    assert 8 * k1 * k1 == s1["reduce_panel"] and 0 < k1 <= v
    assert s2["final_adjacency"] == _padded(k1) ** 2
    assert "reduce_panel" not in s2
    assert "l0_adjacency" not in s1 and "l0_adjacency" not in s2


def test_input_engine_fetches_count_the_bytes_of_their_shapes(tmp_path):
    """With an engine (one CPU shard) the hetcor adjacency stays on the host
    through every level: no degrees, no adjacency and no level-0 mask leave
    the shard, only the hits (two int32 a hit) and stage 1's reduction
    panels; the decision files are those of the one-card run."""
    stats = _solve_input(tmp_path, tmp_path / "engine", mesh=["cpu"])
    for stage in ("stage1", "stage2"):
        got = stats[stage]["d2h_bytes"]
        assert stats[stage]["device_levels"] == []
        assert not set(got) & {"l0_adjacency", "loop_lists", "final_adjacency"}
        assert got["hits"] > 0 and got["hits"] % 8 == 0
    k1 = int(round((stats["stage1"]["d2h_bytes"]["reduce_panel"] / 8) ** 0.5))
    assert 8 * k1 * k1 == stats["stage1"]["d2h_bytes"]["reduce_panel"]
    _solve_input(tmp_path, tmp_path / "one")
    names = sorted(os.listdir(tmp_path / "one"))
    assert names == sorted(os.listdir(tmp_path / "engine")) and names
    for name in names:
        assert ((tmp_path / "one" / name).read_bytes()
                == (tmp_path / "engine" / name).read_bytes()), name


def test_run_all_blocks_hands_back_each_blocks_stats(tmp_path, capsys):
    """Per-block stats from the runner: prepare_s and finish_s, the walls its
    closing line prints, and finish's own keys."""
    from cigwas_tpu_torch.parallel import run_all_blocks
    from cigwas_tpu_torch.pipelines import make_blocks
    from cigwas_tpu_torch.prep import prep_bed

    stem = str(tmp_path / "sim")
    planted_dataset(stem, 17, 2000, [96],
                    {0: [(5, 0.4), (40, 0.4), (70, 0.4)], 1: [(20, 0.4)]}, {1: [(0, 0.5)]})
    prep_bed(stem)
    make_blocks(stem, 32, 16, verbose=False, device="cpu")
    out = tmp_path / "out"
    out.mkdir()
    stats: dict = {}
    res = run_all_blocks(stem + ".phen", stem, stem + "_m32.blocks", 1e-3, 3, 14, 1, str(out),
                         num_partitions=1, partition_index=0, device="cpu", stats=stats)
    printed = capsys.readouterr().out
    assert set(stats) == set(res) and len(res) >= 3
    for block, st in stats.items():
        assert st["finish_s"] >= st["prescreen_s"] >= 0.0 and st["prepare_s"] > 0.0
        assert (f"[run_all_blocks] [{block}] retained "
                f"{'no' if res[block] is None else res[block]} markers, "
                f"prepare {st['prepare_s']:.3f} s, finish {st['finish_s']:.3f} s, ") in printed
        if res[block] is not None:
            assert st["finish_s"] >= st["panel_s"] + st["stage2_s"] + st["write_s"]
    total = sum(st["prepare_s"] + st["finish_s"] for st in stats.values())
    assert f"processed {len(res)} blocks in {total:.2f}s" in printed



def _chunk_samples(n: int, sample_chunk: int) -> int:
    """Samples of a chunk of the panels: at most sample_chunk, and the
    block's bytes rounded up to a multiple of 32 (`ops/corr.py`)."""
    return min(sample_chunk, 4 * (-(-(-(-n // 4)) // 32) * 32))


def test_to_device_counts_bytes_whatever_the_device():
    from cigwas_tpu_torch.utils.timing import count, to_device

    stats: dict = {}
    a = np.arange(12, dtype=np.int32)
    first = to_device(a, "cpu", stats, "rows")
    to_device(a[::2], "cpu", stats, "rows")
    to_device(np.zeros((3, 4), dtype=np.float32), "cpu", stats, "phen")
    count(stats, "decoded", 5)
    count(stats, "decoded", 7)
    count(None, "decoded", 1)
    assert stats == {"h2d_bytes": {"rows": 48 + 24, "phen": 48}, "decoded": 12}
    a[0] = 9
    assert first.tolist() == list(range(12))  # a fresh tensor, not a view of a


def test_block_io_spans_nest_in_their_phases(block_files, tmp_path):
    """The `.phen` read lies inside the context, the `.bed` read inside the
    host I/O phase, in the trace and in the walls; the uploads appear as
    transfers inside the solve."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        stats = _solve_block(block_files, tmp_path / "out")
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = _annotations(path)
    for inner, outer in (("cigwas.io.load_phen", "cigwas.pipeline.context"),
                         ("cigwas.io.read_bed", "cigwas.pipeline.prepare")):
        (i,) = [e for e in events if e[0] == inner]
        (o,) = [e for e in events if e[0] == outer]
        assert _inside(i, o), inner
    (root,) = [e for e in events if e[0] == ROOTS["block"]]
    for site in ("prescreen_block", "panel_block", "phen", "panel_traits"):
        got = [e for e in events if e[0] == "cigwas.transfer." + site]
        assert got and all(_inside(e, root) for e in got), site
    assert 0.0 < stats["load_phen_s"] <= stats["context_s"]
    assert 0.0 < stats["read_bed_s"] <= stats["prepare_s"]


def test_block_uploads_and_panel_counters_follow_the_shapes(block_files, tmp_path):
    """The single-pass panel of the block (one sample chunk): the pre-screen
    uploads the block's packed bytes, the panel the bytes of its m_pad rows,
    both padded to the sample chunk's bytes; each uploads the phenotypes and
    their validities over the padded samples; the panel its padded means and
    stds; its marker-marker block is one launch of the Kendall panel kernel,
    which writes no one-hot to device memory."""
    stats = _solve_block(block_files, tmp_path / "out")
    samples = _chunk_samples(SAMPLES, 131072)  # one chunk
    m_pad = MARKERS + (-(MARKERS + TRAITS)) % PANEL_ALIGN
    assert stats["h2d_bytes"] == {
        "prescreen_block": MARKERS * samples // 4,
        "panel_block": m_pad * samples // 4,
        "phen": 2 * (2 * TRAITS * samples * 4),
        "panel_traits": 2 * m_pad * 4,
    }
    assert (stats["panel_markers"], stats["panel_samples"], stats["panel_sample_chunks"]) == (
        MARKERS, SAMPLES, 1)
    assert (stats["panel_decode_bytes"], stats["panel_kernel_launches"]) == (0, 1)


@pytest.mark.parametrize("case", ["own-sums", "prescreen-corr"])
def test_striped_panel_counters(case):
    """The striped panel's counters: one launch of the Kendall panel kernel
    over every sample, no one-hot in device memory. The uploads: the packed
    bytes of the m rows as they are (976 bytes a row, a multiple of 16), the
    phenotypes and the trait blocks; without the pre-screen's correlations
    also the m rows and the phenotypes for the marker-phen sums (in their
    own default chunks) and the means and stds, with them the correlations
    themselves."""
    from cigwas_tpu_torch.io.bed import encode_bed_values
    from cigwas_tpu_torch.ops import corr

    m, n, p, row_tile = 300, 3901, 3, 128
    rng = np.random.default_rng(3)
    G = rng.integers(0, 3, (m, n)).astype(np.float32)
    Y = rng.normal(size=(p, n)).astype(np.float32)
    means, stds = G.mean(1).astype(np.float32), G.std(1).astype(np.float32)
    bb = encode_bed_values(G)
    mp = (corr.marker_phen_corr(bb, Y, means, stds, n, device="cpu")
          if case == "prescreen-corr" else None)
    stats: dict = {}
    corr.corr_panel_device_tiled(bb, Y, means, stds, n, "cpu", mp_corr=mp,
                                 row_tile=row_tile, stats=stats)
    assert (stats["panel_markers"], stats["panel_samples"], stats["panel_sample_chunks"]) == (
        m, n, 1)
    assert (stats["panel_decode_bytes"], stats["panel_kernel_launches"]) == (0, 1)
    if mp is not None:
        assert stats["h2d_bytes"] == {
            "panel_traits": m * p * 4 + p * p * 4,
            "panel_block": m * (-(-n // 4)),
            "phen": 2 * p * n * 4,
        }
        return
    sums = _chunk_samples(n, corr.DEFAULT_SAMPLE_CHUNK)  # the marker-phen sums' own chunks
    assert stats["h2d_bytes"] == {
        "prescreen_block": m * sums // 4,
        "panel_block": m * (-(-n // 4)),
        "phen": 2 * p * sums * 4 + 2 * p * n * 4,
        "panel_traits": 2 * m * 4 + p * p * 4,
    }


# the module attributes that force each route of levels 1-3 (both skeletons)
ROUTES = {
    "device_loop": {},
    "list": {"DEV_RESIDENT_MAX": 0, "_DEV_RESIDENT_WIDTH": 0, "L1_LOCAL_MAX_WIDTH": 1 << 30},
    "dense": {"DEV_RESIDENT_MAX": 0, "_DEV_RESIDENT_WIDTH": 0, "L1_LOCAL_MAX_WIDTH": 0,
              "L1_LOCAL_COST_RATIO": 1 << 60},
}


@pytest.fixture(scope="module")
def rfdisease_files(tmp_path_factory):
    """A merged, time-indexed input of 4 risk factors and 2 diseases over 500
    markers selected from 600 rows, and its configuration."""
    return rfdisease_input(tmp_path_factory.mktemp("rfdisease"))


def _solve_rfdisease(rfdisease_files, outdir) -> dict:
    from cigwas_tpu_torch.pipelines import CuskssArgs, cuskss

    d, cfg = rfdisease_files
    os.makedirs(outdir, exist_ok=True)
    args = CuskssArgs.from_paths(
        mxm=d["mxm"], mxp=d["mxp"], mxp_se=d["mxp_se"], pxp=d["pxp"], pxp_se=d["pxp_se"],
        marker_indices=d["marker_ixs"], time_index=d["time_index"], alpha=cfg["alpha"],
        max_level_one=3, max_level_two=14, max_depth=1, num_samples=cfg["gwas_samples"],
        outdir=str(outdir))
    stats: dict = {}
    cuskss(args, verbose=False, device="cpu", stats=stats)
    return stats


@pytest.mark.parametrize("route", list(ROUTES))
@pytest.mark.parametrize("kind", ["block", "input"])
def test_tests_by_level_sum_to_ci_tests(kind, route, monkeypatch, block_files,
                                        rfdisease_files, tmp_path):
    """In both stages of both skeletons, on the device loop, the list route
    and the dense level 1, ``ci_tests_level`` splits ``ci_tests`` by level:
    its levels ran, none below 2 unless combinatorial, and they sum to it."""
    from cigwas_tpu_torch.skeleton import cupc

    for name, value in ROUTES[route].items():
        monkeypatch.setattr(cupc, name, value)
    if kind == "block":
        stats = _solve_block(block_files, tmp_path / "out")
    else:
        stats = _solve_rfdisease(rfdisease_files, tmp_path / "out")
    s1 = stats["stage1"]
    first = {"device_loop": "device_loop" if kind == "block" else None,
             "list": "local", "dense": "dense"}[route]
    if first is not None:
        assert s1["level_route"][1] == first
    if kind == "input":
        assert s1["device_levels"][:2] == ([0] if route == "list" else [0, 1])
    for stage in ("stage1", "stage2"):
        st = stats[stage]
        by_level = st["ci_tests_level"]
        assert sum(by_level.values()) == st["ci_tests"], stage
        assert set(by_level) <= set(st["level_route"]), stage
        assert all(l >= 2 or st["level_route"][l] == "combinatorial" for l in by_level), stage
    assert stats["stage1"]["ci_tests"] > 0
    if kind == "input":  # stage 2's hubs reach the combinatorial levels
        assert any(l >= 4 and n > 0 for l, n in stats["stage2"]["ci_tests_level"].items())


def test_the_merged_selection_lies_inside_the_load(rfdisease_files, tmp_path):
    """A merged input's marker-trait read and row selection is the span
    ``cigwas.io.merged_select`` (``merged_select_s``), inside the load in
    the trace and in the walls."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        stats = _solve_rfdisease(rfdisease_files, tmp_path / "out")
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = _annotations(path)
    (inner,) = [e for e in events if e[0] == "cigwas.io.merged_select"]
    (outer,) = [e for e in events if e[0] == INPUT_SPANS["load_s"]]
    assert _inside(inner, outer)
    assert 0.0 < stats["merged_select_s"] <= stats["load_s"]
