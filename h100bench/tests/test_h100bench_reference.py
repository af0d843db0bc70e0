"""The plain reference against the program on the CPU at a tiny size, its
control, and the faults that ``correct`` must catch."""

from __future__ import annotations

import os
import shutil
import tempfile
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from h100bench import harness
from h100bench.reference import compare, skeleton

SEED = 2**31 + 977


def _run(c, bench, seed=SEED):
    result, compared = harness.run(c, bench, seed, 0.05, False, device="cpu")
    return result, {k: v["value"] for k, v in compared.items()}


@pytest.fixture(scope="module")
def cusk_cell(tiny):
    here, bench = tiny
    return harness.cell("tiny.cusk", bench, here=here), bench


@pytest.mark.parametrize("name", ["tiny.cusk", "tiny.cuskss"])
def test_the_program_matches_the_reference_on_the_cpu(tiny, name):
    here, bench = tiny
    c = harness.cell(name, bench, here=here)
    result, numbers = _run(c, bench)
    assert result["correct"] and result["failed"] == 0
    assert numbers["retained_diff"] == numbers["adjacency_diff"] == 0
    assert numbers.get("sepset_diff", 0) == 0 and numbers["corr_err"] < 1e-6


def test_the_summary_statistic_control_in_bfloat16_is_not_correct(tiny):
    here, bench = tiny
    c = harness.cell("tiny.cuskss", bench, here=here)
    work = Path(tempfile.mkdtemp(prefix="h100bench-test-"))
    try:
        data = c.generator.generate(c.cfg, c.traffic, SEED, str(work), "cpu")
        state = c.entry.setup(c.cfg, data, "cpu")
        numbers = compare.compare(c.entry.expected(state, "cpu", torch.bfloat16),
                                  c.entry.expected(state, "cpu"))
    finally:
        shutil.rmtree(work)
    assert any(numbers[k] > v for k, v in c.work["limits"].items()), numbers


@pytest.fixture(scope="module")
def solved(cusk_cell):
    """A solve of the tiny block by the program and the state that made it."""
    c, _ = cusk_cell
    work = Path(tempfile.mkdtemp(prefix="h100bench-test-"))
    data = c.generator.generate(c.cfg, c.traffic, SEED, str(work), "cpu")
    state = c.entry.setup(c.cfg, data, "cpu")
    (work / "out").mkdir()
    stats = c.entry.solve(state, str(work / "out"))
    yield c, state, work, stats
    shutil.rmtree(work)


def test_the_tiny_block_reaches_every_stage(solved):
    _, _, _, stats = solved
    assert sorted(stats["stage1"]["level_wall_s"]) == [1, 2, 3]
    assert max(stats["stage2"]["level_wall_s"]) >= 4  # the waves of levels >= 4


def test_the_control_in_bfloat16_is_not_correct(solved):
    """The reference in bfloat16 in the program's place fails a limit."""
    c, state, _, _ = solved
    ref = c.entry.expected(state, "cpu")
    ctl = c.entry.expected(state, "cpu", torch.bfloat16)
    numbers = compare.compare(ctl, ref)
    limits = c.work["limits"]
    assert any(numbers[k] > limits[k] for k in limits), numbers


class Broken:
    """The cell's entry with its solve replaced."""

    def __init__(self, entry, solve):
        self.WITH_SEPSETS = entry.WITH_SEPSETS
        self.setup, self.expected, self.solve = entry.setup, entry.expected, solve


def _altered(entry):
    def solve(state, outdir):
        stats = entry.solve(state, outdir)
        base = compare.output_base(outdir)
        G = np.fromfile(base + ".adj", dtype=np.int32)
        k = int(np.sqrt(G.size))
        G[0 * k + k - 1] ^= 1  # one marker - trait decision flipped
        G[(k - 1) * k + 0] ^= 1
        G.tofile(base + ".adj")
        return stats
    return solve


def _unchanged(entry):
    def solve(state, outdir):
        return {}  # returns at once: nothing solved, nothing written
    return solve


def _half_input(data: dict, h: int, outdir: str) -> dict:
    """The first h markers of a summary-statistic input as files of their own:
    the triangle's first h rows, the tables' first h rows, one block."""
    half = dict(data)
    half["mxm"] = os.path.join(outdir, "half_mxm.bin")
    np.fromfile(data["mxm"], dtype=np.float32)[: h * (h + 1) // 2].tofile(half["mxm"])
    for key in ("mxp", "mxp_se"):
        half[key] = os.path.join(outdir, f"half_{key}.txt")
        with open(data[key]) as src, open(half[key], "w") as dst:
            dst.writelines(line for i, line in enumerate(src) if i <= h)
    return half


def _half(entry):
    def solve(state, outdir):
        h = state["data"]["markers"] // 2
        half = dict(state)
        blocks = os.path.join(outdir, "half.blocks")
        with open(blocks, "w") as f:
            f.write(f"1\t0\t{h - 1}\n")
        if "blocks" in state:  # individual-level: the block file of the solve
            half["blocks"] = blocks
        else:  # summary statistics: the input itself, then its block file
            half["data"] = {**_half_input(state["data"], h, outdir), "blocks": blocks}
        stats = entry.solve(half, outdir)
        for f in os.listdir(outdir):
            if f.startswith("half"):
                os.unlink(os.path.join(outdir, f))
        return stats
    return solve


@pytest.mark.parametrize("fault", [_altered, _unchanged, _half])
@pytest.mark.parametrize("name", ["tiny.cusk", "tiny.cuskss"])
def test_a_broken_solve_is_not_correct(tiny, name, fault):
    here, bench = tiny
    c = harness.cell(name, bench, here=here)
    broken = SimpleNamespace(**{**vars(c), "entry": Broken(c.entry, fault(c.entry))})
    result, _ = _run(broken, bench, SEED + 1)
    assert result["correct"] is False


def test_the_waves_stop_a_node_once_its_edges_are_gone(monkeypatch):
    """From level 4 a node scans its sets in waves and stops once every edge
    it has is gone; with no hit it scans every set, as a full scan does."""
    monkeypatch.setattr(skeleton, "CHUNK", 8)
    monkeypatch.setattr(skeleton, "MAX_CHUNKS", 2)  # waves of 16 sets
    v, l = 12, skeleton.FIRST_WAVE_LEVEL  # comb(11, 4) = 330 sets a node
    rng = np.random.default_rng(5)
    C = torch.from_numpy(np.corrcoef(rng.normal(size=(v, 200))))
    G = np.ones((v, v), dtype=bool)
    np.fill_diagonal(G, False)
    tests = skeleton.Tests(C)

    def level(cut, waves):
        xs, ys, stat, rank = skeleton._level(tests, G, l, cut, waves)
        order = np.lexsort((ys, xs))
        return stat[order], rank[order]

    full = level(-1.0, False)
    no_hit = level(-1.0, True)
    assert np.array_equal(full[0], no_hit[0]) and np.array_equal(full[1], no_hit[1])
    all_hit = level(1.0, True)
    assert all_hit[1].max() < 16 <= full[1].max()
    assert np.all(all_hit[0] >= full[0])


def test_colex_ranks_and_sets_agree():
    sets = skeleton.colex(0, 20, 3, 6)
    assert sets[:4].tolist() == [[0, 1, 2], [0, 1, 3], [0, 2, 3], [1, 2, 3]]
    assert (skeleton.colex_of(np.array([19, 7]), 3, 6) == sets[[19, 7]]).all()
