"""The readers of stage 2's per-layer metrics on a summary-statistic input
(``metrics/skeleton.stage2_s.input.py``,
``metrics/skeleton.stage2_tests_per_s.input.py``) on made-up runs: what they
read, and nothing where a program lacks the counters."""

from __future__ import annotations

from types import SimpleNamespace

import pytest

from h100bench import harness

from conftest import HERE


def _reader(name: str):
    return harness.load_module(HERE / "metrics" / f"{name}.py", f"reader_{name}")


def _solve(wall: float, levels: dict, with_counter: bool = True) -> dict:
    """The stats of a made-up solve whose stage 2 ran levels {l: (tests, s)}."""
    stage2 = {"skeleton_wall_s": wall, "ci_tests": sum(t for t, _ in levels.values()),
              "level_wall_s": {l: w for l, (_, w) in levels.items()}}
    if with_counter:
        stage2["ci_tests_level"] = {l: t for l, (t, _) in levels.items()}
    return {"stage1": {"skeleton_wall_s": 0.3}, "stage2": stage2, "stage2_s": wall + 0.1}


def _run(stats: list) -> SimpleNamespace:
    return SimpleNamespace(stats=stats, solves=len(stats), window_s=10.0, trace=None,
                           launches={})


def test_stage2_wall_is_the_mean_of_its_skeleton_walls():
    read = _reader("skeleton.stage2_s.input").read
    run = _run([_solve(0.9, {4: (10, 0.1)}), _solve(1.1, {4: (10, 0.1)})])
    assert read(run) == pytest.approx(1.0)
    assert read(_run([])) is None
    assert read(_run([{"stage1": {"skeleton_wall_s": 0.3}}])) is None  # no second stage


def test_stage2_rate_counts_levels_from_four_over_their_walls():
    read = _reader("skeleton.stage2_tests_per_s.input").read
    a = _solve(1.0, {2: (1000, 0.01), 3: (2000, 0.01), 4: (300, 0.1), 7: (500, 0.3)})
    b = _solve(1.0, {3: (50, 0.01), 5: (200, 0.1)})
    # (300 + 500 + 200) tests over (0.1 + 0.3 + 0.1) s: levels 2-3 left out
    assert read(_run([a, b])) == pytest.approx(1000 / 0.5)


def test_stage2_rate_is_missing_without_the_counter_or_the_levels():
    read = _reader("skeleton.stage2_tests_per_s.input").read
    levels = {2: (1000, 0.01), 4: (300, 0.1)}
    # a program that counts no tests by level (the parent of the counter)
    assert read(_run([_solve(1.0, levels, with_counter=False)])) is None
    # a stage 2 that stopped before level 4
    assert read(_run([_solve(1.0, {2: (1000, 0.01), 3: (10, 0.01)})])) is None
    assert read(_run([])) is None
