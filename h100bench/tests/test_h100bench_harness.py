"""The harness: cells found by name, the closed loop of solves, the result
line, the traced window."""

from __future__ import annotations

import json
import re
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import pytest

from h100bench import harness, tracing

from conftest import HERE, ROOT, make_tiny

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_every_entry_of_the_benchmark_resolves_to_its_files():
    bench = harness.spec()
    paths = bench["paths"]
    assert bench["command"][1].startswith(paths[0] + "/")
    for cfg in bench["configs"]:
        f = ROOT / cfg["file"]
        assert f.is_file() and cfg["file"].split("/")[0] in paths
        assert json.loads(f.read_text())["name"] == cfg["name"]
        assert set(cfg["reduced"]) <= set(json.loads(f.read_text())["reduced"])
    reported = {}
    for w in bench["workloads"]:
        c = harness.cell(w["name"], bench)
        assert c.chips == w["chips"] == 1
        assert callable(c.generator.generate) and callable(c.entry.solve)
        assert set(c.work["limits"]) and c.work["why"]
        e2e = {m["name"] for m in harness.end_to_end(bench, w["name"])}
        assert {"setup_s", c.work["per_solve"]} <= e2e
        reported[w["name"]] = harness.per_layer(bench, w["name"])
        assert reported[w["name"]], w["name"]
    for m in bench["per_layer"]:
        reader = harness.load_module(HERE / "metrics" / f"{m['name']}.py", "reader")
        assert callable(reader.read)
        assert all(m in reported[w] for w in m["workloads"])
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in bench[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)


def test_a_cell_added_as_files_alone_is_found(tiny, tmp_path):
    here, bench = tiny
    (here / "workloads" / "dummy.json").write_text(json.dumps(
        {"config": "tiny_cusk", "traffic": "tiny_block", "entry": "cusk",
         "per_solve": "block_s", "why": "dummy", "limits": {"corr_err": 1.0}}))
    (here / "metrics" / "dummy.layer_s.block.py").write_text(
        "def read(run):\n    return float(run.solves)\n")
    bench = {**bench, "workloads": bench["workloads"] + [
        {"name": "dummy", "config": "tiny_cusk", "traffic": "tiny_block", "chips": 1}],
        "per_layer": [{"name": "dummy.layer_s.block", "unit": "s", "better": "lower",
                       "source": "program_span", "layer": "dummy", "moves": "block_s",
                       "workloads": ["dummy"]}]}
    c = harness.cell("dummy", bench, here=here)
    assert c.work["why"] == "dummy" and c.entry.WITH_SEPSETS
    assert [m["name"] for m in harness.per_layer(bench, "dummy")] == ["dummy.layer_s.block"]
    assert harness.per_layer(bench, "tiny.cusk") == []


class Sleeper:
    """An entry whose solve takes a fixed time and writes one output."""

    WITH_SEPSETS = False

    def __init__(self, solve_s: float):
        self.solve_s = solve_s

    def setup(self, cfg, data, device):
        return {}

    def solve(self, state, outdir):
        time.sleep(self.solve_s)
        return {"stage1": {}}

    def expected(self, state, device, dtype=None):
        return {}


def _sleeper_cell(solve_s: float) -> SimpleNamespace:
    return SimpleNamespace(
        name="sleep", chips=1, cfg={}, traffic={},
        work={"per_solve": "block_s", "limits": {}},
        generator=SimpleNamespace(generate=lambda *a: {}), entry=Sleeper(solve_s))


def test_the_window_is_whole_solves_and_the_rate_is_its_seconds_over_them(monkeypatch):
    bench = {"end_to_end": [{"name": "block_s", "unit": "s/block"},
                            {"name": "setup_s", "unit": "s"}], "per_layer": []}
    monkeypatch.setattr(harness, "judge", lambda c, state, outdirs, device: ({}, 0))
    t = time.perf_counter()
    result, _ = harness.run(_sleeper_cell(0.05), bench, 7, 0.2, False, device="cpu",
                            t_start=t)
    solves = result["attempted"]
    # the loop stops at the first solve that ends at or after 0.2 s
    assert 4 <= solves <= 5 and result["failed"] == 0
    rate = result["metrics"]["block_s"]["value"]
    assert 0.05 <= rate < 0.07
    assert rate * solves >= 0.2
    assert 0 < result["metrics"]["setup_s"]["value"] < 1.0


def test_the_result_line_has_the_contract_keys(tiny):
    here, bench = tiny
    c = harness.cell("tiny.cusk", bench, here=here)
    result, compared = harness.run(c, bench, 2**31 + 12345, 0.1, False, device="cpu")
    assert list(result) == ["correct", "attempted", "failed", "metrics", "device", "compared"]
    assert set(result["metrics"]) == {"block_s", "peak_device_gib", "setup_s"}
    assert all(set(v) == {"value", "unit"} for v in result["metrics"].values())
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(result["device"])
    assert set(compared) == set(c.work["limits"])
    assert all(set(v) == {"value", "limit"} for v in compared.values())
    assert result["correct"] is True
    json.dumps(result)


def test_the_traced_window_reads_one_clock(monkeypatch):
    bench = {"end_to_end": [{"name": "block_s", "unit": "s/block"}],
             "per_layer": [{"name": "device.idle_pct.block", "unit": "%", "moves": "block_s",
                            "workloads": ["sleep"]}]}
    monkeypatch.setattr(harness, "judge", lambda c, state, outdirs, device: ({}, 0))
    result, _ = harness.run(_sleeper_cell(0.02), bench, 3, 0.1, True, device="cpu")
    # no device work on the CPU: the card's idle share of the window is 100%
    assert result["metrics"]["device.idle_pct.block"]["value"] == pytest.approx(100.0)
    assert result["device"]["busy_s"] == 0.0 and result["device"]["window_s"] >= 0.1
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    assert result["breakdown"]["idle_gaps"][0][1] == pytest.approx(
        result["device"]["window_s"])


def test_busy_time_is_the_union_of_device_intervals():
    events = [
        {"ph": "X", "cat": "user_annotation", "name": tracing.SOLVE_SPAN, "ts": 1000.0,
         "dur": 9000.0},
        {"ph": "X", "cat": "kernel", "name": "void sweep_table_kernel<3>(float const*)",
         "ts": 2000.0, "dur": 1000.0},
        {"ph": "X", "cat": "kernel", "name": "b", "ts": 2500.0, "dur": 1000.0},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 6000.0, "dur": 500.0},
    ]
    samples = [(10.0 + k * 0.001, "skeleton/cupc.py:skeleton") for k in range(10)]
    s = tracing.Summary(events, [10.0], samples, 10.0, 10.01)
    assert s.busy_s == pytest.approx(0.002)
    assert s.window_s == pytest.approx(0.01)
    assert s.family(r"(?<![A-Za-z_])sweep_table_kernel") == (pytest.approx(0.001), 1)
    assert sum(v for v in s.idle_by_host.values()) == pytest.approx(0.008)
    assert s.idle_by_host["skeleton/cupc.py:skeleton"] > 0


WITHOUT_PROGRAM = """
import json, sys
sys.path[:0] = [{base!r}]
from pathlib import Path
from h100bench import harness
bench = json.loads(Path({base!r}, "bench.json").read_text())
c = harness.cell("tiny.cusk", bench, here=Path({base!r}, "h100bench"))
print(json.dumps(harness.run(c, bench, 5, 0.01, False, device="cpu")[0]))
"""


def test_without_the_program_a_run_fails_and_prints_no_result(tmp_path):
    """A checkout that holds only the benchmark's files cannot run a cell."""
    here, bench = make_tiny(tmp_path)
    (tmp_path / "bench.json").write_text(json.dumps(bench))
    out = subprocess.run([sys.executable, "-c", WITHOUT_PROGRAM.format(base=str(tmp_path))],
                         capture_output=True, text=True, cwd=tmp_path, timeout=300,
                         env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path)})
    assert out.returncode != 0
    assert "cigwas_tpu_torch" in out.stderr and '"correct"' not in out.stdout
