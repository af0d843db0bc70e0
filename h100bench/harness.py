"""One run of one cell: set-up, a closed loop of whole solves, the check.

1. Set-up: the cell's traffic generator makes its data on the card from
   the seed and writes the files its users' commands read, under
   ``TMPDIR``; the entry prepares them (``prep-bed``); one warm solve
   builds whatever the program builds at first use.
2. The window: solves start one after another; it ends when the first
   solve that finishes after ``seconds`` finishes, so no solve is cut.
   Each solve writes into a directory of its own.
3. The check: the reference solves the same inputs once more, after the
   window and with the program's state freed, and every solve's files are
   compared with its result; ``correct`` holds when no solve failed and
   every number is within its limit (``limits`` of the cell's file).

``--trace 0`` reports the cell's end-to-end metrics: the window's seconds
per completed solve under the cell's ``per_solve`` name, ``peak_device_gib``
(``torch.cuda.max_memory_allocated`` over the window) and ``setup_s``
(process start to the window's start). ``--trace 1`` runs the window under
the profiler (:mod:`h100bench.tracing`) and reports the per-layer metrics
of ``BENCHMARK.json`` that list the cell, each from its reader in
``metrics/``.
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import importlib.util
import json
import shutil
import sys
import tempfile
import time
import traceback
from pathlib import Path
from types import SimpleNamespace

import torch

from h100bench import tracing
from h100bench.reference import compare

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# top-level module names that no run may load
FORBIDDEN = ("jax", "jaxlib", "flax", "cigwas_tpu", "chip_smoke")
# the program's modules whose ``launches`` dicts count kernel launches
COUNTED = ("local_sweep", "panel_gather", "dense_l1", "hetcor_sweep")
GIB = float(1 << 30)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    """The module in file path, loaded under name."""
    if not path.is_file():
        raise FileNotFoundError(path)
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def spec(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def cell(name: str, bench: dict, here: Path = HERE) -> SimpleNamespace:
    """Everything one cell needs, found by name: its entry in
    ``BENCHMARK.json`` and ``workloads/<name>.json``, the configuration and
    traffic they name, the traffic's generator and the cell's entry."""
    entry = {w["name"]: w for w in bench["workloads"]}.get(name)
    if entry is None:
        raise KeyError(f"BENCHMARK.json has no cell {name!r}")
    work = load_json(here / "workloads" / f"{name}.json")
    if (work["config"], work["traffic"]) != (entry["config"], entry["traffic"]):
        raise ValueError(f"{name}: workloads/{name}.json and BENCHMARK.json disagree")
    traffic = load_json(here / "traffic" / f"{work['traffic']}.json")
    return SimpleNamespace(
        name=name, chips=entry["chips"], work=work,
        cfg=load_json(here / "configs" / f"{work['config']}.json"), traffic=traffic,
        generator=load_module(here / "generators" / f"{traffic['generator']}.py",
                              f"h100bench_generator_{traffic['generator']}"),
        entry=load_module(here / "entries" / f"{work['entry']}.py",
                          f"h100bench_entry_{work['entry']}"),
    )


def end_to_end(bench: dict, name: str) -> list:
    return [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]


def per_layer(bench: dict, name: str) -> list:
    reported = {m["name"] for m in end_to_end(bench, name)}
    return [m for m in bench["per_layer"]
            if name in m.get("workloads", [name] if m["moves"] in reported else [])]


def counters() -> dict:
    """The program's kernel launch counters, flattened."""
    out = {}
    for mod in COUNTED:
        m = sys.modules.get(f"cigwas_tpu_torch.ops.kernels.{mod}")
        for k, v in (getattr(m, "launches", None) or {}).items():
            out[k if isinstance(k, str) else f"{mod}_l{k}"] = v
    return out


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def _files_digest(outdir: Path) -> str:
    h = hashlib.sha256()
    for f in sorted(outdir.iterdir()):
        h.update(f.name.encode() + b"\0" + f.read_bytes())
    return h.hexdigest()


def judge(c: SimpleNamespace, state: dict, outdirs: list, device, dtype=torch.float64):
    """(numbers, malformed outputs): the reference's result against every
    output directory; identical outputs are compared once."""
    ref = c.entry.expected(state, device, dtype)
    numbers, bad, seen = [], 0, {}
    for d in outdirs:
        try:
            key = _files_digest(d)
            if key not in seen:
                out = compare.read_output(compare.output_base(str(d)), c.entry.WITH_SEPSETS)
                seen[key] = compare.compare(out, ref)
            numbers.append(seen[key])
        except compare.Malformed as e:
            print(f"malformed output: {e}", file=sys.stderr)
            bad += 1
    return compare.worst(numbers), bad


def run(c: SimpleNamespace, bench: dict, seed: int, seconds: float, trace: bool,
        device: str = "cuda", t_start: float | None = None) -> tuple[dict, dict]:
    """One run of cell c: (the result line's object, the numbers compared
    with their limits)."""
    t_start = time.perf_counter() if t_start is None else t_start
    cuda = device.startswith("cuda")
    work = Path(tempfile.mkdtemp(prefix="h100bench-"))
    try:
        data = c.generator.generate(c.cfg, c.traffic, seed % (1 << 63), str(work), device)
        state = c.entry.setup(c.cfg, data, device)
        (work / "warm").mkdir()
        c.entry.solve(state, str(work / "warm"))
        setup_peak = 0
        if cuda:
            torch.cuda.synchronize()
            setup_peak = torch.cuda.max_memory_allocated()
            torch.cuda.reset_peak_memory_stats()
        before = counters()
        outdirs, stats, walls, failed = [], [], [], 0
        traced = tracing.Traced() if trace else None
        with traced or contextlib.nullcontext():
            t0 = time.perf_counter()
            setup_s = t0 - t_start
            while True:
                out = work / f"solve{len(walls)}"
                out.mkdir()
                ts = time.perf_counter()
                try:
                    with traced.solve() if traced else contextlib.nullcontext():
                        st = c.entry.solve(state, str(out))
                    outdirs.append(out)
                    stats.append(st)
                except Exception:  # a solve that raises is a failed solve; the loop goes on
                    traceback.print_exc(limit=4, file=sys.stderr)
                    failed += 1
                t1 = time.perf_counter()
                walls.append(t1 - ts)
                if t1 - t0 >= seconds:
                    break
        window_s = t1 - t0
        attempted = len(outdirs) + failed
        peak = torch.cuda.max_memory_allocated() if cuda else 0
        launches = {k: v - before.get(k, 0) for k, v in counters().items()}
        metrics, extra = {}, {}
        if trace:
            summary = traced.summary(t0, t1)
            record = SimpleNamespace(stats=stats, solves=len(stats), window_s=window_s,
                                     trace=summary, launches=launches)
            for m in per_layer(bench, c.name):
                reader = load_module(HERE / "metrics" / f"{m['name']}.py",
                                     f"h100bench_metric_{m['name']}")
                value = reader.read(record)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
            extra = {"busy_s": summary.busy_s, "window_s": window_s}
            breakdown = summary.breakdown()
            traced = summary = None  # the trace's events are freed before the check
        else:
            # over the solves completed; with none the window itself (correct is false)
            values = {c.work["per_solve"]: window_s / max(1, len(stats)),
                      "peak_device_gib": peak / GIB, "setup_s": setup_s}
            for m in end_to_end(bench, c.name):
                metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
        if cuda:
            torch.cuda.empty_cache()
        t_ref = time.perf_counter()
        numbers, malformed = judge(c, state, outdirs, device)
        print(json.dumps({"solve_walls_s": walls, "reference_s": time.perf_counter() - t_ref}),
              file=sys.stderr)
        failed += malformed
        limits = c.work["limits"]
        compared = {k: {"value": numbers.get(k), "limit": limits[k]} for k in limits}
        correct = (failed == 0 and bool(stats) and all(
            v["value"] is not None and v["value"] <= v["limit"] for v in compared.values()))
        result = {
            "correct": correct, "attempted": attempted, "failed": failed, "metrics": metrics,
            "device": {
                "platform": "gpu" if cuda else "cpu",
                "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                "count": c.chips, "memory_peak_bytes": max(setup_peak, peak), **extra},
        }
        if trace:
            result["breakdown"] = breakdown
        result["compared"] = compared
        return result, compared
    finally:
        shutil.rmtree(work, ignore_errors=True)


def main(argv: list, t_start: float) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = spec()
    c = cell(args.workload, bench)
    if not torch.cuda.is_available() or torch.cuda.device_count() < c.chips:
        print(f"{args.workload} needs {c.chips} CUDA card(s); "
              f"torch sees {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result, compared = run(c, bench, args.seed, args.seconds, bool(args.trace),
                           t_start=t_start)
    leaked = forbidden_modules()
    if leaked:
        print(f"modules that no run may load were loaded: {leaked}", file=sys.stderr)
        return 3
    for k, v in compared.items():
        print(f"{k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0
