#!/usr/bin/env python3
"""Readings that the limits of ``correct`` are set from, in one process.

    python3 h100bench/calibrate.py --workload <cell> --seeds 1 2 3 --control-seeds 1 2 3

For each seed it makes the cell's data, runs one solve of the program and
the reference, and prints the numbers compared (the lower readings: the
program's); for each control seed it also puts the reference computed in
bfloat16 in the program's place (the upper readings: the control's). One
JSON line a seed, then the largest program reading and the smallest
control reading of each number. The benchmark's own runs do not run this.
"""

import json
import os
import shutil
import sys
import tempfile
import time
from pathlib import Path

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0] = ROOT


def main(argv: list) -> int:
    import argparse

    import torch

    from h100bench import harness
    from h100bench.reference import compare

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    args = ap.parse_args(argv)
    device = "cuda" if torch.cuda.is_available() else "cpu"
    c = harness.cell(args.workload, harness.spec())
    lower, upper = {}, {}
    for seed in dict.fromkeys(args.seeds + args.control_seeds):
        work = Path(tempfile.mkdtemp(prefix="h100bench-cal-"))
        try:
            data = c.generator.generate(c.cfg, c.traffic, seed % (1 << 63), str(work), device)
            state = c.entry.setup(c.cfg, data, device)
            (work / "out").mkdir()
            t = time.perf_counter()
            stats = c.entry.solve(state, str(work / "out"))
            line = {"seed": seed, "solve_s": time.perf_counter() - t,
                    "routes": {s: stats[s].get("level_route") for s in ("stage1", "stage2")},
                    "widths": {s: {l: max(d for d, _ in v) for l, v in
                                   stats[s].get("launches", {}).items()}
                               for s in ("stage1", "stage2")}}
            if device == "cuda":
                torch.cuda.empty_cache()
            t = time.perf_counter()
            ref = c.entry.expected(state, device)
            line["reference_s"] = time.perf_counter() - t
            out = compare.read_output(compare.output_base(str(work / "out")),
                                      c.entry.WITH_SEPSETS)
            if seed in args.seeds:
                line["program"] = compare.compare(out, ref)
                for k, v in line["program"].items():
                    lower[k] = max(lower.get(k, v), v)
            if seed in args.control_seeds:
                t = time.perf_counter()
                ctl = c.entry.expected(state, device, torch.bfloat16)
                line["control_s"] = time.perf_counter() - t
                line["control"] = compare.compare(ctl, ref)
                for k, v in line["control"].items():
                    upper[k] = min(upper.get(k, v), v)
            print(json.dumps(line), flush=True)
        finally:
            shutil.rmtree(work, ignore_errors=True)
    print(json.dumps({"lower": lower, "upper": upper}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
