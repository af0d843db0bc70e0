#!/usr/bin/env python3
"""The bfloat16 control of a cell over the first markers of its traffic.

    python3 h100bench/control_cut.py --workload <cell> --markers 2000 --seeds 1 2 3

``calibrate.py``'s steps with the traffic cut to ``--markers`` (and, for a
check on the CPU, the individuals to ``--individuals``): for each
seed it makes the cell's data, runs one solve of the program, the reference
and the reference in bfloat16, and prints one JSON line with the numbers
compared for both (the program's and the control's), the variables each
reference kept and the process's peak resident memory. For a cell whose
control cannot be computed at its full width: in bfloat16 the reference's
second stage can keep thousands of markers, and its skeleton then outgrows
the host. The benchmark's own runs do not run this.
"""

import json
import os
import resource
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
    ap.add_argument("--markers", type=int, required=True)
    ap.add_argument("--individuals", type=int)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    device = "cuda" if torch.cuda.is_available() else "cpu"
    c = harness.cell(args.workload, harness.spec())
    c.traffic = {**c.traffic, "markers": args.markers}
    if args.individuals:
        c.cfg = {**c.cfg, "individuals": args.individuals}
    for seed in args.seeds:
        work = Path(tempfile.mkdtemp(prefix="h100bench-ctl-"))
        try:
            data = c.generator.generate(c.cfg, c.traffic, seed % (1 << 63), str(work), device)
            state = c.entry.setup(c.cfg, data, device)
            (work / "out").mkdir()
            t = time.perf_counter()
            c.entry.solve(state, str(work / "out"))
            line = {"seed": seed, "markers": args.markers,
                    "individuals": c.cfg["individuals"], "solve_s": time.perf_counter() - t}
            if device == "cuda":
                torch.cuda.empty_cache()
            t = time.perf_counter()
            ref = c.entry.expected(state, device)
            line["reference_s"] = time.perf_counter() - t
            out = compare.read_output(compare.output_base(str(work / "out")),
                                      c.entry.WITH_SEPSETS)
            t = time.perf_counter()
            ctl = c.entry.expected(state, device, torch.bfloat16)
            line["control_s"] = time.perf_counter() - t
            line["kept"] = {"reference": int(ref["ixs"].size), "control": int(ctl["ixs"].size)}
            line["program"] = compare.compare(out, ref)
            line["control"] = compare.compare(ctl, ref)
            line["maxrss_gib"] = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20
            print(json.dumps(line), flush=True)
        finally:
            shutil.rmtree(work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
