#!/usr/bin/env python3
"""Run one cell of the benchmark once and print its result as one JSON line.

    python3 h100bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout that holds the program. The kernel and
compiler caches live in fixed directories under ``.bench_cache/`` of the
checkout, so only the first run of a checkout builds. Exits 2 without a
result where the cell's CUDA cards are missing, and 3 where a module of
JAX, of the JAX package or of ``chip_smoke`` was loaded.
"""

import os
import sys
import time

T_START = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, ".bench_cache")
for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("CUDA_CACHE_PATH", "cuda")):
    os.environ[var] = os.path.join(CACHE, sub)
sys.path[0] = ROOT

if __name__ == "__main__":
    from h100bench.harness import main

    sys.exit(main(sys.argv[1:], T_START))
