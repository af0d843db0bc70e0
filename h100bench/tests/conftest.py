"""Fixtures of the benchmark's CPU tests: a copy of the benchmark folder
with one tiny cell of each entry, run on the CPU with the program's plain
kernel versions.

    python -m pytest h100bench/tests -q

Tests that need a card carry the ``cuda`` marker and skip without one.
"""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

HERE = ROOT / "h100bench"

TINY_CUSK = {"individuals": 2000, "traits": 4}
TINY_CUSKSS = {"traits": 4, "num_samples": 500000.0}


def _write(path: Path, obj) -> None:
    path.write_text(json.dumps(obj))


@pytest.fixture(scope="session")
def tiny(tmp_path_factory):
    torch.set_num_threads(2)
    return make_tiny(tmp_path_factory.mktemp("bench"))


def make_tiny(base: Path):
    """(here, bench): a copy of ``h100bench/`` under base with the cells
    ``tiny.cusk`` (600 markers x 2,000 individuals x 4 traits) and
    ``tiny.cuskss`` (400 markers x 4 traits), and the BENCHMARK.json object
    that names them."""
    here = base / "h100bench"
    shutil.copytree(HERE, here, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    cfg = json.loads((HERE / "configs" / "cusk_ind16k.json").read_text())
    _write(here / "configs" / "tiny_cusk.json", {**cfg, **TINY_CUSK})
    _write(here / "traffic" / "tiny_block.json",
           {"generator": "ar1_block", "markers": 600, "chunk": 256, "layout_seed": 11})
    limits = json.loads((HERE / "workloads" / "cusk.block11k.json").read_text())["limits"]
    _write(here / "workloads" / "tiny.cusk.json",
           {"config": "tiny_cusk", "traffic": "tiny_block", "entry": "cusk",
            "per_solve": "block_s", "why": "tiny", "limits": limits})
    cells = [{"name": "tiny.cusk", "config": "tiny_cusk", "traffic": "tiny_block", "chips": 1}]
    ss = HERE / "workloads" / "cuskss.input10k.json"
    if ss.exists():
        cfg = json.loads((HERE / "configs" / "cuskss_merged10k.json").read_text())
        _write(here / "configs" / "tiny_cuskss.json", {**cfg, **TINY_CUSKSS})
        traffic = json.loads((HERE / "traffic" / "input10k.json").read_text())
        _write(here / "traffic" / "tiny_input.json", {**traffic, "markers": 400})
        work = json.loads(ss.read_text())
        _write(here / "workloads" / "tiny.cuskss.json",
               {**work, "config": "tiny_cuskss", "traffic": "tiny_input"})
        cells.append({"name": "tiny.cuskss", "config": "tiny_cuskss",
                      "traffic": "tiny_input", "chips": 1})
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench = {**bench, "workloads": cells,
             "end_to_end": [{**m, "workloads": [c["name"] for c in cells]}
                            if m["name"] in ("peak_device_gib", "setup_s")
                            else {**m, "workloads": ["tiny.cusk" if m["name"] == "block_s"
                                                     else "tiny.cuskss"]}
                            for m in bench["end_to_end"]
                            if m["name"] in ("block_s", "input_s", "peak_device_gib",
                                             "setup_s")],
             "per_layer": []}
    return here, bench
