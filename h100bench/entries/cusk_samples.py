"""A solve of one LD block through ``cigwas_tpu_torch.pipelines.cusk.cusk``
at a biobank's sample size.

Set-up and solve are those of ``entries/cusk.py``. The reference solves the
block again from the ``.bed`` and ``.phen`` files with its panel built by
chunks of samples (``reference/cusk_samples.py``).
"""

from __future__ import annotations

from pathlib import Path

import torch

from h100bench.harness import load_module
from h100bench.reference import cusk_samples as reference

_cusk = load_module(Path(__file__).with_name("cusk.py"), "h100bench_entry_cusk")
setup, solve = _cusk.setup, _cusk.solve

WITH_SEPSETS = True


def expected(state: dict, device, dtype=torch.float64) -> dict:
    data = state["data"]
    return reference.solve(data["stem"] + ".bed", data["stem"] + ".phen", data["markers"],
                           data["individuals"], state["cfg"], device, dtype)
