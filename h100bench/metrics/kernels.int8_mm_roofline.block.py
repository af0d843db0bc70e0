"""The int8 contingency products' share of their roofline: 100 x the least
time of a solve's products on the card (``h100bench/roofline.py``, from the
panel's unpadded ``panel_markers`` m and ``panel_samples`` n: the distinct
pairs of indicator rows, 3 m (3 m + 1) n operations at 1.979e15 a second,
which bound it) over the device seconds of the kernels that
``kernels.int8_mm_device_ms.block`` counts. None where the program does not
count the panel's shape or the trace holds no such kernel."""

from pathlib import Path

from h100bench.harness import load_module
from h100bench.roofline import int8_panel_seconds

PATTERN = load_module(Path(__file__).with_name("kernels.int8_mm_device_ms.block.py"),
                      "h100bench_metric_kernels.int8_mm_device_ms.block").PATTERN


def read(run):
    if not run.stats or any("panel_markers" not in s or "panel_samples" not in s
                            for s in run.stats):
        return None
    sec, records = run.trace.family(PATTERN)
    if not records or sec <= 0:
        return None
    least = sum(int8_panel_seconds(s["panel_markers"], s["panel_samples"]) for s in run.stats)
    return 100.0 * least / sec
