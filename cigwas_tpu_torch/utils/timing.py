"""Lightweight timing / tracing instrumentation (`cigwas_tpu.utils.timing`).

Equivalent of the reference's cudaEvent "spent seconds" prints around every
level kernel (`cuPC-S.cu:80-83,130-134`): a stage timer that logs wall-clock
per named stage and can wrap the run in a `torch.profiler` trace.
"""

from __future__ import annotations

import contextlib
import os
import time


class StageTimer:
    """Collects named stage durations; optionally prints as it goes."""

    def __init__(self, verbose: bool = False, prefix: str = ""):
        self.verbose = verbose
        self.prefix = prefix
        self.stages: list[tuple[str, float]] = []

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        yield
        dt = time.perf_counter() - t0
        self.stages.append((name, dt))
        if self.verbose:
            print(f"{self.prefix}[{name}] spent seconds: {dt:.4f}", flush=True)

    def total(self) -> float:
        return sum(dt for _, dt in self.stages)

    def as_dict(self) -> dict:
        return dict(self.stages)


@contextlib.contextmanager
def maybe_profile(trace_dir: str | None = None):
    """torch.profiler trace (CPU, and the card where there is one) written
    as a Chrome trace into a directory when one is given (or via
    CIGWAS_TORCH_TRACE_DIR), else a no-op."""
    trace_dir = trace_dir or os.environ.get("CIGWAS_TORCH_TRACE_DIR")
    if not trace_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(trace_dir, f"trace_{os.getpid()}.json"))
