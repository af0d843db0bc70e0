"""The traced window: torch.profiler over whole solves, and a sampler of
what the host was running.

The profiler records the card's kernels, copies and sets; a thread samples
the main thread's Python stack every ``SAMPLE_S`` and names it by the
innermost function of the program (``cigwas_tpu_torch``) on the stack. Both
are read on one clock: each solve runs under a profiler annotation whose
host start is known. From the trace come the seconds the card was busy (the
union of its intervals inside the window), the device time of each kernel,
and the idle gaps between busy intervals, each named by what the host was
running during it.
"""

from __future__ import annotations

import bisect
import json
import os
import re
import sys
import tempfile
import threading
import time
from collections import Counter, defaultdict

import torch

SAMPLE_S = 0.002
SOLVE_SPAN = "h100bench.solve"
PROGRAM = os.sep + "cigwas_tpu_torch" + os.sep
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class HostSampler(threading.Thread):
    """Samples (perf_counter, name) of what the main thread runs."""

    def __init__(self):
        super().__init__(daemon=True)
        self.main = threading.main_thread().ident
        self.samples: list = []
        self.halt = threading.Event()

    def run(self) -> None:
        while not self.halt.wait(SAMPLE_S):
            frame = sys._current_frames().get(self.main)
            name = "harness"
            while frame is not None:
                path = frame.f_code.co_filename
                if PROGRAM in path:
                    rel = path.split(PROGRAM, 1)[1]
                    name = f"{rel}:{frame.f_code.co_name}"
                    break
                frame = frame.f_back
            self.samples.append((time.perf_counter(), name))

    def stop(self) -> None:
        self.halt.set()
        self.join()


class Traced:
    """Context of the traced window: the profiler and the host sampler."""

    def __enter__(self):
        self.anchors: list = []  # host start of each solve, in order
        self.prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU,
                        torch.profiler.ProfilerActivity.CUDA])
        self.sampler = HostSampler()
        self.prof.__enter__()
        self.sampler.start()
        return self

    def solve(self):
        self.anchors.append(time.perf_counter())
        return torch.profiler.record_function(SOLVE_SPAN)

    def __exit__(self, *exc):
        self.sampler.stop()
        self.prof.__exit__(*exc)
        return False

    def summary(self, t0: float, t1: float) -> "Summary":
        """The trace of the window [t0, t1] (host perf_counter seconds)."""
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.unlink(path)
        return Summary(events, self.anchors, self.sampler.samples, t0, t1)


def _union(intervals: list) -> list:
    merged: list = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


class Summary:
    """Busy seconds, device time by kernel name and idle gaps of a window."""

    def __init__(self, events: list, anchors: list, samples: list, t0: float, t1: float):
        spans = sorted(e["ts"] for e in events
                       if e.get("ph") == "X" and e.get("name") == SOLVE_SPAN
                       and e.get("cat") == "user_annotation")
        if not spans or not anchors:
            raise RuntimeError("the trace holds no solve annotation")
        # trace microseconds -> host seconds, from the first solve's annotation
        offset = anchors[0] - spans[0] * 1e-6
        self.window_s = t1 - t0
        self.kernels: dict = defaultdict(lambda: [0.0, 0])
        busy = []
        for e in events:
            if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
                continue
            a = e["ts"] * 1e-6 + offset
            b = a + e.get("dur", 0) * 1e-6
            a, b = max(a, t0), min(b, t1)
            if b <= a:
                continue
            busy.append((a, b))
            k = self.kernels[e["name"]]
            k[0] += b - a
            k[1] += 1
        merged = _union(busy)
        self.busy_s = sum(b - a for a, b in merged)
        edges = [t0] + [x for iv in merged for x in iv] + [t1]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        self.idle_by_host: Counter = Counter()
        times = [s[0] for s in samples]
        for a, b in gaps:
            lo, hi = bisect.bisect_left(times, a), bisect.bisect_right(times, b)
            names = Counter(name for _, name in samples[lo:hi])
            self.idle_by_host[names.most_common(1)[0][0] if names else "unsampled"] += b - a

    def family(self, pattern: str) -> tuple[float, int]:
        """(device seconds, records) of the kernels whose name matches."""
        rx = re.compile(pattern)
        sec, n = 0.0, 0
        for name, (s, c) in self.kernels.items():
            if rx.search(name):
                sec += s
                n += c
        return sec, n

    def breakdown(self) -> dict:
        ops = sorted(((n, s) for n, (s, _) in self.kernels.items()), key=lambda x: -x[1])
        gaps = sorted(self.idle_by_host.items(), key=lambda x: -x[1])
        return {"device_ops": [[n[:200], s] for n, s in ops[:10]],
                "idle_gaps": [[n, s] for n, s in gaps[:10]]}
