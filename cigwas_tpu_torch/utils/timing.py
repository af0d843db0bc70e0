"""Spans and transfer counters of the solve path (`cigwas_tpu.utils.timing`).

:class:`span` adds a block's host wall into a ``stats`` dict, the port's one
record of where a solve's time goes, :func:`to_host` fetches a device
tensor and counts its bytes there under ``stats["d2h_bytes"][site]``,
:func:`to_device` uploads a host array and counts its bytes under
``stats["h2d_bytes"][site]``, and :func:`count` adds to any other counter.
While a ``torch.profiler`` records, and only then, each span and transfer
also opens a ``torch.profiler.record_function`` annotation: the span then
lies in the profiler's trace on the clock of the kernels and copies it
caused, nested under the span that was open when it began. Names follow the
layers of the solve: ``cigwas.pipeline.*``, ``cigwas.io.*``,
``cigwas.panel.*``, ``cigwas.skeleton.*``, ``cigwas.reduce.*`` and
``cigwas.transfer.<site>`` (:func:`to_host`, :func:`to_device`).

None synchronises the device: a wall ends where the code it wraps ends,
in a synchronisation or a fetch only where that code makes one. With no
profiler recording, a span costs the clock reads and one flag check.
"""

from __future__ import annotations

import time

import numpy as np
import torch
from torch.autograd import _profiler_enabled


def _add(stats: dict, key, value) -> None:
    """stats[key] += value (from 0); a tuple key names a path of nested dicts."""
    if isinstance(key, tuple):
        *path, key = key
        for k in path:
            stats = stats.setdefault(k, {})
    stats[key] = stats.get(key, 0) + value


class span:
    """Context manager: adds the host seconds of its block to ``stats[key]``
    (accumulating; a tuple key is a path into nested dicts; no record where
    stats or key is None) and, while a profiler records, annotates the block
    as ``name`` in its trace."""

    __slots__ = ("stats", "key", "name", "t0", "rf")

    def __init__(self, stats: dict | None, key, name: str):
        self.stats, self.key, self.name = stats, key, name

    def __enter__(self):
        self.rf = None
        if _profiler_enabled():
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self.t0
        if self.rf is not None:
            self.rf.__exit__(*exc)
        if self.stats is not None and self.key is not None:
            _add(self.stats, self.key, dt)
        return False


def to_host(t: torch.Tensor, stats: dict | None, site: str, copy: bool = False) -> np.ndarray:
    """``t`` as a host numpy array, its bytes added to
    ``stats["d2h_bytes"][site]`` whatever its device (so the count of a CPU
    run is the card's), under the annotation ``cigwas.transfer.<site>`` while
    a profiler records. copy: a fresh array even where t already lives on
    the host (the result is written to)."""
    if stats is not None:
        _add(stats, ("d2h_bytes", site), t.numel() * t.element_size())
    if _profiler_enabled():
        with torch.profiler.record_function("cigwas.transfer." + site):
            return t.to("cpu", copy=copy).numpy()
    return t.to("cpu", copy=copy).numpy()


def count(stats: dict | None, key, value) -> None:
    """stats[key] += value (from 0; a tuple key is a path of nested dicts);
    nothing where stats is None."""
    if stats is not None:
        _add(stats, key, value)


def to_device(a: np.ndarray, device, stats: dict | None, site: str) -> torch.Tensor:
    """A fresh tensor on device holding ``a``, its bytes added to
    ``stats["h2d_bytes"][site]`` whatever the device (so the count of a CPU
    run is the card's), under the annotation ``cigwas.transfer.<site>`` while
    a profiler records."""
    count(stats, ("h2d_bytes", site), a.nbytes)
    if _profiler_enabled():
        with torch.profiler.record_function("cigwas.transfer." + site):
            return torch.tensor(a, device=device)
    return torch.tensor(a, device=device)
