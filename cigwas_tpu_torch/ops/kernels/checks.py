"""Argument checks shared by the kernel wrappers: what a kernel takes is
validated in Python before any pointer is passed to it.

Dtype, shape and device are checked at every launch; they cost nothing. The
index range is checked once per set of lists by :func:`check_index_range`:
on the host arrays before their upload where the caller has them (the
skeleton does, and then launches with ``index_range_checked=True``, so a
launch adds no synchronisation), else by the wrapper on the device tensors,
which reads one flag back and so waits for the device."""

from __future__ import annotations

import torch


def check_panels(who: str, C: torch.Tensor, **others: torch.Tensor) -> int:
    """C and every other panel a square (vp, vp) float32 tensor on C's
    device; returns vp."""
    vp = C.shape[0]
    for name, P in {"C": C, **others}.items():
        if (P.dtype != torch.float32 or tuple(P.shape) != (vp, vp)
                or P.device != C.device):
            raise ValueError(
                f"{who}: {name} must be a ({vp}, {vp}) float32 panel on {C.device}")
    return vp


def check_int32(who: str, device: torch.device, **named) -> None:
    """named: name=(tensor, shape); each an int32 tensor of that shape on device."""
    for name, (t, shape) in named.items():
        if t.dtype != torch.int32 or tuple(t.shape) != shape or t.device != device:
            raise ValueError(f"{who}: {name} must be int32 {shape} on {device}")


def check_index_range(who: str, vp: int, d: int, node_ixs, nbrs, deg) -> None:
    """node_ixs and nbrs within [0, vp), deg within [0, d]; numpy arrays (no
    device involved) or tensors (one flag read back from the device)."""
    if nbrs.shape[0] == 0 or nbrs.shape[1] == 0:
        return
    bad = (
        (nbrs.min() < 0) | (nbrs.max() >= vp) | (node_ixs.min() < 0)
        | (node_ixs.max() >= vp) | (deg.min() < 0) | (deg.max() > d)
    )
    if bool(bad):
        raise ValueError(f"{who}: index out of range (nbrs, node_ixs < {vp}; deg <= {d})")
