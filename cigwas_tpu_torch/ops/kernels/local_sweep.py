"""Wrapper of the levels 1-3 sweep kernel ``csrc/local_sweep.cu``.

:func:`local_sweep` launches the CUDA kernel for CUDA tensors and runs the
plain version (:func:`cigwas_tpu_torch.ops.pcorr.local_sweep_plain`) for CPU
tensors; nothing else. The kernel is built at its first launch
(:mod:`cigwas_tpu_torch.ops.kernels.build`), never at import.
"""

from __future__ import annotations

import ctypes

import torch

from cigwas_tpu_torch.ops import pcorr
from cigwas_tpu_torch.ops.kernels import build

SOURCE = "cigwas_tpu_torch/csrc/local_sweep.cu"
# kernel launches per level since the last reset; the CPU path adds nothing
launches = {1: 0, 2: 0, 3: 0}


def reset_launches() -> None:
    for l in launches:
        launches[l] = 0


def _lib() -> ctypes.CDLL:
    lib = build.load("local_sweep")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.local_sweep_launch.argtypes = [p, ll, p, p, p, i, i, i, p, p, p, p]
    lib.local_sweep_launch.restype = i
    lib.local_sweep_scratch_floats.argtypes = [i, i]
    lib.local_sweep_scratch_floats.restype = ll
    return lib


def local_sweep(C: torch.Tensor, node_ixs: torch.Tensor, nbrs: torch.Tensor,
                deg: torch.Tensor, l: int):
    """Min |pcorr(x, y | S)| over |S| = l for every node x and neighbour
    slot y, with the minimizing positions.

    C (vp, vp) f32 panel; node_ixs (nt,), nbrs (nt, d) ascending neighbour
    lists (pad slots hold any valid index), deg (nt,) <= d, all int32.
    Returns rho (nt, d) f32 and pos (nt, d, l) int32 ascending positions
    into the neighbour list; pad slots y >= deg come back as (2.0, 0).
    """
    if l not in (1, 2, 3):
        raise ValueError(f"local_sweep serves levels 1-3, got {l}")
    if C.device.type == "cpu":
        return pcorr.local_sweep_plain(C, node_ixs, nbrs, deg, l)
    if C.device.type != "cuda":
        raise ValueError(f"local_sweep: unsupported device {C.device}")
    nt, d = nbrs.shape
    vp = C.shape[0]
    if C.dtype != torch.float32 or C.dim() != 2 or C.shape[1] != vp:
        raise ValueError("local_sweep: C must be a square float32 panel")
    for name, t, shape in (("node_ixs", node_ixs, (nt,)), ("nbrs", nbrs, (nt, d)),
                           ("deg", deg, (nt,))):
        if t.dtype != torch.int32 or tuple(t.shape) != shape or t.device != C.device:
            raise ValueError(f"local_sweep: {name} must be int32 {shape} on {C.device}")
    C, node_ixs, nbrs, deg = (t.contiguous() for t in (C, node_ixs, nbrs, deg))
    rho = torch.empty((nt, d), dtype=torch.float32, device=C.device)
    pos = torch.empty((nt, d, l), dtype=torch.int32, device=C.device)
    if nt == 0 or d == 0:
        return rho, pos
    bad = (
        (nbrs.min() < 0) | (nbrs.max() >= vp) | (node_ixs.min() < 0)
        | (node_ixs.max() >= vp) | (deg.min() < 0) | (deg.max() > d)
    )
    if bool(bad):
        raise ValueError("local_sweep: index out of range (nbrs, node_ixs < vp; deg <= d)")
    lib = _lib()
    n_scratch = lib.local_sweep_scratch_floats(nt, d)
    scratch = (
        torch.empty(n_scratch, dtype=torch.float32, device=C.device)
        if n_scratch else None
    )
    with torch.cuda.device(C.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.local_sweep_launch(
            C.data_ptr(), vp, node_ixs.data_ptr(), nbrs.data_ptr(),
            deg.data_ptr(), nt, d, l,
            scratch.data_ptr() if scratch is not None else None,
            rho.data_ptr(), pos.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"local_sweep kernel launch failed: cudaError {err}")
    launches[l] += 1
    return rho, pos
