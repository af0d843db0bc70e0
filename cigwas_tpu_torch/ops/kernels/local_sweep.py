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
from cigwas_tpu_torch.ops.kernels.checks import (
    check_index_range,
    check_int32,
    check_panels,
)

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
                deg: torch.Tensor, l: int, *, index_range_checked: bool = False):
    """Min |pcorr(x, y | S)| over |S| = l for every node x and neighbour
    slot y, with the minimizing positions.

    C (vp, vp) f32 panel; node_ixs (nt,), nbrs (nt, d) ascending neighbour
    lists (pad slots hold any valid index), deg (nt,) <= d, all int32.
    Returns rho (nt, d) f32 and pos (nt, d, l) int32 ascending positions
    into the neighbour list; pad slots y >= deg come back as (2.0, 0).

    index_range_checked: the caller has held these lists to
    :func:`~cigwas_tpu_torch.ops.kernels.checks.check_index_range` on the
    host, so the launch does not wait for the device to check them again.
    """
    if l not in (1, 2, 3):
        raise ValueError(f"local_sweep serves levels 1-3, got {l}")
    if C.device.type == "cpu":
        return pcorr.local_sweep_plain(C, node_ixs, nbrs, deg, l)
    if C.device.type != "cuda":
        raise ValueError(f"local_sweep: unsupported device {C.device}")
    nt, d = nbrs.shape
    vp = check_panels("local_sweep", C)
    check_int32("local_sweep", C.device, node_ixs=(node_ixs, (nt,)),
                nbrs=(nbrs, (nt, d)), deg=(deg, (nt,)))
    C, node_ixs, nbrs, deg = (t.contiguous() for t in (C, node_ixs, nbrs, deg))
    rho = torch.empty((nt, d), dtype=torch.float32, device=C.device)
    pos = torch.empty((nt, d, l), dtype=torch.int32, device=C.device)
    if nt == 0 or d == 0:
        return rho, pos
    if not index_range_checked:
        check_index_range("local_sweep", vp, d, node_ixs, nbrs, deg)
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
