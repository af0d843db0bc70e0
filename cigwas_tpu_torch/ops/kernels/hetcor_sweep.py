"""Wrapper of the hetcor levels 1-3 kernel ``csrc/hetcor_sweep.cu``.

:func:`hetcor_local_sweep` launches the CUDA kernel for CUDA tensors and runs
the plain version (:func:`cigwas_tpu_torch.ops.pcorr.hetcor_local_sweep_plain`)
for CPU tensors; nothing else. The kernel is built at its first launch
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

SOURCE = "cigwas_tpu_torch/csrc/hetcor_sweep.cu"
# kernel launches per level since the last reset; the CPU path adds nothing
launches = {1: 0, 2: 0, 3: 0}


def reset_launches() -> None:
    for l in launches:
        launches[l] = 0


def _lib() -> ctypes.CDLL:
    lib = build.load("hetcor_sweep")
    p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    lib.hetcor_sweep_launch.argtypes = [p, p, p, ll, p, p, p, i, i, i, f, p, p, p]
    lib.hetcor_sweep_launch.restype = i
    lib.hetcor_sweep_scratch_floats.argtypes = [i, i]
    lib.hetcor_sweep_scratch_floats.restype = ll
    return lib


def hetcor_local_sweep(C: torch.Tensor, N: torch.Tensor, t_ix: torch.Tensor,
                       node_ixs: torch.Tensor, nbrs: torch.Tensor,
                       deg: torch.Tensor, th: float, l: int, *,
                       index_range_checked: bool = False) -> torch.Tensor:
    """Min hetcor margin |pcorr(x, y | S)| - tanh(th / sqrt(mean_ess - l - 3))
    over |S| = l for every node x and neighbour slot y.

    C, N (vp, vp) f32 correlation and per-pair ESS panels (N raw or truncated,
    NaN = no estimate); t_ix (vp,), node_ixs (nt,), nbrs (nt, d) ascending
    neighbour lists (pad slots hold any valid index), deg (nt,) <= d, all
    int32; th the scalar |Phi^-1(alpha / 2)|. Returns margin (nt, d) f32:
    negative where some allowed S separates x and y; 3.0e38 at pad slots
    y >= deg and where no test is valid.

    index_range_checked: the caller has held these lists to
    :func:`~cigwas_tpu_torch.ops.kernels.checks.check_index_range` on the
    host, so the launch does not wait for the device to check them again.
    """
    if l not in (1, 2, 3):
        raise ValueError(f"hetcor_local_sweep serves levels 1-3, got {l}")
    if C.device.type == "cpu":
        return pcorr.hetcor_local_sweep_plain(C, N, t_ix, node_ixs, nbrs, deg, th, l)
    if C.device.type != "cuda":
        raise ValueError(f"hetcor_local_sweep: unsupported device {C.device}")
    nt, d = nbrs.shape
    vp = check_panels("hetcor_local_sweep", C, N=N)
    check_int32("hetcor_local_sweep", C.device, t_ix=(t_ix, (vp,)),
                node_ixs=(node_ixs, (nt,)), nbrs=(nbrs, (nt, d)), deg=(deg, (nt,)))
    C, N, t_ix, node_ixs, nbrs, deg = (
        t.contiguous() for t in (C, N, t_ix, node_ixs, nbrs, deg))
    margin = torch.empty((nt, d), dtype=torch.float32, device=C.device)
    if nt == 0 or d == 0:
        return margin
    if not index_range_checked:
        check_index_range("hetcor_local_sweep", vp, d, node_ixs, nbrs, deg)
    lib = _lib()
    n_scratch = lib.hetcor_sweep_scratch_floats(nt, d)
    scratch = (
        torch.empty(n_scratch, dtype=torch.float32, device=C.device)
        if n_scratch else None
    )
    with torch.cuda.device(C.device):
        err = lib.hetcor_sweep_launch(
            C.data_ptr(), N.data_ptr(), t_ix.data_ptr(), vp, node_ixs.data_ptr(),
            nbrs.data_ptr(), deg.data_ptr(), nt, d, l, float(th),
            scratch.data_ptr() if scratch is not None else None,
            margin.data_ptr(), torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"hetcor_sweep kernel launch failed: cudaError {err}")
    launches[l] += 1
    return margin
