"""Wrapper of the local-panel gather kernel ``csrc/panel_gather.cu``.

:func:`gather_local_panels` (one panel) and :func:`gather_local_panels2` (two
matched panels in one launch) launch the CUDA kernel for CUDA tensors and
run the plain versions beside them for CPU tensors; nothing else. Pad slots
(j >= deg) read as the node's own index (:func:`remap_pad_slots`; the kernel
does the same as it stages a node's list), so the result equals
``C[nbrs_w[:, :, None], nbrs_w[:, None, :]]`` and ``C[x[:, None], nbrs_w]``
everywhere, bit for bit. The kernel is built at its first launch
(:mod:`cigwas_tpu_torch.ops.kernels.build`), never at import.
"""

from __future__ import annotations

import ctypes

import torch

from cigwas_tpu_torch.ops.kernels import build
from cigwas_tpu_torch.ops.kernels.checks import (
    check_index_range,
    check_int32,
    check_panels,
)

SOURCE = "cigwas_tpu_torch/csrc/panel_gather.cu"
# kernel launches per entry since the last reset; the CPU path adds nothing
launches = {"panel_gather": 0, "panel_gather2": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _lib() -> ctypes.CDLL:
    lib = build.load("panel_gather")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.panel_gather_launch.argtypes = [p, p, ll, p, p, p, i, i, p, p, p, p, p]
    lib.panel_gather_launch.restype = i
    return lib


def remap_pad_slots(node_ixs: torch.Tensor, nbrs: torch.Tensor,
                    deg: torch.Tensor) -> torch.Tensor:
    """nbrs with every pad slot (j >= deg) holding the node's own index."""
    slot = torch.arange(nbrs.shape[1], device=nbrs.device)[None, :]
    return torch.where(slot < deg[:, None], nbrs, node_ixs[:, None])


def gather_local_panels_plain(C, node_ixs, nbrs, deg):
    """Plain version of the one-panel gather: (Cb (nt, d, d), qb (nt, d))."""
    nb = remap_pad_slots(node_ixs, nbrs, deg).long()
    return C[nb[:, :, None], nb[:, None, :]], C[node_ixs.long()[:, None], nb]


def gather_local_panels2_plain(C, N, node_ixs, nbrs, deg):
    """Plain version of the two-panel gather: (Cb, qb, Nb, nr)."""
    return (*gather_local_panels_plain(C, node_ixs, nbrs, deg),
            *gather_local_panels_plain(N, node_ixs, nbrs, deg))


def _launch(C, N, node_ixs, nbrs, deg, index_range_checked):
    nt, d = nbrs.shape
    vp = check_panels("panel_gather", C, **({} if N is None else {"N": N}))
    check_int32("panel_gather", C.device, node_ixs=(node_ixs, (nt,)),
                nbrs=(nbrs, (nt, d)), deg=(deg, (nt,)))
    two = N is not None
    shapes = ((nt, d, d), (nt, d)) * (2 if two else 1)
    outs = [torch.empty(s, dtype=torch.float32, device=C.device) for s in shapes]
    if nt == 0 or d == 0:
        return tuple(outs)
    if not index_range_checked:
        check_index_range("panel_gather", vp, d, node_ixs, nbrs, deg)
    C = C.contiguous()
    N = N.contiguous() if two else None
    node_ixs, nbrs, deg = (t.contiguous() for t in (node_ixs, nbrs, deg))
    lib = _lib()
    with torch.cuda.device(C.device):
        err = lib.panel_gather_launch(
            C.data_ptr(), N.data_ptr() if two else None, vp, node_ixs.data_ptr(),
            nbrs.data_ptr(), deg.data_ptr(), nt, d,
            outs[0].data_ptr(), outs[1].data_ptr(),
            outs[2].data_ptr() if two else None,
            outs[3].data_ptr() if two else None,
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"panel_gather kernel launch failed: cudaError {err}")
    launches["panel_gather2" if two else "panel_gather"] += 1
    return tuple(outs)


def _check_device(C: torch.Tensor) -> bool:
    """True for the card, False for the CPU; anything else raises."""
    if C.device.type not in ("cpu", "cuda"):
        raise ValueError(f"panel_gather: unsupported device {C.device}")
    return C.device.type == "cuda"


def gather_local_panels(C: torch.Tensor, node_ixs: torch.Tensor,
                        nbrs: torch.Tensor, deg: torch.Tensor, *,
                        index_range_checked: bool = False):
    """Local panels of every node: Cb[i] = C[nb_i, nb_i] (nt, d, d) and
    qb[i] = C[x_i, nb_i] (nt, d), NaNs kept bit for bit.

    C (vp, vp) f32; node_ixs (nt,), nbrs (nt, d), deg (nt,) int32; slots
    j >= deg read the node's own row and column. Any width d >= 1.

    index_range_checked: the caller has held these lists to
    :func:`~cigwas_tpu_torch.ops.kernels.checks.check_index_range` on the
    host, so the launch does not wait for the device to check them again."""
    if not _check_device(C):
        return gather_local_panels_plain(C, node_ixs, nbrs, deg)
    return _launch(C, None, node_ixs, nbrs, deg, index_range_checked)


def gather_local_panels2(C: torch.Tensor, N: torch.Tensor, node_ixs: torch.Tensor,
                         nbrs: torch.Tensor, deg: torch.Tensor, *,
                         index_range_checked: bool = False):
    """The same gather of two matched panels in one launch:
    (Cb, qb) from C and (Nb, nr) from N."""
    if not _check_device(C):
        return gather_local_panels2_plain(C, N, node_ixs, nbrs, deg)
    return _launch(C, N, node_ixs, nbrs, deg, index_range_checked)
