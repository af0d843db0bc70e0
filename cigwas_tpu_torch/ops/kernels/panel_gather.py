"""Wrapper of the local-panel gather kernel ``csrc/panel_gather.cu``.

:func:`gather_local_panels` (one panel) and :func:`gather_local_panels2` (two
matched panels in one launch) launch the CUDA kernel for CUDA tensors and
run the plain versions beside them for CPU tensors; nothing else. Pad slots
(j >= deg) read as the node's own index (:func:`remap_pad_slots`; the kernel
does the same as it stages a node's list), so the result equals
``C[nbrs_w[:, :, None], nbrs_w[:, None, :]]`` and ``C[x[:, None], nbrs_w]``
everywhere, bit for bit. The kernel is built at its first launch
(:mod:`cigwas_tpu_torch.ops.kernels.build`), never at import. How a launch
is shaped (route, threads, nodes per CTA, rows per CTA, staging) is decided
here, in :func:`plan`; the C launcher refuses a plan that does not fit.
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
# the route of csrc/panel_gather.cu: whole output rows per warp
ROUTE_ROWS = 0
# dynamic shared memory a CTA may opt in to on sm_90
SMEM_OPT_IN = 232448
# output elements (both panels counted) a CTA copies, about; warps a CTA has
# at most; rows of one node a CTA takes at least, to repay staging its list
CTA_ELEMS, MAX_WARPS, MIN_ROWS = 8192, 8, 8
# kernel launches per entry since the last reset; the CPU path adds nothing
launches = {"panel_gather": 0, "panel_gather2": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def plan(d: int, panels: int) -> dict:
    """The launch plan of a gather at bucket width d from one or two panels,
    as the C launcher takes it: route, threads per CTA, nodes per CTA, rows
    of a node per CTA (of its d + 1: the q row and the d panel rows), whether
    the lists are staged in shared memory, and the dynamic shared bytes.

    Nodes whose d + 1 rows are at most half of CTA_ELEMS share a CTA, a warp
    per node (d <= 44 with one panel, 31 with two). Wider nodes take a CTA
    or several: runs of about CTA_ELEMS elements, never fewer than MIN_ROWS
    rows, shared out evenly. The lists are staged while they fit the opt-in
    limit (d <= 58112 for one node) and read through the cache beyond."""
    if d < 1 or panels not in (1, 2):
        raise ValueError(f"panel_gather: no plan for width {d}, {panels} panels")
    rows, d4 = d + 1, -(-d // 4) * 4
    lanes_row = min(32, d // 4 if d % 4 == 0 else d)
    rows_pass = 32 // lanes_row  # rows a warp copies at a time
    npc = min(CTA_ELEMS // (2 * rows * d * panels), 32)
    if npc > 1:
        rows_cta, warps = rows, min(npc, MAX_WARPS)
    else:
        npc = 1
        rows_cta = min(rows, max(MIN_ROWS, -(-CTA_ELEMS // (d * panels))))
        rows_cta = -(-rows // -(-rows // rows_cta))  # even runs, as many CTAs
        warps = min(MAX_WARPS, -(-rows_cta // rows_pass))
    smem = 4 * npc * d4
    staged = smem <= SMEM_OPT_IN
    return {"route": ROUTE_ROWS, "threads": 32 * warps, "nodes_per_cta": npc,
            "rows_per_cta": rows_cta, "staged": int(staged),
            "smem_bytes": smem if staged else 0}


def _lib() -> ctypes.CDLL:
    lib = build.load("panel_gather")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.panel_gather_launch.argtypes = [p, p, ll, p, p, p, i, i, i, i, i, i, i, i,
                                        p, p, p, p, p]
    lib.panel_gather_launch.restype = i
    lib.panel_gather_empty_launch.argtypes = [p]
    lib.panel_gather_empty_launch.restype = i
    return lib


def launch_empty() -> None:
    """Launch a kernel that does nothing on the current stream: what a launch
    alone costs, for the timing of the few-node gathers. Counts as no launch
    of the gather."""
    err = _lib().panel_gather_empty_launch(torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"panel_gather: empty kernel launch failed: cudaError {err}")


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


def _launch(C, N, node_ixs, nbrs, deg, index_range_checked, launch_plan):
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
    pl = launch_plan or plan(d, 2 if two else 1)
    with torch.cuda.device(C.device):
        err = lib.panel_gather_launch(
            C.data_ptr(), N.data_ptr() if two else None, vp, node_ixs.data_ptr(),
            nbrs.data_ptr(), deg.data_ptr(), nt, d, pl["route"], pl["threads"],
            pl["nodes_per_cta"], pl["rows_per_cta"], pl["staged"], pl["smem_bytes"],
            outs[0].data_ptr(), outs[1].data_ptr(),
            outs[2].data_ptr() if two else None,
            outs[3].data_ptr() if two else None,
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"panel_gather kernel launch failed: cudaError {err}, plan {pl}")
    launches["panel_gather2" if two else "panel_gather"] += 1
    return tuple(outs)


def _check_device(C: torch.Tensor) -> bool:
    """True for the card, False for the CPU; anything else raises."""
    if C.device.type not in ("cpu", "cuda"):
        raise ValueError(f"panel_gather: unsupported device {C.device}")
    return C.device.type == "cuda"


def gather_local_panels(C: torch.Tensor, node_ixs: torch.Tensor,
                        nbrs: torch.Tensor, deg: torch.Tensor, *,
                        index_range_checked: bool = False,
                        launch_plan: dict | None = None):
    """Local panels of every node: Cb[i] = C[nb_i, nb_i] (nt, d, d) and
    qb[i] = C[x_i, nb_i] (nt, d), NaNs kept bit for bit.

    C (vp, vp) f32; node_ixs (nt,), nbrs (nt, d), deg (nt,) int32; slots
    j >= deg read the node's own row and column. Any width d >= 1.

    index_range_checked: the caller has held these lists to
    :func:`~cigwas_tpu_torch.ops.kernels.checks.check_index_range` on the
    host, so the launch does not wait for the device to check them again.
    launch_plan: a plan to launch with instead of ``plan(d, 1)`` (no
    staging, other rows or threads per CTA, for comparisons on the card)."""
    if not _check_device(C):
        return gather_local_panels_plain(C, node_ixs, nbrs, deg)
    return _launch(C, None, node_ixs, nbrs, deg, index_range_checked, launch_plan)


def gather_local_panels2(C: torch.Tensor, N: torch.Tensor, node_ixs: torch.Tensor,
                         nbrs: torch.Tensor, deg: torch.Tensor, *,
                         index_range_checked: bool = False,
                         launch_plan: dict | None = None):
    """The same gather of two matched panels in one launch:
    (Cb, qb) from C and (Nb, nr) from N."""
    if not _check_device(C):
        return gather_local_panels2_plain(C, N, node_ixs, nbrs, deg)
    return _launch(C, N, node_ixs, nbrs, deg, index_range_checked, launch_plan)
