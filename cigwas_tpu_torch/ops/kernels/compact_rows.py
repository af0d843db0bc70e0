"""Wrapper of the row-compaction kernel ``csrc/compact_rows.cu``.

:func:`compact_rows` launches the CUDA kernel for CUDA tensors and runs the
plain version (:func:`compact_rows_plain`) for CPU tensors; nothing else.
The kernel is built at its first launch
(:mod:`cigwas_tpu_torch.ops.kernels.build`), never at import.
"""

from __future__ import annotations

import ctypes

import torch

from cigwas_tpu_torch.ops.kernels import build

SOURCE = "cigwas_tpu_torch/csrc/compact_rows.cu"
# kernel launches since the last reset; the CPU path adds nothing
launches = {"compact_rows": 0}


def reset_launches() -> None:
    launches["compact_rows"] = 0


def compact_rows_plain(G: torch.Tensor, rows: torch.Tensor, d: int):
    """Plain version of :func:`compact_rows`: the rows' set columns by
    ``torch.nonzero`` (row-major, so ascending within a row), each placed at
    its rank within its row where that is below d."""
    sub = G[rows.long()]
    deg = sub.sum(dim=1, dtype=torch.int32)
    ri, ci = torch.nonzero(sub, as_tuple=True)
    starts = torch.cumsum(deg, 0) - deg
    slot = torch.arange(ri.numel(), device=G.device) - starts[ri]
    ok = slot < d
    nbrs = torch.zeros((rows.numel(), d), dtype=torch.int32, device=G.device)
    nbrs[ri[ok], slot[ok]] = ci[ok].to(torch.int32)
    return nbrs, deg


def _lib() -> ctypes.CDLL:
    lib = build.load("compact_rows")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.compact_rows_launch.argtypes = [p, ll, p, i, i, p, p, p]
    lib.compact_rows_launch.restype = i
    return lib


def compact_rows(G: torch.Tensor, rows: torch.Tensor, d: int, *,
                 index_range_checked: bool = False):
    """(nbrs (nr, d) int32, deg (nr,) int32): for each index r of rows, the
    first d columns c ascending with G[r, c] set, pad slots 0, and the count
    of set columns of the whole row r (which may exceed d).

    G (n, n) bool; rows (nr,) int32 in [0, n), on G's device; d >= 1.
    index_range_checked: the caller knows rows to lie in [0, n), so the
    launch does not wait for the device to check them."""
    n = G.shape[0]
    if G.dtype != torch.bool or G.dim() != 2 or G.shape[1] != n:
        raise ValueError(f"compact_rows: G must be a square bool matrix, got {G.dtype} "
                         f"{tuple(G.shape)}")
    if rows.dtype != torch.int32 or rows.dim() != 1 or rows.device != G.device:
        raise ValueError(f"compact_rows: rows must be int32 (nr,) on {G.device}")
    if d < 1:
        raise ValueError(f"compact_rows: width {d} < 1")
    if not index_range_checked and rows.numel() and bool(
            (rows.min() < 0) | (rows.max() >= n)):
        raise ValueError(f"compact_rows: row index out of range (< {n})")
    if G.device.type == "cpu":
        return compact_rows_plain(G, rows, d)
    if G.device.type != "cuda":
        raise ValueError(f"compact_rows: unsupported device {G.device}")
    nr = rows.numel()
    nbrs = torch.empty((nr, d), dtype=torch.int32, device=G.device)
    deg = torch.empty(nr, dtype=torch.int32, device=G.device)
    if nr == 0:
        return nbrs, deg
    G, rows = G.contiguous(), rows.contiguous()
    with torch.cuda.device(G.device):
        err = _lib().compact_rows_launch(
            G.data_ptr(), n, rows.data_ptr(), nr, d, nbrs.data_ptr(), deg.data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"compact_rows kernel launch failed: cudaError {err}")
    launches["compact_rows"] += 1
    return nbrs, deg
