"""Wrapper of the Kendall panel kernel ``csrc/kendall_panel.cu``.

:func:`kendall_panel` writes the npn correlations of a block's markers
straight from their packed 2-bit genotypes: it launches the CUDA kernel for
CUDA tensors and runs the plain version (:func:`kendall_panel_plain`, the
one-hot products :func:`~cigwas_tpu_torch.ops.decode.contingency_counts`
in row stripes and sample chunks, and :func:`kendall_from_counts`) for CPU
tensors; nothing else. The kernel
is built at its first launch (:mod:`cigwas_tpu_torch.ops.kernels.build`),
never at import.
"""

from __future__ import annotations

import ctypes
import math

import torch

from cigwas_tpu_torch.ops.decode import contingency_counts, geno_onehot, unpack_bed_codes
from cigwas_tpu_torch.ops.kernels import build

SOURCE = "cigwas_tpu_torch/csrc/kendall_panel.cu"
# kernel launches since the last reset; the CPU path adds nothing
launches = {"kendall_int8_panel": 0}
# the kernel's TMA reads rows whose stride is a multiple of this many bytes
ROW_ALIGN = 16
# the plain version's rows a stripe and bytes of int8 one-hot a sample chunk:
# at 11,000 markers ~0.8 GB of int32 counts a stripe and 1 GiB of one-hot
PLAIN_ROW_TILE = 2048
PLAIN_ONEHOT_BYTES = 1 << 30


def reset_launches() -> None:
    launches["kendall_int8_panel"] = 0


def kendall_from_counts(counts: torch.Tensor, mr: int, mc: int) -> torch.Tensor:
    """(3mr, 3mc) channel-major f32 contingency counts -> (mr, mc) npn corr.

    Concordant/discordant/tie aggregates of `corr_kernels.cu:455-471`, in the
    JAX package's order of operations; the result is sin(pi/2 * tau_b)."""
    s = [
        counts[(i // 3) * mr : (i // 3 + 1) * mr, (i % 3) * mc : (i % 3 + 1) * mc]
        for i in range(9)
    ]
    p = (
        s[0] * (s[4] + s[5] + s[7] + s[8])
        + s[1] * (s[5] + s[8])
        + s[3] * (s[7] + s[8])
        + s[4] * s[8]
    )
    q = (
        s[1] * (s[3] + s[6])
        + s[2] * (s[3] + s[4] + s[6] + s[7])
        + s[4] * s[6]
        + s[5] * (s[6] + s[7])
    )
    t = (
        s[0] * (s[1] + s[2])
        + s[1] * s[2]
        + s[3] * (s[4] + s[5])
        + s[4] * s[5]
        + s[6] * (s[7] + s[8])
        + s[7] * s[8]
    )
    u = (
        s[0] * (s[3] + s[6])
        + s[1] * (s[4] + s[7])
        + s[2] * (s[5] + s[8])
        + s[3] * s[6]
        + s[4] * s[7]
        + s[5] * s[8]
    )
    tau = (p - q) / torch.sqrt((p + q + t) * (p + q + u))
    return torch.sin(math.pi / 2 * tau)


def kendall_panel_plain(codes: torch.Tensor, num_samples: int, out: torch.Tensor) -> None:
    """Plain version of :func:`kendall_panel`: in stripes of PLAIN_ROW_TILE
    rows against every row, the int8 one-hots of each sample chunk (codes
    past num_samples set missing), their exact int32 products summed, and
    the Kendall map of the stripe's counts. A chunk's one-hot of every row
    stays within PLAIN_ONEHOT_BYTES, so the plain version's memory is
    bounded however large the block; the counts are exact, so the stripes
    and chunks give the values of one whole product."""
    m, nb = codes.shape
    cb = max(8, PLAIN_ONEHOT_BYTES // (12 * m) // 8 * 8)  # bytes a chunk: 32-sample steps

    def onehot(rows: torch.Tensor, b0: int) -> torch.Tensor:
        x = unpack_bed_codes(rows[:, b0 : b0 + cb])
        x[:, max(0, num_samples - 4 * b0) :] = 1  # missing
        return geno_onehot(x).reshape(3 * rows.shape[0], -1)

    for t0 in range(0, m, PLAIN_ROW_TILE):
        rows = codes[t0 : t0 + PLAIN_ROW_TILE]
        counts = torch.zeros((3 * rows.shape[0], 3 * m), dtype=torch.int32, device=codes.device)
        for b0 in range(0, nb, cb):
            counts += contingency_counts(onehot(rows, b0), onehot(codes, b0))
        out[t0 : t0 + rows.shape[0], :m] = kendall_from_counts(
            counts.to(torch.float32), rows.shape[0], m)
        del counts  # free this stripe's counts before the next one is allocated


def _lib() -> ctypes.CDLL:
    lib = build.load("kendall_panel")
    p, ll = ctypes.c_void_p, ctypes.c_longlong
    lib.kendall_panel_launch.argtypes = [p, ll, ll, ll, p, ll, p]
    lib.kendall_panel_launch.restype = ctypes.c_int
    return lib


def kendall_panel(codes: torch.Tensor, num_samples: int, out: torch.Tensor) -> None:
    """out[i, j] = sin(pi/2 tau_b(i, j)) for the markers i, j < m of codes;
    nothing else of out is written.

    codes (m, nb) uint8, contiguous: the packed 2-bit genotypes (PLINK's
    LSB-first codes), the first num_samples of each row read, codes past
    them counted as missing; on a card nb is a multiple of ROW_ALIGN. out
    (rows >= m, cols >= m) float32, contiguous, on codes' device. A pair of
    markers with no concordant, discordant or tied-in-one sample (an
    all-missing or monomorphic marker) gives NaN, as 0/0."""
    m = codes.shape[0]
    if codes.dtype != torch.uint8 or codes.dim() != 2 or not codes.is_contiguous():
        raise ValueError(f"kendall_panel: codes must be a contiguous (m, nb) uint8 matrix, got "
                         f"{codes.dtype} {tuple(codes.shape)}")
    if not 1 <= num_samples <= 4 * codes.shape[1]:
        raise ValueError(f"kendall_panel: {num_samples} samples in rows of "
                         f"{codes.shape[1]} bytes")
    if (out.dtype != torch.float32 or out.dim() != 2 or not out.is_contiguous()
            or out.shape[0] < m or out.shape[1] < m or out.device != codes.device):
        raise ValueError(f"kendall_panel: out must be a contiguous float32 matrix of at least "
                         f"({m}, {m}) on {codes.device}, got {out.dtype} {tuple(out.shape)} "
                         f"on {out.device}")
    if m == 0:
        return
    if codes.device.type == "cpu":
        kendall_panel_plain(codes, num_samples, out)
        return
    if codes.device.type != "cuda":
        raise ValueError(f"kendall_panel: unsupported device {codes.device}")
    if codes.shape[1] % ROW_ALIGN or codes.data_ptr() % ROW_ALIGN:
        raise ValueError(f"kendall_panel: rows of {codes.shape[1]} bytes; the kernel reads "
                         f"{ROW_ALIGN}-byte aligned rows")
    with torch.cuda.device(codes.device):
        err = _lib().kendall_panel_launch(
            codes.data_ptr(), m, codes.shape[1], num_samples, out.data_ptr(), out.shape[1],
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"kendall_panel kernel launch failed: cudaError {err}")
    launches["kendall_int8_panel"] += 1
