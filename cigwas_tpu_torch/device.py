"""Device selection: the port never picks a device on its own.

Every public entry takes an explicit ``device``; there is no "cuda if
available" fallback, so a run that asked for the card and found none fails
instead of quietly measuring the CPU.
"""

from __future__ import annotations

import torch


def require_cuda() -> torch.device:
    """The first CUDA device; raises if there is none."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def resolve(device) -> torch.device:
    """``torch.device(device)``, checking that a requested card exists."""
    dev = torch.device(device)
    if dev.type == "cuda":
        require_cuda()
    return dev


def require_full_f32() -> None:
    """Float32 matmuls in full precision: the marker-phen and phen-phen sums
    and the one-hot selections of the level >= 4 scan need all 24 bits
    (TF32 keeps about 3 decimal digits)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    if torch.get_float32_matmul_precision() != "highest":
        raise RuntimeError(
            "float32 matmul precision must be 'highest', got "
            f"{torch.get_float32_matmul_precision()!r}"
        )
