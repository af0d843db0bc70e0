"""ctypes bindings for the native host-side .bed operations.

The shared library (native/bedops.cpp) is compiled on first use and cached
next to the source; every entry point has a numpy fallback so the package
works without a toolchain.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "native")
_SRC = os.path.join(_NATIVE_DIR, "bedops.cpp")
_SO = os.path.join(_NATIVE_DIR, "libbedops.so")

_lib = None
_tried = False


def _build() -> bool:
    try:
        subprocess.run(
            ["g++", "-O3", "-shared", "-fPIC", "-o", _SO, _SRC],
            check=True,
            capture_output=True,
        )
        return True
    except Exception:
        return False


def get_lib():
    """The loaded shared library, or None if unavailable."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if os.environ.get("CIGWAS_TPU_NO_NATIVE"):
        return None
    if not os.path.exists(_SO) or (
        os.path.exists(_SRC) and os.path.getmtime(_SRC) > os.path.getmtime(_SO)
    ):
        if not os.path.exists(_SRC) or not _build():
            return None
    try:
        lib = ctypes.CDLL(_SO)
    except OSError:
        return None
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    lib.bed_decode.argtypes = [
        u8p,
        ctypes.c_int64,
        ctypes.c_int64,
        ctypes.c_int64,
        f32p,
        f32p,
    ]
    lib.bed_col_stats.argtypes = [
        u8p,
        ctypes.c_int64,
        ctypes.c_int64,
        ctypes.c_int64,
        f32p,
        f32p,
        i32p,
    ]
    lib.bed_file_col_stats.argtypes = [
        ctypes.c_char_p,
        ctypes.c_int64,
        ctypes.c_int64,
        f32p,
        f32p,
        i32p,
    ]
    lib.bed_file_col_stats.restype = ctypes.c_int64
    _lib = lib
    return _lib


def bed_decode(bed_bytes: np.ndarray, num_samples: int):
    """(values, validity) via the native decoder; numpy fallback."""
    lib = get_lib()
    bed_bytes = np.ascontiguousarray(bed_bytes, dtype=np.uint8)
    m, bpc = bed_bytes.shape
    if lib is None:
        from cigwas_tpu_torch.io.bed import decode_bed_values

        return decode_bed_values(bed_bytes, num_samples)
    vals = np.empty((m, num_samples), dtype=np.float32)
    valid = np.empty((m, num_samples), dtype=np.float32)
    lib.bed_decode(bed_bytes, m, bpc, num_samples, vals, valid)
    return vals, valid


def bed_col_stats(bed_bytes: np.ndarray, num_samples: int):
    """(means, stds, modes) per marker; numpy fallback."""
    lib = get_lib()
    bed_bytes = np.ascontiguousarray(bed_bytes, dtype=np.uint8)
    m, bpc = bed_bytes.shape
    if lib is None:
        from cigwas_tpu_torch.prep import compute_bed_stats

        return compute_bed_stats(bed_bytes, num_samples)
    means = np.empty(m, dtype=np.float32)
    stds = np.empty(m, dtype=np.float32)
    modes = np.empty(m, dtype=np.int32)
    lib.bed_col_stats(bed_bytes, m, bpc, num_samples, means, stds, modes)
    return means, stds, modes


def bed_file_col_stats(path: str, num_samples: int, num_markers: int):
    """Streamed whole-file column stats; returns (means, stds, modes) or
    None if the native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    means = np.empty(num_markers, dtype=np.float32)
    stds = np.empty(num_markers, dtype=np.float32)
    modes = np.empty(num_markers, dtype=np.int32)
    done = lib.bed_file_col_stats(
        path.encode(), num_samples, num_markers, means, stds, modes
    )
    if done != num_markers:
        return None
    return means, stds, modes
