"""Build the CUDA sources under ``cigwas_tpu_torch/csrc`` at first use.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` into a shared library with a
plain C interface and loaded with ``ctypes`` (no PyTorch headers, so a build
takes seconds). Libraries go to ``build/cigwas_tpu_torch/`` at the root of
the checkout, keyed by a hash of the source, of every header under ``csrc``
it includes and of the flags, so an edited source or header rebuilds and an
unchanged one loads the cached file. Nothing here runs
at import: a machine without ``nvcc`` can import every module of the port.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "cigwas_tpu_torch"
# IEEE sqrt and division, no FMA contraction: the kernels must reproduce
# their plain PyTorch versions bit for bit (never add --use_fast_math)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_loaded: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of the CUDA compiler: $CUDA_HOME/bin, then PATH, then
    /usr/local/cuda/bin."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    if shutil.which("nvcc"):
        cands.append(shutil.which("nvcc"))
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)


def source_files(name: str) -> list[Path]:
    """``csrc/<name>.cu`` and, transitively, every file under ``csrc`` that it
    includes with quotes, each once, in the order met."""
    found: list[Path] = []
    todo = [CSRC / f"{name}.cu"]
    while todo:
        path = todo.pop()
        if path in found:
            continue
        found.append(path)
        for inc in _INCLUDE.findall(path.read_bytes()):
            header = (path.parent / inc.decode()).resolve()
            if CSRC in header.parents and header.is_file():
                todo.append(header)
    return found


def library_path(name: str, defines: tuple = ()) -> Path:
    flags = (*NVCC_FLAGS, *(f"-D{d}" for d in defines))
    h = hashlib.sha256(" ".join(flags).encode())
    for path in source_files(name):
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(name: str, defines: tuple = ()) -> Path:
    """Compile ``csrc/<name>.cu`` unless its keyed library exists; returns
    the library path. The compiler's output goes beside it as ``.log``.
    ``defines`` (``"NAME=value"``) set a source's tunables for a tuning tool;
    the port itself builds with none. Raises with nvcc's stderr if the build
    fails."""
    out = library_path(name, defines)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, *(f"-D{d}" for d in defines), "-o", str(tmp),
           str(CSRC / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed to build {name}.cu:\n{' '.join(cmd)}\n{proc.stderr}"
        )
    os.replace(tmp, out)  # atomic: a concurrent build never sees half a file
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _loaded.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build(name)))
        _loaded[name] = lib
    return lib
