"""cigwas_tpu_torch — the PyTorch/CUDA port of :mod:`cigwas_tpu` for NVIDIA Hopper.

Same layout and module names as the JAX package, so each counterpart is
easy to find:

- :mod:`cigwas_tpu_torch.device`    — ``require_cuda``
- :mod:`cigwas_tpu_torch.host`      — the numpy-only modules of ``cigwas_tpu`` the port reuses
- :mod:`cigwas_tpu_torch.ops`       — 2-bit decode, correlation panels, CI tests, CUDA kernels
- :mod:`cigwas_tpu_torch.skeleton`  — the PC-stable skeleton and the ancestor reduction
- :mod:`cigwas_tpu_torch.pipelines` — the per-block ``cusk`` pipeline

The port imports ``torch`` and never ``jax``. It reuses the numpy-only host
modules of ``cigwas_tpu`` (I/O, prep, statistics, colex enumeration) instead
of copying them; importing any ``cigwas_tpu`` module runs
``cigwas_tpu/__init__.py``, which imports jax to enable its compilation cache
unless ``CIGWAS_TPU_NO_COMPILE_CACHE`` is set — so it is set here, before the
first such import.
"""

import os as _os

_os.environ.setdefault("CIGWAS_TPU_NO_COMPILE_CACHE", "1")

from cigwas_tpu_torch.device import require_cuda  # noqa: E402

__version__ = "0.1.0"
__all__ = ["require_cuda", "__version__"]
