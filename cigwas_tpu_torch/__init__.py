"""cigwas_tpu_torch — the PyTorch/CUDA port of :mod:`cigwas_tpu` for NVIDIA Hopper.

Same layout and module names as the JAX package, so each counterpart is
easy to find:

- :mod:`cigwas_tpu_torch.device`    — ``require_cuda``
- :mod:`cigwas_tpu_torch.constants`, :mod:`cigwas_tpu_torch.io`,
  :mod:`cigwas_tpu_torch.prep`, :mod:`cigwas_tpu_torch.native`,
  :mod:`cigwas_tpu_torch.utils`     — host-side numpy: files, prep, statistics, colex enumeration
- :mod:`cigwas_tpu_torch.ops`       — 2-bit decode, correlation panels, CI tests, CUDA kernels
- :mod:`cigwas_tpu_torch.skeleton`  — the PC-stable and hetcor skeletons, the ancestor reduction
- :mod:`cigwas_tpu_torch.pipelines` — the per-block ``cusk`` and summary-statistic ``cuskss`` pipelines

The port imports ``torch`` and never ``jax``, and nothing of the JAX package:
the host-side modules above are its own copies.
"""

from cigwas_tpu_torch.device import require_cuda

__version__ = "0.1.0"
__all__ = ["require_cuda", "__version__"]
