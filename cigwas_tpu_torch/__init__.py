"""cigwas_tpu_torch — the PyTorch/CUDA port of :mod:`cigwas_tpu` for NVIDIA Hopper.

Same layout and module names as the JAX package, so each counterpart is
easy to find:

- :mod:`cigwas_tpu_torch.device`    — ``require_cuda``
- :mod:`cigwas_tpu_torch.constants`, :mod:`cigwas_tpu_torch.io`,
  :mod:`cigwas_tpu_torch.prep`, :mod:`cigwas_tpu_torch.native`,
  :mod:`cigwas_tpu_torch.utils`     — host-side numpy: files, prep, statistics, colex enumeration
- :mod:`cigwas_tpu_torch.ops`       — 2-bit decode, correlation panels, CI tests, CUDA kernels
- :mod:`cigwas_tpu_torch.skeleton`  — the PC-stable (with pMax) and hetcor skeletons, the
  ancestor reduction, the second-stage sepsets
- :mod:`cigwas_tpu_torch.blocking`  — LD blocking of a chromosome
- :mod:`cigwas_tpu_torch.pipelines` — ``make_blocks``, the per-block ``cusk`` and the
  summary-statistic ``cuskss`` pipelines
- :mod:`cigwas_tpu_torch.parallel`  — the multi-block runner, the device mesh, the engines,
  the multi-device step
- :mod:`cigwas_tpu_torch.merge`     — merge of block outputs, sepselect, v-structures, IV checks
- :mod:`cigwas_tpu_torch.pag`       — sRFCI (the trait PAG) and sDAVS causal effects
- :mod:`cigwas_tpu_torch.mr`        — MVIVW and the MR competitors
- :mod:`cigwas_tpu_torch.analysis`  — pleiotropy, parent sets, PAG paths, association tables, plots
- :mod:`cigwas_tpu_torch.sim`       — simulated DAGs and PLINK filesets
- :mod:`cigwas_tpu_torch.phen_prep` — merging phenotype files into a `.phen`
- :mod:`cigwas_tpu_torch.vis`       — the correlation QC scatter
- :mod:`cigwas_tpu_torch.cli`       — ``ci-gwas-torch``, the shell entry points

The port imports ``torch`` and never ``jax``, and nothing of the JAX package:
the host-side modules above are its own copies. Nor does it import pandas or
matplotlib; the plot helpers import matplotlib when they are called.
"""

from cigwas_tpu_torch.constants import ML
from cigwas_tpu_torch.device import require_cuda

__version__ = "0.1.0"
__all__ = ["ML", "require_cuda", "__version__"]
