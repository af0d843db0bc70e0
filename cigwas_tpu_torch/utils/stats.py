"""Fisher-z statistics and level-indexed significance thresholds.

Equivalent functionality to the reference `cusk/src/cuPC_call_prep.cpp:13-28`
(boost::math normal quantile replaced with scipy) and the Fisher-z transform
used throughout `cuPC-S.cu` / `sepselect.py:21-30`.
"""

from __future__ import annotations

import numpy as np
from scipy.stats import norm

from cigwas_tpu_torch.constants import ML


def fisher_z(v):
    """|0.5 * log|(1+v)/(1-v)|| — the absolute Fisher z-transform.

    Matches `sepselect.py:21-22` and the in-kernel formula of the reference
    (`cuPC-S.cu:465`). Works on numpy arrays and scalars; |v| = 1 maps to +inf.
    """
    if isinstance(v, np.ndarray):
        with np.errstate(divide="ignore", invalid="ignore"):
            return np.abs(0.5 * np.log(np.abs((1 + v) / (1 - v))))
    return np.abs(0.5 * np.log(np.abs((1 + v) / (1 - v))))


def threshold_array(n: int, alpha: float, max_level: int = ML) -> np.ndarray:
    """Level-indexed Fisher-z thresholds Th[l] = |Phi^-1(alpha/2)| / sqrt(n - l - 3).

    Reference: `cuPC_call_prep.cpp:13-23` (levels 0..ML inclusive).
    """
    q = abs(norm.ppf(0.5 * alpha))
    levels = np.arange(max_level + 1, dtype=np.float64)
    return (q / np.sqrt(n - levels - 3)).astype(np.float32)


def hetcor_threshold(alpha: float) -> float:
    """Scalar |Phi^-1(alpha/2)| used by the hetcor (per-test ESS) skeleton.

    Reference: `cuPC_call_prep.cpp:25-28`. The per-test threshold is
    th / sqrt(mean_ess - l - 3) (`hetcor-cuPC-S.cu:471`).
    """
    return float(abs(norm.ppf(0.5 * alpha)))


def alpha_threshold(alpha: float, n: int, l: int) -> float:
    """Threshold for a single CI test at conditioning-set size l.

    Matches `sepselect.py:25-26` (`alpha_thr`).
    """
    return float(norm.ppf(1 - alpha / 2) / np.sqrt(n - l - 3))
