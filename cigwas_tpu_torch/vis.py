"""Correlation-diagnostic plots (`cigwas_tpu.vis`; `cusk/py-vis/vis.py`).

The reference ships a small matplotlib helper that scatter-plots two binary
lower-triangular correlation dumps against each other (Pearson rho vs the
Kendall-derived sin(pi/2 tau_B)) with their correlation annotated
(`py-vis/vis.py:23-52`); it is a data-QC tool, not a pipeline stage.
matplotlib is imported lazily so the package has no hard plotting
dependency.
"""

from __future__ import annotations

import numpy as np


def read_floats_from_bin(path: str, num_values: int) -> np.ndarray:
    """Binary f32 vector reader (`py-vis/vis.py:18-20`)."""
    return np.fromfile(path, dtype=np.float32, count=num_values).astype(
        np.float64
    )


def corr_plot(b1: str, b2: str, num_markers: int, title: str = "", ax=None):
    """Scatter of two triangular correlation dumps (`py-vis/vis.py:23-52`).

    b1/b2: binary f32 files holding the strict lower triangle
    (m*(m-1)/2 values) of two correlation estimates for the same markers,
    e.g. Pearson vs Kendall-npn. Returns the matplotlib Axes; the caller
    shows/saves the figure.
    """
    import matplotlib.pyplot as plt

    num_values = num_markers * (num_markers - 1) // 2
    v1 = read_floats_from_bin(b1, num_values)
    v2 = read_floats_from_bin(b2, num_values)
    corr = np.around(np.corrcoef(v1, v2)[0, 1], 3)

    if ax is None:
        _, ax = plt.subplots()
    diag = np.linspace(-1, 1, 10)
    ax.plot(diag, diag, "k--")
    ax.plot(v1, v2, "x")
    ax.set_xlabel(r"$\rho$")
    ax.set_ylabel(r"$\sin(\pi / 2 \tau_B)$")
    ax.text(
        0.05,
        0.95,
        rf"$\rho={corr}$",
        transform=ax.transAxes,
        fontsize=14,
        verticalalignment="top",
        bbox=dict(boxstyle="round", facecolor="wheat", alpha=0.5),
    )
    if title:
        ax.set_title(title)
    ax.figure.tight_layout()
    return ax
