"""Device time of the port's hetcor kernels on an input (``csrc/``):
``hetcor_sweep``, ``hetcor_dense_l1`` and the two-panel ``panel_gather``,
ms a solve, from the profiler's trace. Missing where the trace holds fewer
records of a family's kernel than the program counted launches of it, or none at all."""

FAMILIES = {
    "hetcor_sweep": (r"(?<![A-Za-z_])(hsweep1_direct|hsweep_table|hsweep_rows)_kernel",
                     ("hetcor_sweep_l1", "hetcor_sweep_l2", "hetcor_sweep_l3")),
    "hetcor_dense_l1": (r"(?<![A-Za-z_])hetcor_dense_l1_kernel", ("hetcor_dense_l1",)),
    "panel_gather": (r"(?<![A-Za-z_])panel_rows_kernel", ("panel_gather", "panel_gather2")),
}


def read(run):
    if not run.solves:
        return None
    total, seen = 0.0, 0
    for pattern, counted in FAMILIES.values():
        sec, records = run.trace.family(pattern)
        if records < sum(run.launches.get(k, 0) for k in counted):
            return None
        total += sec
        seen += records
    return 1e3 * total / run.solves if seen else None
