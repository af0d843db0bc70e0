"""Device time of the port's skeleton kernels on a block (``csrc/``):
``local_sweep``, ``dense_l1`` and ``panel_gather``, ms a solve, from the
profiler's trace. Missing where the trace holds fewer records of a family's
kernel than the program counted launches of it, or none at all."""

FAMILIES = {
    # family: (kernel names, the program's launch counters)
    "local_sweep": (r"(?<![A-Za-z_])(sweep1_direct|sweep_table|sweep_rows)_kernel",
                    ("local_sweep_l1", "local_sweep_l2", "local_sweep_l3")),
    "dense_l1": (r"(?<![A-Za-z_])dense_l1_kernel", ("dense_l1",)),
    "panel_gather": (r"(?<![A-Za-z_])panel_rows_kernel", ("panel_gather",)),
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
