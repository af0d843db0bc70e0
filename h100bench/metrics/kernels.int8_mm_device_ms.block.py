"""Device time of the int8 contingency products (cuBLAS through
``torch._int_mm`` in ``ops/decode.py``), ms a solve, from the profiler's
trace: the kernels whose names mark 8-bit integer inputs."""

PATTERN = r"(?i)(s8s8|i8i8|imma|int8|_s8_|_i8_)"


def read(run):
    if not run.solves:
        return None
    sec, records = run.trace.family(PATTERN)
    return 1e3 * sec / run.solves if records else None
