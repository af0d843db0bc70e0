"""What no top-level span of a summary-statistic input covers: the window's
seconds a solve less the mean sum of the spans that tile ``cuskss``
(``load_s``, ``assemble_s``, ``init_s``, ``stage1_s``, ``stage2_s``,
``write_s``), seconds a solve: the harness's share of a solve and any code
outside the spans. None where the program lacks one of the spans."""

TOP = ("load_s", "assemble_s", "init_s", "stage1_s", "stage2_s", "write_s")


def read(run):
    spans = []
    for s in run.stats:
        if any(k not in s for k in TOP):
            return None
        spans.append(sum(s[k] for k in TOP))
    if not spans:
        return None
    return run.window_s / run.solves - sum(spans) / len(spans)
