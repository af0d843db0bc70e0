"""What no top-level span of a block covers: the window's seconds a solve
less the mean sum of the spans that tile ``cusk`` (``context_s``,
``prepare_s``, ``prescreen_s``, ``panel_s``, stage 1's
``skeleton_wall_s``, ``reduce_s``, ``stage2_s``, ``write_s``), seconds a
solve: the harness's share of a solve and any code outside the spans. None
where the program lacks one of the spans."""

TOP = ("context_s", "prepare_s", "prescreen_s", "panel_s", "reduce_s", "stage2_s", "write_s")


def read(run):
    spans = []
    for s in run.stats:
        if any(k not in s for k in TOP) or "skeleton_wall_s" not in s.get("stage1", {}):
            return None
        spans.append(sum(s[k] for k in TOP) + s["stage1"]["skeleton_wall_s"])
    if not spans:
        return None
    return run.window_s / run.solves - sum(spans) / len(spans)
