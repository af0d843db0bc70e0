"""Stage 1 of the skeleton (``skeleton/cupc.py``): its ``skeleton_wall_s``,
seconds a solve (mean)."""


def read(run):
    if not run.stats:
        return None
    return sum(s["stage1"]["skeleton_wall_s"] for s in run.stats) / len(run.stats)
