"""Stage 2 of the hetcor skeleton on a summary-statistic input
(``skeleton/cupc.py``): its ``skeleton_wall_s``, without the reductions,
seconds a solve (mean). None where a solve has no second stage."""


def read(run):
    walls = [s.get("stage2", {}).get("skeleton_wall_s") for s in run.stats]
    if not walls or any(w is None for w in walls):
        return None
    return sum(walls) / len(walls)
