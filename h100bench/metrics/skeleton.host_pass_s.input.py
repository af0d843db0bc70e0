"""The skeleton's host passes over (n, n) and (n, n, depth) arrays between
launches (``skeleton/cupc.py``: degree sums, removal masks, adjacency
updates, sepset folds, the final cast): the span ``host_pass_s`` of both
stages, seconds a solve (mean). None where the program has no such span."""


def read(run):
    walls = []
    for s in run.stats:
        stages = [s[k] for k in ("stage1", "stage2") if k in s]
        if not stages or any("host_pass_s" not in st for st in stages):
            return None
        walls.append(sum(st["host_pass_s"] for st in stages))
    return sum(walls) / len(walls) if walls else None
