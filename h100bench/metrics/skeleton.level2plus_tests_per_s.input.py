"""Stage 1's hetcor CI tests a second at levels >= 2 (``skeleton/cupc.py``):
``ci_tests`` over the sum of its ``level_wall_s`` of levels >= 2, summed
over the window's solves."""


def read(run):
    tests = sum(s["stage1"].get("ci_tests", 0) for s in run.stats)
    wall = sum(w for s in run.stats for l, w in s["stage1"].get("level_wall_s", {}).items()
               if l >= 2)
    return tests / wall if tests and wall > 0 else None
