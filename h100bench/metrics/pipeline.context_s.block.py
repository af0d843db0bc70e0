"""The block's ``CuskContext`` (``pipelines/cusk.py``): the `.phen`, `.bim`,
`.dim` and `.blocks` reads and the thresholds, made anew by every ``cusk``
call: its span ``context_s``, seconds a solve (mean). None where the
program has no such span."""


def read(run):
    walls = [s.get("context_s") for s in run.stats]
    if not walls or None in walls:
        return None
    return sum(walls) / len(walls)
