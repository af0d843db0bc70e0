"""The `.phen` read of a block's ``CuskContext`` (``io/phen.py``), made anew
by every ``cusk`` call: the span ``load_phen_s`` inside ``context_s``,
seconds a solve (mean). None where the program has no such span."""


def read(run):
    walls = [s.get("load_phen_s") for s in run.stats]
    if not walls or None in walls:
        return None
    return sum(walls) / len(walls)
