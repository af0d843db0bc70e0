"""The block's `.bed` read (``io/bed.py::read_block_from_bed``): the span
``read_bed_s`` inside ``prepare_s``, seconds a solve (mean). None where the
program has no such span."""


def read(run):
    walls = [s.get("read_bed_s") for s in run.stats]
    if not walls or None in walls:
        return None
    return sum(walls) / len(walls)
