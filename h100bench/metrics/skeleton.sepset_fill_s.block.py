"""The sepset buffer's fill (``skeleton/cupc.py::_sepset_buffer``): the
span ``sepset_alloc_s`` of both skeleton stages, seconds a solve (mean)."""


def read(run):
    walls = [sum(s[k].get("sepset_alloc_s", 0.0) for k in ("stage1", "stage2") if k in s)
             for s in run.stats]
    if not walls or not all(walls):
        return None
    return sum(walls) / len(walls)
