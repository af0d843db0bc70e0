"""The reduction and stage 2 (``skeleton/reduce.py``, ``skeleton/cupc.py``):
``reduce_s`` + ``stage2_s`` of ``pipelines/cusk.py``'s stats, seconds a
solve (mean)."""


def read(run):
    if not run.stats:
        return None
    return sum(s["reduce_s"] + s["stage2_s"] for s in run.stats) / len(run.stats)
