"""The summary-statistic input's first reduction and its second stage
(``pipelines/cuskss.py``: ``skeleton/reduce.py``, ``skeleton/cupc.py``):
``stage1["reduce_s"]`` + ``stage2_s`` (the stage with its reduction),
seconds a solve (mean). None where the program has no ``stage2_s`` span."""


def read(run):
    walls = []
    for s in run.stats:
        if "stage2_s" not in s or "reduce_s" not in s.get("stage1", {}):
            return None
        walls.append(s["stage1"]["reduce_s"] + s["stage2_s"])
    return sum(walls) / len(walls) if walls else None
