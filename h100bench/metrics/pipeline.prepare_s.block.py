"""Host I/O of a block before its panel: ``prepare_s`` + ``prescreen_s``
of ``pipelines/cusk.py``'s stats, seconds a solve (mean)."""


def read(run):
    if not run.stats:
        return None
    return sum(s["prepare_s"] + s["prescreen_s"] for s in run.stats) / len(run.stats)
