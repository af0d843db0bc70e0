"""The correlation panel (``ops/corr.py``, ``ops/decode.py``): ``panel_s``
of ``pipelines/cusk.py``'s stats, ending in a device synchronisation,
seconds a solve (mean)."""


def read(run):
    if not run.stats:
        return None
    return sum(s["panel_s"] for s in run.stats) / len(run.stats)
