"""The summary-statistic input's host reads and panel assembly
(``pipelines/cuskss.py``): ``load_s`` + ``assemble_s``, seconds a solve
(mean)."""


def read(run):
    if not run.stats:
        return None
    return sum(s["load_s"] + s["assemble_s"] for s in run.stats) / len(run.stats)
