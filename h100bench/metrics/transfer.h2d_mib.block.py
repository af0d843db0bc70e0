"""The block's uploads (``utils/timing.py::to_device``): every
``h2d_bytes`` counter of a solve's stats (the pre-screen's and the panel's
packed bytes, the phenotype arrays, the panel's trait blocks), MiB a solve
(mean). None where the program counts none."""


def read(run):
    counted = [s.get("h2d_bytes") for s in run.stats]
    if not counted or None in counted:
        return None
    return sum(sum(c.values()) for c in counted) / len(counted) / float(1 << 20)
