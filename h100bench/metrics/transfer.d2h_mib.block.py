"""The solve path's device-to-host fetches (``utils/timing.py::to_host``):
every ``d2h_bytes`` counter of a solve's stats, each site summed, MiB a
solve (mean). None where the program counts none."""


def _bytes(stats):
    if not isinstance(stats, dict):
        return 0, False
    total, seen = sum((stats.get("d2h_bytes") or {}).values()), "d2h_bytes" in stats
    for k, v in stats.items():
        if k != "d2h_bytes":
            b, s = _bytes(v)
            total, seen = total + b, seen or s
    return total, seen


def read(run):
    counted = [_bytes(s) for s in run.stats]
    if not counted or not all(seen for _, seen in counted):
        return None
    return sum(b for b, _ in counted) / len(counted) / float(1 << 20)
