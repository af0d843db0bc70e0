"""The int8 one-hot bytes the panel decodes a solve (``ops/corr.py``): the
counter ``panel_decode_bytes``, every decode counted, GiB a solve (mean).
None where the program has no such counter."""


def read(run):
    counted = [s.get("panel_decode_bytes") for s in run.stats]
    if not counted or None in counted:
        return None
    return sum(counted) / len(counted) / float(1 << 30)
