"""The numbers that decide ``correct``: a solve's output files against the
reference's result.

Each number is the largest over the solves compared:

- ``retained_diff``: variables retained by one side only (block indices);
- ``adjacency_diff``: pairs of variables retained by both whose adjacency
  differs;
- ``sepset_diff``: ordered pairs of variables retained by both whose
  separation sets, as sets of block indices, differ (for outputs that
  carry them);
- ``corr_err``: the largest |difference| of a retained pair's correlation.

A file that is missing or does not hold what its ``.mdim`` says makes the
solve failed, not a number.
"""

from __future__ import annotations

import os

import numpy as np

NUMBERS = ("retained_diff", "adjacency_diff", "sepset_diff", "corr_err")


class Malformed(Exception):
    """An output file that is missing or not of the size its header gives."""


def read_output(base: str, with_sepsets: bool) -> dict:
    """One solve's ``.mdim/.ixs/.adj/.corr[/.sep]`` files."""
    try:
        with open(base + ".mdim") as f:
            num_var, num_phen, stride = (int(v) for v in f.readline().split())
        ixs = np.fromfile(base + ".ixs", dtype=np.int32)
        G = np.fromfile(base + ".adj", dtype=np.int32)
        C = np.fromfile(base + ".corr", dtype=np.float32)
        S = np.fromfile(base + ".sep", dtype=np.int32) if with_sepsets else None
    except (OSError, ValueError) as e:
        raise Malformed(f"{base}: {e}") from e
    k = num_var
    if ixs.size != k or G.size != k * k or C.size != k * k or (
            S is not None and S.size != k * k * stride):
        raise Malformed(f"{base}: sizes do not match {k} variables")
    return {"num_phen": num_phen, "ixs": ixs.astype(np.int64), "G": G.reshape(k, k) != 0,
            "C": C.reshape(k, k).astype(np.float64),
            "S": None if S is None else S.reshape(k, k, stride).astype(np.int64)}


def _sets(S: np.ndarray, ixs: np.ndarray, rows: np.ndarray) -> list:
    """Separation sets of the (rows x rows) pairs as frozensets of block
    indices."""
    sub = S[np.ix_(rows, rows)]
    return [frozenset(ixs[s] for s in entry if s >= 0) for entry in sub.reshape(-1, sub.shape[-1])]


def compare(out: dict, ref: dict) -> dict:
    """The numbers of one output against the reference."""
    if out["num_phen"] != ref["num_phen"]:
        raise Malformed(f"{out['num_phen']} traits, the reference has {ref['num_phen']}")
    both, io, ir = np.intersect1d(out["ixs"], ref["ixs"], return_indices=True)
    retained = out["ixs"].size + ref["ixs"].size - 2 * both.size
    adj = int(np.triu(out["G"][np.ix_(io, io)] != ref["G"][np.ix_(ir, ir)], 1).sum())
    corr = float(np.abs(out["C"][np.ix_(io, io)] - ref["C"][np.ix_(ir, ir)]).max(initial=0.0))
    nums = {"retained_diff": float(retained), "adjacency_diff": float(adj), "corr_err": corr}
    if ref.get("S") is not None:
        a = _sets(out["S"], out["ixs"], io)
        b = _sets(ref["S"], ref["ixs"], ir)
        nums["sepset_diff"] = float(sum(x != y for x, y in zip(a, b)))
    return nums


def worst(numbers: list) -> dict:
    """The largest of each number over several outputs."""
    keys = [k for k in NUMBERS if any(k in n for n in numbers)]
    return {k: max(n[k] for n in numbers if k in n) for k in keys}


def output_base(outdir: str) -> str:
    """The file stem of the one output in outdir."""
    stems = {os.path.splitext(f)[0] for f in os.listdir(outdir) if f.endswith(".mdim")}
    if len(stems) != 1:
        raise Malformed(f"{outdir}: {len(stems)} outputs")
    return os.path.join(outdir, stems.pop())
