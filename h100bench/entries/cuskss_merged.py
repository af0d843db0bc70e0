"""A solve of one merged, time-indexed summary-statistic input through
``cigwas_tpu_torch.pipelines.cuskss.cuskss``, the function that
``ci-gwas-torch cuskss`` calls, with ``--marker-indices`` and
``--time-index``, standard errors (hetcor) and two stages.

A solve reads the input's files and writes ``cuskss_merged.{mdim,ixs,adj,
corr}`` into its own directory. The reference solves the input again from
the same files.
"""

from __future__ import annotations

import torch

from h100bench.reference import cuskss_merged as reference

WITH_SEPSETS = False


def setup(cfg: dict, data: dict, device) -> dict:
    return {"cfg": cfg, "data": data, "device": str(device)}


def solve(state: dict, outdir: str) -> dict:
    from cigwas_tpu_torch.pipelines.cuskss import CuskssArgs, cuskss

    cfg, d = state["cfg"], state["data"]
    args = CuskssArgs.from_paths(
        mxm=d["mxm"], mxp=d["mxp"], mxp_se=d["mxp_se"], pxp=d["pxp"], pxp_se=d["pxp_se"],
        marker_indices=d["marker_ixs"], time_index=d["time_index"], alpha=cfg["alpha"],
        max_level_one=cfg["max_level"], max_level_two=cfg["max_level_two"],
        max_depth=cfg["depth"], num_samples=cfg["gwas_samples"], outdir=outdir)
    stats: dict = {}
    cuskss(args, verbose=False, device=state["device"], stats=stats)
    if state["device"].startswith("cuda"):
        torch.cuda.synchronize()
    return stats


def expected(state: dict, device, dtype=torch.float64) -> dict:
    return reference.solve(state["data"], state["cfg"], device, dtype)
