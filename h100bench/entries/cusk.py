"""A solve of one LD block through ``cigwas_tpu_torch.pipelines.cusk.cusk``,
the function that ``ci-gwas-torch cusk`` calls.

Set-up writes the block's PLINK files, a ``.blocks`` file of the one block,
and runs ``prep-bed`` over them (``cigwas_tpu_torch.prep.prep_bed``). A
solve writes ``<chr>_<first>_<last>.{mdim,ixs,adj,corr,sep}`` into its own
directory. The reference solves the block again from the ``.bed`` and
``.phen`` files.
"""

from __future__ import annotations

import torch

from h100bench.reference import cusk as reference

WITH_SEPSETS = True


def setup(cfg: dict, data: dict, device) -> dict:
    from cigwas_tpu_torch.prep import prep_bed

    stem = data["stem"]
    blocks = stem + ".blocks"
    with open(blocks, "w") as f:
        f.write(f"1\t0\t{data['markers'] - 1}\n")
    prep_bed(stem)
    return {"cfg": cfg, "data": data, "blocks": blocks, "device": str(device)}


def solve(state: dict, outdir: str) -> dict:
    from cigwas_tpu_torch.pipelines.cusk import cusk

    cfg, stem = state["cfg"], state["data"]["stem"]
    stats: dict = {}
    cusk(stem + ".phen", stem, state["blocks"], cfg["alpha"], cfg["max_level"],
         cfg["max_level_two"], cfg["depth"], outdir, 0, verbose=False,
         device=state["device"], stats=stats)
    if state["device"].startswith("cuda"):
        torch.cuda.synchronize()
    return stats


def expected(state: dict, device, dtype=torch.float64) -> dict:
    data = state["data"]
    return reference.solve(data["stem"] + ".bed", data["stem"] + ".phen", data["markers"],
                           data["individuals"], state["cfg"], device, dtype)
