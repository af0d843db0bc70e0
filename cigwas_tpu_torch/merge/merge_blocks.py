"""Merge per-block skeleton outputs into one global sparse skeleton.

Equivalent of `cusk_postprocessing/merge_blocks.py`. Global (1-based) index
scheme: traits occupy 1..P; each block's selected markers are appended after
all previous blocks' selected markers, at P + running_selected_offset + 1.

Parity notes (behaviors of the reference that are deliberately reproduced):

* trait–trait edges are *intersected* across blocks, but the reference's
  intersection loop iterates 0-based trait indices against 1-based keys
  (`merge_blocks.py:336-345`), so edges touching the last trait are unioned
  instead — reproduced here so merged outputs match exactly,
* missing block outputs are skipped with a warning while the global .bim
  offsets stay correct (`merge_blocks.py:371-391`),
* the MatrixMarket dims are max(row index of sam) for both sam and scm
  (`merge_blocks.py:307-318`).
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from cigwas_tpu_torch.io.results import load_mdim

BASE_INDEX = 1


def block_stems_from_blockfile(blockpath: str) -> list[str]:
    stems = []
    with open(blockpath) as fin:
        for line in fin:
            fields = line.split()
            if fields:
                stems.append(f"{fields[0]}_{fields[1]}_{fields[2]}")
    return stems


def _stem_block_size(basepath: str) -> int:
    first, last = basepath.split("_")[-2:]
    return int(last) - int(first) + 1


class BlockOutput:
    """One block's `.mdim/.adj/.corr/.sep/.ixs` fileset, with sparse views in
    the global index space."""

    def __init__(self, basepath: str, marker_offset: int = 0, global_marker_offset: int = 0):
        self.basepath = basepath
        self.mdim = load_mdim(basepath)
        self.marker_offset = marker_offset  # selected markers in prior blocks
        self.global_marker_offset = global_marker_offset  # .bim row of block start

    def num_markers(self) -> int:
        return self.mdim[0] - self.mdim[1]

    def num_phen(self) -> int:
        return self.mdim[1]

    def max_level(self) -> int:
        return self.mdim[2]

    def block_size(self) -> int:
        return _stem_block_size(self.basepath)

    def _dm2sm(self) -> np.ndarray:
        """Dense (block) index -> sparse (global, 1-based) index."""
        num_m, num_p = self.num_markers(), self.num_phen()
        ixs = np.arange(num_m + num_p)
        out = np.where(
            ixs < num_m,
            ixs + self.marker_offset + num_p + BASE_INDEX,
            ixs - num_m + BASE_INDEX,
        )
        return out

    def _load_dense(self, suffix: str, dtype) -> np.ndarray:
        n = self.num_markers() + self.num_phen()
        return np.fromfile(self.basepath + suffix, dtype=dtype).reshape(n, n)

    def sam(self) -> dict:
        dm = self._load_dense(".adj", np.int32)
        dm2sm = self._dm2sm()
        ii, jj = np.nonzero(dm)
        return {
            (int(dm2sm[i]), int(dm2sm[j])): int(dm[i, j]) for i, j in zip(ii, jj)
        }

    def scm(self) -> dict:
        dm = self._load_dense(".corr", np.float32)
        dm2sm = self._dm2sm()
        ii, jj = np.nonzero(dm)
        # keep np.float32 scalars: the .mtx writer formats them with numpy's
        # shortest repr, byte-identical to the reference's output
        return {
            (int(dm2sm[i]), int(dm2sm[j])): dm[i, j] for i, j in zip(ii, jj)
        }

    def ssm(self) -> dict:
        """Sparse sepsets in global index space (union-ready)."""
        num_m, num_p = self.num_markers(), self.num_phen()
        n = num_m + num_p
        ml = self.max_level()
        sep = np.fromfile(self.basepath + ".sep", dtype=np.int32).reshape(n, n, ml)
        dm2sm = self._dm2sm()
        res = {}
        for i in range(n):
            for j in range(n):
                entries = sep[i, j]
                entries = entries[: int(np.argmax(entries == -1))] if (entries == -1).any() else entries
                if entries.size:
                    key = (int(dm2sm[i]), int(dm2sm[j]))
                    vals = set(int(dm2sm[e]) for e in entries)
                    if key[0] in vals or key[1] in vals:
                        raise ValueError("SepSet(x, y) contains x or y")
                    res[key] = vals
        return res

    def gmi(self) -> dict:
        """Global marker indices: sparse marker index -> .bim row index."""
        rel = np.fromfile(self.basepath + ".ixs", dtype=np.int32)
        dm2sm = self._dm2sm()
        num_p = self.num_phen()
        out = {}
        for dm_ix, sm_ix in enumerate(dm2sm):
            if sm_ix >= num_p + BASE_INDEX:
                out[int(sm_ix)] = int(rel[dm_ix]) + self.global_marker_offset
        return out


def _merge_sam(acc: dict, new: dict, num_p: int) -> None:
    """Intersect trait-trait edges, union everything touching a marker.

    Reproduces `add_sam` (`merge_blocks.py:336-345`) including its 0-based
    range over 1-based keys.
    """
    for i in range(num_p):
        for j in range(num_p):
            if (i, j) in acc and (i, j) not in new:
                del acc[(i, j)]
    for (i, j), v in new.items():
        if i >= num_p or j >= num_p:
            acc[(i, j)] = v


@dataclass
class GlobalMergeResult:
    sam: dict
    scm: dict
    gmi: dict
    num_var: int
    num_phen: int
    max_level: int

    def write_mm(self, basepath: str) -> None:
        dim = max(t[0] for t in self.sam.keys())
        with open(basepath + "_sam.mtx", "w") as fout:
            fout.write("%%MatrixMarket matrix coordinate integer general\n")
            fout.write(f"{dim}\t{dim}\t{len(self.sam)}\n")
            for (t1, t2), v in self.sam.items():
                fout.write(f"{t1}\t{t2}\t{v}\n")
        with open(basepath + "_scm.mtx", "w") as fout:
            fout.write("%%MatrixMarket matrix coordinate real general\n")
            fout.write(f"{dim}\t{dim}\t{len(self.scm)}\n")
            for (t1, t2), v in self.scm.items():
                fout.write(f"{t1}\t{t2}\t{v}\n")
        with open(basepath + ".mdim", "w") as fout:
            fout.write(f"{self.num_var}\t{self.num_phen}\t{self.max_level}\n")
        np.array(sorted(self.gmi.values()), dtype=np.int32).tofile(basepath + ".ixs")


def merge_block_outputs(blockfile: str, outdir: str) -> GlobalMergeResult:
    if not outdir.endswith("/"):
        outdir += "/"
    basepaths = [outdir + s for s in block_stems_from_blockfile(blockfile)]

    sam: dict = {}
    scm: dict = {}
    gmi: dict = {}
    marker_offset = 0
    global_marker_offset = 0
    last_bo = None
    for idx, path in enumerate(basepaths):
        try:
            bo = BlockOutput(path, marker_offset, global_marker_offset)
        except FileNotFoundError:
            print(f"Missing: {path}")
            global_marker_offset += _stem_block_size(path)
            continue
        if idx == 0:
            # only block 0 seeds the trait-trait edges; if it is missing,
            # later blocks can only contribute marker edges (reference
            # behavior, `merge_blocks.py:361-391`)
            sam = bo.sam()
            scm = bo.scm()
            gmi = bo.gmi()
        else:
            _merge_sam(sam, bo.sam(), bo.num_phen())
            scm.update(bo.scm())
            gmi.update(bo.gmi())
        marker_offset += bo.num_markers()
        global_marker_offset += bo.block_size()
        last_bo = bo

    if last_bo is None:
        raise FileNotFoundError("no block outputs found to merge")

    return GlobalMergeResult(
        sam=sam,
        scm=scm,
        gmi=gmi,
        num_var=marker_offset + last_bo.num_phen(),
        num_phen=last_bo.num_phen(),
        max_level=last_bo.max_level(),
    )


def reformat_cuskss_merged_output(cusk_dir: str) -> GlobalMergeResult:
    """Map cuskss-merged output rows back to global .bim indices
    (`reformat_cuskss_merged_output`, `merge_blocks.py:398-425`)."""
    num_var, num_trait, max_level = load_mdim(os.path.join(cusk_dir, "cuskss_merged"))
    old_glob = np.fromfile(os.path.join(cusk_dir, "merged_blocks.ixs"), dtype=np.int32)
    ixs = np.fromfile(os.path.join(cusk_dir, "cuskss_merged.ixs"), dtype=np.int32)
    glob_ixs = old_glob[ixs[:-num_trait]]
    gmi = {ix: int(gix) for ix, gix in enumerate(glob_ixs)}
    bo = BlockOutput.__new__(BlockOutput)
    bo.basepath = os.path.join(cusk_dir, "cuskss_merged")
    bo.mdim = [num_var, num_trait, max_level]
    bo.marker_offset = 0
    bo.global_marker_offset = 0
    return GlobalMergeResult(
        sam=bo.sam(),
        scm=bo.scm(),
        gmi=gmi,
        num_var=num_var,
        num_phen=num_trait,
        max_level=max_level,
    )
