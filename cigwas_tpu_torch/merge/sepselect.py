"""Greedy separation-set search and v-structure orientation on the merged
skeleton.

Equivalent of `cusk_postprocessing/sepselect.py` (classes `CuskResults` /
`MergedCuskResults`). For every "RFCI-relevant" unshielded triple's outer
pair (i, j), the search greedily grows a conditioning set from i's trait
neighbours, always adding the neighbour that minimizes the partial
correlation:

* the **maximal sepset** keeps growing while independence holds and stops at
  the first non-independent extension after independence was reached
  (`find_maximal_and_min_pcorr_sepsets_incr`, `sepselect.py:262-329`),
* the **min-pcorr sepset** is the prefix at the first local minimum of the
  partial correlation after independence was reached,
* triples whose middle node is in the maximal but not the min-pcorr sepset
  are **ambiguous** (`mark_ambiguous_triples`, `sepselect.py:96-107`).

Candidate evaluation (one matrix inverse per candidate) is batched with a
vectorized numpy inverse over all remaining neighbours at once — the
reference's hottest Python loop (`SURVEY.md §3.5`).

Parity notes: the merged layout is traits-first; `is_marker` uses the
reference's strict `ix > num_phen` comparison (`sepselect.py:451-452`), which
treats the first marker like a trait — reproduced deliberately.
"""

from __future__ import annotations

import numpy as np
from scipy.io import mmread

from cigwas_tpu_torch.io.binary import write_coo_mtx
from cigwas_tpu_torch.utils.stats import alpha_threshold, fisher_z


def _pcorr_z(corr: np.ndarray, ixs: list[int]) -> float:
    """Fisher z of the partial correlation of ixs[0], ixs[1] given the rest."""
    sub = corr[np.ix_(ixs, ixs)]
    try:
        prec = np.linalg.inv(sub)
    except np.linalg.LinAlgError:
        prec = np.linalg.pinv(sub)
    return float(fisher_z(-(prec[0, 1] / np.sqrt(np.abs(prec[0, 0] * prec[1, 1])))))


def _pcorr_z_batch(corr: np.ndarray, i: int, j: int, base: list[int], cands: np.ndarray):
    """z for every candidate extension [i, j] + base + [c]; vectorized inverse."""
    k = len(base) + 3
    idx = np.empty((len(cands), k), dtype=np.int64)
    idx[:, 0] = i
    idx[:, 1] = j
    for t, b in enumerate(base):
        idx[:, 2 + t] = b
    idx[:, -1] = cands
    subs = corr[idx[:, :, None], idx[:, None, :]]  # (c, k, k)
    try:
        prec = np.linalg.inv(subs)
    except np.linalg.LinAlgError:
        prec = np.stack([np.linalg.pinv(s) for s in subs])
    with np.errstate(invalid="ignore", divide="ignore"):
        z = fisher_z(-(prec[:, 0, 1] / np.sqrt(np.abs(prec[:, 0, 0] * prec[:, 1, 1]))))
    return z


class MergedSkeleton:
    """Merged skeleton loaded from `_sam.mtx/_scm.mtx/.mdim/.ixs`
    (`MergedCuskResults`, `sepselect.py:428-478`)."""

    def __init__(self, stem: str, orientation_prior_file: str | None = None):
        with open(f"{stem}.mdim") as fin:
            self.num_var, self.num_phen, self.max_level = [
                int(e) for e in fin.readline().split()
            ]
        self.num_m = self.num_var - self.num_phen
        self.ixs = np.fromfile(f"{stem}.ixs", dtype=np.int32)
        self.adj = mmread(f"{stem}_sam.mtx").toarray().astype(bool)
        self.corr = mmread(f"{stem}_scm.mtx").toarray()
        np.fill_diagonal(self.corr, 1.0)
        self._drop_collinear_markers()

        self.orientation_prior = np.zeros_like(self.adj, dtype=np.int32)
        # markers always point into traits
        self.orientation_prior[self.num_phen :, : self.num_phen] = self.adj[
            self.num_phen :, : self.num_phen
        ]
        if orientation_prior_file is not None:
            prior = np.fromfile(orientation_prior_file, dtype=np.int32)
            if prior.size != self.num_phen**2:
                raise ValueError(
                    "orientation prior has to have n_trait * n_trait entries"
                )
            self.orientation_prior[: self.num_phen, : self.num_phen] = prior.reshape(
                self.num_phen, self.num_phen
            )

        self.pag: np.ndarray | None = None
        self.max_sepsets: dict | None = None
        self.min_sepsets: dict | None = None
        self.max_level_maximal_sepsets: int | None = None
        self.maximal_sepset_arr: np.ndarray | None = None
        self.minimal_pcorr_sepset_arr: np.ndarray | None = None
        self.ambiguous_triples: np.ndarray | None = None
        self._unshielded_triples: set | None = None
        self._rfci_triples: np.ndarray | None = None

    # -- structure ---------------------------------------------------------

    def _drop_collinear_markers(self) -> None:
        """Remove marker rows with more than one corr == 1 entry
        (`rm_collinear_markers`, `sepselect.py:464-478`)."""
        n_rm = 0
        i = self.num_phen
        while i < self.num_var:
            if np.sum(self.corr[i, :] == 1) > 1:
                keep = np.arange(self.num_var) != i
                self.corr = self.corr[np.ix_(keep, keep)]
                self.adj = self.adj[np.ix_(keep, keep)]
                self.ixs = np.delete(self.ixs, i - self.num_phen)
                self.num_var -= 1
                n_rm += 1
            else:
                i += 1
        self.num_m = self.num_var - self.num_phen
        if n_rm:
            print(f"Removed {n_rm} collinear markers")

    def is_marker(self, ix: int) -> bool:
        # strict '>' like the reference (`sepselect.py:451-452`)
        return ix > self.num_phen

    def neighbors(self, ix: int) -> np.ndarray:
        return np.where(self.adj[ix, :])[0]

    def trait_neighbors(self, ix: int) -> np.ndarray:
        nb = self.neighbors(ix)
        return nb[nb < self.num_phen]

    def adjacent(self, a: int, b: int) -> bool:
        return bool(self.adj[a, b] or self.adj[b, a])

    def unshielded_triples(self) -> set:
        """All (a, b, c) with b adjacent to both, a and c non-adjacent
        (`get_unshielded_triples`, `sepselect.py:146-160`)."""
        if self._unshielded_triples is None:
            triples = set()
            adj_or = self.adj | self.adj.T
            for b in range(self.num_var):
                nb = np.where(self.adj[b, :])[0]
                # common-neighbour pattern from both loop variants of the
                # reference collapses to: any two neighbours of b that are
                # themselves non-adjacent
                for ai in range(len(nb)):
                    for ci in range(len(nb)):
                        a, c = int(nb[ai]), int(nb[ci])
                        if a != c and not adj_or[a, c]:
                            triples.add((a, b, c))
            # the reference also walks a -> b -> c along directed adj rows;
            # with a symmetric skeleton both constructions coincide
            self._unshielded_triples = triples
        return self._unshielded_triples

    def rfci_relevant_triples(self) -> np.ndarray:
        """Triples with a trait middle node, < 2 markers, x < z
        (`get_rfci_relevant_unshielded_triples`, `sepselect.py:71-84`)."""
        if self._rfci_triples is None:
            rows = []
            for x, y, z in self.unshielded_triples():
                if (
                    not self.is_marker(y)
                    and x < z
                    and sum(self.is_marker(e) for e in (x, y, z)) < 2
                ):
                    rows.append([x, y, z])
            self._rfci_triples = np.array(rows, dtype=np.int32).reshape(-1, 3)
        return self._rfci_triples

    def rfci_outer_pairs(self) -> set:
        pairs = set()
        for t in self.rfci_relevant_triples():
            pairs.add((int(t[0]), int(t[2])))
            pairs.add((int(t[2]), int(t[0])))
        return pairs

    # -- sepset search -----------------------------------------------------

    def find_maximal_and_min_pcorr_sepsets(self, alpha: float, num_samples: int):
        """Greedy maximal + min-pcorr sepsets per outer pair
        (`find_maximal_and_min_pcorr_sepsets_incr`, `sepselect.py:262-329`)."""
        max_sepsets: dict = {}
        min_sepsets: dict = {}
        pairs = sorted(self.rfci_outer_pairs())
        for i, j in pairs:
            remaining = sorted(int(v) for v in self.trait_neighbors(i))
            sepset: list[int] = []
            found_sepset = _pcorr_z(self.corr, [i, j]) < alpha_threshold(
                alpha, num_samples, 0
            )
            found_minimum = False
            last_ref = np.inf
            for size in range(1, len(remaining) + len(sepset) + 1):
                if not remaining:
                    break
                cands = np.array(remaining)
                zs = _pcorr_z_batch(self.corr, i, j, sepset, cands)
                zs = np.where(np.isnan(zs), np.inf, zs)
                best = int(np.argmin(zs))
                ref = float(zs[best])
                add = int(cands[best])

                if ref > last_ref and found_sepset and not found_minimum:
                    found_minimum = True
                    # the reference stores the *live* list here without a
                    # copy (`sepselect.py:289-291`), so the recorded min
                    # sepset keeps growing with the maximal one; ambiguous
                    # triples can then only come from pairs where no minimum
                    # was recorded at all — reproduced for parity
                    min_sepsets[(i, j)] = sepset

                indep = ref < alpha_threshold(alpha, num_samples, size)
                if not indep and found_sepset:
                    break
                if indep:
                    found_sepset = True
                last_ref = ref
                sepset.append(add)
                remaining.remove(add)
            max_sepsets[(i, j)] = sepset

        self.max_sepsets = max_sepsets
        self.min_sepsets = min_sepsets
        self.max_level_maximal_sepsets = (
            max((len(v) for v in max_sepsets.values()), default=0)
        )
        self.maximal_sepset_arr = self._sepsets_to_array(
            max_sepsets, self.max_level_maximal_sepsets
        )
        ml_min = max((len(v) for v in min_sepsets.values()), default=0)
        self.minimal_pcorr_sepset_arr = self._sepsets_to_array(min_sepsets, ml_min)

    def _sepsets_to_array(self, sepsets: dict, width: int) -> np.ndarray:
        arr = np.full((self.num_var, self.num_var, max(width, 1)), -1, dtype=np.int32)
        for (i, j), v in sepsets.items():
            arr[i, j, : len(v)] = v
        return arr

    def mark_ambiguous_triples(self) -> None:
        """(a, b, c) with b in max-sepset(a,c) but not in min-sepset(a,c)
        (`mark_ambiguous_triples`, `sepselect.py:96-107`)."""
        if self.maximal_sepset_arr is None or self.minimal_pcorr_sepset_arr is None:
            raise RuntimeError("run find_maximal_and_min_pcorr_sepsets first")
        rows = []
        for a, b, c in self.unshielded_triples():
            if np.any(self.maximal_sepset_arr[a, c] == b) and np.all(
                self.minimal_pcorr_sepset_arr[a, c] != b
            ):
                rows.append([a, b, c])
        self.ambiguous_triples = np.array(rows, dtype=np.int32).reshape(-1, 3)

    # -- orientation -------------------------------------------------------

    def orient_v_structures(self, alpha: float, num_samples: int) -> None:
        """PAG codes 1/2/3 honoring the orientation prior
        (`orient_v_structures`, `sepselect.py:480-533`)."""
        self.pag = np.zeros_like(self.adj, dtype=np.int32)
        self.pag[self.adj] = 1
        if self.max_sepsets is None:
            self.find_maximal_and_min_pcorr_sepsets(alpha, num_samples)
        for x, y, z in self.rfci_relevant_triples():
            x, y, z = int(x), int(y), int(z)
            orient = (
                y not in self.max_sepsets.get((x, z), [])
                and y not in self.max_sepsets.get((z, x), [])
            )
            for a in (x, z):
                if self.orientation_prior[a, y] == 1:
                    self.pag[a, y] = 2
                    self.pag[y, a] = 3
                elif self.orientation_prior[y, a] == 1:
                    self.pag[y, a] = 2
                    self.pag[a, y] = 3
                elif orient:
                    self.pag[a, y] = 2

    # -- output ------------------------------------------------------------

    def to_file(self, stem: str) -> None:
        n_atr = self.ambiguous_triples.shape[0]
        n_ut = self.rfci_relevant_triples().shape[0]
        with open(stem + ".mdim", "w") as fout:
            fout.write(
                f"{self.num_var}\t{self.num_phen}\t{self.max_level_maximal_sepsets}"
                f"\t{n_atr}\t{n_ut}\n"
            )
        write_coo_mtx(f"{stem}_sam.mtx", self.adj.astype(np.int32), integer=True)
        write_coo_mtx(f"{stem}_scm.mtx", self.corr)
        if self.pag is None:
            self.pag = np.zeros_like(self.adj, dtype=np.int32)
        write_coo_mtx(f"{stem}_spm.mtx", self.pag, integer=True)
        self.ambiguous_triples.tofile(f"{stem}.atr")
        self.rfci_relevant_triples().tofile(f"{stem}.ut")
        with open(f"{stem}.ssm", "w") as fout:
            for i in range(self.num_var):
                for j in range(self.num_var):
                    ss = self.maximal_sepset_arr[i, j]
                    ss = ss[ss != -1]
                    if ss.size == 0:
                        continue
                    row = np.concatenate([[i, j], ss]) + 1
                    fout.write(" ".join(str(int(e)) for e in row) + "\n")


def sepselect_merged(stem: str, alpha: float, num_samples: int) -> MergedSkeleton:
    ms = MergedSkeleton(stem)
    ms.find_maximal_and_min_pcorr_sepsets(alpha, num_samples)
    ms.mark_ambiguous_triples()
    return ms


def orient_v_structures_merged(
    stem: str, alpha: float, num_samples: int, orientation_prior_file=None
) -> MergedSkeleton:
    ms = MergedSkeleton(stem, orientation_prior_file=orientation_prior_file)
    ms.orient_v_structures(alpha, num_samples)
    ms.mark_ambiguous_triples()
    return ms
