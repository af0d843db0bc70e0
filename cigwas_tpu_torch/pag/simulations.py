"""Simulation-mode sRFCI drivers (mpu / mpd / std / cusk2 modes).

Port of `srfci/CIGWAS_est_PAG_simulations.R`: runs RFCI v-structure
orientation with CI re-testing on raw per-block cusk output
(`.adj/.corr/.sep/.mdim`), then the R1-R10 rules, with mode-dependent
marker->trait forcing. Used to evaluate PAG recovery against simulated
ground truth; the production path is :func:`cigwas_tpu_torch.pag.rfci.estimate_pag`.

The v-structure step follows the RFCI algorithm (Colombo et al. 2012), as
implemented by pcalg's `rfci.vStruc`: for every unshielded triple (a, b, c)
both edges are re-tested given sepset(a, c) \\ {b}; an edge that turns out
independent is deleted (its separating set recorded), otherwise the triple
is oriented as a collider when b is not in the separating set.
"""

from __future__ import annotations

import numpy as np
from scipy.stats import norm

from cigwas_tpu_torch.io.results import ReducedGCS
from cigwas_tpu_torch.pag.rfci import triple2numb, udag2apag_sequential


def gauss_ci_pvalue(C, x, y, S, n) -> float:
    S = list(S)
    ixs = [x, y] + S
    sub = np.asarray(C)[np.ix_(ixs, ixs)]
    try:
        prec = np.linalg.inv(sub)
    except np.linalg.LinAlgError:
        prec = np.linalg.pinv(sub)
    r = -prec[0, 1] / np.sqrt(np.abs(prec[0, 0] * prec[1, 1]))
    r = min(max(r, -0.9999999), 0.9999999)
    z = np.sqrt(max(n - len(S) - 3, 1)) * abs(np.arctanh(r))
    return float(2 * norm.sf(z))


def find_unsh_triples(adj: np.ndarray, restrict: np.ndarray | None = None):
    """Unshielded triples (a, b, c), a < c, of a symmetric adjacency.

    restrict: optional boolean node mask; when given, only triples whose
    nodes all lie in the mask are returned (the `unsh_triple_pheno_only`
    modes restrict to trait nodes).
    """
    adj = np.asarray(adj).astype(bool)
    n = adj.shape[0]
    triples = []
    for b in range(n):
        nb = np.where(adj[b])[0]
        for i in range(len(nb)):
            for j in range(i + 1, len(nb)):
                a, c = int(nb[i]), int(nb[j])
                if not adj[a, c] and not adj[c, a]:
                    if restrict is not None and not (
                        restrict[a] and restrict[b] and restrict[c]
                    ):
                        continue
                    triples.append((a, b, c))
    return triples


def rfci_vstructures(
    adj: np.ndarray,
    C: np.ndarray,
    n: int,
    alpha: float,
    sepset: dict,
    triples: list | None = None,
):
    """RFCI v-structure step with edge re-testing.

    Returns (amat with codes {0,1,2}, updated sepset, unf set). The input
    sepset maps ordered pairs to sets of 0-based indices.
    """
    adj = np.asarray(adj).astype(bool).copy()
    sepset = {k: set(v) for k, v in sepset.items()}
    if triples is None:
        triples = find_unsh_triples(adj)

    def sep_of(a, c):
        return sepset.get((a, c), set()) | sepset.get((c, a), set())

    # re-test both edges of each triple given sepset(a, c) \ {b}
    deleted = True
    while deleted:
        deleted = False
        for a, b, c in triples:
            if not (adj[a, b] and adj[b, c]) or adj[a, c]:
                continue
            S = sorted(sep_of(a, c) - {b})
            for (x, y) in ((a, b), (c, b)):
                if not adj[x, y]:
                    continue
                if gauss_ci_pvalue(C, x, y, S, n) > alpha:
                    adj[x, y] = adj[y, x] = False
                    sepset[(x, y)] = set(S)
                    deleted = True

    amat = np.zeros_like(adj, dtype=np.int32)
    amat[adj] = 1
    unf: set = set()
    p = adj.shape[0]
    for a, b, c in triples:
        if adj[a, b] and adj[b, c] and not adj[a, c]:
            if b not in sep_of(a, c):
                amat[a, b] = 2
                amat[c, b] = 2
    return amat, sepset, unf


def sepset_dict_from_array(sep: np.ndarray) -> dict:
    """(n, n, L) -1-padded sepset array -> ordered-pair dict."""
    res = {}
    n = sep.shape[0]
    for i in range(n):
        for j in range(n):
            vals = sep[i, j]
            vals = vals[vals != -1]
            if vals.size:
                res[(i, j)] = set(int(v) for v in vals)
    return res


def estimate_pag_simulations(
    stem: str,
    num_individuals: int,
    alpha: float,
    mode: str = "std",
    verbose: bool = False,
) -> np.ndarray:
    """Mode-driven PAG estimation on raw block output
    (`CIGWAS_est_PAG_simulations.R`). Writes
    `<stem>_estimated_pag_<mode>.mtx` and the after-vStruc snapshot.

    Note: markers occupy indices 0..m-1, traits m..n-1 in block outputs.
    """
    from cigwas_tpu_torch.io.binary import write_coo_mtx

    modes = {
        "mpu": dict(pheno_only=True, force_before=False, force_end=True, ext_atr=False),
        "mpd": dict(pheno_only=True, force_before=True, force_end=False, ext_atr=False),
        "std": dict(pheno_only=False, force_before=False, force_end=False, ext_atr=False),
        "cusk2": dict(pheno_only=False, force_before=False, force_end=True, ext_atr=True),
    }
    if mode not in modes:
        raise ValueError("mode has to be one of [mpu, mpd, std, cusk2]")
    cfg = modes[mode]

    gcs = ReducedGCS.from_file(stem)
    num_var, num_phen = gcs.num_var, gcs.num_phen
    num_marker = num_var - num_phen
    adj = (gcs.G != 0).astype(np.int32)
    sepset = sepset_dict_from_array(gcs.S)

    restrict = None
    if cfg["pheno_only"]:
        restrict = np.zeros(num_var, dtype=bool)
        restrict[num_marker:] = True
    triples = find_unsh_triples(adj, restrict=restrict)

    A, sepset, unf = rfci_vstructures(
        adj, gcs.C, num_individuals, alpha, sepset, triples=triples
    )
    write_coo_mtx(f"{stem}_estimated_pag_{mode}_after_vStruc.mtx", A, integer=True)

    if cfg["force_before"]:
        mt = A[:num_marker, num_marker:]
        mt[mt != 0] = 2
        A[:num_marker, num_marker:] = mt
        tm = A[num_marker:, :num_marker]
        tm[tm != 0] = 3
        A[num_marker:, :num_marker] = tm

    if cfg["ext_atr"]:
        atr = np.fromfile(f"{stem}.atr", dtype=np.int32).reshape(-1, 3)
        for x, y, z in atr:
            unf.add(triple2numb(num_var, int(x) + 1, int(y) + 1, int(z) + 1))

    # the simulation R driver uses the SEQUENTIAL udag2apag
    # (`CIGWAS_est_PAG_simulations.R:153` -> `RFCI_functions_final.R:335`),
    # unlike production cusk2 which uses the order-independent fixpoint
    Amat = udag2apag_sequential(A, sepset, unf=unf, verbose=verbose)

    if cfg["force_end"]:
        mt = Amat[:num_marker, num_marker:]
        mt[mt != 0] = 2
        Amat[:num_marker, num_marker:] = mt
        tm = Amat[num_marker:, :num_marker]
        tm[tm != 0] = 3
        Amat[num_marker:, :num_marker] = tm

    write_coo_mtx(f"{stem}_estimated_pag_{mode}.mtx", Amat, integer=True)
    return Amat
