"""sDAVS: data-driven adjustment-set search for average causal effects.

Python port of `sdavs/DAVS_functions_final.R` + the driver
`sdavs/CIGWAS_est_ACE.R`: for an (exposure W, outcome Y) pair, candidate
COSO variables Q come from W's PAG parents/spouses minus Y's; for each Q an
apriori-style search over subsets Z of the possible-d-sep set finds
adjustment sets satisfying  Q ~ Y | Z dependent  and  Q ~ Y | {W} u Z
independent (the generalized adjustment criterion rules), and the ACE is the
regression coefficient of W from the correlation matrix
(`est_reg_con_cor` / `lm.cov`, `DAVS_functions_final.R:506-533`).

Like the reference, this stage is standalone (not wired into the main
pipeline CLI). Deviation from the reference: its length(Fk)==2 branch reuses
a stale loop variable (`DAVS_functions_final.R:124-157`, `Z` from the L1
loop); here the candidate pair itself is tested.

Edge mark codes: 0 none, 1 circle, 2 arrowhead, 3 tail.
"""

from __future__ import annotations

from itertools import combinations

import numpy as np
from scipy.stats import norm

from cigwas_tpu_torch.utils.stats import fisher_z


# --------------------------------------------------------------------------
# PAG structure helpers


def search_am(pag: np.ndarray, x: int, kind: str) -> list[int]:
    """pcalg-style searchAM for parents ("pa") / spouses ("sp") of x."""
    p = pag.shape[0]
    out = []
    for y in range(p):
        if y == x or pag[y, x] == 0:
            continue
        if kind == "pa" and pag[y, x] == 2 and pag[x, y] == 3:
            out.append(y)
        elif kind == "sp" and pag[y, x] == 2 and pag[x, y] == 2:
            out.append(y)
    return out


def possible_de(amat: np.ndarray, x: int) -> list[int]:
    """Possible descendants of x on definite-status paths
    (`possibleDe`, `DAVS_functions_final.R:410-460`)."""
    p = amat.shape[0]
    is_de = np.zeros(p, dtype=bool)
    is_de[x] = True
    ind_d = [int(d) for d in np.where((amat[x, :] != 0) & (amat[:, x] != 2) & ~is_de)[0]]
    preds = [x] * len(ind_d)
    while ind_d:
        d = ind_d.pop(0)
        pred = preds.pop(0)
        is_de[d] = True
        a_d = amat[:, d]
        a_d_p = a_d[pred]
        for r in np.where((amat[d, :] != 0) & (a_d != 2) & ~is_de)[0]:
            r = int(r)
            if a_d_p == 3 or a_d[r] == 3 or (
                a_d_p == 1 and a_d[r] == 1 and amat[pred, r] == 0
            ):
                ind_d.append(r)
                preds.append(d)
    return [int(i) for i in np.where(is_de)[0]]


def is_poss_ancestor(a: int, b: int, g: np.ndarray, visited=None) -> bool:
    """Possible-ancestor check along tail/circle-out edges
    (`is.poss.ancestor`, `DAVS_functions_final.R:462-491`)."""
    if a == b:
        return True
    if visited is None:
        visited = []
    out_marks = np.where((g[:, a] == 3) | (g[:, a] == 1))[0]
    for c in out_marks:
        c = int(c)
        if c in visited:
            continue
        if g[a, c] in (2, 1):
            if c == b:
                return True
            if np.any((g[:, c] == 3) | (g[:, c] == 1)):
                if is_poss_ancestor(c, b, g, visited=visited + [a]):
                    return True
    return False


def pdsep_reach(a: int, b: int, adjacency: np.ndarray, max_depth: int | None = None):
    """Possible-d-sep set of (a, b) via labeled-edge BFS
    (`pdsepset.reach`, `DAVS_functions_final.R:247-284`, "small" variant)."""
    p = adjacency.shape[0]
    edgeslist = [list(np.where(adjacency[:, i] != 0)[0].astype(int)) for i in range(p)]
    labeled = [[(a, s) for s in edgeslist[a]]]
    edgeslist[a] = []

    depth = 2
    while True:
        new_edges = []
        for r in labeled[-1]:
            edgestemp = list(edgeslist[r[1]])
            if not edgestemp:
                break
            for s in edgestemp:
                legal = (
                    (
                        adjacency[r[0], r[1]] == 2
                        and adjacency[s, r[1]] == 2
                        and r[0] != s
                    )
                    or (adjacency[r[0], s] != 0 and r[0] != s)
                ) and (
                    (is_poss_ancestor(s, a, adjacency) or is_poss_ancestor(s, b, adjacency))
                    and (
                        is_poss_ancestor(r[1], a, adjacency)
                        or is_poss_ancestor(r[1], b, adjacency)
                    )
                )
                if legal:
                    if s in edgeslist[r[1]]:
                        edgeslist[r[1]].remove(s)
                    if (r[1], s) not in new_edges:
                        new_edges.append((r[1], s))
        if not new_edges:
            break
        labeled.append(new_edges)
        depth += 1
        if max_depth is not None and depth >= max_depth:
            break
    nodes = set()
    for layer in labeled:
        for x, y in layer:
            nodes.add(int(x))
            nodes.add(int(y))
    return sorted(nodes)


# --------------------------------------------------------------------------
# CI test & effect estimation on the correlation matrix


def gauss_ci_pvalue(C: np.ndarray, x: int, y: int, S, n: int) -> float:
    """pcalg gaussCItest p-value from a correlation matrix."""
    S = list(S)
    ixs = [x, y] + S
    sub = C[np.ix_(ixs, ixs)]
    try:
        prec = np.linalg.inv(sub)
    except np.linalg.LinAlgError:
        prec = np.linalg.pinv(sub)
    r = -prec[0, 1] / np.sqrt(np.abs(prec[0, 0] * prec[1, 1]))
    r = min(max(r, -0.9999999), 0.9999999)
    z = np.sqrt(max(n - len(S) - 3, 1)) * abs(np.arctanh(r))
    return float(2 * norm.sf(z))


def lm_cov(C: np.ndarray, y: int, xs: list[int]) -> float:
    """First regression coefficient of y on xs from the correlation matrix
    (`lm.cov`, `DAVS_functions_final.R:506-509`)."""
    beta = np.linalg.solve(C[np.ix_(xs, xs)], C[np.ix_(xs, [y])])
    return float(beta[0, 0])


def _create_ck(fk: list[tuple], k: int) -> list[tuple]:
    """Apriori candidate join (`create_Ck`): merge pairs differing only in
    the last element; keep unions whose every k-subset is in fk."""
    fk_set = set(fk)
    out = []
    for i in range(len(fk) - 1):
        for j in range(i + 1, len(fk)):
            l1, l2 = fk[i], fk[j]
            if l1[:-1] == l2[:-1] and l1[-1] != l2[-1]:
                item = tuple(sorted(set(l1) | set(l2)))
                if all(tuple(c) in fk_set for c in combinations(item, k)):
                    if item not in out:
                        out.append(item)
    return out


def davs_ace(
    C: np.ndarray,
    w: int,
    y: int,
    q: int,
    pag: np.ndarray,
    n: int,
    alpha: float = 0.05,
    max_k: int | None = 3,
    max_depth: int | None = 2,
    force_directed: bool = False,
) -> float:
    """ACE of w on y using COSO variable q
    (`Davs.con.causaleffect_cor_new`, `DAVS_functions_final.R:9-245`).

    Returns 0.0 when no valid adjustment set is found or y is not a
    possible descendant of w.
    """
    pag = np.asarray(pag).copy()
    if force_directed and pag[w, y] == 2 and pag[y, w] == 2:
        pag[y, w] = 3

    if y not in possible_de(pag, w):
        return 0.0

    pdsep = sorted(set(pdsep_reach(w, y, pag, max_depth=max_depth)) | {y})
    pdsep = [v for v in pdsep if v not in (w, y)]
    pdes = possible_de(pag, w)
    pdsepset = [v for v in pdsep if v not in set([q] + pdes)]

    # Rule 2 pre-checks on (W, Y), (Q, W), (Q, Y)
    p_wy = gauss_ci_pvalue(C, w, y, [], n)
    p_qw = gauss_ci_pvalue(C, q, w, [], n)
    p_qy = gauss_ci_pvalue(C, q, y, [], n)
    if p_wy > alpha or (p_qw < alpha and p_qy > alpha):
        return 0.0

    valid_z: list[tuple] = []
    aces: list[float] = []

    def try_set(z_nodes: tuple) -> bool:
        """Returns True if (q indep y | {w} u Z) held (candidate consumed)."""
        zl = list(z_nodes)
        p1 = gauss_ci_pvalue(C, q, y, zl, n)
        if p1 >= alpha:
            return False
        p2 = gauss_ci_pvalue(C, q, y, [w] + zl, n)
        if p2 <= alpha:
            return None  # dependent given W u Z: keep as frontier
        if z_nodes not in valid_z:
            valid_z.append(z_nodes)
            aces.append(lm_cov(C, y, [w] + zl))
        return True

    # level 1: the frontier keeps every candidate that was not consumed as a
    # valid adjustment set (`Fk <- setdiff(L, L.tmp)`)
    frontier: list[tuple] = []
    for v in pdsepset:
        res = try_set((v,))
        if res is not True:
            frontier.append((v,))
    # higher levels via apriori join
    k = 1
    while frontier and len(frontier) >= 2:
        k += 1
        if max_k is not None and k > max_k:
            break
        ck = _create_ck(sorted(frontier), k - 1)
        if not ck:
            break
        new_frontier = []
        for cand in ck:
            res = try_set(cand)
            if res is None:
                new_frontier.append(cand)
        if not new_frontier:
            break
        frontier = new_frontier

    if not aces:
        return 0.0
    return float(np.mean(aces))


def estimate_ace(
    skeleton_results_filestem: str,
    pag_path: str,
    exposure: int,
    outcome: int,
    num_individuals: int,
    alpha: float,
    max_k: int = 3,
    max_depth: int = 2,
) -> float:
    """Driver equivalent of `CIGWAS_est_ACE.R`: average davs_ace over all
    COSO candidates Q in (pa(W) u sp(W)) \\ (pa(Y) u sp(Y)).

    exposure/outcome are 0-based variable indices into the sepselect result.
    Returns NaN when no candidate produced a nonzero estimate.
    """
    from scipy.io import mmread

    C = mmread(f"{skeleton_results_filestem}_scm.mtx").toarray()
    np.fill_diagonal(C, 1.0)
    pag = mmread(pag_path).toarray().astype(np.int32)

    ww = set(search_am(pag, exposure, "pa")) | set(search_am(pag, exposure, "sp"))
    yy = set(search_am(pag, outcome, "pa")) | set(search_am(pag, outcome, "sp"))
    estimates = []
    for q in sorted(ww - yy):
        est = davs_ace(
            C,
            exposure,
            outcome,
            q,
            pag,
            num_individuals,
            alpha=alpha,
            max_k=max_k,
            max_depth=max_depth,
        )
        if est != 0.0:
            estimates.append(est)
    if not estimates:
        return float("nan")
    return float(np.mean(estimates))
