"""sRFCI PAG orientation: order-independent FCI rules R1-R10.

Python port of the semantics of `srfci/RFCI_functions_final.R` (rules
`rule1_order_indp` .. `rule10_order_indp`, path helpers `minUncovPdPath`,
`minUncovCircPath`, `minDiscrPath`, `faith.check`) and the production driver
`srfci/CIGWAS_est_PAG.R` (cusk2 mode).

Edge mark codes (pcalg convention, `sepselect.py:33-37`):
    0 = no edge, 1 = circle, 2 = arrowhead, 3 = tail
``apag[i, j]`` is the mark at j on the edge i - j; a directed edge i -> j is
``apag[i, j] = 2, apag[j, i] = 3``.

All indices here are 0-based; pair enumeration follows R's column-major
`which(..., arr.ind=TRUE)` order so that conflict resolution matches.

Parity note: the production R driver builds its ambiguous-triple vector with
`c(unfTrip, ...)` whose result is discarded (`CIGWAS_est_PAG.R:66-72`), so
rules always run with an EMPTY unfVect there. :func:`estimate_pag` reproduces
that by default; pass ``use_ambiguous_triples=True`` for the intended
behaviour.
"""

from __future__ import annotations

from itertools import combinations

import numpy as np


def triple2numb(p: int, i: int, j: int, k: int) -> int:
    """pcalg's triple encoding (1-based node numbers)."""
    return p * (p * i + j) + k


def _colmajor_pairs(cond: np.ndarray):
    """(row, col) pairs of True entries in R's column-major order."""
    cols, rows = np.nonzero(cond.T)
    return list(zip(rows.tolist(), cols.tolist()))


def _is_unf(unf: set, p: int, a: int, b: int, c: int) -> bool:
    """Membership of the (1-based encoded) triple a-b-c or its reverse."""
    if not unf:
        return False
    return (
        triple2numb(p, a + 1, b + 1, c + 1) in unf
        or triple2numb(p, c + 1, b + 1, a + 1) in unf
    )


def faith_check(cp: list[int], unf: set, p: int) -> bool:
    """True iff every consecutive triple on the circular path is unambiguous
    (`faith.check`, `RFCI_functions_final.R:1314-1341`; its l=0 iteration is
    an R indexing no-op, so triples start at the path's first element)."""
    if not unf:
        return True
    n = len(cp)
    for l in range(1, n):
        a = cp[l - 1]
        b = cp[l % n]
        c = cp[(l + 1) % n]
        if _is_unf(unf, p, a, b, c):
            return False
    return True


def min_uncov_pd_path(p, pag, a, b, c, unf) -> list[int] | None:
    """Minimal uncovered potentially-directed path from a through b to c
    (`minUncovPdPath`, `RFCI_functions_final.R:1120-1214`)."""
    assert pag[a, b] in (1, 2) and pag[b, a] in (1, 3)
    if pag[b, c] in (1, 2) and pag[c, b] in (1, 3) and pag[c, a] == 0:
        mpath = [a, b, c]
        if faith_check(mpath, unf, p):
            return mpath
    visited = np.zeros(p, dtype=bool)
    visited[[a, b, c]] = True
    ok_fwd = (pag[b, :] == 1) | (pag[b, :] == 2)
    ok_bwd = (pag[:, b] == 1) | (pag[:, b] == 3)
    ind_d = np.where(ok_fwd & ok_bwd & (pag[:, a] == 0) & ~visited)[0]
    path_list = [[b, int(d)] for d in ind_d]
    while path_list:
        mpath = path_list.pop(0)
        d = mpath[-1]
        visited[d] = True
        if pag[d, c] in (1, 2) and pag[c, d] in (1, 3):
            full = [a] + mpath + [c]
            n = len(full)
            uncov = all(
                pag[full[l], full[l + 2]] == 0 and pag[full[l + 2], full[l]] == 0
                for l in range(n - 2)
            )
            if uncov and faith_check(full, unf, p):
                return full
        else:
            ok_f = (pag[d, :] == 1) | (pag[d, :] == 2)
            ok_b = (pag[:, d] == 1) | (pag[:, d] == 3)
            for r in np.where(ok_f & ok_b & ~visited)[0]:
                path_list.append(mpath + [int(r)])
    return None


def min_uncov_circ_path(p, pag, path, unf) -> list[int] | None:
    """Minimal uncovered circle path for (a, c, d, b)
    (`minUncovCircPath`, `RFCI_functions_final.R:990-1056`)."""
    a, c, d, b = path
    visited = np.zeros(p, dtype=bool)
    visited[list(path)] = True
    ind_x = np.where((pag[c, :] == 1) & (pag[:, c] == 1) & ~visited)[0]
    path_list = [[c, int(x)] for x in ind_x]
    while path_list:
        mpath = path_list.pop(0)
        x = mpath[-1]
        visited[x] = True
        if pag[x, d] == 1 and pag[d, x] == 1:
            full = [a] + mpath + [d, b]
            n = len(full)
            uncov = all(
                pag[full[l], full[l + 2]] == 0 and pag[full[l + 2], full[l]] == 0
                for l in range(n - 2)
            )
            if uncov and faith_check(full, unf, p):
                return full
        else:
            for r in np.where((pag[x, :] == 1) & (pag[:, x] == 1) & ~visited)[0]:
                path_list.append(mpath + [int(r)])
    return None


def min_discr_path(pag, a, b, c) -> list[int] | None:
    """Minimal discriminating path for (a, b, c)
    (`minDiscrPath`, `RFCI_functions_final.R:1058-1105`)."""
    p = pag.shape[0]
    visited = np.zeros(p, dtype=bool)
    visited[[a, b, c]] = True
    ind_d = np.where((pag[a, :] != 0) & (pag[:, a] == 2) & ~visited)[0]
    path_list = [[a, int(d)] for d in ind_d]
    while path_list:
        mpath = path_list.pop(0)
        d = mpath[-1]
        if pag[c, d] == 0 and pag[d, c] == 0:
            return list(reversed(mpath)) + [b, c]
        pred = mpath[-2]
        if pag[d, c] == 2 and pag[c, d] == 3 and pag[pred, d] == 2:
            visited[d] = True
            for r in np.where((pag[d, :] != 0) & (pag[:, d] == 2) & ~visited)[0]:
                # the reference drops the first path element when extending
                # (`mpath[-1]` in R slices off element 1)
                path_list.append(mpath[1:] + [int(r)])
    return None


# --------------------------------------------------------------------------
# rules


def rule1(apag, unf):
    p = apag.shape[0]
    search = apag.copy()
    for b, c in _colmajor_pairs((apag != 0) & (apag.T == 1)):
        ind_a = np.where(
            (search[b, :] != 0)
            & (search[:, b] == 2)
            & (search[c, :] == 0)
            & (search[:, c] == 0)
        )[0]
        for a in ind_a:
            if a == c:
                continue
            if _is_unf(unf, p, a, b, c):
                continue
            if apag[c, b] == 1 and apag[b, c] != 0:
                apag[b, c] = 2
                apag[c, b] = 3
            elif apag[c, b] == 2:
                apag[b, c] = 2
    return apag


def rule2(apag, unf):
    search = apag.copy()
    for a, c in _colmajor_pairs((apag == 1) & (apag.T != 0)):
        cond = (
            (search[a, :] == 2) & (search[:, a] == 3) & (search[c, :] != 0) & (search[:, c] == 2)
        ) | (
            (search[a, :] == 2) & (search[:, a] != 0) & (search[c, :] == 3) & (search[:, c] == 2)
        )
        if cond.any():
            apag[a, c] = 2
    return apag


def rule3(apag, unf):
    p = apag.shape[0]
    search = apag.copy()
    for b, d in _colmajor_pairs((apag != 0) & (apag.T == 1)):
        ind_ac = np.where(
            (search[b, :] != 0)
            & (search[:, b] == 2)
            & (search[:, d] == 1)
            & (search[d, :] != 0)
        )[0]
        if len(ind_ac) >= 2:
            for a, c in combinations(ind_ac.tolist(), 2):
                if apag[a, c] == 0 and apag[c, a] == 0 and c != a:
                    if _is_unf(unf, p, a, d, c):
                        apag[d, b] = 2
    return apag


def rule4(apag, unf, sepset):
    """sepset: dict (i, j) -> set of conditioning variables (0-based)."""
    search = apag.copy()
    for b, c in _colmajor_pairs((apag != 0) & (apag.T == 1)):
        ind_a = np.where(
            (search[b, :] == 2)
            & (search[:, b] != 0)
            & (search[c, :] == 3)
            & (search[:, c] == 2)
        )[0]
        for a in ind_a:
            if apag[a, b] == 2 and apag[b, c] == 2 and apag[c, b] == 2:
                break
            md_path = min_discr_path(apag, a, b, c)
            if md_path is not None and len(md_path) > 1:
                first, last = md_path[0], md_path[-1]
                in_sep = b in sepset.get((first, last), set()) or b in sepset.get(
                    (last, first), set()
                )
                if in_sep:
                    apag[b, c] = 2
                    if apag[c, b] != 2:
                        apag[c, b] = 3
                else:
                    apag[a, b] = apag[b, c] = apag[c, b] = 2
    return apag


def rule5(apag, unf):
    p = apag.shape[0]
    search = apag.copy()
    for a, b in _colmajor_pairs((apag == 1) & (apag.T == 1)):
        ind_c = np.where(
            (search[a, :] == 1) & (search[:, a] == 1) & (search[b, :] == 0) & (search[:, b] == 0)
        )[0]
        ind_c = ind_c[ind_c != b]
        ind_d = np.where(
            (search[b, :] == 1) & (search[:, b] == 1) & (search[a, :] == 0) & (search[:, a] == 0)
        )[0]
        ind_d = ind_d[ind_d != a]
        for c in ind_c:
            for d in ind_d:
                if search[c, d] == 1 and search[d, c] == 1:
                    if faith_check([a, c, d, b], unf, p):
                        apag[a, b] = apag[b, a] = 3
                        apag[a, c] = apag[c, a] = 3
                        apag[c, d] = apag[d, c] = 3
                        apag[d, b] = apag[b, d] = 3
                else:
                    ucp = min_uncov_circ_path(p, search, (a, c, d, b), unf)
                    if ucp is not None and len(ucp) > 1:
                        n = len(ucp)
                        apag[ucp[0], ucp[n - 1]] = apag[ucp[n - 1], ucp[0]] = 3
                        for j in range(n - 1):
                            apag[ucp[j], ucp[j + 1]] = apag[ucp[j + 1], ucp[j]] = 3
    return apag


def rule6(apag, unf):
    search = apag.copy()
    for b, c in _colmajor_pairs((apag != 0) & (apag.T == 1)):
        if ((search[b, :] == 3) & (search[:, b] == 3)).any():
            apag[c, b] = 3
    return apag


def rule7(apag, unf):
    p = apag.shape[0]
    search = apag.copy()
    for b, c in _colmajor_pairs((apag != 0) & (apag.T == 1)):
        ind_a = np.where(
            (search[b, :] == 3)
            & (search[:, b] == 1)
            & (search[c, :] == 0)
            & (search[:, c] == 0)
        )[0]
        ind_a = ind_a[ind_a != c]
        for a in ind_a:
            if apag[c, b] == 3:
                break
            if _is_unf(unf, p, a, b, c):
                continue
            apag[c, b] = 3
    return apag


def rule8(apag, unf):
    search = apag.copy()
    for a, c in _colmajor_pairs((apag == 2) & (apag.T == 1)):
        cond = (
            ((search[a, :] == 2) & (search[:, a] == 3))
            | ((search[a, :] == 1) & (search[:, a] == 3))
        ) & ((search[c, :] == 3) & (search[:, c] == 2))
        if cond.any():
            apag[c, a] = 3
    return apag


def rule9(apag, unf):
    p = apag.shape[0]
    search = apag.copy()
    for a, c in _colmajor_pairs((apag == 2) & (apag.T == 1)):
        ind_b = np.where(
            ((search[a, :] == 2) | (search[a, :] == 1))
            & ((search[:, a] == 1) | (search[:, a] == 3))
            & ((search[c, :] == 0) & (search[:, c] == 0))
        )[0]
        ind_b = ind_b[ind_b != c]
        for b in ind_b:
            if apag[c, a] == 3:
                break
            upd = min_uncov_pd_path(p, search, a, b, c, unf)
            if upd is not None and len(upd) > 1:
                apag[c, a] = 3
    return apag


def rule10(apag, unf):
    p = apag.shape[0]
    search = apag.copy()
    for a, c in _colmajor_pairs((apag == 2) & (apag.T == 1)):
        ind_b = np.where((search[c, :] == 3) & (search[:, c] == 2))[0]
        for b in ind_b:
            if apag[c, a] != 1:
                break
            for d in ind_b:
                if b == d or apag[c, a] != 1:
                    continue
                if (
                    search[a, b] in (1, 2)
                    and search[b, a] in (1, 3)
                    and search[a, d] in (1, 2)
                    and search[d, a] in (1, 3)
                    and search[d, b] == 0
                    and search[b, d] == 0
                ):
                    if _is_unf(unf, p, b, a, d):
                        continue
                    apag[c, a] = 3
                else:
                    ind_x = np.where(
                        ((search[a, :] == 1) | (search[a, :] == 2))
                        & ((search[:, a] == 1) | (search[:, a] == 3))
                    )[0]
                    ind_x = ind_x[ind_x != c]
                    for pos1 in ind_x:
                        if apag[c, a] != 1:
                            break
                        for pos2 in ind_x:
                            if pos1 == pos2 or apag[c, a] != 1:
                                continue
                            t1 = min_uncov_pd_path(p, search, a, pos1, b, unf)
                            t2 = min_uncov_pd_path(p, search, a, pos2, d, unf)
                            if (
                                t1 is not None
                                and len(t1) > 1
                                and t2 is not None
                                and len(t2) > 1
                                and apag[pos1, pos2] == 0
                            ):
                                if not _is_unf(unf, p, pos1, a, pos2):
                                    apag[c, a] = 3
    return apag


def rule_functions(sepset):
    return [
        rule1,
        rule2,
        rule3,
        lambda g, u: rule4(g, u, sepset),
        rule5,
        rule6,
        rule7,
        rule8,
        rule9,
        rule10,
    ]


def udag2apag(
    apag: np.ndarray,
    sepset: dict,
    rules: list[bool] | None = None,
    unf: set | None = None,
    verbose: bool = False,
) -> np.ndarray:
    """Apply R1-R10 to a fixpoint (`udag2apag_ci_gwas`,
    `RFCI_functions_final.R:286-333`)."""
    apag = np.asarray(apag, dtype=np.int32).copy()
    unf = unf or set()
    if rules is None:
        rules = [True] * 10
    fns = rule_functions(sepset)
    old = np.zeros_like(apag)
    while (old != apag).any():
        old = apag.copy()
        for ix, (use, fn) in enumerate(zip(rules, fns)):
            if use:
                if verbose:
                    print(f"Applying rule {ix + 1}")
                apag = fn(apag, unf)
    return apag


# --------------------------------------------------------------------------
# sequential (pcalg-order) rules — the simulation drivers' udag2apag
#
# The reference ships TWO rule engines: `udag2apag_ci_gwas`
# (`RFCI_functions_final.R:286-333`, order-independent per-pass snapshots,
# used by the production cusk2 driver and ported above) and the SEQUENTIAL
# `udag2apag` (`RFCI_functions_final.R:335-833`, used by
# `CIGWAS_est_PAG_simulations.R:153`), where every rule pass reads the LIVE
# matrix: a match list is taken once per pass (R's column-major
# `which(..., arr.ind=TRUE)`), but the per-match search sets and guard
# re-checks see all orientations applied earlier in the same pass. The two
# engines can produce different PAGs (see tests/test_pag.py), so both are
# kept; rule-4's commented-out CI re-testing (`RFCI_functions_final.R:518`)
# means no indepTest is needed here either.


def rule1_seq(apag, unf):
    p = apag.shape[0]
    for a, b in _colmajor_pairs((apag == 2) & (apag.T != 0)):
        ind_c = np.where(
            (apag[b, :] != 0)
            & (apag[:, b] == 1)
            & (apag[a, :] == 0)
            & (apag[:, a] == 0)
        )[0]
        ind_c = ind_c[ind_c != a]
        if len(ind_c) == 0:
            continue
        if not unf:
            apag[b, ind_c] = 2
            apag[ind_c, b] = 3
        else:
            for c in ind_c:
                if not _is_unf(unf, p, a, b, c):
                    apag[b, c] = 2
                    apag[c, b] = 3
    return apag


def rule2_seq(apag, unf):
    for a, c in _colmajor_pairs((apag == 1) & (apag.T != 0)):
        cond = (
            (apag[a, :] == 2) & (apag[:, a] == 3) & (apag[c, :] != 0) & (apag[:, c] == 2)
        ) | (
            (apag[a, :] == 2) & (apag[:, a] != 0) & (apag[c, :] == 3) & (apag[:, c] == 2)
        )
        if cond.any():
            apag[a, c] = 2
    return apag


def rule3_seq(apag, unf):
    p = apag.shape[0]
    for b, d in _colmajor_pairs((apag != 0) & (apag.T == 1)):
        ind_ac = np.where(
            (apag[b, :] != 0)
            & (apag[:, b] == 2)
            & (apag[:, d] == 1)
            & (apag[d, :] != 0)
        )[0]
        if len(ind_ac) < 2:
            continue
        if not unf:
            for ci in range(len(ind_ac) - 1):
                if apag[d, b] == 2:
                    break
                for ii in range(ci + 1, len(ind_ac)):
                    if apag[d, b] == 2:
                        break
                    if (
                        apag[ind_ac[ci], ind_ac[ii]] == 0
                        and apag[ind_ac[ii], ind_ac[ci]] == 0
                    ):
                        apag[d, b] = 2
        else:
            # NB: the sequential rule orients when the triple is NOT
            # ambiguous — the opposite of the reference's order-independent
            # rule3 quirk (`rule3_order_indp`, RFCI_functions_final.R:64-67)
            for a, c in combinations(ind_ac.tolist(), 2):
                if apag[a, c] == 0 and apag[c, a] == 0 and c != a:
                    if not _is_unf(unf, p, a, d, c):
                        apag[d, b] = 2
    return apag


def rule4_seq(apag, unf, sepset):
    for b, c in _colmajor_pairs((apag != 0) & (apag.T == 1)):
        ind_a = list(
            np.where(
                (apag[b, :] == 2)
                & (apag[:, b] != 0)
                & (apag[c, :] == 3)
                & (apag[:, c] == 2)
            )[0]
        )
        while ind_a and apag[c, b] == 1:
            a = int(ind_a.pop(0))
            done = False
            while (
                not done
                and apag[a, b] != 0
                and apag[a, c] != 0
                and apag[b, c] != 0
            ):
                md = min_discr_path(apag, a, b, c)
                if md is None:
                    done = True
                else:
                    first, last = md[0], md[-1]
                    if b in sepset.get((first, last), set()) or b in sepset.get(
                        (last, first), set()
                    ):
                        apag[b, c] = 2
                        apag[c, b] = 3
                    else:
                        apag[a, b] = apag[b, c] = apag[c, b] = 2
                    done = True
    return apag


def rule5_seq(apag, unf):
    p = apag.shape[0]
    for a, b in _colmajor_pairs((apag == 1) & (apag.T == 1)):
        ind_c = np.where(
            (apag[a, :] == 1) & (apag[:, a] == 1) & (apag[b, :] == 0) & (apag[:, b] == 0)
        )[0]
        ind_c = [int(c) for c in ind_c if c != b]
        ind_d = np.where(
            (apag[b, :] == 1) & (apag[:, b] == 1) & (apag[a, :] == 0) & (apag[:, a] == 0)
        )[0]
        ind_d = [int(d) for d in ind_d if d != a]
        if not ind_c or not ind_d:
            continue
        for c in ind_c:
            if apag[a, b] != 1:
                break
            for d in ind_d:
                if apag[a, b] != 1:
                    break
                if apag[c, d] == 1 and apag[d, c] == 1:
                    if faith_check([a, c, d, b], unf, p):
                        apag[a, b] = apag[b, a] = 3
                        apag[a, c] = apag[c, a] = 3
                        apag[c, d] = apag[d, c] = 3
                        apag[d, b] = apag[b, d] = 3
                else:
                    ucp = min_uncov_circ_path(p, apag, (a, c, d, b), unf)
                    if ucp is not None and len(ucp) > 1:
                        apag[ucp[0], ucp[-1]] = apag[ucp[-1], ucp[0]] = 3
                        for j in range(len(ucp) - 1):
                            apag[ucp[j], ucp[j + 1]] = apag[ucp[j + 1], ucp[j]] = 3
    return apag


def rule6_seq(apag, unf):
    for b, c in _colmajor_pairs((apag != 0) & (apag.T == 1)):
        if ((apag[b, :] == 3) & (apag[:, b] == 3)).any():
            apag[c, b] = 3
    return apag


def rule7_seq(apag, unf):
    p = apag.shape[0]
    for b, c in _colmajor_pairs((apag != 0) & (apag.T == 1)):
        ind_a = np.where(
            (apag[b, :] == 3)
            & (apag[:, b] == 1)
            & (apag[c, :] == 0)
            & (apag[:, c] == 0)
        )[0]
        ind_a = ind_a[ind_a != c]
        if len(ind_a) == 0:
            continue
        if not unf:
            apag[c, b] = 3
        else:
            for a in ind_a:
                if not _is_unf(unf, p, a, b, c):
                    apag[c, b] = 3
    return apag


def rule8_seq(apag, unf):
    for a, c in _colmajor_pairs((apag == 2) & (apag.T == 1)):
        cond = (
            ((apag[a, :] == 2) & (apag[:, a] == 3))
            | ((apag[a, :] == 1) & (apag[:, a] == 3))
        ) & ((apag[c, :] == 3) & (apag[:, c] == 2))
        if cond.any():
            apag[c, a] = 3
    return apag


def rule9_seq(apag, unf):
    p = apag.shape[0]
    for a, c in _colmajor_pairs((apag == 2) & (apag.T == 1)):
        ind_b = np.where(
            ((apag[a, :] == 2) | (apag[a, :] == 1))
            & ((apag[:, a] == 1) | (apag[:, a] == 3))
            & (apag[c, :] == 0)
            & (apag[:, c] == 0)
        )[0]
        ind_b = [int(x) for x in ind_b if x != c]
        while ind_b and apag[c, a] == 1:
            b = ind_b.pop(0)
            upd = min_uncov_pd_path(p, apag, a, b, c, unf)
            if upd is not None and len(upd) > 1:
                apag[c, a] = 3
    return apag


def rule10_seq(apag, unf):
    p = apag.shape[0]
    for a, c in _colmajor_pairs((apag == 2) & (apag.T == 1)):
        ind_b = [int(x) for x in np.where((apag[c, :] == 3) & (apag[:, c] == 2))[0]]
        if len(ind_b) < 2:
            continue
        for b in ind_b:
            if apag[c, a] != 1:
                break
            ind_d = [x for x in ind_b if x != b]
            for d in ind_d:
                if apag[c, a] != 1:
                    break
                if (
                    apag[a, b] in (1, 2)
                    and apag[b, a] in (1, 3)
                    and apag[a, d] in (1, 2)
                    and apag[d, a] in (1, 3)
                    and apag[d, b] == 0
                    and apag[b, d] == 0
                ):
                    if not _is_unf(unf, p, b, a, d):
                        apag[c, a] = 3
                else:
                    ind_x = np.where(
                        ((apag[a, :] == 1) | (apag[a, :] == 2))
                        & ((apag[:, a] == 1) | (apag[:, a] == 3))
                    )[0]
                    ind_x = [int(x) for x in ind_x if x != c]
                    # R: `if (length(indX >= 2))` — a length of the BOOLEAN
                    # vector, i.e. any non-empty indX passes
                    for p1 in ind_x:
                        if apag[c, a] != 1:
                            break
                        for p2 in ind_x:
                            if p2 == p1:
                                continue
                            if apag[c, a] != 1:
                                break
                            t1 = min_uncov_pd_path(p, apag, a, p1, b, unf)
                            t2 = min_uncov_pd_path(p, apag, a, p2, d, unf)
                            if (
                                t1 is not None
                                and len(t1) > 1
                                and t2 is not None
                                and len(t2) > 1
                                and apag[p1, p2] == 0
                            ):
                                if not _is_unf(unf, p, p1, a, p2):
                                    apag[c, a] = 3
    return apag


def udag2apag_sequential(
    apag: np.ndarray,
    sepset: dict,
    rules: list[bool] | None = None,
    unf: set | None = None,
    verbose: bool = False,
) -> np.ndarray:
    """Apply R1-R10 to a fixpoint with SEQUENTIAL within-pass semantics
    (`udag2apag`, `RFCI_functions_final.R:335-833`)."""
    apag = np.asarray(apag, dtype=np.int32).copy()
    unf = unf or set()
    if rules is None:
        rules = [True] * 10
    fns = [
        rule1_seq,
        rule2_seq,
        rule3_seq,
        lambda g, u: rule4_seq(g, u, sepset),
        rule5_seq,
        rule6_seq,
        rule7_seq,
        rule8_seq,
        rule9_seq,
        rule10_seq,
    ]
    if not (apag != 0).any():
        return apag
    old = np.zeros_like(apag)
    while (old != apag).any():
        old = apag.copy()
        for ix, (use, fn) in enumerate(zip(rules, fns)):
            if use:
                if verbose:
                    print(f"Applying rule {ix + 1}")
                apag = fn(apag, unf)
    return apag


# --------------------------------------------------------------------------
# production driver (cusk2 mode)


def load_sparse_sepsets(path: str) -> dict:
    """.ssm rows 'i j s1 s2 ...' (1-based) -> {(i-1, j-1): {s-1, ...}}."""
    res: dict = {}
    with open(path) as fin:
        for line in fin:
            vals = [int(v) for v in line.split()]
            if len(vals) > 2:
                res[(vals[0] - 1, vals[1] - 1)] = set(v - 1 for v in vals[2:])
    return res


def estimate_pag(
    input_filestem: str,
    alpha: float,
    num_individuals: int,
    use_ambiguous_triples: bool = False,
    verbose: bool = True,
) -> np.ndarray:
    """cusk2-mode sRFCI (`CIGWAS_est_PAG.R`): apply R1-R10 to the trait
    submatrix of the sepselect PAG, then force marker->trait orientation and
    write `<stem>_estimated_pag.mtx`.

    ``use_ambiguous_triples=False`` reproduces the reference driver, whose
    unfVect construction discards its result (`CIGWAS_est_PAG.R:66-72`).
    """
    from scipy.io import mmread

    from cigwas_tpu_torch.io.binary import write_coo_mtx
    from cigwas_tpu_torch.io.results import load_mdim

    num_var, num_phen, *_rest = load_mdim(input_filestem)
    sepset = load_sparse_sepsets(input_filestem + ".ssm")
    A = mmread(input_filestem + "_spm.mtx").toarray().astype(np.int32)

    unf: set = set()
    if use_ambiguous_triples:
        atr = np.fromfile(input_filestem + ".atr", dtype=np.int32).reshape(-1, 3)
        for x, y, z in atr:
            unf.add(triple2numb(num_phen, int(x) + 1, int(y) + 1, int(z) + 1))

    if verbose:
        print("Applying R1-R10")
    trait_block = udag2apag(A[:num_phen, :num_phen], sepset, unf=unf, verbose=verbose)
    Amat = A.copy()
    Amat[:num_phen, :num_phen] = trait_block

    # force marker -> trait (`CIGWAS_est_PAG.R:82-84`)
    tm = Amat[:num_phen, num_phen:]
    tm[tm != 0] = 3
    Amat[:num_phen, num_phen:] = tm
    mt = Amat[num_phen:, :num_phen]
    mt[mt != 0] = 2
    Amat[num_phen:, :num_phen] = mt

    write_coo_mtx(input_filestem + "_estimated_pag.mtx", Amat, integer=True)
    if verbose:
        print("Done")
    return Amat
