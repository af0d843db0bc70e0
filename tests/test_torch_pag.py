"""The port's PAG stage (`cigwas_tpu_torch.pag`: sRFCI rules R1-R10 in both
semantics, `estimate_pag`, the simulation drivers, sDAVS) against the JAX
package's (`cigwas_tpu.pag`) on the same seeded inputs. Both are the same
host numpy and scipy calls, so every mark, file and estimate must be equal
exactly (NaN where JAX gives NaN)."""

import os
import shutil
from itertools import combinations

import numpy as np
import pytest

from torch_parity import TRAIT_DAG, merged_fileset, set_threads

from cigwas_tpu.pag import davs as jax_davs
from cigwas_tpu.pag import rfci as jax_rfci
from cigwas_tpu.pag import simulations as jax_simulations
from cigwas_tpu_torch.constants import ML
from cigwas_tpu_torch.io.results import ReducedGCS
from cigwas_tpu_torch.merge import orient_v_structures_merged
from cigwas_tpu_torch.pag import davs, rfci, simulations

set_threads()

SEEDS = range(8)
P = 6  # traits of merged_fileset's model


def random_pag(seed: int, p: int = 9, density: float = 0.35):
    """A random skeleton after the v-structure step: circles on every edge,
    arrowheads at the middle of each unshielded triple whose middle node is
    not in the outer pair's sepset (so bidirected edges and discriminating
    paths occur), sepsets from the pair's common neighbours plus an
    occasional other node, and ~30% of the unshielded triples ambiguous."""
    rng = np.random.default_rng(seed)
    adj = np.triu(rng.random((p, p)) < density, 1)
    adj = adj | adj.T
    sepset = {}
    for i, j in combinations(range(p), 2):
        if not adj[i, j]:
            pick = {int(c) for c in np.where(adj[i] & adj[j])[0] if rng.random() < 0.5}
            if rng.random() < 0.3:
                pick |= {int(rng.integers(p))} - {i, j}
            sepset[(i, j) if rng.random() < 0.7 else (j, i)] = pick
    pag = adj.astype(np.int32)
    unf = set()
    for b in range(p):
        for a, c in combinations(np.where(adj[b])[0].tolist(), 2):
            if adj[a, c]:
                continue
            if b not in sepset.get((a, c), set()) | sepset.get((c, a), set()):
                pag[a, b] = pag[c, b] = 2
            if rng.random() < 0.3:
                unf.add(rfci.triple2numb(p, a + 1, b + 1, c + 1))
    return pag, sepset, unf


def marked_dag(seed: int, p: int = 10, density: float = 0.35):
    """Marks as the rules leave them midway: a random DAG whose edges carry
    an arrowhead at the child (55%) and a tail at the parent (50%), circles
    otherwise, around a chordless 5-cycle; sepsets from common neighbours,
    ~30% of the unshielded triples ambiguous."""
    rng = np.random.default_rng([seed, 1])
    A = np.triu(rng.random((p, p)) < density, 1)
    ring = rng.permutation(p)[:5]
    for a, b in combinations(ring, 2):
        A[min(a, b), max(a, b)] = False
    for k in range(5):
        a, b = ring[k], ring[(k + 1) % 5]
        A[min(a, b), max(a, b)] = True
    perm = rng.permutation(p)
    A = A[np.ix_(perm, perm)]
    pag = np.zeros((p, p), np.int32)
    for i, j in zip(*np.nonzero(A)):
        pag[i, j] = 2 if rng.random() < 0.55 else 1
        pag[j, i] = 3 if rng.random() < 0.5 else 1
    adj = pag != 0
    sepset = {(i, j): {int(c) for c in np.where(adj[i] & adj[j])[0] if rng.random() < 0.5}
              for i, j in combinations(range(p), 2) if not adj[i, j]}
    unf = {rfci.triple2numb(p, a + 1, b + 1, c + 1)
           for b in range(p) for a, c in combinations(np.where(adj[b])[0].tolist(), 2)
           if not adj[a, c] and rng.random() < 0.3}
    return pag, sepset, unf


def _edge(g, i, j, at_j, at_i):
    g[i, j], g[j, i] = at_j, at_i


def rare_rule_cases():
    """Small PAGs on which the rules that random inputs seldom reach fire:
    R3, R5 (a chordless circle cycle), R6, R8 and R10."""
    cases = []
    g = np.zeros((5, 5), np.int32)  # R3: 0 *-> 1 <-* 2, 0 *-o 3 o-* 2, 3 *-o 1
    for e in ((0, 1, 2, 1), (2, 1, 2, 1), (0, 3, 1, 1), (2, 3, 1, 1), (3, 1, 1, 1), (4, 0, 1, 1)):
        _edge(g, *e)
    cases.append((g, {(0, 2): {3}}, {rfci.triple2numb(5, 1, 4, 3)}))
    g = np.zeros((5, 5), np.int32)  # R5: circles 0-1-2-3-4-0
    for k in range(5):
        _edge(g, k, (k + 1) % 5, 1, 1)
    cases.append((g, {}, set()))
    g = np.zeros((4, 4), np.int32)  # R6: 0 --- 1 o-> 2
    for e in ((0, 1, 3, 3), (1, 2, 2, 1), (2, 3, 1, 1)):
        _edge(g, *e)
    cases.append((g, {}, set()))
    g = np.zeros((4, 4), np.int32)  # R8: 0 -> 1 -> 2, 0 o-> 2
    for e in ((0, 1, 2, 3), (1, 2, 2, 3), (0, 2, 2, 1), (3, 0, 1, 1)):
        _edge(g, *e)
    cases.append((g, {}, set()))
    g = np.zeros((5, 5), np.int32)  # R10: 0 o-> 1, 2 -> 1 <- 3, 0 o-o 2, 0 o-o 3
    for e in ((0, 1, 2, 1), (2, 1, 2, 3), (3, 1, 2, 3), (0, 2, 1, 1), (0, 3, 1, 1), (4, 2, 1, 1)):
        _edge(g, *e)
    cases.append((g, {}, set()))
    return cases


def all_inputs():
    return ([random_pag(s) for s in SEEDS] + [marked_dag(s) for s in SEEDS]
            + rare_rule_cases())


@pytest.mark.parametrize("ambiguous", [False, True], ids=["no_unf", "unf"])
@pytest.mark.parametrize("engine", ["udag2apag", "udag2apag_sequential"])
@pytest.mark.parametrize("seed", SEEDS)
def test_fixpoint_equals_jax(seed, engine, ambiguous):
    """R1-R10 to the fixpoint, mark for mark, in both semantics, on both
    random inputs of the seed."""
    for pag, sepset, unf in (random_pag(seed), marked_dag(seed)):
        u = unf if ambiguous else None
        got = getattr(rfci, engine)(pag.copy(), sepset, unf=u)
        exp = getattr(jax_rfci, engine)(pag.copy(), sepset, unf=u)
        assert got.dtype == exp.dtype and np.array_equal(got, exp)
        assert np.array_equal(got != 0, pag != 0)  # marks change, the skeleton stays


def _rules(module, sequential: bool, sepset: dict) -> list:
    if not sequential:
        return module.rule_functions(sepset)
    return [(lambda g, u: module.rule4_seq(g, u, sepset)) if r == 4
            else getattr(module, f"rule{r}_seq") for r in range(1, 11)]


@pytest.mark.parametrize("sequential", [False, True], ids=["order_indp", "seq"])
@pytest.mark.parametrize("rule", range(1, 11))
def test_each_rule_equals_jax(rule, sequential):
    """Each rule alone against JAX's on every matrix it meets on the way to
    the fixpoint (the port's passes over all inputs, with and without
    ambiguous triples); it must change a mark on at least one of them."""
    fired = 0
    for pag, sepset, unf in all_inputs():
        port, ref = _rules(rfci, sequential, sepset), _rules(jax_rfci, sequential, sepset)
        for u in (set(), unf):
            apag, old = pag.copy(), np.zeros_like(pag)
            while (old != apag).any():
                old = apag.copy()
                for r in range(10):
                    before = apag.copy()
                    apag = port[r](apag, u)
                    if r == rule - 1:
                        assert np.array_equal(apag, ref[r](before.copy(), u))
                        fired += bool((apag != before).any())
    assert fired > 0, f"rule {rule} never fired"


def sepselect_fileset(tmp_path, seed: int, dropped: float = 0.0) -> str:
    """A merged skeleton of the planted trait DAG through the port's orient-v-structs:
    the `max_sep_min_pc` fileset that srfci reads."""
    os.makedirs(tmp_path, exist_ok=True)
    merged = str(tmp_path / "merged_blocks")
    merged_fileset(merged, seed, dropped=dropped)
    out = str(tmp_path / "max_sep_min_pc")
    orient_v_structures_merged(merged, 1e-3, 5000).to_file(out)
    return out


@pytest.mark.parametrize("ambiguous", [False, True], ids=["reference", "unf"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_estimate_pag_file_equals_jax(tmp_path, seed, ambiguous):
    """`_estimated_pag.mtx` byte-identical, forced marker -> trait marks and
    the discarded unfVect (`use_ambiguous_triples=False`) included."""
    stem = sepselect_fileset(tmp_path / "port", seed, dropped=0.2 * seed)
    os.makedirs(tmp_path / "jax")
    for f in os.listdir(tmp_path / "port"):
        shutil.copy(tmp_path / "port" / f, tmp_path / "jax" / f)
    jax_stem = str(tmp_path / "jax" / "max_sep_min_pc")
    got = rfci.estimate_pag(stem, 1e-3, 5000, use_ambiguous_triples=ambiguous, verbose=False)
    exp = jax_rfci.estimate_pag(jax_stem, 1e-3, 5000, use_ambiguous_triples=ambiguous,
                                verbose=False)
    assert np.array_equal(got, exp)
    a, b = (open(s + "_estimated_pag.mtx", "rb").read() for s in (stem, jax_stem))
    assert a == b and len(a) > 0
    assert (got[:P, P:] != 0).any() and set(np.unique(got[:P, P:])) <= {0, 3}
    assert set(np.unique(got[P:, :P])) <= {0, 2}
    assert rfci.load_sparse_sepsets(stem + ".ssm") == jax_rfci.load_sparse_sepsets(stem + ".ssm")


def block_fileset(stem: str, seed: int) -> None:
    """A per-block output (markers first, then traits) of that model
    for the simulation drivers: the true adjacency plus one spurious
    marker-trait edge, sepsets of the pairs' common neighbours, a `.atr` of
    a few unshielded triples."""
    from scipy.io import mmread

    merged_fileset(stem + "_merged", seed, latent=None)
    adj = mmread(stem + "_merged_sam.mtx").toarray().astype(np.int32)
    C = mmread(stem + "_merged_scm.mtx").toarray() + np.eye(len(adj))
    perm = np.r_[P:len(adj), :P]  # markers first
    adj, C = adj[np.ix_(perm, perm)], C[np.ix_(perm, perm)]
    m = len(adj) - P
    adj[0, m + 3] = adj[m + 3, 0] = 1  # spurious: marker 0 (of T0) - T3
    n = len(adj)
    S = np.full((n, n, ML), -1, np.int32)
    for i, j in combinations(range(n), 2):
        if not adj[i, j]:
            common = np.where(adj[i] & adj[j])[0][:ML]
            S[i, j, : len(common)] = common
    ReducedGCS(num_var=n, num_phen=P, max_level=ML,
               new_to_old_indices=np.arange(n, dtype=np.int32), G=adj,
               C=C.astype(np.float32), S=S).to_file(stem)
    triples = simulations.find_unsh_triples(adj)
    np.array(triples[::3], dtype=np.int32).reshape(-1, 3).tofile(stem + ".atr")


@pytest.mark.parametrize("mode", ["mpu", "mpd", "std", "cusk2"])
def test_estimate_pag_simulations_equals_jax(tmp_path, mode):
    """Every mode of the simulation driver: the PAG and both files it
    writes (after the v-structure step, and at the end)."""
    stem = str(tmp_path / "block")
    block_fileset(stem, seed=4)
    got = simulations.estimate_pag_simulations(stem, 5000, 1e-3, mode=mode)
    files = {s: open(f"{stem}_estimated_pag_{mode}{s}.mtx", "rb").read()
             for s in ("", "_after_vStruc")}
    exp = jax_simulations.estimate_pag_simulations(stem, 5000, 1e-3, mode=mode)
    assert np.array_equal(got, exp)
    for s, data in files.items():
        assert open(f"{stem}_estimated_pag_{mode}{s}.mtx", "rb").read() == data, s
    gcs = ReducedGCS.from_file(stem)
    triples = simulations.find_unsh_triples(gcs.G)
    assert triples == jax_simulations.find_unsh_triples(gcs.G) and triples
    assert simulations.sepset_dict_from_array(gcs.S) == jax_simulations.sepset_dict_from_array(
        gcs.S)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_estimate_ace_equals_jax(tmp_path, seed):
    """sDAVS for every ordered trait pair on the estimated PAG: equal
    estimates, NaN where JAX gives NaN; every planted trait edge gets a
    positive estimate."""
    stem = sepselect_fileset(tmp_path, seed)
    rfci.estimate_pag(stem, 1e-3, 5000, verbose=False)
    pag_path = stem + "_estimated_pag.mtx"
    got = np.array([[davs.estimate_ace(stem, pag_path, w, y, 5000, 1e-3) if w != y else 0.0
                     for y in range(P)] for w in range(P)])
    exp = np.array([[jax_davs.estimate_ace(stem, pag_path, w, y, 5000, 1e-3) if w != y else 0.0
                     for y in range(P)] for w in range(P)])
    assert np.array_equal(np.isnan(got), np.isnan(exp))
    assert np.array_equal(got[~np.isnan(got)], exp[~np.isnan(exp)])
    assert all(got[w, y] > 0 for y, parents in TRAIT_DAG.items() for w, _ in parents)


def test_davs_helpers_equal_jax():
    """The sDAVS building blocks on the random PAGs: parents and spouses,
    possible descendants, possible-d-sep sets, the Gaussian CI p-value and
    the regression coefficient on a correlation matrix."""
    rng = np.random.default_rng(7)
    X = rng.normal(size=(9, 400))
    X[3] += X[1]
    X[5] += 0.5 * X[3] + 0.5 * X[4]
    C = np.corrcoef(X)
    for seed in SEEDS:
        pag, sepset, _ = random_pag(seed)
        pag = rfci.udag2apag(pag, sepset)
        for x in range(9):
            for kind in ("pa", "sp"):
                assert davs.search_am(pag, x, kind) == jax_davs.search_am(pag, x, kind)
            assert davs.possible_de(pag, x) == jax_davs.possible_de(pag, x)
            y = (x + 3) % 9
            assert davs.pdsep_reach(x, y, pag, 2) == jax_davs.pdsep_reach(x, y, pag, 2)
            S = [(x + 1) % 9, (x + 5) % 9]
            assert davs.gauss_ci_pvalue(C, x, y, S, 400) == jax_davs.gauss_ci_pvalue(
                C, x, y, S, 400)
            assert davs.lm_cov(C, y, [x] + S) == jax_davs.lm_cov(C, y, [x] + S)
            q = (x + 7) % 9
            assert davs.davs_ace(C, x, y, q, pag, 400) == jax_davs.davs_ace(C, x, y, q, pag, 400)
