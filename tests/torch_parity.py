"""Shared helpers of the port's parity tests (tests/test_torch_*.py).

Each test makes its inputs with numpy from a seed, runs the JAX function
(on the CPU, as the JAX package's own tests run it) and its PyTorch
counterpart on the same arrays, and compares them with a stated tolerance.
"""

from __future__ import annotations

import numpy as np
import torch

# the parity contract's continuous tolerance, the one the JAX package allows
# between its own routes (tests/test_pallas_gather.py): XLA:CPU contracts
# a*b - c*d into FMA and its rsqrt differs from 1/sqrt by up to 2 ulp, a
# one-ulp operand change that cancellation amplifies on near-zero rho
RTOL, ATOL = 1e-5, 1e-6


def set_threads() -> None:
    """Two intra-op threads: tier-1 runs the test files in 6 workers."""
    torch.set_num_threads(2)


def nan_equal(a: np.ndarray, b: np.ndarray) -> bool:
    return np.array_equal(np.isnan(a), np.isnan(b))


def assert_close_nan(a, b, atol: float) -> None:
    """Same NaN positions, finite entries within atol."""
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    assert nan_equal(a, b), "NaN positions differ"
    ok = ~np.isnan(a)
    np.testing.assert_allclose(a[ok], b[ok], rtol=0, atol=atol)


def scattered_case(seed: int, vp: int, nt: int, d: int, nan_frac: float):
    """Random symmetric panel with NaNs and scattered neighbour lists with
    ragged degrees, pad slots holding 0 (the compaction's convention)."""
    rng = np.random.default_rng(seed)
    C = (0.4 * rng.normal(size=(vp, vp))).astype(np.float32)
    C = ((C + C.T) / 2).astype(np.float32)
    C[rng.random((vp, vp)) < nan_frac] = np.nan
    np.fill_diagonal(C, 1.0)
    nbrs = np.sort(rng.choice(vp, size=(nt, d), replace=True), axis=1).astype(np.int32)
    node_ixs = rng.integers(0, vp, nt).astype(np.int32)
    deg = rng.integers(max(4, d // 2), d + 1, nt).astype(np.int32)
    nbrs = np.where(np.arange(d)[None, :] < deg[:, None], nbrs, 0).astype(np.int32)
    return C, node_ixs, nbrs, deg


def ar1_panel(seed: int, v: int, n: int, vp: int, ar: float = 0.92) -> np.ndarray:
    """The AR(1)-correlated panel of tests/test_pallas_gather.py, zero-padded
    to vp with a unit diagonal."""
    rng = np.random.default_rng(seed)
    L = rng.normal(size=(v, n))
    for i in range(1, v):
        L[i] = ar * L[i - 1] + np.sqrt(1 - ar**2) * L[i]
    C = np.corrcoef(L).astype(np.float32)
    Cp = np.zeros((vp, vp), np.float32)
    Cp[:v, :v] = C
    np.fill_diagonal(Cp, 1.0)
    return Cp


def jax_local_sweep(C, node_ixs, nbrs, deg, l: int, ct: int = 8):
    """The JAX package's XLA local sweeps: (rho (nt, d), pos (nt, d, l))."""
    import jax.numpy as jnp

    from cigwas_tpu.ops import pcorr as jp

    args = [jnp.asarray(a) for a in (C, node_ixs, nbrs, deg)]
    if l == 1:
        rho, pos = jp.level1_local_sweep(*args)
        pos = np.asarray(pos)[:, :, None]
    else:
        fn = jp.level2_local_sweep if l == 2 else jp.level3_local_sweep
        rho, pos = fn(*args, ct)
    return np.asarray(rho), np.asarray(pos).reshape(len(deg), nbrs.shape[1], l)


def torch_local_sweep(C, node_ixs, nbrs, deg, l: int):
    """The port's local sweep on CPU tensors (its plain version)."""
    from cigwas_tpu_torch.ops.kernels.local_sweep import local_sweep

    rho, pos = local_sweep(
        torch.from_numpy(C), torch.from_numpy(node_ixs), torch.from_numpy(nbrs),
        torch.from_numpy(deg), l,
    )
    return rho.numpy(), pos.numpy()


# --- summary-statistic (hetcor) inputs ---------------------------------------


def hetcor_panel(rng, v: int, n: int = 4000) -> np.ndarray:
    """Correlation panel of data sampled from a random sparse linear model
    (the generator of tests/test_hetcor_property.py)."""
    X = np.zeros((v, n))
    X[0] = rng.normal(size=n)
    for i in range(1, v):
        ps = rng.choice(i, size=min(i, 2), replace=False)
        X[i] = sum(0.55 * X[p] for p in ps) + rng.normal(size=n)
    return np.corrcoef(X).astype(np.float32)


def hetcor_ess(rng, v: int, n: int, nan_frac: float = 0.15) -> np.ndarray:
    """Fractional symmetric per-pair ESS with a share of NaN holes."""
    E = rng.uniform(0.3 * n, 1.2 * n, size=(v, v))
    E = (E + E.T) / 2
    nan_mask = np.triu(rng.random((v, v)) < nan_frac, 1)
    E[nan_mask | nan_mask.T] = np.nan
    np.fill_diagonal(E, n)
    return E.astype(np.float32)


def hetcor_case(seed: int, v: int, n: int = 4000, nan_frac: float = 0.15,
                t_max: int = 0):
    """(C, N, time_index) from a seed; time indices in [0, t_max]."""
    rng = np.random.default_rng(seed)
    C = hetcor_panel(rng, v, n)
    N = hetcor_ess(rng, v, n, nan_frac)
    t_ix = rng.integers(0, t_max + 1, size=v).astype(np.int32)
    return C, N, t_ix


def hetcor_neighbours(seed: int, v: int, nt: int, d: int):
    """Distinct ascending neighbour lists that leave out the node, ragged
    degrees in [d // 2, d], pad slots 0 (the compaction's convention)."""
    rng = np.random.default_rng(seed)
    node_ixs = rng.choice(v, nt, replace=False).astype(np.int32)
    deg = rng.integers(d // 2, d + 1, nt).astype(np.int32)
    nbrs = np.zeros((nt, d), np.int32)
    for i, x in enumerate(node_ixs):
        pool = np.delete(np.arange(v), x)
        nbrs[i, : deg[i]] = np.sort(rng.choice(pool, deg[i], replace=False))
    return node_ixs, nbrs, deg


def hetcor_inputs_to_torch(C, N, G, time_index, device="cpu"):
    """The numpy arrays the JAX functions take, as the port's state: panels
    and time index as tensors on device, the adjacency as host int32."""
    return (
        torch.from_numpy(np.asarray(C, np.float32)).to(device),
        torch.from_numpy(np.asarray(N, np.float32)).to(device),
        np.asarray(G, np.int32),
        torch.from_numpy(np.asarray(time_index, np.int32)).to(device),
    )


# --- exact ties: panels of repeated variables --------------------------------


def tied_case(seed: int, hetcor: bool = False):
    """A 12-variable panel in which every variable stands twice (variable i
    is base variable i // 2), and three nodes at width d = 10 whose lists
    hold both copies of several base variables: conditioning sets that
    differ only in the copy they hold give bitwise equal statistics. The
    lists leave out the node and its own copy. Returns (C, node_ixs, nbrs,
    deg), or (C, N, t_ix, node_ixs, nbrs, deg) for hetcor."""
    rng = np.random.default_rng(seed)
    ix = np.arange(12) // 2
    C = np.corrcoef(rng.normal(size=(6, 40))).astype(np.float32)[ix][:, ix].copy()
    lists = [(0, list(range(2, 12))), (2, list(range(4, 12))), (5, [0, 1, 6, 7, 8, 9])]
    node_ixs = np.array([x for x, _ in lists], np.int32)
    deg = np.array([len(nb) for _, nb in lists], np.int32)
    nbrs = np.zeros((3, 10), np.int32)
    for i, (_, nb) in enumerate(lists):
        nbrs[i, : len(nb)] = nb
    if not hetcor:
        return C, node_ixs, nbrs, deg
    N = hetcor_ess(rng, 6, 4000, nan_frac=0.2)[ix][:, ix].copy()
    t_ix = rng.integers(0, 2, 6).astype(np.int32)[ix].copy()
    return C, N, t_ix, node_ixs, nbrs, deg


# --- files of the shell entry points -----------------------------------------


def std(v: np.ndarray) -> np.ndarray:
    return (v - v.mean()) / v.std()


def genotypes(rng, m: int, n: int, missing: float = 0.0) -> np.ndarray:
    """(m, n) float32 genotypes in {0, 1, 2} with allele frequencies uniform
    in [0.1, 0.5]; a share `missing` of the entries NaN."""
    maf = rng.uniform(0.1, 0.5, m)
    G = (rng.random((m, n)) < maf[:, None]).astype(np.float32) + (
        rng.random((m, n)) < maf[:, None]
    )
    if missing:
        G[rng.random((m, n)) < missing] = np.nan
    return G


def write_plink(stem: str, G: np.ndarray, Y: np.ndarray, chr_sizes=None) -> None:
    """`.bed/.bim/.fam/.phen` of genotypes G (m, n) and standardized traits
    Y (p, n), read alike by both packages; chr_sizes splits the markers over
    chromosomes "1", "2", ... (default: one chromosome)."""
    from cigwas_tpu_torch.constants import BED_PREFIX_COL_MAJ
    from cigwas_tpu_torch.io.bed import encode_bed_values

    m, n = G.shape
    chr_sizes = [m] if chr_sizes is None else list(chr_sizes)
    assert sum(chr_sizes) == m
    chrom = np.repeat(np.arange(1, len(chr_sizes) + 1), chr_sizes)
    with open(stem + ".bed", "wb") as f:
        f.write(BED_PREFIX_COL_MAJ)
        f.write(encode_bed_values(G).tobytes())
    with open(stem + ".bim", "w") as f:
        f.writelines(f"{chrom[i]}\trs{i}\t0\t{1000 * i}\tA\tG\n" for i in range(m))
    with open(stem + ".fam", "w") as f:
        f.writelines(f"F{i} I{i} 0 0 0 -9\n" for i in range(n))
    with open(stem + ".phen", "w") as f:
        f.write("FID\tIID\t" + "\t".join(f"T{t}" for t in range(len(Y))) + "\n")
        for i in range(n):
            f.write(f"F{i}\tI{i}\t" + "\t".join(f"{v:.6f}" for v in Y[:, i]) + "\n")


def planted_dataset(stem: str, seed: int, n: int, chr_sizes, effects: dict,
                    trait_effects: dict | None = None) -> None:
    """A fileset with planted structure: effects {trait: [(marker, beta)]},
    trait_effects {trait: [(earlier trait, beta)]}, unit noise, traits
    standardized."""
    rng = np.random.default_rng(seed)
    G = genotypes(rng, sum(chr_sizes), n)
    Y = []
    for t in sorted(effects):
        y = sum(b * std(G[k]) for k, b in effects[t]) + rng.normal(size=n)
        for s, b in (trait_effects or {}).get(t, []):
            y = y + b * std(Y[s])
        Y.append(y)
    write_plink(stem, G, np.stack([std(y) for y in Y]), chr_sizes)


def dir_bytes(path) -> dict:
    """{file name: bytes} of a directory's files."""
    import os

    return {f: open(os.path.join(path, f), "rb").read() for f in sorted(os.listdir(path))
            if os.path.isfile(os.path.join(path, f))}


def assert_block_dirs_match(got: dict, exp: dict) -> None:
    """Two block output directories: `.corr` within atol 1e-6 (the panel's
    float32 values, see tests/test_torch_corr.py), every other file
    byte-identical."""
    assert got.keys() == exp.keys() and exp
    for f, data in exp.items():
        if f.endswith(".corr"):
            np.testing.assert_allclose(np.frombuffer(got[f], np.float32),
                                       np.frombuffer(data, np.float32), rtol=0, atol=1e-6)
        else:
            assert got[f] == data, f"{f} differs"


# --- merged skeletons for the host chain (srfci, mvivw) ----------------------

# the planted trait DAG of the chain's tests: a collider T0 -> T2 <- T1, then
# T2 -> T3 and T4 -> T5 (child: [(parent, beta)])
TRAIT_DAG = {2: [(0, 0.3), (1, 0.3)], 3: [(2, 0.3)], 5: [(4, 0.3)]}


def merged_fileset(stem: str, seed: int, n: int = 5000, p: int = 6, per_trait: int = 3,
                   trait_dag: dict | None = None, latent: tuple | None = (3, 5),
                   dropped: float = 0.0) -> None:
    """A merged skeleton as `merge-block-outputs` writes it (`stem_sam.mtx`,
    `stem_scm.mtx`, `.mdim`, `.ixs`; traits first, then markers) over data
    from a linear model: `per_trait` planted markers per trait at 0.3, the
    trait DAG (default TRAIT_DAG) at its betas on the standardized parents,
    a hidden common cause of the two `latent` traits at 0.5. The adjacency is
    the true one (marker-trait, trait-trait, the latent pair), with a share
    `dropped` of the marker-trait edges left out; the correlations are the
    sample's."""
    from cigwas_tpu_torch.io.binary import write_coo_mtx

    rng = np.random.default_rng(seed)
    trait_dag = TRAIT_DAG if trait_dag is None else trait_dag
    m = p * per_trait
    G = genotypes(rng, m, n)
    hidden = rng.normal(size=n)
    Y = []
    for t in range(p):
        y = sum(0.3 * std(G[t * per_trait + k]) for k in range(per_trait)) + rng.normal(size=n)
        for s, b in trait_dag.get(t, []):
            y = y + b * std(Y[s])
        if latent is not None and t in latent:
            y = y + 0.5 * hidden
        Y.append(y)
    C = np.corrcoef(np.vstack([np.stack([std(y) for y in Y]), G]))
    adj = np.zeros((p + m, p + m), np.int32)
    for t in range(p):
        for k in range(per_trait):
            if rng.random() >= dropped:
                adj[t, p + t * per_trait + k] = adj[p + t * per_trait + k, t] = 1
        for s, _ in trait_dag.get(t, []):
            adj[t, s] = adj[s, t] = 1
    if latent is not None:
        a, b = latent
        adj[a, b] = adj[b, a] = 1
    write_coo_mtx(stem + "_sam.mtx", adj, integer=True)
    write_coo_mtx(stem + "_scm.mtx", C - np.eye(p + m))
    with open(stem + ".mdim", "w") as f:
        f.write(f"{p + m}\t{p}\t14\n")
    np.arange(m, dtype=np.int32).tofile(stem + ".ixs")
