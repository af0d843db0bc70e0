"""Ground-truth simulation for validation (`cigwas_tpu.sim`): host numpy,
the same draws of the same seeded generator in the same order, so the DAG,
the data and every file are the JAX package's exactly.

Port of `simulation/simulate_dag.R` (`gen_rand_dag`): a random DAG over
SNP + latent + trait variables in topological order, uniform effect sizes
with random signs, and a linear SEM whose noise variance tops each variable
up to unit variance. Writes the same artifacts (true adjacency, correlation
panel, true causal effects) used by the reference's accuracy evaluation.

Also provides a genotype-level simulator (`simulate_genotype_dataset`) that
emits a PLINK fileset + standardized .phen with planted SNP->trait effects —
the structural analog of `simulate_dag_ukb.R` without requiring UK Biobank
genotypes.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from cigwas_tpu_torch.constants import BED_PREFIX_COL_MAJ
from cigwas_tpu_torch.io.bed import encode_bed_values
from cigwas_tpu_torch.io.binary import write_coo_mtx


@dataclass
class SimulatedDag:
    G: np.ndarray  # binary adjacency (topological, upper triangular)
    A: np.ndarray  # weighted effects
    x: np.ndarray  # (n, pq) data matrix
    num_snp: int
    num_latent: int
    num_trait: int

    @property
    def pq(self) -> int:
        return self.G.shape[0]

    def observed(self) -> np.ndarray:
        """Data without the latent columns (`simulate_dag.R:118`)."""
        keep = np.r_[
            np.arange(self.num_snp),
            np.arange(self.num_snp + self.num_latent, self.pq),
        ]
        return self.x[:, keep]

    def true_effects(self) -> np.ndarray:
        """M M^T with M = (I - A^T)^-1 (`simulate_dag.R:128-130`)."""
        M = np.linalg.inv(np.eye(self.pq) - self.A.T)
        return M @ M.T

    def true_trait_effects(self) -> np.ndarray:
        """Upper triangle of the trait block of the true effects."""
        t0 = self.num_snp + self.num_latent
        te = self.true_effects()[t0:, t0:].copy()
        te[np.tril_indices_from(te)] = 0.0
        return te


def gen_rand_dag(
    n: int,
    num_snp: int,
    num_trait: int,
    num_latent: int,
    deg: float,
    prob_pleio: float,
    lo_mp: float,
    hi_mp: float,
    lo_pp: float,
    hi_pp: float,
    seed: int = 0,
) -> SimulatedDag:
    """Random DAG + linear SEM data (`gen_rand_dag`, `simulate_dag.R:3-98`).

    Variable order: SNPs, latents, traits (topological: edges only go from
    lower to higher index). SNP->trait effects are U(lo_mp, hi_mp) with
    random sign; all other effects U(lo_pp, hi_pp) with random sign. Each
    SNP with exactly one trait child gains extra pleiotropic trait children
    with probability prob_pleio.
    """
    rng = np.random.default_rng(seed)
    pq = num_snp + num_latent + num_trait
    t0 = num_snp + num_latent
    prob1 = deg / num_snp
    prob2 = min(deg / num_trait, 1.0)

    G = np.zeros((pq, pq), dtype=np.int8)
    for i in range(num_snp):
        G[i, i + 1 :] = rng.binomial(1, prob1, pq - i - 1)
    # pleiotropy: SNPs with a single trait child gain more trait children
    for i in range(num_snp):
        trait_children = np.where(G[i, t0:] == 1)[0]
        if len(trait_children) == 1:
            extra = rng.binomial(1, prob_pleio, num_trait)
            extra[trait_children[0]] = G[i, t0 + trait_children[0]]
            G[i, t0:] = np.maximum(G[i, t0:], extra)
    for j in range(num_snp, pq):
        G[j, j + 1 :] = rng.binomial(1, prob2, pq - j - 1)

    A = np.zeros((pq, pq), dtype=np.float64)
    for i in range(num_snp):
        snp_desc = np.where(G[i, :num_snp] == 1)[0]
        if snp_desc.size:
            A[i, snp_desc] = rng.uniform(lo_pp, hi_pp, snp_desc.size) * np.sign(
                rng.normal(size=snp_desc.size)
            )
        rest = np.where(G[i, num_snp:] == 1)[0]
        if rest.size:
            A[i, rest + num_snp] = rng.uniform(lo_mp, hi_mp, rest.size) * np.sign(
                rng.normal(size=rest.size)
            )
    for i in range(num_snp, pq):
        desc = np.where(G[i] == 1)[0]
        if desc.size:
            A[i, desc] = rng.uniform(lo_pp, hi_pp, desc.size) * np.sign(
                rng.normal(size=desc.size)
            )

    x = np.zeros((n, pq), dtype=np.float64)
    for i in range(pq):
        parents = np.where(G[:, i] == 1)[0]
        if parents.size == 0:
            x[:, i] = rng.normal(size=n)
        else:
            g = x[:, parents] @ A[parents, i]
            noise_var = max(1.0 - g.var(ddof=1), 0.0)
            x[:, i] = g + rng.normal(0, np.sqrt(noise_var), size=n)

    return SimulatedDag(
        G=G, A=A, x=x, num_snp=num_snp, num_latent=num_latent, num_trait=num_trait
    )


def write_simulation_artifacts(dag: SimulatedDag, outdir: str, tag: str = "sim") -> dict:
    """Write the reference's simulation outputs (`simulate_dag.R:117-135`)."""
    os.makedirs(outdir, exist_ok=True)
    paths = {
        "true_adj": os.path.join(outdir, f"true_adj_mat_{tag}.mtx"),
        "corr": os.path.join(outdir, f"corr_{tag}.mtx"),
        "true_effects": os.path.join(outdir, f"true_causaleffects_{tag}.mtx"),
        "true_trait_effects": os.path.join(
            outdir, f"true_trait_causaleffects_{tag}.mtx"
        ),
    }
    write_coo_mtx(paths["true_adj"], dag.A)
    corr = np.corrcoef(dag.observed(), rowvar=False)
    write_coo_mtx(paths["corr"], corr)
    write_coo_mtx(paths["true_effects"], dag.true_effects())
    write_coo_mtx(paths["true_trait_effects"], dag.true_trait_effects())
    return paths


def simulate_genotype_dataset(
    outdir: str,
    num_samples: int = 4000,
    num_markers: int = 200,
    trait_parents: dict[int, list[int]] | None = None,
    trait_edges: list[tuple[int, int]] | None = None,
    effect: float = 0.3,
    trait_effect: float = 0.5,
    num_traits: int = 3,
    missing_rate: float = 0.0,
    seed: int = 42,
    stem: str = "sim",
) -> str:
    """PLINK fileset + standardized .phen with planted causal structure.

    trait_parents: {trait_ix: [marker indices]}; trait_edges: directed
    (source_trait, sink_trait) pairs applied in index order. Returns the
    fileset stem path.
    """
    rng = np.random.default_rng(seed)
    os.makedirs(outdir, exist_ok=True)
    maf = rng.uniform(0.1, 0.5, num_markers)
    G = (
        (rng.random((num_markers, num_samples)) < maf[:, None]).astype(np.float32)
        + (rng.random((num_markers, num_samples)) < maf[:, None])
    ).astype(np.float32)
    if missing_rate > 0:
        G[rng.random(G.shape) < missing_rate] = np.nan

    if trait_parents is None:
        # spread default parent SNPs over the available markers
        picks = np.linspace(0, num_markers - 1, 8).astype(int)
        trait_parents = {0: picks[:4].tolist(), 1: picks[4:7].tolist()}
    if trait_edges is None:
        trait_edges = [(0, 1)]

    def std(v):
        return (v - np.nanmean(v)) / np.nanstd(v)

    Y = np.zeros((num_traits, num_samples))
    for t in range(num_traits):
        y = rng.normal(size=num_samples)
        for mk in trait_parents.get(t, []):
            y = y + effect * std(np.nan_to_num(G[mk]))
        Y[t] = y
    for src, dst in trait_edges:
        Y[dst] = Y[dst] + trait_effect * Y[src]
    Y = (Y - Y.mean(axis=1, keepdims=True)) / Y.std(axis=1, keepdims=True)

    base = os.path.join(outdir, stem)
    with open(base + ".bed", "wb") as f:
        f.write(BED_PREFIX_COL_MAJ)
        f.write(encode_bed_values(G).tobytes())
    with open(base + ".bim", "w") as f:
        for i in range(num_markers):
            f.write(f"1\trs{i}\t0\t{1000 * i}\tA\tG\n")
    with open(base + ".fam", "w") as f:
        for i in range(num_samples):
            f.write(f"F{i} I{i} 0 0 0 -9\n")
    with open(base + ".phen", "w") as f:
        f.write(
            "FID\tIID\t" + "\t".join(f"T{t}" for t in range(num_traits)) + "\n"
        )
        for i in range(num_samples):
            f.write(
                f"F{i}\tI{i}\t"
                + "\t".join(f"{v:.6f}" for v in Y[:, i])
                + "\n"
            )
    return base
