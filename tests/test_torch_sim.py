"""The port's `sim` against the JAX package's on tests/test_sim.py's seeds:
the same DAG, effects and data exactly, byte-identical artifact and PLINK
files; and the port's skeleton on the simulated panel against the JAX
skeleton's (decisions exact, pMax within the parity tolerance) with the
recall tests/test_sim.py asks of it."""

import os

import numpy as np
import pytest

from torch_parity import ATOL, RTOL, set_threads

from cigwas_tpu import sim as jax_sim
from cigwas_tpu_torch import sim

set_threads()

# tests/test_sim.py's fixture (the reference's simulate_dag.R scaled down)
DAG_KW = dict(n=8000, num_snp=60, num_trait=6, num_latent=1, deg=3, prob_pleio=0.2,
              lo_mp=0.1, hi_mp=0.3, lo_pp=0.1, hi_pp=0.4, seed=7)


@pytest.fixture(scope="module")
def dags():
    return sim.gen_rand_dag(**DAG_KW), jax_sim.gen_rand_dag(**DAG_KW)


def _files(d):
    return {f: open(os.path.join(d, f), "rb").read() for f in sorted(os.listdir(d))}


def test_gen_rand_dag_matches_jax(dags):
    got, exp = dags
    for f in ("G", "A", "x"):
        assert np.array_equal(getattr(got, f), getattr(exp, f)), f
    assert (got.num_snp, got.num_latent, got.num_trait) == (exp.num_snp, exp.num_latent,
                                                           exp.num_trait)
    assert np.array_equal(got.observed(), exp.observed())
    assert np.array_equal(got.true_effects(), exp.true_effects())
    assert np.array_equal(got.true_trait_effects(), exp.true_trait_effects())
    assert np.all(np.tril(got.G) == 0)


def test_simulation_artifacts_match_jax(dags, tmp_path):
    got, exp = dags
    paths = sim.write_simulation_artifacts(got, str(tmp_path / "t"), tag="s")
    jax_paths = jax_sim.write_simulation_artifacts(exp, str(tmp_path / "j"), tag="s")
    assert [os.path.basename(p) for p in paths.values()] == [
        os.path.basename(p) for p in jax_paths.values()]
    assert _files(tmp_path / "t") == _files(tmp_path / "j")


@pytest.mark.parametrize("kw", [
    dict(num_samples=200, num_markers=30, missing_rate=0.05, seed=1),
    dict(num_samples=301, num_markers=45, seed=42),
    dict(num_samples=120, num_markers=20, trait_parents={2: [3, 4]}, trait_edges=[(2, 0)],
         num_traits=4, effect=0.5, seed=3, stem="planted"),
], ids=["missing", "defaults", "planted"])
def test_simulate_genotype_dataset_matches_jax(tmp_path, kw):
    stem = sim.simulate_genotype_dataset(str(tmp_path / "t"), **kw)
    jax_stem = jax_sim.simulate_genotype_dataset(str(tmp_path / "j"), **kw)
    assert os.path.basename(stem) == os.path.basename(jax_stem)
    files = _files(tmp_path / "t")
    assert sorted(files) == sorted(os.path.basename(stem) + e
                                   for e in (".bed", ".bim", ".fam", ".phen"))
    assert files == _files(tmp_path / "j")


def test_skeleton_on_simulated_dag_matches_jax(dags):
    """tests/test_sim.py's recovery check, through the port, held to the
    JAX skeleton on the same panel."""
    import jax.numpy as jnp

    from cigwas_tpu.skeleton import skeleton as jax_skeleton
    from cigwas_tpu.utils.stats import threshold_array
    from cigwas_tpu_torch.skeleton import skeleton

    dag = dags[0]
    obs = dag.observed()
    n = obs.shape[0]
    C = np.corrcoef(obs, rowvar=False).astype(np.float32)
    th = threshold_array(n, 1e-3)
    res = skeleton(C, th, 14, device="cpu")
    res_j = jax_skeleton(jnp.asarray(C), th, 14)
    assert np.array_equal(res.G, res_j.G) and np.array_equal(res.sepset, res_j.sepset)
    np.testing.assert_allclose(res.pmax, res_j.pmax, rtol=RTOL, atol=ATOL)

    keep = np.r_[np.arange(dag.num_snp), np.arange(dag.num_snp + dag.num_latent, dag.pq)]
    true_dir = dag.G[np.ix_(keep, keep)] != 0
    true_skel = true_dir | true_dir.T
    est = res.G.astype(bool)
    iu = np.triu_indices(len(keep), 1)
    tp = np.sum(est[iu] & true_skel[iu])
    fn = np.sum(~est[iu] & true_skel[iu])
    assert tp / max(tp + fn, 1) > 0.8
