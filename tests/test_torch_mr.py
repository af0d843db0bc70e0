"""The port's MR stage (`cigwas_tpu_torch.mr`, `merge.mr_assumptions`, the
table writer `io.tables`) against the JAX package's on the same seeded
inputs. Both run the same numpy and scipy calls (MR-PRESSO's distortion
test on the same seeded `np.random.default_rng` draws), so every estimate is
held exactly, NaN where JAX gives NaN; the tables the port writes without
pandas are held byte for byte to what pandas writes for the JAX package."""

import dataclasses
import shutil

import numpy as np
import pandas as pd
import pytest

from torch_parity import TRAIT_DAG, merged_fileset, set_threads

from cigwas_tpu.merge import mr_assumptions as jax_mr_assumptions
from cigwas_tpu.mr import cause as jax_cause
from cigwas_tpu.mr import competitors as jax_competitors
from cigwas_tpu.mr import mvivw as jax_mvivw
from cigwas_tpu_torch.io.tables import write_table
from cigwas_tpu_torch.merge import mr_assumptions
from cigwas_tpu_torch.mr import cause, competitors, mvivw

set_threads()

N = 5000


def same(a, b) -> bool:
    """Exact equality through dataclasses, sequences, dicts and arrays; NaN
    equals NaN."""
    if dataclasses.is_dataclass(a):
        return type(a).__name__ == type(b).__name__ and all(
            same(getattr(a, f.name), getattr(b, f.name)) for f in dataclasses.fields(a))
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        return a.shape == b.shape and np.array_equal(
            a, b, equal_nan=a.dtype.kind == "f" and b.dtype.kind == "f")
    if isinstance(a, float) and isinstance(b, float) and np.isnan(a) and np.isnan(b):
        return True
    return a == b


def records(df) -> list[dict]:
    return df.to_dict("records")


@pytest.fixture(scope="module")
def filesets(tmp_path_factory):
    """The same merged skeleton twice (a directory for each package), as
    `merged_blocks` and as the `cuskss_merged` fileset run_mvivw_filtered
    reads, with an orientation prior that forbids T0 -> T2."""
    root = tmp_path_factory.mktemp("torch_mr")
    dirs = {}
    for name in ("port", "jax"):
        d = root / name
        d.mkdir()
        merged_fileset(str(d / "merged_blocks"), seed=11, n=N)
        for ext in ("_sam.mtx", "_scm.mtx", ".mdim", ".ixs"):
            shutil.copy(d / f"merged_blocks{ext}", d / f"cuskss_merged{ext}")
        prior = np.zeros((6, 6), np.int32)
        prior[2, 0] = prior[5, 3] = 1
        prior.tofile(d / "prior.bin")
        dirs[name] = d
    return dirs


@pytest.mark.parametrize("robust", [False, True], ids=["random_effects", "robust"])
@pytest.mark.parametrize("seed", range(4))
def test_mv_ivw_regression_equals_jax(seed, robust):
    """Estimates, standard errors and p values, bitwise, on instruments with
    a few pleiotropic outliers."""
    rng = np.random.default_rng(seed)
    j, k = 30 + 10 * seed, 1 + seed
    bx = rng.normal(0, 0.1, (j, k))
    byse = rng.uniform(0.005, 0.02, j)
    by = bx @ rng.normal(0.3, 0.1, k) + rng.normal(0, 1, j) * byse
    by[: 3 + seed] += 0.2
    got = mvivw.mv_ivw_regression(bx, by, byse, robust=robust)
    exp = jax_mvivw.mv_ivw_regression(bx, by, byse, robust=robust)
    assert same(list(got), list(exp))


MVIVW_CASES = {
    "plain": {},
    "skeleton": {"use_skeleton": True},
    "orientation_prior": {"rm_counterfactual": True},
    "not_robust": {"robust": False},
}


@pytest.mark.parametrize("case", sorted(MVIVW_CASES))
def test_run_mvivw_equals_jax(filesets, case):
    """`run_mvivw` (as `mvivw`, `mvivw -s`, `--orientation-prior`, and the
    non-robust model): the same rows, and the TSV byte-identical to the one
    pandas writes for the JAX package."""
    kw = dict(MVIVW_CASES[case])
    out = {}
    for name, module in (("port", mvivw), ("jax", jax_mvivw)):
        d = filesets[name]
        if kw.get("rm_counterfactual"):
            kw["orientation_prior"] = str(d / "prior.bin")
        out[name] = module.run_mvivw(str(d / "merged_blocks"), N,
                                     out_path=str(d / f"{case}.tsv"), **kw)
    assert same(out["port"], records(out["jax"]))
    got, exp = (open(filesets[n] / f"{case}.tsv", "rb").read() for n in ("port", "jax"))
    assert got == exp and got.count(b"\n") == 31
    if case == "plain":  # the planted edges are found
        for y, parents in TRAIT_DAG.items():
            for w, _ in parents:
                row = [r for r in out["port"] if r["source"] == w + 1 and r["sink"] == y + 1][0]
                assert row["effect"] > 0 and row["p"] < 1e-3, row


@pytest.mark.parametrize("relaxed,reverse", [(False, False), (True, False), (False, True),
                                             (True, True)])
def test_check_ivs_and_filtered_mvivw_equal_jax(filesets, relaxed, reverse):
    """`check_ivs` in every combination of its two flags gives JAX's rows in
    JAX's order, and `run_mvivw_filtered` on them JAX's rows and TSV."""
    rows = {}
    for name, module in (("port", mr_assumptions), ("jax", jax_mr_assumptions)):
        rows[name] = module.check_ivs(str(filesets[name] / "merged_blocks"), N, 1e-3, 1e-3,
                                      relaxed_local_faithfulness=relaxed,
                                      check_reverse_causality=reverse)
    assert rows["port"] == records(rows["jax"]) and rows["port"]
    tag = f"filtered_{relaxed}_{reverse}.tsv"
    got = mvivw.run_mvivw_filtered(str(filesets["port"]), N, rows["port"],
                                   out_path=str(filesets["port"] / tag))
    exp = jax_mvivw.run_mvivw_filtered(str(filesets["jax"]), N, rows["jax"],
                                       out_path=str(filesets["jax"] / tag))
    assert same(got, records(exp))
    assert open(filesets["port"] / tag, "rb").read() == open(filesets["jax"] / tag, "rb").read()


@pytest.mark.parametrize("dropped", [0.0, 0.5, 1.0], ids=["all", "half", "none"])
def test_iv_candidates_csv_equals_jax(tmp_path, dropped):
    """`get_iv_candidates` and the `_iv_candidates.csv` the CLI writes, in
    the set order of the reference; with no marker parent at all both write
    the single byte `\\n`."""
    stem = str(tmp_path / "merged_blocks")
    merged_fileset(stem, seed=12, n=2000, dropped=dropped)
    got = mr_assumptions.get_iv_candidates(stem)
    exp = jax_mr_assumptions.get_iv_candidates(stem)
    assert got == records(exp)
    write_table(str(tmp_path / "port.csv"), got)
    exp.to_csv(str(tmp_path / "jax.csv"), index=False)
    data = open(tmp_path / "port.csv", "rb").read()
    assert data == open(tmp_path / "jax.csv", "rb").read()
    assert (data == b"\n") == (dropped == 1.0)


@pytest.mark.parametrize("sep", [",", "\t"], ids=["csv", "tsv"])
def test_write_table_equals_pandas(tmp_path, sep):
    """Ints, bools, TRUE/FALSE strings, shortest round-trip floats, NaN as
    the empty field, +-inf, an empty table."""
    rows = [
        {"source": 1, "sink": 2, "effect": 0.1 + 0.2, "p": 1e-05, "sk_adj": True, "t": "TRUE"},
        {"source": 2, "sink": 1, "effect": float("nan"), "p": float("nan"), "sk_adj": False,
         "t": "FALSE"},
        {"source": 3, "sink": 1, "effect": float("inf"), "p": 0.0, "sk_adj": True, "t": "x"},
        {"source": 4, "sink": 1, "effect": -float("inf"), "p": 1.0, "sk_adj": True, "t": "y"},
        {"source": 5, "sink": 1, "effect": 1e16, "p": 2.5e-300, "sk_adj": False, "t": "z"},
        {"source": 6, "sink": 1, "effect": np.float64(-0.25), "p": 123456789.123,
         "sk_adj": False, "t": "w"},
    ]
    for name, table in (("rows", rows), ("empty", [])):
        write_table(str(tmp_path / f"{name}.port"), table, sep=sep)
        pd.DataFrame(table).to_csv(str(tmp_path / f"{name}.pandas"), sep=sep, index=False)
        assert (open(tmp_path / f"{name}.port", "rb").read()
                == open(tmp_path / f"{name}.pandas", "rb").read()), name
    with pytest.raises(ValueError, match="quoting"):
        write_table(str(tmp_path / "bad"), [{"a": f"x{sep}y"}], sep=sep)


def _simulate(seed: int = 0, n: int = 3000, m: int = 45):
    """Three traits, T0 -> T1 at 0.4, T2 independent, ten instruments of
    spread strengths per trait (the generator of tests/test_mr_competitors.py
    at a smaller size)."""
    rng = np.random.default_rng(seed)
    maf = rng.uniform(0.2, 0.5, m)
    G = (rng.random((n, m)) < maf).astype(np.float64) + (rng.random((n, m)) < maf)
    Gs = (G - G.mean(0)) / G.std(0)
    w = np.linspace(0.15, 0.6, 10)
    t0 = Gs[:, :10] @ w + rng.normal(size=n)
    t1 = Gs[:, 10:20] @ w + 0.4 * t0 + rng.normal(size=n)
    t2 = Gs[:, 20:30] @ w + rng.normal(size=n)
    return G, np.stack([t0, t1, t2], axis=1)


@pytest.mark.parametrize("robust", [False, True], ids=["plain", "robust"])
def test_ivw_and_egger_equal_jax(robust):
    """GWAS associations, univariable IVW and Egger for every ordered pair."""
    G, Y = _simulate(1)
    got, exp = competitors.gwas_associations(G, Y), jax_competitors.gwas_associations(G, Y)
    assert same(list(got), list(exp))
    beta, se, _, pval = got
    g_it = pval < 1e-3
    for method in ("mr_ivw", "mr_egger"):
        a = competitors.run_pairwise_mr_analyses(g_it, beta, se, getattr(competitors, method),
                                                 robust=robust)
        b = jax_competitors.run_pairwise_mr_analyses(g_it, beta, se,
                                                     getattr(jax_competitors, method),
                                                     robust=robust)
        assert a and same(a, b)


def test_presso_equals_jax():
    """MR-PRESSO with planted outliers and the pair loop: the same seeded
    numpy draws give the same Monte-Carlo p values, outliers and
    distortion test."""
    rng = np.random.default_rng(5)
    j = 30
    bx = rng.uniform(0.05, 0.2, j)
    bxse = np.full(j, 0.01)
    byse = rng.uniform(0.01, 0.02, j)
    by = 0.3 * bx + rng.normal(0, 1, j) * byse
    by[[2, 11, 17]] += 0.5 * bx[[2, 11, 17]] + 0.05
    got = competitors.mr_presso(bx, bxse, by, byse, n_dist=300, seed=3)
    exp = jax_competitors.mr_presso(bx, bxse, by, byse, n_dist=300, seed=3)
    assert same(got, exp) and got.outliers
    G, Y = _simulate(2)
    beta, se, _, pval = competitors.gwas_associations(G, Y)
    a = competitors.run_presso_analyses(pval < 1e-3, beta, se, n_dist=200, seed=4)
    b = jax_competitors.run_presso_analyses(pval < 1e-3, beta, se, n_dist=200, seed=4)
    assert a and same(a, b)


def test_cause_equals_jax():
    """CAUSE: the null-model parameters, the grid posteriors and the
    sharing-vs-causal contrast of one pair, and the pair loop."""
    G, Y = _simulate(3)
    beta, se, _, pval = competitors.gwas_associations(G, Y)
    ivs = np.where(pval[:, 0] < 1e-3)[0]
    args = (beta[ivs, 0], se[ivs, 0], beta[ivs, 1], se[ivs, 1])
    params = cause.est_cause_params(*args)
    assert same(params, jax_cause.est_cause_params(*args))
    assert same(cause.cause_fit(*args, params=params), jax_cause.cause_fit(*args, params=params))
    a = cause.run_cause_analyses(pval < 1e-3, beta, se)
    b = jax_cause.run_cause_analyses(pval < 1e-3, beta, se)
    assert a and same(a, b)


def test_mr_benchmark_equals_jax():
    """The whole `run_mr.R` flow on raw data (IVW, Egger, MR-PRESSO)."""
    G, Y = _simulate(4)
    got = competitors.run_mr_benchmark(G, Y, presso=True, presso_n_dist=100)
    exp = jax_competitors.run_mr_benchmark(G, Y, presso=True, presso_n_dist=100)
    assert same(got, exp) and got["ivw"] and got["presso"]


def test_exports_match_jax():
    """`mr/`, `pag/` and `merge/` export what the JAX package's do."""
    import cigwas_tpu.merge
    import cigwas_tpu.mr
    import cigwas_tpu.pag
    import cigwas_tpu_torch.merge
    import cigwas_tpu_torch.mr
    import cigwas_tpu_torch.pag

    assert cigwas_tpu_torch.mr.__all__ == cigwas_tpu.mr.__all__
    assert cigwas_tpu_torch.pag.__all__ == cigwas_tpu.pag.__all__
    assert set(cigwas_tpu.merge.__all__) <= set(cigwas_tpu_torch.merge.__all__)
    for pkg in (cigwas_tpu_torch.mr, cigwas_tpu_torch.pag, cigwas_tpu_torch.merge):
        assert all(callable(getattr(pkg, name)) for name in pkg.__all__)
