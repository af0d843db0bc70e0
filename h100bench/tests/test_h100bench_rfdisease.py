"""The risk-factor and disease input (``generators/sumstats_dag.py``), its
reference (``reference/cuskss_merged.py``) and its entry
(``entries/cuskss_merged.py``) on the CPU, at a small size: the generator's
recipe, the port against the reference through a tiny cell, and the time
index reaching the skeleton."""

from __future__ import annotations

import importlib
import json
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from h100bench import harness
from h100bench.generators.sumstats_dag import SMALL
from h100bench.generators.sumstats_dag import SMALL_TRAFFIC as TRAFFIC

from conftest import HERE, ROOT


def _cfg() -> dict:
    cfg = json.loads((HERE / "configs" / "cuskss_rfdisease10k.json").read_text())
    return {**cfg, **SMALL}


def _traffic() -> dict:
    return {**json.loads((HERE / "traffic" / "merged10k.json").read_text()), **TRAFFIC}


def _generator():
    return harness.load_module(HERE / "generators" / "sumstats_dag.py", "sumstats_dag_test")


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    torch.set_num_threads(2)
    work = tmp_path_factory.mktemp("rfdisease")
    return _generator().generate(_cfg(), _traffic(), 2147483811, str(work), "cpu")


def test_the_sem_is_a_joint_correlation(small):
    """The markers' AR(1) correlation and the SEM's marker - trait and trait -
    trait correlations form one positive definite matrix with a unit
    diagonal, and the traits' block is the generator's pxp."""
    gen, cfg = _generator(), _cfg()
    m = TRAFFIC["markers"]
    corr_xy, corr_yy = gen.population(cfg, m, small["layout"], "cpu")
    ii = torch.arange(m, dtype=torch.float64)
    S = cfg["ld_ar1"] ** (ii[:, None] - ii[None, :]).abs()
    J = torch.cat([torch.cat([S, corr_xy], 1), torch.cat([corr_xy.T, corr_yy], 1)], 0)
    assert torch.allclose(torch.diagonal(J), torch.ones(J.shape[0], dtype=torch.float64))
    assert torch.linalg.eigvalsh(J).min() > 0
    pxp = np.loadtxt(small["pxp"], skiprows=1, usecols=range(1, 7))
    np.testing.assert_allclose(pxp, corr_yy.float().numpy(), rtol=0, atol=1e-7)


def test_the_layout_follows_the_recipe(small):
    """Every planted risk-factor marker acts on exactly ``pleiotropy``
    distinct risk factors and each risk factor on ``rf_planted`` markers;
    each disease has its parents among the risk factors and its own direct
    markers; the planted markers are distinct."""
    cfg, lay = _cfg(), small["layout"]
    nr, nd = cfg["risk_factors"], cfg["diseases"]
    acts: dict = {}
    for t in range(nr):
        ks = [k for k, _ in lay["effects"][t]]
        assert len(ks) == len(set(ks)) == cfg["rf_planted"]
        for k in ks:
            acts.setdefault(k, []).append(t)
    assert len(acts) == nr * cfg["rf_planted"] // cfg["pleiotropy"]
    assert all(len(ts) == cfg["pleiotropy"] for ts in acts.values())
    direct = [k for d in range(nd) for k, _ in lay["effects"][nr + d]]
    assert len(direct) == len(set(direct)) == nd * cfg["disease_direct"]
    assert not set(direct) & set(acts)
    assert sorted(set(direct) | set(acts)) == lay["positions"].tolist()
    for d in range(nd):
        pa = lay["parents"][nr + d]
        assert len(pa) == len(set(pa)) == cfg["disease_parents"] and max(pa) < nr


def test_the_files_hold_the_merged_time_indexed_input(small):
    """``marker_ixs`` is ascending and unique within the table's rows; the
    time index holds the risk factors' 1s, then the diseases' 2s; the mxm
    triangle is the merged markers'; the tables have every row."""
    cfg = _cfg()
    ixs = np.fromfile(small["marker_ixs"], dtype=np.int32)
    assert ixs.size == TRAFFIC["markers"] and np.all(np.diff(ixs) > 0)
    assert ixs.min() >= 0 and ixs.max() < TRAFFIC["table_rows"]
    times = [int(v) for v in Path(small["time_index"]).read_text().split()]
    assert times == [1] * cfg["risk_factors"] + [2] * cfg["diseases"]
    m = TRAFFIC["markers"]
    assert np.fromfile(small["mxm"], dtype=np.float32).size == m * (m + 1) // 2
    for k in ("mxp", "mxp_se"):
        lines = Path(small[k]).read_text().splitlines()
        assert len(lines) == 1 + TRAFFIC["table_rows"]
        assert lines[0].split()[:3] == ["chr", "snp", "ref"]


def test_the_same_seed_makes_the_same_files(tmp_path):
    gen, cfg, tr = _generator(), _cfg(), _traffic()
    made = {}
    for name, seed in (("a", 7), ("b", 7), ("c", 8)):
        (tmp_path / name).mkdir()
        made[name] = gen.generate(cfg, tr, seed, str(tmp_path / name), "cpu")
    a, b, c = made["a"], made["b"], made["c"]
    for k in ("mxm", "mxp", "mxp_se", "pxp", "pxp_se", "marker_ixs", "time_index"):
        assert Path(a[k]).read_bytes() == Path(b[k]).read_bytes(), k
    assert Path(a["mxp"]).read_bytes() != Path(c["mxp"]).read_bytes()
    assert Path(a["marker_ixs"]).read_bytes() != Path(c["marker_ixs"]).read_bytes()


def _tiny_cell(base: Path):
    """(cell, bench): a copy of ``h100bench/`` under base with the cell
    ``tiny.dense`` (500 merged markers of 600 rows, 4 risk factors, 2
    diseases) and the BENCHMARK.json object that names it."""
    here = base / "h100bench"
    shutil.copytree(HERE, here, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    (here / "configs" / "tiny_rfdisease.json").write_text(json.dumps(_cfg()))
    (here / "traffic" / "tiny_merged.json").write_text(json.dumps(_traffic()))
    work = json.loads((HERE / "workloads" / "cuskss.dense10k.json").read_text())
    (here / "workloads" / "tiny.dense.json").write_text(json.dumps(
        {**work, "config": "tiny_rfdisease", "traffic": "tiny_merged"}))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench = {**bench, "workloads": [{"name": "tiny.dense", "config": "tiny_rfdisease",
                                     "traffic": "tiny_merged", "chips": 1}],
             "end_to_end": [{**m, "workloads": ["tiny.dense"]} for m in bench["end_to_end"]
                            if m["name"] in ("input_s", "peak_device_gib", "setup_s")],
             "per_layer": []}
    return harness.cell("tiny.dense", bench, here), bench


@pytest.fixture(scope="module")
def tiny_dense(tmp_path_factory):
    torch.set_num_threads(2)
    return _tiny_cell(tmp_path_factory.mktemp("tiny_dense"))


def test_the_port_matches_the_reference_on_the_cpu(tiny_dense):
    """One run of the tiny cell: the merged, time-indexed solve's files
    against the reference's result: the same variables and adjacency, the
    correlations within 1e-6, ``correct``."""
    c, bench = tiny_dense
    result, compared = harness.run(c, bench, 2147483811, 0.0, False, device="cpu")
    assert result["correct"] and result["failed"] == 0 and result["attempted"] >= 1
    assert compared["retained_diff"]["value"] == 0
    assert compared["adjacency_diff"]["value"] == 0
    assert compared["corr_err"]["value"] < 1e-6
    assert set(result["metrics"]) == {"input_s", "peak_device_gib", "setup_s"}


def test_the_time_index_reaches_the_skeleton(tiny_dense, monkeypatch, tmp_path):
    """The entry hands the time-index file to the program, whose two stages
    give the hetcor skeleton the markers at 0, the risk factors at 1 and the
    diseases at 2, and whose merged input is the selected rows."""
    pipeline = importlib.import_module("cigwas_tpu_torch.pipelines.cuskss")
    c, _ = tiny_dense
    data = c.generator.generate(c.cfg, c.traffic, 2147483812, str(tmp_path), "cpu")
    seen = []
    real = pipeline.hetcor_skeleton

    def spy(C, G, N, threshold, max_level, time_index=None, **kw):
        seen.append((np.asarray(G).shape[0], np.asarray(time_index).copy()))
        return real(C, G, N, threshold, max_level, time_index=time_index, **kw)

    monkeypatch.setattr(pipeline, "hetcor_skeleton", spy)
    (tmp_path / "out").mkdir()
    stats = c.entry.solve(c.entry.setup(c.cfg, data, "cpu"), str(tmp_path / "out"))
    nr, nd = c.cfg["risk_factors"], c.cfg["diseases"]
    traits = [1] * nr + [2] * nd
    assert len(seen) == 2
    v1, t1 = seen[0]
    assert v1 == TRAFFIC["markers"] + nr + nd
    assert t1.tolist() == [0] * TRAFFIC["markers"] + traits
    v2, t2 = seen[1]
    assert t2.tolist() == [0] * (v2 - nr - nd) + traits
    assert 0.0 < stats["merged_select_s"] <= stats["load_s"]
    assert (tmp_path / "out" / "cuskss_merged.mdim").is_file()


def test_the_time_index_changes_a_risk_factors_margins(small):
    """Level 2's hetcor margins of a risk factor over a list that holds a
    disease: with the 3-valued index no set holding the disease (time 2)
    tests the risk factor (time 1) against a marker (time 0), so the margins
    differ from an all-1 index's, and are never below them (fewer sets)."""
    from cigwas_tpu_torch.ops import pcorr
    from cigwas_tpu_torch.utils.stats import hetcor_threshold
    from h100bench.reference.cuskss_merged import panels, time_index

    cfg = _cfg()
    C, N, m, p = panels(small, cfg["gwas_samples"], "cpu", torch.float32)
    nr = cfg["risk_factors"]
    rf = m  # the first risk factor
    lay = small["layout"]
    markers = [k for k, _ in lay["effects"][0]]
    diseases = [m + nr + d for d in range(cfg["diseases"])]
    nb = sorted(markers + diseases + [m + 1])
    node = torch.tensor([rf], dtype=torch.int32)
    nbrs = torch.tensor([nb], dtype=torch.int32)
    deg = torch.tensor([len(nb)], dtype=torch.int32)
    N_lvl = pcorr.trunc_ref_ess(N)
    th = hetcor_threshold(cfg["alpha"])
    t3 = torch.from_numpy(time_index(small["time_index"], m)).to(torch.int32)
    t1 = torch.cat([torch.zeros(m, dtype=torch.int32), torch.ones(p, dtype=torch.int32)])
    a = pcorr.hetcor_local_sweep_plain(C, N_lvl, t3, node, nbrs, deg, th, 2)[0]
    b = pcorr.hetcor_local_sweep_plain(C, N_lvl, t1, node, nbrs, deg, th, 2)[0]
    assert not torch.equal(a, b)
    assert bool((a >= b).all())


def test_the_control_in_bfloat16_is_not_correct(tiny_dense, tmp_path):
    """The reference computed in bfloat16, in the program's place, breaks a
    limit of the cell: its correlations alone are ~1e-3 off."""
    from h100bench.reference import compare

    c, _ = tiny_dense
    data = c.generator.generate(c.cfg, c.traffic, 2147483813, str(tmp_path), "cpu")
    state = c.entry.setup(c.cfg, data, "cpu")
    ref = c.entry.expected(state, "cpu")
    numbers = compare.compare(c.entry.expected(state, "cpu", torch.bfloat16), ref)
    limits = c.work["limits"]
    assert any(numbers[k] > limits[k] for k in limits)
    assert numbers["corr_err"] > limits["corr_err"]
