"""The port's multi-device engines (`cigwas_tpu_torch.parallel.sharded`)
against the JAX package's (`cigwas_tpu.parallel.sharded`) and the port's own
one-device path, on the CPU: the counterparts of tests/test_sharded_skeleton.py.

The JAX engines run on the 8 virtual CPU devices (tests/conftest.py), the
port's on D entries of the CPU. Block files: every file md5-identical to the
port's one-device run; against the JAX engine the decision files
(`.adj/.ixs/.mdim/.sep`) md5-identical and `.corr` within atol 1e-6 (the
panel's float32 values are not bit-equal between the packages, see
tests/test_torch_corr.py). The same engine tests run on D shards of one card
under the `cuda` marker.
"""

import hashlib
import os
import re
from collections import Counter

import numpy as np
import pytest
import torch

from torch_parity import set_threads, std, write_plink

from cigwas_tpu_torch.parallel.sharded import RowShardedEngine, ShardedEngine

set_threads()

DS = [1, 2, 3, 4, 8]
MODES = ["replicated", "rowsharded"]
ENGINE = {"replicated": ShardedEngine, "rowsharded": RowShardedEngine}
DECISIONS = (".adj", ".ixs", ".mdim", ".sep")


def _jax_mesh(D: int):
    import jax
    from jax.sharding import Mesh

    return Mesh(np.array(jax.devices()[:D]), ("marker",))


@pytest.fixture(scope="module")
def sharded_dataset(tmp_path_factory):
    """The dataset of tests/test_sharded_skeleton.py (seed 21, n = 3000,
    m = 96, three traits), blocked by the port at 48 markers; the port's
    one-device block outputs."""
    from cigwas_tpu_torch.pipelines import make_blocks
    from cigwas_tpu_torch.prep import prep_bed

    tmp = tmp_path_factory.mktemp("torch_sharded")
    rng = np.random.default_rng(21)
    n, m = 3000, 96
    maf = rng.uniform(0.1, 0.5, m)
    G = (rng.random((m, n)) < maf[:, None]).astype(np.float32) + (
        rng.random((m, n)) < maf[:, None]
    )
    y0 = sum(0.4 * std(G[i]) for i in (8, 18, 28)) + rng.normal(size=n)
    y1 = sum(0.4 * std(G[i]) for i in (40, 55)) + 0.5 * y0 + rng.normal(size=n)
    y2 = 0.4 * std(G[28]) + 0.3 * y0 + rng.normal(size=n)
    Y = np.stack([y0, y1, y2])
    Y = (Y - Y.mean(1, keepdims=True)) / Y.std(1, keepdims=True)
    stem = str(tmp / "sim")
    write_plink(stem, G, Y)
    prep_bed(stem)
    make_blocks(stem, 48, 16, verbose=False, device="cpu")
    blockfile = stem + "_m48.blocks"
    plain = _port_blocks(stem, blockfile, tmp / "out_plain", device="cpu")
    assert plain, "no block outputs produced"
    return tmp, stem, blockfile, plain


def _hashes(outdir) -> dict:
    return {f: hashlib.md5(open(os.path.join(outdir, f), "rb").read()).hexdigest()
            for f in sorted(os.listdir(outdir))
            if re.match(r"^\d+_\d+_\d+\.(adj|corr|ixs|sep|mdim)$", f)}


def _port_blocks(stem, blockfile, outdir, **kw) -> dict:
    from cigwas_tpu_torch.pipelines import CuskContext

    os.makedirs(outdir, exist_ok=True)
    ctx = CuskContext(stem + ".phen", stem, blockfile, 0.001, 3, 14, 1, str(outdir),
                      verbose=False, **kw)
    for bi in range(len(ctx.blocks)):
        ctx.finish(ctx.prepare(bi))
    return _hashes(outdir)


def _jax_blocks(stem, blockfile, outdir, mesh, panel_mode) -> None:
    from cigwas_tpu.pipelines.cusk import CuskContext

    os.makedirs(outdir, exist_ok=True)
    ctx = CuskContext(stem + ".phen", stem, blockfile, 0.001, 3, 14, 1, str(outdir),
                      verbose=False, mesh=mesh, panel_mode=panel_mode)
    for bi in range(len(ctx.blocks)):
        ctx.finish(ctx.prepare(bi))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("D", DS)
def test_sharded_two_stage_cusk_byte_identical(sharded_dataset, D, mode):
    """The full two-stage cusk over D CPU shards, in both panel modes,
    writes the port's one-device block files byte for byte, and the JAX
    engine's decision files over the same D devices."""
    tmp, stem, blockfile, plain = sharded_dataset
    out = tmp / f"out_{mode}_{D}"
    got = _port_blocks(stem, blockfile, out, mesh=["cpu"] * D, panel_mode=mode)
    assert got == plain

    jax_out = tmp / f"jax_{mode}_{D}"
    _jax_blocks(stem, blockfile, jax_out, _jax_mesh(D), mode)
    jax = _hashes(jax_out)
    assert set(jax) == set(got)
    for f in got:
        if f.endswith(DECISIONS):
            assert got[f] == jax[f], f"{f} differs from the JAX engine's"
        else:
            np.testing.assert_allclose(np.fromfile(out / f, np.float32),
                                       np.fromfile(jax_out / f, np.float32), rtol=0, atol=1e-6)


def _dense_panel():
    rng = np.random.default_rng(5)
    n_var, n = 48, 20000
    X = np.zeros((n_var, n))
    X[0] = rng.normal(size=n)
    for i in range(1, n_var):
        parents = rng.choice(i, size=min(i, 2), replace=False)
        X[i] = sum(0.5 * X[p] for p in parents) + rng.normal(size=n)
    return np.corrcoef(X).astype(np.float32), n


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("D", [2, 3, 8])
def test_sharded_engine_levels_match_plain(D, mode):
    """skeleton() with an engine on a dense panel whose degrees reach level
    4 (the gather and the scan): adjacency, sepsets and pMax bit-identical to
    the one-device path; adjacency and sepsets equal to the JAX engine's (its
    replicated one where its row-sharded one needs D to divide the panel)."""
    from cigwas_tpu.parallel.sharded import RowShardedEngine as JaxRow
    from cigwas_tpu.parallel.sharded import ShardedEngine as JaxSharded
    from cigwas_tpu.skeleton import skeleton as jax_skeleton
    from cigwas_tpu_torch.skeleton import skeleton
    from cigwas_tpu_torch.utils.stats import threshold_array

    C, n = _dense_panel()
    th = threshold_array(n, 0.01)
    plain = skeleton(C, th, 4, device="cpu")
    eng = ENGINE[mode].flat(["cpu"] * D)
    got = skeleton(C, th, 4, engine=eng)
    assert plain.final_level == got.final_level == 4
    assert np.array_equal(plain.G, got.G)
    assert np.array_equal(plain.sepset, got.sepset)
    assert np.array_equal(plain.pmax, got.pmax)
    calls = sum(eng.record["calls"], start=Counter())
    # one level-1 bucket: D parts, and the row-sharded engine splits a part
    # whose compact panel would outgrow a stripe into several launches
    assert calls["panel_gather"] >= D and calls["local_sweep_l1"] >= D
    assert mode == "rowsharded" or calls["local_sweep_l1"] == D

    jax_cls = JaxRow if mode == "rowsharded" and 128 % D == 0 else JaxSharded
    ref = jax_skeleton(C, th, 4, engine=jax_cls(_jax_mesh(D), "marker"))
    assert np.array_equal(got.G, ref.G)
    assert np.array_equal(got.sepset, ref.sepset)


@pytest.mark.parametrize("mode", MODES)
def test_sharded_hetcor_matches_plain(n10_fixture, mode):
    """hetcor_skeleton with either engine over 8 CPU shards equals the
    one-device path, the N10 golden adjacency and the JAX engine."""
    from cigwas_tpu.parallel.sharded import RowShardedEngine as JaxRow
    from cigwas_tpu.parallel.sharded import ShardedEngine as JaxSharded
    from cigwas_tpu.skeleton import hetcor_skeleton as jax_hetcor
    from cigwas_tpu_torch.skeleton import hetcor_skeleton
    from cigwas_tpu_torch.utils.stats import hetcor_threshold

    C, A, alpha, n = n10_fixture
    N = np.full_like(C, float(n))
    th = hetcor_threshold(alpha)
    plain = hetcor_skeleton(C, np.ones_like(A), N, th, 14, device="cpu")
    got = hetcor_skeleton(C, np.ones_like(A), N, th, 14, engine=ENGINE[mode].flat(["cpu"] * 8))
    assert np.array_equal(plain.G, got.G)
    assert np.array_equal(got.G, A)
    jax_cls = JaxRow if mode == "rowsharded" else JaxSharded
    ref = jax_hetcor(C, np.ones_like(A), N, th, 14, engine=jax_cls(_jax_mesh(8), "marker"))
    assert np.array_equal(got.G, ref.G)


def _heterogeneous(seed: int = 3, v: int = 60):
    rng = np.random.default_rng(seed)
    C = np.corrcoef(rng.normal(size=(v, 2 * v))).astype(np.float32)
    N = rng.uniform(50, 500, (v, v)).astype(np.float32)
    N = (N + N.T) / 2
    N[rng.random((v, v)) < 0.05] = np.nan
    N = np.where(np.isnan(N.T), np.nan, N)
    return C, N, rng.integers(0, 3, v)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("ess_mode", ["reference", "float"])
def test_rowsharded_hetcor_heterogeneous(ess_mode, mode):
    """Heterogeneous per-pair N with NaNs and a time index, through level
    >= 4 in the float ess_mode (the two-panel gather and the hetcor scan):
    each engine over 3 CPU shards equals the one-device path, and its
    adjacency the JAX row-sharded engine's."""
    from cigwas_tpu.parallel.sharded import RowShardedEngine as JaxRow
    from cigwas_tpu.skeleton import hetcor_skeleton as jax_hetcor
    from cigwas_tpu_torch.skeleton import hetcor_skeleton
    from cigwas_tpu_torch.utils.stats import hetcor_threshold

    C, N, t_ix = _heterogeneous()
    v = C.shape[0]
    th = hetcor_threshold(1e-2)
    G0 = np.ones((v, v), np.int32)
    plain = hetcor_skeleton(C, G0, N, th, 14, time_index=t_ix, ess_mode=ess_mode, device="cpu")
    eng = ENGINE[mode].flat(["cpu"] * 3)
    got = hetcor_skeleton(C, G0, N, th, 14, time_index=t_ix, ess_mode=ess_mode, engine=eng)
    if ess_mode == "float":
        assert plain.final_level >= 4
        assert sum(c["panel_gather2"] for c in eng.record["calls"]) >= 3
    assert plain.final_level == got.final_level
    assert np.array_equal(plain.G, got.G)
    ref = jax_hetcor(C, G0, N, th, 14, time_index=t_ix, ess_mode=ess_mode,
                     engine=JaxRow(_jax_mesh(8), "marker"))
    assert np.array_equal(got.G, ref.G)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("l", [1, 2, 3])
def test_engine_hetcor_margins_match_jax(l, mode):
    """The hetcor margins of levels 1-3 launched part by part on 3 CPU shards
    (the row-sharded engine on compact panels with remapped lists): bitwise
    the one-device sweep's, and the JAX sweep's within the parity tolerance
    (atol 1e-6, equal signs beyond it, the sentinels in the same places)."""
    import jax.numpy as jnp

    from cigwas_tpu.ops import pcorr as jp
    from cigwas_tpu_torch.ops.kernels.hetcor_sweep import hetcor_local_sweep
    from cigwas_tpu_torch.utils.stats import hetcor_threshold

    from torch_parity import ATOL, hetcor_case, hetcor_neighbours

    th = hetcor_threshold(1e-3)
    v, nt, d = 60, 9, 24
    C, N, t_ix = hetcor_case(10 + l, v, t_max=2)
    node_ixs, nbrs, deg = hetcor_neighbours(l, v, nt, d)
    one = hetcor_local_sweep(*(torch.from_numpy(a) for a in (C, N, t_ix, node_ixs, nbrs, deg)),
                             th, l).numpy()
    eng = ENGINE[mode].flat(["cpu"] * 3)
    Cp, Np = eng.put_panel(C), eng.put_panel(N, fill=10.0)
    t_of = eng.replicate(torch.from_numpy(np.pad(t_ix, (0, Cp.vp - v))))
    parts = []
    for k, sl in eng.parts(Cp, node_ixs, nbrs):
        (Ck, Nk), lists, (tk,) = eng.local((Cp, Np), k, node_ixs[sl], nbrs[sl], deg[sl], (t_of,))
        parts.append(hetcor_local_sweep(Ck, Nk, tk, *lists, th, l).numpy())
    got = np.concatenate(parts)
    assert got.view(np.int32).tolist() == one.view(np.int32).tolist()

    args = [jnp.asarray(a) for a in (C, N, t_ix, node_ixs, nbrs, deg)]
    fn = {1: jp.hetcor1_local_sweep, 2: jp.hetcor2_local_sweep, 3: jp.hetcor3_local_sweep}[l]
    exp = np.asarray(fn(*args, jnp.float32(th)) if l == 1 else fn(*args, jnp.float32(th), 8))
    valid = np.arange(d)[None, :] < deg[:, None]
    exp = np.where(valid, exp, np.float32(3.0e38))
    big = exp >= 3.0e38
    np.testing.assert_array_equal(got >= 3.0e38, big)
    np.testing.assert_allclose(got[~big], exp[~big], rtol=0, atol=ATOL)
    firm = ~big & (np.abs(exp) > ATOL)
    np.testing.assert_array_equal(got[firm] < 0, exp[firm] < 0)
    assert (exp[~big] < 0).any() and (exp[~big] > 0).any()


DENSE_GATES = {"L1_LOCAL_MAX_WIDTH": 0, "L1_LOCAL_COST_RATIO": 1 << 60}


@pytest.fixture
def dense_level1(monkeypatch):
    """Level 1 forced to the dense route, as tests/test_hetcor_property.py
    forces it in the JAX package."""
    from cigwas_tpu_torch.skeleton import cupc

    for k, v in DENSE_GATES.items():
        monkeypatch.setattr(cupc, k, v)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("D", [1, 2, 3, 4])
def test_engines_dense_level1_cusk_byte_identical(sharded_dataset, dense_level1, D, mode):
    """The engines' dense level 1 (replicated slabs, or the row-sharded
    ring) through the two-stage cusk over D CPU shards: every block file
    equal to the one-device run's (default routes) byte for byte, with the dense
    launches counted per shard."""
    tmp, stem, blockfile, plain = sharded_dataset
    from cigwas_tpu_torch.ops.kernels import dense_l1 as dk
    from cigwas_tpu_torch.pipelines import CuskContext

    out = tmp / f"out_dense_{mode}_{D}"
    os.makedirs(out, exist_ok=True)
    ctx = CuskContext(stem + ".phen", stem, blockfile, 0.001, 3, 14, 1, str(out), verbose=False,
                      mesh=["cpu"] * D, panel_mode=mode)
    stats = {}
    for bi in range(len(ctx.blocks)):
        ctx.finish(ctx.prepare(bi), stats=stats)
    assert _hashes(out) == plain
    assert stats["stage1"]["level_route"][1] == "dense"
    calls = sum(ctx.engine.record["calls"], start=Counter())
    assert calls["dense_l1"] >= D
    assert dk.launches["dense_l1"] == 0  # the CPU path launches no kernel


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("D", [1, 2, 3, 4])
def test_engine_dense_sweeps_equal_one_device(D, mode):
    """The engines' dense level-1 sweeps: rho, s and the hetcor margins
    bitwise the one-card sweeps', and the screens' hits the same; the
    row-sharded ring copies the other stripes' rows between shards."""
    from cigwas_tpu_torch.ops import pcorr

    C, N, t_ix = _heterogeneous(seed=4, v=100)
    eng = ENGINE[mode].flat(["cpu"] * D)
    Cp, Np = eng.put_panel(C), eng.put_panel(N, fill=10.0)
    vp = Cp.vp
    G = np.zeros((vp, vp), dtype=bool)
    G[:100, :100] = np.abs(C) > 0.12
    np.fill_diagonal(G, False)
    Cf = torch.from_numpy(np.pad(C, ((0, vp - 100), (0, vp - 100))))
    Nf = torch.from_numpy(np.pad(N, ((0, vp - 100), (0, vp - 100)), constant_values=10.0))
    tf = torch.from_numpy(np.pad(t_ix, (0, vp - 100)).astype(np.int32))
    t_of = eng.replicate(tf)
    rho1, s1 = (t.numpy() for t in pcorr.level1_dense_minrho(Cf, G))
    rho, s = eng.level1_dense_minrho(Cp, G)
    assert np.array_equal(rho.view(np.int32), rho1.view(np.int32)) and np.array_equal(s, s1)
    th = float(np.float32(0.1))
    one = pcorr.level1_dense_screen(Cf, G, th)
    got = pcorr.dense1_screen(eng.dense1_sweeps(Cp, G), vp, th)
    order = np.lexsort((got[2], got[1]))
    assert np.array_equal(got[0], one[0]) and got[0].sum() > 0
    for a, b in zip(got[1:], one[1:]):
        assert np.array_equal(a[order], b)
    m1 = pcorr.hetcor1_dense_margin(Cf, Nf, tf, G, 2.5).numpy()
    m = eng.hetcor1_dense_margin(Cp, Np, t_of, G, 2.5)
    assert np.array_equal(m.view(np.int32), m1.view(np.int32))
    cond = pcorr.dense1_screen(eng.dense1_sweeps(Cp, G, Np, t_of, 2.5), vp)
    assert np.array_equal(cond, (m1 < 0) & G) and cond.sum() > 0
    if mode == "rowsharded" and D > 1:
        assert eng.record["crossed_bytes"] > 0


def _banded_input(m: int):
    from cigwas_tpu_torch.io.bed import encode_bed_values

    rng = np.random.default_rng(m)
    maf = rng.uniform(0.1, 0.5, m)
    G = (rng.random((m, 600)) < maf[:, None]).astype(np.float32) + (
        rng.random((m, 600)) < maf[:, None]
    )
    G[5] = 0.0  # monomorphic row -> NaN band entries must zero identically
    return encode_bed_values(G)


@pytest.mark.parametrize("m", [384, 370])
def test_sharded_banded_corr_byte_identical(m):
    """The banded `block`-stage correlation over 8 CPU shards (rows split,
    boundary rows exchanged) equals the one-device route with the shard
    length as its row tile bit for bit, and the JAX engine's within the
    parity tolerance; so do its row sums and the streaming route's."""
    from cigwas_tpu.parallel.sharded import ShardedEngine as JaxSharded
    from cigwas_tpu_torch.ops.corr import (
        banded_row_abs_sums_streaming,
        kendall_npn_corr_banded,
    )

    from torch_parity import ATOL, RTOL

    bb, width = _banded_input(m), 16
    mloc = -(-m // 8)
    ref = kendall_npn_corr_banded(bb, 600, width, row_tile=mloc, device="cpu")
    eng = ShardedEngine.flat(["cpu"] * 8)
    got = eng.kendall_npn_corr_banded(bb, 600, width)
    assert got.shape == ref.shape == (m, width)
    np.testing.assert_array_equal(got, ref)
    assert eng.record["crossed_bytes"] > 0  # the boundary rows moved between shards
    sums = eng.banded_row_abs_sums(bb, 600, width, row_tile=64)
    np.testing.assert_array_equal(
        sums, banded_row_abs_sums_streaming(bb, 600, width, row_tile=64, device="cpu"))
    jax = JaxSharded(_jax_mesh(8), "marker").kendall_npn_corr_banded(bb, 600, width)
    np.testing.assert_allclose(got, np.asarray(jax), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("engine", ["port", "jax"])
def test_sharded_banded_corr_rejects_thin_shards(engine):
    """Both packages refuse shards thinner than the band."""
    from cigwas_tpu.parallel.sharded import ShardedEngine as JaxSharded
    from cigwas_tpu_torch.io.bed import encode_bed_values

    rng = np.random.default_rng(0)
    bb = encode_bed_values((rng.random((40, 200)) < 0.3).astype(np.float32))
    eng = (ShardedEngine.flat(["cpu"] * 8) if engine == "port"
           else JaxSharded(_jax_mesh(8), "marker"))
    with pytest.raises(ValueError, match="corr_width"):
        eng.kendall_npn_corr_banded(bb, 200, 16)


def test_make_blocks_over_a_mesh_writes_the_same_blocks(tmp_path):
    """`make_blocks(mesh=)` writes the one-device `.blocks` bytes by both
    routes (the band fetched, and reduced on the shards), and refuses a
    chromosome thinner than the band per shard."""
    from cigwas_tpu_torch.pipelines import make_blocks
    from cigwas_tpu_torch.prep import prep_bed

    rng = np.random.default_rng(8)
    n, m = 800, 300
    G = (rng.random((m, n)) < rng.uniform(0.1, 0.5, m)[:, None]).astype(np.float32)
    G = G + np.roll(G, 1, axis=0) * (rng.random((m, n)) < 0.5)
    stem = str(tmp_path / "chr")
    write_plink(stem, G, rng.normal(size=(2, n)))
    prep_bed(stem)
    blocks = {}
    for tag, kw in (("one", {"device": "cpu"}), ("mesh", {"mesh": ["cpu"] * 3}),
                    ("streamed", {"mesh": ["cpu"] * 3, "streaming_min_markers": 100}),
                    ("one_streamed", {"device": "cpu", "streaming_min_markers": 100})):
        out = str(tmp_path / f"{tag}.blocks")
        make_blocks(stem, 64, 16, out_path=out, verbose=False, **kw)
        blocks[tag] = open(out, "rb").read()
    assert blocks["one"] and blocks["mesh"] == blocks["one"]
    assert blocks["streamed"] == blocks["one_streamed"]
    with pytest.raises(ValueError, match="corr_width"):
        make_blocks(stem, 64, 160, out_path=str(tmp_path / "thin.blocks"), verbose=False,
                    mesh=["cpu"] * 2)


def test_rowsharded_panel_is_actually_sharded(sharded_dataset):
    """The row-sharded panel's parts are (vp/D, vp) stripes, and over a whole
    two-stage cusk the engine's record of what it placed holds no (vp, vp)
    tensor and no compact panel larger than a stripe, while the replicated
    engine's holds one copy per distinct device."""
    from cigwas_tpu_torch.io.bed import encode_bed_values
    from cigwas_tpu_torch.pipelines import CuskContext

    rng = np.random.default_rng(0)
    m, n, p = 100, 500, 2
    G = (rng.random((m, n)) < 0.3).astype(np.float32) + (rng.random((m, n)) < 0.3)
    Y = rng.normal(size=(p, n)).astype(np.float32)
    eng = RowShardedEngine.flat(["cpu"] * 8)
    C, v = eng.corr_panel_device(encode_bed_values(G), Y, G.mean(1), G.std(1), n)
    assert v == m + p and C.vp % (128 * 8 // np.gcd(128, 8)) == 0
    assert {tuple(t.shape) for t in C.parts} == {(C.vp // 8, C.vp)}

    tmp, stem, blockfile, _ = sharded_dataset
    for mode, D in (("rowsharded", 4), ("replicated", 4)):
        out = tmp / f"record_{mode}"
        os.makedirs(out)
        ctx = CuskContext(stem + ".phen", stem, blockfile, 0.001, 3, 14, 1, str(out),
                          verbose=False, mesh=["cpu"] * D, panel_mode=mode)
        for bi in range(len(ctx.blocks)):
            ctx.finish(ctx.prepare(bi))
        placed = ctx.engine.record["placed"]
        vps = {shape[1] for what, _, _, shape in placed if what == "panel"}
        whole = [shape for _, _, _, shape in placed if shape[0] == shape[1] and shape[0] in vps]
        assert vps
        if mode == "rowsharded":  # and no compact panel larger than a stripe
            assert not whole, placed
            compact = [shape for what, _, _, shape in placed if what == "compact"]
            assert compact and all(a * b <= max(vps) ** 2 // D for a, b in compact), compact
        else:  # one copy per distinct device (the CPU) of each panel
            assert len(whole) == sum(what == "panel" for what, *_ in placed)


def _card_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("D", [2, 3])
def test_card_engines_match_one_device(sharded_dataset, D, mode):
    """On a card: the two-stage cusk over D shards of cuda:0 writes the
    one-card block files byte for byte, and a dense panel's skeleton through
    level 4 is bit-identical to one card's."""
    _card_or_skip()
    from cigwas_tpu_torch.skeleton import skeleton
    from cigwas_tpu_torch.utils.stats import threshold_array

    tmp, stem, blockfile, _ = sharded_dataset
    one = _port_blocks(stem, blockfile, tmp / f"card_one_{mode}_{D}", device="cuda")
    got = _port_blocks(stem, blockfile, tmp / f"card_{mode}_{D}", mesh=["cuda:0"] * D,
                       panel_mode=mode)
    assert got == one
    C, n = _dense_panel()
    th = threshold_array(n, 0.01)
    plain = skeleton(C, th, 4, device="cuda")
    res = skeleton(C, th, 4, engine=ENGINE[mode].flat(["cuda:0"] * D))
    assert np.array_equal(plain.G, res.G) and np.array_equal(plain.sepset, res.sepset)
    assert np.array_equal(plain.pmax, res.pmax)
