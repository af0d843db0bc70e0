"""The routes of levels 1-3 of the port's skeletons (`skeleton/cupc.py`) on
the CPU: the list route, the device-resident loop (one card's default up
to its size and width, checked before the level-1 gate), the dense level 1
and the combinatorial route, each forced by the module attributes
the JAX package's tests patch (tests/test_skeleton.py, tests/
test_hetcor_property.py). Under each route the port's skeleton is held to
the JAX skeleton under the same route and to the port's default: adjacency
and sepsets identical, pMax within the JAX package's tolerance between its
own routes (bitwise between the port's list, loop and dense routes, which
share their arithmetic). Also the
gate itself, `skeleton(chunk=)`, `CuskContext` over two blocks and the pipeline's
sepset records.
"""

import contextlib

import numpy as np
import pytest
import torch

from torch_parity import ar1_panel, set_threads

from cigwas_tpu.utils.stats import hetcor_threshold, threshold_array

set_threads()

BIG = 1 << 60
# the gate values that force each route, in both packages (the JAX
# package's default for these small panels is its device-resident loop)
PORT_ROUTES = {
    "list": {},
    "device_loop": {"DEV_RESIDENT_MAX": BIG},
    "dense": {"L1_LOCAL_MAX_WIDTH": 0, "L1_LOCAL_COST_RATIO": BIG},
    "combinatorial": {"LOCAL_LEVELS": (), "L1_LOCAL_MAX_WIDTH": 0, "L1_LOCAL_COST_RATIO": BIG,
                      "DENSE_L1_MAX": 0},
}
JAX_ROUTES = {**PORT_ROUTES, "list": {"DEV_RESIDENT_MAX": 0}}
WANT = {"list": "local", "device_loop": "device_loop", "dense": "dense",
        "combinatorial": "combinatorial"}


@contextlib.contextmanager
def _gates(module, values: dict):
    saved = {k: getattr(module, k) for k in values}
    for k, v in values.items():
        setattr(module, k, v)
    try:
        yield
    finally:
        for k, v in saved.items():
            setattr(module, k, v)


def _port(route: str):
    from cigwas_tpu_torch.skeleton import cupc

    base = {"DEV_RESIDENT_MAX": 0, "L1_LOCAL_MAX_WIDTH": 128, "L1_LOCAL_COST_RATIO": 0}
    return _gates(cupc, {**base, **PORT_ROUTES[route]})


def _jax(route: str):
    from cigwas_tpu.skeleton import cupc

    return _gates(cupc, JAX_ROUTES[route])


def _factor_panel(seed: int, v: int = 40, n: int = 20000):
    """The panel of tests/test_skeleton.py's level 2-3 route test: each
    variable a sum of up to three earlier ones, so levels 2-4 remove edges."""
    rng = np.random.default_rng(seed)
    X = np.zeros((v, n))
    X[0] = rng.normal(size=n)
    for i in range(1, v):
        ps = rng.choice(i, size=min(i, 3), replace=False)
        X[i] = sum(0.4 * X[p] for p in ps) + rng.normal(size=n)
    return np.corrcoef(X).astype(np.float32), n


def _panels():
    C1, n1 = _factor_panel(0)
    C2, n2 = _factor_panel(2)
    return {
        "factor0": (C1, threshold_array(n1, 0.01), 4),
        "factor2": (C2, threshold_array(n2, 0.01), 4),
        "ar1": (ar1_panel(5, 96, 900, 96), threshold_array(900, 1e-2), 3),
    }


PANELS = _panels()


def _assert_same(a, b, pmax_exact: bool) -> None:
    assert a.final_level == b.final_level
    np.testing.assert_array_equal(a.G, b.G)
    np.testing.assert_array_equal(a.sepset, b.sepset)
    if pmax_exact:
        assert np.array_equal(a.pmax.view(np.int32), b.pmax.view(np.int32))
    else:  # the combinatorial route's inverse: tests/test_skeleton.py:355's tolerance
        np.testing.assert_allclose(a.pmax, b.pmax, rtol=1e-3, atol=1e-5)


@pytest.mark.parametrize("panel", sorted(PANELS))
@pytest.mark.parametrize("route", sorted(PORT_ROUTES))
def test_skeleton_route_matches_jax_and_the_default(route, panel):
    from cigwas_tpu.skeleton import cupc as jc
    from cigwas_tpu_torch.skeleton import cupc

    C, th, lmax = PANELS[panel]
    stats = {}
    with _port(route):
        got = cupc.skeleton(C, th, lmax, device="cpu", stats=stats)
    assert stats["level_route"][1] == WANT[route]
    for l in (2, 3):
        if l in stats["level_route"]:
            assert stats["level_route"][l] == ("local" if route == "dense" else WANT[route])
    with _jax(route):
        ref = jc.skeleton(C, th, lmax)
    np.testing.assert_array_equal(got.G, ref.G)
    np.testing.assert_array_equal(got.sepset, ref.sepset)
    # the JAX package's own tolerance between its routes' pMax
    # (tests/test_skeleton.py:355): near-zero rho at level 4 amplifies the
    # last-bit differences of the two packages' float32 operations
    np.testing.assert_allclose(got.pmax, ref.pmax, rtol=1e-3, atol=1e-5)
    assert got.final_level == ref.final_level
    with _port("list"):
        default = cupc.skeleton(C, th, lmax, device="cpu")
    _assert_same(got, default, pmax_exact=route != "combinatorial")


def test_device_loop_runs_levels_1_to_3_and_hands_over_to_the_host_loop():
    """The loop serves levels 1-3, then the host loop's combinatorial level 4
    starts from the loop's adjacency; the loop's width is the level's max
    degree, one launch a level."""
    from cigwas_tpu_torch.skeleton import cupc

    C, th, _ = PANELS["factor0"]
    stats = {}
    with _port("device_loop"):
        got = cupc.skeleton(C, th, 6, device="cpu", stats=stats)
    routes = stats["level_route"]
    assert [routes[l] for l in (1, 2, 3)] == ["device_loop"] * 3
    assert all(routes[l] == "combinatorial" for l in routes if l > 3)
    assert all(len(stats["launches"][l]) == 1 for l in (1, 2, 3))
    assert "final_fetch_s" in stats
    with _port("list"):
        default = cupc.skeleton(C, th, 6, device="cpu")
    _assert_same(got, default, pmax_exact=True)


def test_device_loop_stops_when_the_graph_runs_out_of_tests():
    """A graph whose max degree falls below l + 1 stops the loop at l - 1,
    and the host loop runs no level after it, as in the JAX package."""
    from cigwas_tpu.skeleton import cupc as jc
    from cigwas_tpu_torch.skeleton import cupc

    rng = np.random.default_rng(4)
    X = rng.normal(size=(12, 3000))
    X[1] += X[0]
    X[2] += X[1]
    C = np.corrcoef(X).astype(np.float32)
    th = threshold_array(3000, 1e-3)
    with _port("device_loop"):
        got = cupc.skeleton(C, th, 14, device="cpu")
    with _jax("device_loop"):
        ref = jc.skeleton(C, th, 14)
    assert got.final_level == ref.final_level < 3
    np.testing.assert_array_equal(got.G, ref.G)
    np.testing.assert_array_equal(got.sepset, ref.sepset)


def _testless_panel(case: str):
    """Panels on which most nodes have no test at levels 2-3 (degree <= l):
    clusters of variables of one latent factor keep their edges through
    every level, a few short chains and independent variables do not.
    ``one_cluster``: eight variables of 48 keep a test at level 3;
    ``clusters``: clusters of 8, 5 and 4 among 64, so levels 2 and 3 launch
    different subsets."""
    rng = np.random.default_rng(11 if case == "one_cluster" else 12)
    X = rng.normal(size=(48 if case == "one_cluster" else 64, 4000))
    clusters = [(0, 8)] if case == "one_cluster" else [(0, 8), (40, 45), (50, 54)]
    for lo, hi in clusters:
        X[lo:hi] += 1.2 * rng.normal(size=4000)
    for a, b in ((10, 11), (11, 12), (20, 21), (30, 31), (31, 32), (32, 33)):
        X[b] += 0.6 * X[a]
    return np.corrcoef(X).astype(np.float32), threshold_array(4000, 1e-3)


@pytest.mark.parametrize("case", ["one_cluster", "clusters"])
def test_device_loop_with_mostly_testless_nodes_matches_jax(case):
    """On a panel where most nodes have no test at levels 2-3, the loop's
    launch at each level holds the nodes with a test alone (compacted on
    the device), a strict subset of the variables; its skeleton equals
    JAX's loop and the list route's."""
    from cigwas_tpu.skeleton import cupc as jc
    from cigwas_tpu_torch.skeleton import cupc

    C, th = _testless_panel(case)
    launched = []
    saved = cupc.local_sweep

    def checked(C_, node_ixs, nbrs, deg, l, **kw):
        launched.append((l, int((deg > l).sum()), len(deg)))
        return saved(C_, node_ixs, nbrs, deg, l, **kw)

    cupc.local_sweep = checked
    try:
        with _port("device_loop"):
            got = cupc.skeleton(C, th, 3, device="cpu")
    finally:
        cupc.local_sweep = saved
    assert [l for l, _, _ in launched] == [1, 2, 3]
    for l, live, rows in launched:
        assert live == rows, launched
        assert l == 1 or 0 < rows < C.shape[0] // 2, launched
    with _jax("device_loop"):
        ref = jc.skeleton(C, th, 3)
    assert got.final_level == ref.final_level == 3
    np.testing.assert_array_equal(got.G, ref.G)
    np.testing.assert_array_equal(got.sepset, ref.sepset)
    np.testing.assert_allclose(got.pmax, ref.pmax, rtol=1e-3, atol=1e-5)
    with _port("list"):
        default = cupc.skeleton(C, th, 3, device="cpu")
    _assert_same(got, default, pmax_exact=True)


def test_level1_hub_route_follows_the_gate():
    """A hub above the width gate: with the JAX package's gate values the
    cost model routes it as JAX does (local for a lone hub, dense when the
    ratio is huge); every route decides the same."""
    from cigwas_tpu.skeleton import cupc as jc
    from cigwas_tpu_torch.skeleton import cupc

    rng = np.random.default_rng(3)
    n, n_z, n_w = 4000, 150, 20
    z = rng.normal(size=(n_z, n))
    hub = z.sum(axis=0) / np.sqrt(n_z) + 0.5 * rng.normal(size=n)
    w = np.zeros((n_w, n))
    w[0] = rng.normal(size=n)
    for i in range(1, n_w):
        w[i] = 0.7 * w[i - 1] + np.sqrt(1 - 0.49) * rng.normal(size=n)
    C = np.corrcoef(np.vstack([hub, z, w])).astype(np.float32)
    th = threshold_array(n, 0.05)
    out = {}
    for ratio, want in ((16, "local"), (BIG, "dense")):
        stats = {}
        with _gates(cupc, {"L1_LOCAL_MAX_WIDTH": 128, "L1_LOCAL_COST_RATIO": ratio,
                           "DEV_RESIDENT_MAX": 0}):
            out[want] = cupc.skeleton(C, th, 3, device="cpu", stats=stats)
            # the cost model sends a lone hub local
            assert cupc._l1_route_local(np.array([n_z + 5]), 256) == (want == "local")
        assert stats["level_route"][1] == want
    with _gates(jc, {"L1_LOCAL_COST_RATIO": BIG}):
        ref = jc.skeleton(C, th, 3)
    for got in out.values():
        np.testing.assert_array_equal(got.G, ref.G)
        np.testing.assert_array_equal(got.sepset, ref.sepset)
    assert np.array_equal(out["local"].pmax.view(np.int32), out["dense"].pmax.view(np.int32))


@pytest.mark.parametrize("seed", range(6))
def test_l1_route_gate_matches_jax(seed):
    """The gate decides as the JAX package's for the same attribute values."""
    from cigwas_tpu.skeleton import cupc as jc
    from cigwas_tpu_torch.skeleton import cupc

    rng = np.random.default_rng(seed)
    deg = rng.integers(0, 300, size=rng.integers(1, 400))
    deg[rng.random(deg.size) < 0.01] = 3000
    for width, ratio in ((128, 16), (0, 16), (64, 1), (256, 1 << 20)):
        for vp in (128, 1024, 11008):
            with _gates(cupc, {"L1_LOCAL_MAX_WIDTH": width, "L1_LOCAL_COST_RATIO": ratio}), \
                    _gates(jc, {"L1_LOCAL_MAX_WIDTH": width, "L1_LOCAL_COST_RATIO": ratio}):
                assert cupc._l1_route_local(deg, vp) == jc._l1_route_local(deg, vp)


def _hetcor_case(seed: int, v: int = 14):
    """tests/test_hetcor_property.py's inputs: a random correlation panel
    of v variables from n samples, a per-pair ESS with NaN holes, a time
    index in {0, 1}."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(2000, 8000))
    X = rng.normal(size=(v, n))
    for i in range(1, v):
        X[i] += 0.6 * X[rng.integers(0, i)]
    C = np.corrcoef(X).astype(np.float32)
    N = rng.uniform(0.5 * n, n, size=(v, v)).astype(np.float32)
    N = (N + N.T) / 2
    hole = np.triu(rng.random((v, v)) < 0.1, 1)
    N[hole | hole.T] = np.nan
    return C, N, rng.integers(0, 2, size=v).astype(np.int32)


@pytest.mark.parametrize("ess_mode", ["reference", "float"])
@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("route", ["list", "dense", "combinatorial"])
def test_hetcor_route_matches_jax_and_the_default(route, seed, ess_mode):
    from cigwas_tpu.skeleton import cupc as jc
    from cigwas_tpu_torch.skeleton import cupc

    C, N, t = _hetcor_case(seed)
    th = hetcor_threshold(1e-3)
    G0 = np.ones(C.shape, np.int32)
    stats = {}
    with _port(route):
        got = cupc.hetcor_skeleton(C, G0, N, th, 3, time_index=t, ess_mode=ess_mode,
                                   device="cpu", stats=stats)
    assert stats["level_route"][1] == WANT[route]
    with _jax(route):
        ref = jc.hetcor_skeleton(C, G0, N, th, 3, time_index=t, ess_mode=ess_mode)
    with _port("list"):
        default = cupc.hetcor_skeleton(C, G0, N, th, 3, time_index=t, ess_mode=ess_mode,
                                       device="cpu")
    np.testing.assert_array_equal(got.G, ref.G)
    np.testing.assert_array_equal(got.G, default.G)
    assert got.final_level == ref.final_level


# the gates of the hetcor device levels' cases: level 1's route, and the
# levels 2-3 left to the local sweep; the first level each hands over at
HETCOR_L1 = {
    "list": {"L1_LOCAL_MAX_WIDTH": BIG},
    "dense": {"L1_LOCAL_MAX_WIDTH": 0, "L1_LOCAL_COST_RATIO": BIG},
    "combinatorial": {"L1_LOCAL_MAX_WIDTH": 0, "L1_LOCAL_COST_RATIO": BIG, "DENSE_L1_MAX": 0},
}
HANDOVER = {(2, 3): 4, (2,): 3, (): 2}


def _hetcor_three_ways(C, G0, N, t, lmax, ess_mode, gates):
    """(device path, host path under the same gates, the host path's list
    route, JAX under the same gates), each (result, stats). The host path
    is an engine's: one CPU shard."""
    from cigwas_tpu.skeleton import cupc as jc
    from cigwas_tpu_torch.parallel.sharded import ShardedEngine
    from cigwas_tpu_torch.skeleton import cupc

    th = hetcor_threshold(1e-3)
    out = []
    for ctx, engine in ((_gates(cupc, gates), None),
                        (_gates(cupc, gates), ShardedEngine.flat(["cpu"])),
                        (_port("list"), ShardedEngine.flat(["cpu"]))):
        stats = {}
        with ctx:
            out.append((cupc.hetcor_skeleton(C, G0, N, th, lmax, time_index=t,
                                             ess_mode=ess_mode, device="cpu", stats=stats,
                                             engine=engine), stats))
    with _gates(jc, {**gates, "DEV_RESIDENT_MAX": 0}):
        out.append((jc.hetcor_skeleton(C, G0, N, th, lmax, time_index=t, ess_mode=ess_mode),
                    None))
    return out


@pytest.mark.parametrize("max_level", [3, 14])
@pytest.mark.parametrize("local_levels", sorted(HANDOVER))
@pytest.mark.parametrize("l1", sorted(HETCOR_L1))
@pytest.mark.parametrize("ess_mode", ["reference", "float"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_hetcor_device_levels_match_the_host_path_and_jax(seed, ess_mode, l1, local_levels,
                                                          max_level):
    """The hetcor levels with the adjacency on the device hand over to the
    host loop at level 1 (a combinatorial level 1), 2, 3 or 4 (LOCAL_LEVELS)
    and decide what the host path and the JAX package decide: the same
    adjacency, final level, routes and ci_tests; device_levels names level
    0 through the last level before the hand-over that ran."""
    C, N, t = _hetcor_case(seed, v=24)  # wide enough for one-sided hits at levels 2-3
    gates = {**HETCOR_L1[l1], "LOCAL_LEVELS": local_levels}
    (dev, sd), (host, sh), (listed, sl), (ref, _) = _hetcor_three_ways(
        C, np.ones(C.shape, np.int32), N, t, max_level, ess_mode, gates)
    for other in (host, listed, ref):
        np.testing.assert_array_equal(dev.G, other.G)
        assert dev.final_level == other.final_level
    assert sd["level_route"] == sh["level_route"]
    assert sd.get("ci_tests", 0) == sh.get("ci_tests", 0)
    handover = 1 if l1 == "combinatorial" else HANDOVER[local_levels]
    last = min(handover - 1, 3, dev.final_level)
    assert sd["device_levels"] == list(range(last + 1))
    assert sh["device_levels"] == sl["device_levels"] == []
    assert "l0_adjacency" not in sd["d2h_bytes"]


def test_hetcor_device_levels_honour_the_incoming_adjacency():
    """Level 0 on the device only deletes: an edge absent from the incoming G
    (symmetric holes, and a few one-sided ones) stays absent, the incoming
    array is left as it was, and the skeleton is the host path's and JAX's."""
    C, N, t = _hetcor_case(5)
    rng = np.random.default_rng(5)
    G0 = (rng.random(C.shape) < 0.6).astype(np.int32)
    G0 = G0 | G0.T
    G0[2, 7] = G0[9, 1] = 0
    before = G0.copy()
    (dev, sd), (host, _), (listed, _), (ref, _) = _hetcor_three_ways(
        C, G0, N, t, 14, "reference", {})
    np.testing.assert_array_equal(G0, before)
    assert sd["device_levels"][:2] == [0, 1]
    for other in (host, listed, ref):
        np.testing.assert_array_equal(dev.G, other.G)
        assert dev.final_level == other.final_level
    assert not (dev.G & ~G0).any()


@pytest.mark.parametrize("kind", ["hetcor", "block"])
def test_hetcor_device_levels_fetch_the_adjacency_once(kind):
    """On the default gates the device levels of either skeleton fetch the
    degrees, each level's hits (the block's loop: x, y and the sepset's l
    variables, int32) and the final adjacency alone: no level-0 adjacency
    or deletion mask. The block's pMax adds the level-0 adjacency of the
    real variables, the panel and the hits' rho."""
    from cigwas_tpu_torch.skeleton import cupc

    vp = 128
    if kind == "hetcor":
        C, N, t = _hetcor_case(1)
        stats = {}
        res = cupc.hetcor_skeleton(C, np.ones(C.shape, np.int32), N, hetcor_threshold(1e-3),
                                   3, time_index=t, device="cpu", stats=stats)
        assert stats["device_levels"] == list(range(res.final_level + 1))
        runs = [(stats, res, 0, {"final_adjacency", "loop_lists"})]
    else:
        C, th, _ = PANELS["factor0"]
        runs = []
        for want in (False, True):
            stats = {}
            res = cupc.skeleton(C, th, 3, device="cpu", stats=stats, want_pmax=want)
            assert set(stats["level_route"].values()) == {"device_loop"}
            sites = {"final_adjacency", "loop_lists"}
            if want:
                sites |= {"l0_adjacency", "pmax_panel"}
                assert stats["d2h_bytes"]["l0_adjacency"] == C.shape[0] ** 2
            width = (res.sepset != -1).sum(axis=2)
            hit_bytes = sum(int((width == l).sum()) * 4 * (2 + l + want) for l in (1, 2, 3))
            runs.append((stats, res, hit_bytes, sites))
    for stats, res, hit_bytes, sites in runs:
        assert stats["d2h_bytes"]["final_adjacency"] == vp * vp
        assert set(stats["d2h_bytes"]) == sites
        # one degree fetch a level, and one more where the graph ran out of tests
        degrees = 4 * vp * min(res.final_level + 1, 3)
        assert stats["d2h_bytes"]["loop_lists"] == degrees + hit_bytes


@pytest.mark.parametrize("chunk", [16, 64])
def test_chunk_of_the_combinatorial_route(chunk):
    """A smaller chunk gives the default chunk's result, and the JAX
    skeleton's under the same chunk."""
    from cigwas_tpu.skeleton import cupc as jc
    from cigwas_tpu_torch.skeleton import cupc

    C, th, lmax = PANELS["factor2"]
    with _port("combinatorial"):
        got = cupc.skeleton(C, th, lmax, device="cpu", chunk=chunk)
        default = cupc.skeleton(C, th, lmax, device="cpu")
    with _jax("combinatorial"):
        ref = jc.skeleton(C, th, lmax, chunk=chunk)
    np.testing.assert_array_equal(got.G, ref.G)
    np.testing.assert_array_equal(got.sepset, ref.sepset)
    _assert_same(got, default, pmax_exact=False)


def _two_block_fileset(tmp_path):
    """(stem, .blocks path) of a 60-marker, 2-trait fileset in two blocks."""
    from torch_parity import std, write_plink

    from cigwas_tpu_torch.io import MarkerBlock, write_marker_blocks_to_file
    from cigwas_tpu_torch.prep import prep_bed

    rng = np.random.default_rng(12)
    n, m = 2000, 60
    G = (rng.random((m, n)) < 0.3).astype(np.float32) + (rng.random((m, n)) < 0.3)
    y0 = 0.5 * std(G[5]) + 0.4 * std(G[40]) + rng.normal(size=n)
    y1 = 0.5 * std(G[20]) + 0.3 * y0 + rng.normal(size=n)
    Y = np.stack([y0, y1])
    Y = (Y - Y.mean(1, keepdims=True)) / Y.std(1, keepdims=True)
    stem = str(tmp_path / "sim")
    write_plink(stem, G, Y)
    prep_bed(stem)
    blocks = stem + ".blocks"
    write_marker_blocks_to_file([MarkerBlock("1", 0, 29), MarkerBlock("1", 30, 59)], blocks)
    return stem, blocks


def test_cusk_context_blocks_equal_fresh_contexts(tmp_path):
    """Two blocks through one CuskContext write what a fresh context
    writes for each."""
    from cigwas_tpu_torch.pipelines import CuskContext

    stem, blocks = _two_block_fileset(tmp_path)
    out_a, out_b = tmp_path / "a", tmp_path / "b"
    out_a.mkdir()
    out_b.mkdir()
    ctx = CuskContext(stem + ".phen", stem, blocks, 1e-3, 3, 14, 1, str(out_a), verbose=False,
                      device="cpu")
    for bi in (0, 1):
        assert ctx.finish(ctx.prepare(bi)) is not None
    for bi in (0, 1):
        fresh = CuskContext(stem + ".phen", stem, blocks, 1e-3, 3, 14, 1, str(out_b),
                            verbose=False, device="cpu")
        fresh.finish(fresh.prepare(bi))
    names = sorted(p.name for p in out_a.iterdir())
    assert names == sorted(p.name for p in out_b.iterdir()) and len(names) == 10
    for name in names:
        assert (out_a / name).read_bytes() == (out_b / name).read_bytes(), name


def test_cusk_pipeline_builds_no_dense_sepset(tmp_path, monkeypatch):
    """CuskContext.finish reduces both stages' sepset records without ever
    building a dense (n, n, depth) sepset, and writes the sepsets that the
    dense arrays give: each stage's result, materialised afterwards and
    reduced, is the written .sep."""
    from cigwas_tpu_torch.io import make_path
    from cigwas_tpu_torch.io.results import ReducedGCS
    import sys

    from cigwas_tpu_torch.pipelines import CuskContext
    from cigwas_tpu_torch.skeleton import cupc
    from cigwas_tpu_torch.skeleton import reduce as red

    stem, blocks = _two_block_fileset(tmp_path)
    results = []

    def recording_skeleton(*args, **kwargs):
        results.append(cupc.skeleton(*args, **kwargs))
        return results[-1]

    def no_dense(self):
        raise AssertionError("a dense sepset was built")

    monkeypatch.setattr(sys.modules["cigwas_tpu_torch.pipelines.cusk"], "skeleton",
                        recording_skeleton)
    ctx = CuskContext(stem + ".phen", stem, blocks, 1e-3, 3, 14, 1, str(tmp_path), verbose=False,
                      device="cpu")
    with monkeypatch.context() as m:
        m.setattr(cupc.SepsetRecords, "dense", no_dense)
        stats: dict = {}
        gcs2 = ctx.finish(ctx.prepare(0), stats=stats)
    assert gcs2 is not None and len(results) == 2
    assert all(r._dense is None for r in results)
    assert len(results[1].records) > 0  # stage 2 removed pairs with a separating set
    # the written sepsets are those of the dense arrays, reduced as the JAX package reduces
    from cigwas_tpu.skeleton.reduce import reduce_gcs as jax_reduce

    res1, res2 = results
    num_var = res1.G.shape[0]
    keep = red.subset_variables(res1.G, num_var, num_var - 2, 1)
    gcs1 = jax_reduce(res1.G, np.zeros((num_var, num_var), np.float32), res1.sepset, keep,
                      num_var, 2, 3)
    keep2 = red.subset_variables(res2.G, gcs1.num_var, gcs1.num_var - 2, 1)
    exp = jax_reduce(res2.G, np.zeros((gcs1.num_var,) * 2, np.float32), res2.sepset, keep2,
                     gcs1.num_var, 2, 14)
    np.testing.assert_array_equal(gcs2.S, exp.S)
    written = ReducedGCS.from_file(make_path(str(tmp_path), ctx.blocks[0].to_file_string(), ""))
    np.testing.assert_array_equal(written.S, exp.S)


def test_device_loop_scatters_only_the_hits():
    """The loop's hit scatter: pad slots hold index 0, so a node with pads
    and a hit elsewhere must not remove or keep the (x, 0) edge by the pads'
    writes. A star around variable 0 keeps every (x, 0) edge whose own test
    does not remove it."""
    from cigwas_tpu_torch.skeleton import cupc

    rng = np.random.default_rng(8)
    X = rng.normal(size=(30, 5000))
    X[1:] += 0.5 * X[0]
    X[10:20] += 0.6 * X[5]
    C = np.corrcoef(X).astype(np.float32)
    th = threshold_array(5000, 1e-3)
    with _port("device_loop"):
        got = cupc.skeleton(C, th, 3, device="cpu")
    with _port("list"):
        default = cupc.skeleton(C, th, 3, device="cpu")
    _assert_same(got, default, pmax_exact=True)
    assert got.G[0].sum() > 5


def test_default_gates_take_the_loop_before_the_dense_level1():
    """Under the default gates a panel within the loop's size and width
    takes the loop on one card even where the level-1 gate says dense; the
    hetcor skeleton takes the dense level 1 there, with its adjacency on
    the device."""
    from cigwas_tpu_torch.skeleton import cupc

    C, th, lmax = PANELS["ar1"]
    stats = {}
    with _gates(cupc, {"L1_LOCAL_MAX_WIDTH": 0, "L1_LOCAL_COST_RATIO": BIG}):
        got = cupc.skeleton(C, th, lmax, device="cpu", stats=stats)
        Ch, N, t = _hetcor_case(0)
        hstats = {}
        cupc.hetcor_skeleton(Ch, np.ones(Ch.shape, np.int32), N, hetcor_threshold(1e-3), 3,
                             time_index=t, device="cpu", stats=hstats)
    assert C.shape[0] <= cupc.DEV_RESIDENT_MAX
    assert set(stats["level_route"].values()) == {"device_loop"}
    assert hstats["level_route"][1] == "dense"
    assert hstats["device_levels"][:2] == [0, 1]
    with _port("list"):
        ref = cupc.skeleton(C, th, lmax, device="cpu")
    _assert_same(got, ref, pmax_exact=True)


def test_level_route_names_every_route():
    from cigwas_tpu_torch.skeleton import cupc

    deg = np.array([3, 200, 5])
    with _gates(cupc, {"L1_LOCAL_MAX_WIDTH": 128, "L1_LOCAL_COST_RATIO": BIG,
                       "DENSE_L1_MAX": 512, "LOCAL_LEVELS": (2,)}):
        assert cupc._level_route(1, deg, 256) == "dense"
        assert cupc._level_route(1, deg, 1024) == "combinatorial"
        assert cupc._level_route(2, deg, 256) == "local"
        assert cupc._level_route(3, deg, 256) == "combinatorial"
        assert cupc._level_route(4, deg, 256) == "combinatorial"
        assert cupc._level_route(1, np.array([3, 5]), 1024) == "local"


@pytest.mark.cuda
@pytest.mark.parametrize("route", sorted(PORT_ROUTES))
def test_card_routes_equal_the_cpu(route):
    """On the card: each route's skeleton equals the CPU's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the routes' kernels have no CPU build")
    from cigwas_tpu_torch.skeleton import cupc

    C, th, lmax = PANELS["factor0"]
    with _port(route):
        got = cupc.skeleton(C, th, lmax, device="cuda")
        ref = cupc.skeleton(C, th, lmax, device="cpu")
    np.testing.assert_array_equal(got.G, ref.G)
    np.testing.assert_array_equal(got.sepset, ref.sepset)


@pytest.mark.cuda
@pytest.mark.parametrize("route", sorted(PORT_ROUTES))
def test_card_routes_count_the_cpus_tests(route):
    """On the card: each route's ci_tests, of both skeletons, equals the
    CPU's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the routes' kernels have no CPU build")
    from cigwas_tpu_torch.skeleton import cupc

    C, th, lmax = PANELS["factor0"]
    Ch, N, t = _hetcor_case(0)
    counts = {}
    for dev in ("cuda", "cpu"):
        stats, hstats = {}, {}
        with _port(route):
            cupc.skeleton(C, th, lmax, device=dev, stats=stats)
            cupc.hetcor_skeleton(Ch, np.ones(Ch.shape, np.int32), N, hetcor_threshold(1e-3),
                                 14, time_index=t, device=dev, stats=hstats)
        counts[dev] = (stats["ci_tests"], hstats.get("ci_tests", 0))
    assert counts["cuda"] == counts["cpu"] and counts["cpu"][0] > 0
