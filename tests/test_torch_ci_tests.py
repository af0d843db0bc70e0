"""The port's skeleton instrumentation against the JAX package's, on the CPU:
``ci_tests`` (the exact number of (x, S, y) evaluations) equal on every
route of levels 1-3, on the combinatorial levels >= 4 (waves that stop a
node early included), for the hetcor skeleton and for both multi-device
engines; ``preamble_s`` and ``skeleton_wall_s`` ordered as their spans are
nested. The routes are forced by the module attributes the JAX package's
tests patch.
"""

import contextlib
import math

import numpy as np
import pytest

from torch_parity import set_threads

from cigwas_tpu.utils.stats import hetcor_threshold, threshold_array

set_threads()

BIG = 1 << 60
# the gate values that force each route, in both packages
ROUTES = {
    "list": {},
    "device_loop": {"DEV_RESIDENT_MAX": BIG},
    "dense": {"L1_LOCAL_MAX_WIDTH": 0, "L1_LOCAL_COST_RATIO": BIG},
    "combinatorial": {"LOCAL_LEVELS": (), "L1_LOCAL_MAX_WIDTH": 0, "L1_LOCAL_COST_RATIO": BIG,
                      "DENSE_L1_MAX": 0},
}
JAX_ROUTES = {**ROUTES, "list": {"DEV_RESIDENT_MAX": 0}}
LEVEL1 = {"list": "local", "device_loop": "device_loop", "dense": "dense",
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
    return _gates(cupc, {**base, **ROUTES[route]})


def _jax(route: str):
    from cigwas_tpu.skeleton import cupc

    return _gates(cupc, JAX_ROUTES[route])


def _chain_panel(seed: int, v: int, n: int, parents: int):
    """Each variable 0.35 x the sum of up to `parents` earlier ones plus
    noise, scaled to unit variance (the panel stays well conditioned): dense
    enough that levels 2-5 have tests and remove edges."""
    rng = np.random.default_rng(seed)
    X = np.zeros((v, n))
    X[0] = rng.normal(size=n)
    for i in range(1, v):
        ps = rng.choice(i, size=min(i, parents), replace=False)
        X[i] = sum(0.35 * X[p] for p in ps) + rng.normal(size=n)
        X[i] /= X[i].std()
    return np.corrcoef(X).astype(np.float32), threshold_array(n, 0.01)


PANELS = {
    "chain3": _chain_panel(3, 36, 20000, 3),
    "chain4": _chain_panel(5, 32, 20000, 4),
}


def _hetcor_case(seed: int, v: int = 16):
    """A correlation panel of v variables from n samples, a per-pair ESS
    with NaN holes and a time index in {0, 1}."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(3000, 9000))
    X = rng.normal(size=(v, n))
    for i in range(1, v):
        X[i] += 0.6 * X[rng.integers(0, i)] + 0.3 * X[rng.integers(0, i)]
    C = np.corrcoef(X).astype(np.float32)
    N = rng.uniform(0.5 * n, n, size=(v, v)).astype(np.float32)
    N = (N + N.T) / 2
    hole = np.triu(rng.random((v, v)) < 0.1, 1)
    N[hole | hole.T] = np.nan
    return C, N, rng.integers(0, 2, size=v).astype(np.int32)


def _formula(G_levels: list) -> int:
    """sum over levels l >= 2 and nodes of comb(deg, l) * deg, from each
    level's starting degrees."""
    return sum(math.comb(int(d), l) * int(d)
               for l, deg in G_levels if l >= 2 for d in deg if d >= l + 1)


def _assert_walls(stats: dict, preamble: bool) -> None:
    wall = stats["skeleton_wall_s"]
    assert wall >= sum(stats["level_wall_s"].values())
    if preamble:
        assert wall >= stats["preamble_s"] >= 0.0
    else:
        assert "preamble_s" not in stats


@pytest.mark.parametrize("panel", sorted(PANELS))
@pytest.mark.parametrize("route", sorted(ROUTES))
def test_skeleton_ci_tests_equal_jax(route, panel):
    """Every route of levels 1-3, then the combinatorial levels 4-5: the
    port's count equals the JAX package's under the same route."""
    from cigwas_tpu.skeleton import cupc as jc
    from cigwas_tpu_torch.skeleton import cupc

    C, th = PANELS[panel]
    stats, jstats = {}, {}
    with _port(route):
        got = cupc.skeleton(C, th, 5, device="cpu", stats=stats)
    with _jax(route):
        ref = jc.skeleton(C, th, 5, stats=jstats)
    np.testing.assert_array_equal(got.G, ref.G)
    assert stats["level_route"][1] == LEVEL1[route]
    assert max(stats["level_wall_s"]) >= 4, "no level >= 4 ran"
    assert type(stats["ci_tests"]) is int and stats["ci_tests"] > 0
    assert stats["ci_tests"] == jstats["ci_tests"]
    _assert_walls(stats, preamble=True)


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_ci_tests_follow_the_starting_degrees(route):
    """Without early stops the count is sum comb(deg, l) * deg over the
    levels' starting degrees, l >= 2, plus level 1 on the combinatorial
    route (whose scan counts every level it runs, as the JAX package's)."""
    from cigwas_tpu_torch.skeleton import cupc

    C, th = PANELS["chain3"]
    stats = {}
    with _port(route):
        res = cupc.skeleton(C, th, 5, device="cpu", stats=stats)
    lmax = max(stats["level_wall_s"])
    levels = []
    for l in range(1, lmax + 1):
        with _port(route):
            prev = cupc.skeleton(C, th, l - 1, device="cpu")
        levels.append((l, prev.G.sum(axis=1)))
    want = _formula(levels)
    if route == "combinatorial":
        want += sum(int(d) * int(d) for d in levels[0][1] if d >= 2)
    assert res.final_level == lmax
    assert stats["ci_tests"] == want


@pytest.mark.parametrize("chunk", [2, 4])
def test_waves_that_stop_a_node_count_what_they_scanned(chunk):
    """One chunk per launch splits the combinatorial levels into many
    waves, and under a strict threshold from level 2 on a node whose edges
    are all condemned stops early: the count is what the waves scanned, the
    JAX package's, below the full comb(deg, l) * deg."""
    from cigwas_tpu.skeleton import cupc as jc
    from cigwas_tpu_torch.skeleton import cupc

    C, th = _chain_panel(2, 24, 20000, 4)
    th = th.copy()
    th[2:] *= 15
    stats, jstats, full = {}, {}, {}
    with _port("combinatorial"):
        cupc.skeleton(C, th, 5, device="cpu", stats=full, chunk=chunk)
        with _gates(cupc, {"MAX_CHUNKS_PER_LAUNCH": 1}):
            got = cupc.skeleton(C, th, 5, device="cpu", stats=stats, chunk=chunk)
    with _jax("combinatorial"), _gates(jc, {"MAX_CHUNKS_PER_LAUNCH": 1}):
        ref = jc.skeleton(C, th, 5, stats=jstats, chunk=chunk)
    np.testing.assert_array_equal(got.G, ref.G)
    assert stats["ci_tests"] == jstats["ci_tests"]
    assert stats["ci_tests"] < full["ci_tests"]


@pytest.mark.parametrize("ess_mode", ["reference", "float"])
@pytest.mark.parametrize("route", ["list", "dense", "combinatorial"])
def test_hetcor_ci_tests_equal_jax(route, ess_mode):
    from cigwas_tpu.skeleton import cupc as jc
    from cigwas_tpu_torch.skeleton import cupc

    C, N, t = _hetcor_case(1)
    th = hetcor_threshold(1e-3)
    G0 = np.ones(C.shape, np.int32)
    stats, jstats = {}, {}
    with _port(route):
        got = cupc.hetcor_skeleton(C, G0, N, th, 14, time_index=t, ess_mode=ess_mode,
                                   device="cpu", stats=stats)
    with _jax(route):
        ref = jc.hetcor_skeleton(C, G0, N, th, 14, time_index=t, ess_mode=ess_mode,
                                 stats=jstats)
    np.testing.assert_array_equal(got.G, ref.G)
    assert stats["level_route"][1] == LEVEL1[route]
    assert max(stats["level_wall_s"]) >= 4, "no level >= 4 ran"
    assert type(stats["ci_tests"]) is int and stats["ci_tests"] > 0
    assert stats["ci_tests"] == jstats["ci_tests"]
    _assert_walls(stats, preamble=False)


@pytest.mark.parametrize("mode", ["replicated", "rowsharded"])
def test_engines_count_once_per_level(mode):
    """Two shards report the one-device count, for both skeletons."""
    from cigwas_tpu_torch.parallel.sharded import RowShardedEngine, ShardedEngine
    from cigwas_tpu_torch.skeleton import cupc

    engine = {"replicated": ShardedEngine, "rowsharded": RowShardedEngine}[mode]
    C, th = PANELS["chain4"]
    one, two = {}, {}
    with _port("list"):
        a = cupc.skeleton(C, th, 5, device="cpu", stats=one)
        b = cupc.skeleton(C, th, 5, stats=two, engine=engine.flat(["cpu"] * 2))
    np.testing.assert_array_equal(a.G, b.G)
    assert max(two["level_wall_s"]) >= 4
    assert two["ci_tests"] == one["ci_tests"] > 0
    _assert_walls(two, preamble=True)

    Ch, N, t = _hetcor_case(1)
    G0 = np.ones(Ch.shape, np.int32)
    hone, htwo = {}, {}
    with _port("list"):
        cupc.hetcor_skeleton(Ch, G0, N, hetcor_threshold(1e-3), 14, time_index=t,
                             device="cpu", stats=hone)
        cupc.hetcor_skeleton(Ch, G0, N, hetcor_threshold(1e-3), 14, time_index=t,
                             stats=htwo, engine=engine.flat(["cpu"] * 2))
    assert htwo["ci_tests"] == hone["ci_tests"] > 0


def test_count_is_an_exact_python_int_past_int64():
    """comb(152, 14) * 152 is past 2**63: the sum stays exact."""
    from cigwas_tpu_torch.skeleton import cupc

    deg = np.array([152, 152, 151, 14, 3], dtype=np.int64)
    stats = {"ci_tests": 1}
    cupc._count_tests(stats, 14, deg)
    want = 1 + 2 * math.comb(152, 14) * 152 + math.comb(151, 14) * 151
    assert type(stats["ci_tests"]) is int and stats["ci_tests"] == want > 1 << 63
    cupc._count_tests(stats, 14, deg, scanned={0: 7, 3: 1})
    assert stats["ci_tests"] == want + 7 * 152 + 14
    cupc._count_tests(None, 2, deg)  # no stats: nothing to do
