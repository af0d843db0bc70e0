"""The row compaction of the hetcor skeleton's device levels
(`cigwas_tpu_torch/ops/kernels/compact_rows.py`, `csrc/compact_rows.cu`):
its plain version against ``np.nonzero`` on the CPU, the kernel against the
plain version on the card, and the device levels on the card against the
CPU. No jax here: the card tests run where it is not installed
(``python -m pytest tests/test_torch_compact_rows.py -m cuda --noconftest``).
The device levels are held to the host path and the JAX package on the CPU
by tests/test_torch_routes.py."""

import numpy as np
import pytest
import torch

from torch_parity import set_threads

set_threads()


def _expected(G: np.ndarray, rows: np.ndarray, d: int):
    nbrs = np.zeros((len(rows), d), np.int32)
    for i, r in enumerate(rows):
        cols = np.nonzero(G[r])[0][:d]
        nbrs[i, : len(cols)] = cols
    return nbrs, G[rows].sum(axis=1).astype(np.int32)


def _matrix(kind: str, n: int, rng) -> np.ndarray:
    if kind == "random":
        return rng.random((n, n)) < 0.1
    if kind == "empty":
        return np.zeros((n, n), bool)
    if kind == "full":
        return np.ones((n, n), bool)
    G = np.zeros((n, n), bool)  # single edges: one set column a row, at its far end
    G[np.arange(n), (np.arange(n) * 7 + n - 1) % n] = True
    return G


@pytest.mark.parametrize("d", [8, 16, 40])
@pytest.mark.parametrize("kind", ["random", "empty", "full", "single"])
def test_plain_compaction_matches_nonzero(kind, d):
    """Ascending set columns, pads 0, the whole row's count (past d too),
    on rows in any order and repeated."""
    from cigwas_tpu_torch.ops.kernels.compact_rows import compact_rows

    rng = np.random.default_rng(3)
    n = 77
    G = _matrix(kind, n, rng)
    rows = np.concatenate([rng.permutation(n)[:30], [5, 5, n - 1]]).astype(np.int32)
    nbrs, deg = compact_rows(torch.from_numpy(G), torch.from_numpy(rows), d)
    want_nbrs, want_deg = _expected(G, rows, d)
    np.testing.assert_array_equal(nbrs.numpy(), want_nbrs)
    np.testing.assert_array_equal(deg.numpy(), want_deg)
    assert nbrs.dtype == deg.dtype == torch.int32


def test_compaction_refuses_bad_arguments():
    from cigwas_tpu_torch.ops.kernels.compact_rows import compact_rows

    G = torch.zeros((8, 8), dtype=torch.bool)
    rows = torch.arange(8, dtype=torch.int32)
    with pytest.raises(ValueError, match="square bool"):
        compact_rows(G.int(), rows, 8)
    with pytest.raises(ValueError, match="int32"):
        compact_rows(G, rows.long(), 8)
    with pytest.raises(ValueError, match="width"):
        compact_rows(G, rows, 0)
    with pytest.raises(ValueError, match="out of range"):
        compact_rows(G, torch.tensor([8], dtype=torch.int32), 8)
    nbrs, deg = compact_rows(G, rows[:0], 8)
    assert nbrs.shape == (0, 8) and deg.shape == (0,)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1000, 1024, 10112, 77])
@pytest.mark.parametrize("d", [8, 16, 56, 152])
def test_card_compaction_equals_plain(n, d):
    """On the card: the kernel equals the plain version, with 16-byte loads
    (n % 16 == 0) and without (n = 1000 or 77, not multiples of 32), on
    every kind of row."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU build")
    from cigwas_tpu_torch.ops.kernels.compact_rows import compact_rows

    rng = np.random.default_rng(n + d)
    for kind in ("random", "empty", "full", "single"):
        G = torch.from_numpy(_matrix(kind, n, rng))
        rows = torch.from_numpy(rng.permutation(n).astype(np.int32))
        want = compact_rows(G, rows, d)
        got = compact_rows(G.cuda(), rows.cuda(), d)
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w), (kind, n, d)


# the gates of the card's hetcor cases: level 1's route
L1_GATES = {
    "list": {"L1_LOCAL_MAX_WIDTH": 1 << 60},
    "dense": {"L1_LOCAL_MAX_WIDTH": 0, "L1_LOCAL_COST_RATIO": 1 << 60},
}


def _hetcor_case(seed: int, v: int):
    """A random correlation panel of v variables from n samples, a per-pair
    ESS with NaN holes, a time index in {0, 1} (tests/test_torch_routes.py's
    cases)."""
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


@pytest.mark.cuda
@pytest.mark.parametrize("local_levels", [(2, 3), (2,), ()])
@pytest.mark.parametrize("l1", sorted(L1_GATES))
def test_card_hetcor_device_levels_equal_the_cpu(l1, local_levels):
    """On the card: the hetcor device levels (compaction, sweeps, in-place
    clears) give the CPU's adjacency, final level, routes and ci_tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU build")
    from cigwas_tpu_torch.skeleton import cupc
    from cigwas_tpu_torch.utils.stats import hetcor_threshold

    gates = {**L1_GATES[l1], "LOCAL_LEVELS": local_levels}
    saved = {k: getattr(cupc, k) for k in gates}
    for seed in range(3):
        C, N, t = _hetcor_case(seed, 40)
        out = {}
        for dev in ("cuda", "cpu"):
            stats = {}
            for k, v in gates.items():
                setattr(cupc, k, v)
            try:
                res = cupc.hetcor_skeleton(C, np.ones(C.shape, np.int32), N,
                                           hetcor_threshold(1e-3), 14, time_index=t,
                                           device=dev, stats=stats)
            finally:
                for k, v in saved.items():
                    setattr(cupc, k, v)
            out[dev] = (res.G, res.final_level, stats["level_route"], stats.get("ci_tests"),
                        stats["device_levels"])
        np.testing.assert_array_equal(out["cuda"][0], out["cpu"][0])
        assert out["cuda"][1:] == out["cpu"][1:]
        assert out["cuda"][4][:2] == [0, 1]
