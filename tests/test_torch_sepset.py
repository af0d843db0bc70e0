"""The skeleton's sepset records (`skeleton/cupc.py::SepsetRecords`) against
the dense (n, n, depth) sepset they replace: the records' dense array is
the one that writing each record in turn gives, the reduction of the
records (`skeleton/reduce.py::reduce_gcs`) is the JAX package's reduction of
that dense array bit for bit, and a dense array taken as records comes back
unchanged.
"""

import numpy as np
import pytest

from torch_parity import set_threads

from cigwas_tpu.constants import ML
from cigwas_tpu.skeleton.reduce import reduce_gcs as jax_reduce

set_threads()

N = 40


def _appends(rng, levels, per_level, n=N, gaps=False):
    """[(l, xs, ys, sep)]: per_level random ordered pairs a level, each set
    l distinct variables other than x and y (a -1 in place of some of them
    with gaps)."""
    out = []
    for l in levels:
        xs = rng.integers(0, n, per_level)
        ys = (xs + rng.integers(1, n, per_level)) % n
        sep = np.stack([rng.choice(np.setdiff1d(np.arange(n), [x, y]), l, replace=False)
                        for x, y in zip(xs, ys)]).astype(np.int32)
        if gaps:
            sep[rng.random(sep.shape) < 0.3] = -1
        out.append((l, xs, ys, sep))
    return out


def _case(name):
    """(appends, depth, keep, max_level) of a case."""
    rng = np.random.default_rng(CASES.index(name))
    half = np.sort(rng.choice(N, N // 2, replace=False))
    if name == "levels1to3_depth3":
        return _appends(rng, (1, 2, 3), 60), 3, half, 3
    if name == "levels1to14_depth14":
        return _appends(rng, range(1, 15), 25), 14, half, ML
    if name == "depth3_into_ml":  # stage 1's records at stage 2's stride
        return _appends(rng, (1, 2, 3), 60), 3, half, ML
    if name == "depth14_cut_to_3":
        return _appends(rng, (2, 4, 9, 14), 40), 14, half, 3
    if name == "gaps":
        return _appends(rng, (1, 3, 5), 50, gaps=True), 5, half, 5
    if name == "pair_written_twice":
        first = _appends(rng, (2,), 80)
        (l, xs, ys, _), = first
        again = _appends(rng, (1, 3), 40)
        # the same ordered pairs again, at other levels, and twice within one append
        again[0] = (1, np.concatenate([xs[:20], xs[:5]]), np.concatenate([ys[:20], ys[:5]]),
                    np.concatenate([again[0][3][:20], again[0][3][20:25]]))
        again[1] = (3, xs[10:30], ys[10:30], again[1][3][:20])
        return first + again, 3, half, 3
    if name == "all_variables_dropped":
        keep = np.arange(5, dtype=np.int32)
        return _appends(rng, (1, 2), 200, n=N), 3, keep, 3
    if name == "empty_keep":
        return _appends(rng, (1, 2, 3), 30), 3, np.empty(0, np.int32), 3
    if name == "no_records":
        return [], 3, half, ML
    raise KeyError(name)


CASES = ["levels1to3_depth3", "levels1to14_depth14", "depth3_into_ml", "depth14_cut_to_3",
         "gaps", "pair_written_twice", "all_variables_dropped", "empty_keep", "no_records"]


@pytest.mark.parametrize("name", CASES)
def test_records_reduce_as_the_dense_sepset(name):
    from cigwas_tpu_torch.skeleton import reduce_gcs
    from cigwas_tpu_torch.skeleton.cupc import SepsetRecords

    appends, depth, keep, max_level = _case(name)
    stats: dict = {}
    rec = SepsetRecords(N, depth, stats)
    S = np.full((N, N, depth), -1, dtype=np.int32)
    for l, xs, ys, sep in appends:
        rec.append(l, xs, ys, sep)
        for x, y, s in zip(xs, ys, sep):  # the dense buffer's writes, one pair at a time
            S[x, y, l:] = -1
            S[x, y, :l] = s
    assert stats["sepset_records"] == len(rec) == sum(xs.size for _, xs, _, _ in appends)
    np.testing.assert_array_equal(rec.dense(), S)
    np.testing.assert_array_equal(SepsetRecords.from_dense(S).dense(), S)

    G = (np.random.default_rng(1).random((N, N)) < 0.2).astype(np.int32)
    C = np.random.default_rng(2).random((N, N)).astype(np.float32)
    exp = jax_reduce(G, C, S, keep, N, 2, max_level)
    got = reduce_gcs(G, C, rec, keep, N, 2, max_level)
    from_dense = reduce_gcs(G, C, S, keep, N, 2, max_level)
    for red in (got, from_dense):
        assert red.S.dtype == np.int32 and red.S.shape == exp.S.shape
        np.testing.assert_array_equal(red.S, exp.S)
        np.testing.assert_array_equal(red.G, exp.G)
        np.testing.assert_array_equal(red.C, exp.C)
    kept = np.zeros(N, bool)
    kept[keep] = True
    in_corner = {(int(x), int(y)) for _, xs, ys, _ in appends for x, y in zip(xs, ys)
                 if kept[x] and kept[y]}
    assert stats["sepset_kept"] == len(in_corner) <= stats["sepset_records"]


@pytest.mark.parametrize("panel", ["ar1_l3", "factor_l6"])
def test_skeleton_records_reduce_as_the_jax_sepset(panel):
    """A skeleton's own records (levels 1-3 on the device loop, levels >= 4
    on the combinatorial route) reduce to what the JAX package's reduction
    makes of the JAX skeleton's dense sepset, and their dense view is that
    sepset; the reduction never builds the dense array."""
    import jax.numpy as jnp

    from cigwas_tpu.skeleton import skeleton as jax_skeleton
    from cigwas_tpu.utils.stats import threshold_array
    from cigwas_tpu_torch.skeleton import reduce_gcs, skeleton, subset_variables

    from test_torch_skeleton import _factor_panel
    from torch_parity import ar1_panel

    if panel == "ar1_l3":
        v, n, lmax = 96, 900, 3
        C = ar1_panel(7, v, n, 128)[:v, :v]
    else:
        v, n, lmax = 60, 2000, 6
        C = _factor_panel(1, v, n)
    th = threshold_array(n, 1e-2)
    stats: dict = {}
    res = skeleton(C, th, lmax, device="cpu", want_pmax=False, stats=stats)
    ref = jax_skeleton(jnp.asarray(C), th, lmax, want_pmax=False)
    keep = subset_variables(res.G, v, v - 4, 2)
    got = reduce_gcs(res.G, C, res.records, keep, v, 4, ML)
    assert res._dense is None and 0 < stats["sepset_kept"] <= stats["sepset_records"]
    exp = jax_reduce(ref.G, C, ref.sepset, keep, v, 4, ML)
    np.testing.assert_array_equal(got.S, exp.S)
    np.testing.assert_array_equal(res.sepset, ref.sepset)
