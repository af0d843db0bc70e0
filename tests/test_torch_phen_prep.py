"""The port's `phen_prep` against the JAX package's (pandas) on the same
files: the merged `.phen` must be byte-identical, and both must refuse the
same inputs."""

import numpy as np
import pytest

from cigwas_tpu import phen_prep as jax_pp
from cigwas_tpu_torch import phen_prep as pp
from cigwas_tpu_torch.io.tables import _xstrtod

N = 40


def _ids(style: str, rng):
    """FID and IID columns of N samples."""
    if style == "string":
        return [f"F{i}" for i in range(N)], [f"I{i}" for i in range(N)]
    if style == "numeric":
        return [str(1000 + i) for i in range(N)], [str(5 + 3 * i) for i in range(N)]
    if style == "leading_zeros":  # read as integers: 007 is 7 in both files
        return [f"{i:04d}" for i in range(N)], [f"{7 * i:05d}" for i in range(N)]
    if style == "mixed":  # one non-numeric IID keeps the column as strings
        iid = [f"{i:03d}" for i in range(N)]
        iid[3] = "x3"
        return [str(i) for i in range(N)], iid
    raise ValueError(style)


def _standardized(rng, k):
    Y = rng.normal(size=(k, N))
    return (Y - Y.mean(1, keepdims=True)) / Y.std(1, ddof=1, keepdims=True)


def _write_fam(path, fid, iid):
    with open(path, "w") as f:
        for a, b in zip(fid, iid):
            f.write(f"{a} {b} 0 0 1 -9\n")


def _write_phen(path, header, fid, iid, cols, order=None, fmt="{:.6f}"):
    """A space-separated phenotype file: header[0:2] name the ID columns
    (FID/IID in that order unless header[0] names the IID), cols are lists
    of tokens or floats, rows in `order`."""
    order = range(N) if order is None else order
    iid_first = header[0].upper() in ("IID", "EID")
    with open(path, "w") as f:
        f.write(" ".join(header) + "\n")
        for i in order:
            ids = [iid[i], fid[i]] if iid_first else [fid[i], iid[i]]
            vals = [v[i] if isinstance(v[i], str) else fmt.format(v[i]) for v in cols]
            f.write(" ".join(ids + vals) + "\n")


def _merge_both(tmp_path, phenos, fam):
    out_t, out_j = str(tmp_path / "torch.phen"), str(tmp_path / "jax.phen")
    pp.make_merged_pheno_file([pp.PhenotypesFile(*p) for p in phenos], fam, out_t)
    jax_pp.make_merged_pheno_file([jax_pp.PhenotypesFile(*p) for p in phenos], fam, out_j)
    got, exp = open(out_t, "rb").read(), open(out_j, "rb").read()
    assert got == exp, (got[:300], exp[:300])
    return got


@pytest.mark.parametrize("ids", ["string", "numeric", "leading_zeros", "mixed"])
@pytest.mark.parametrize("headers", [("FID", "IID"), ("IID", "FID"), ("EID", "FID"),
                                     ("fid", "eid")])
def test_merged_file_matches_jax(tmp_path, ids, headers):
    """Two files, the second in another row order and missing two samples."""
    rng = np.random.default_rng(len(ids) + 7 * len(headers[0]))
    fid, iid = _ids(ids, rng)
    fam = str(tmp_path / "s.fam")
    _write_fam(fam, fid, iid)
    a = str(tmp_path / "a.txt")
    _write_phen(a, [*headers, "T0", "T1"], fid, iid, list(_standardized(rng, 2)))
    b = str(tmp_path / "b.txt")
    order = [i for i in rng.permutation(N) if i not in (4, 17)]
    _write_phen(b, [*headers, "U0", "U1", "U2"], fid, iid, list(_standardized(rng, 3)),
                order=order)
    text = _merge_both(tmp_path, [(a, ["T0", "T1"]), (b, ["U2", "U0"])], fam)
    assert text.count(b"\tnan") == 4  # two samples x two traits of the second file


def test_integer_trait_column(tmp_path):
    """An all-integer trait column stays int64 (written as integers) unless
    the alignment brings missing samples, which make it float (``1.0``)."""
    rng = np.random.default_rng(1)
    fid, iid = _ids("string", rng)
    fam = str(tmp_path / "s.fam")
    _write_fam(fam, fid, iid)
    ints = [str(1 if i % 2 else -1) for i in range(N)]
    a, b = str(tmp_path / "a.txt"), str(tmp_path / "b.txt")
    _write_phen(a, ["FID", "IID", "B0", "Y0"], fid, iid, [ints, _standardized(rng, 1)[0]])
    _write_phen(b, ["FID", "IID", "B1"], fid, iid, [ints], order=range(1, N))
    text = _merge_both(tmp_path, [(a, ["B0", "Y0"]), (b, ["B1"])], fam)
    lines = text.decode().splitlines()
    assert lines[1].split("\t")[2] == "-1" and lines[1].split("\t")[4] == "nan"
    assert lines[2].split("\t")[4] == "1.0"


def test_seventeen_digit_floats_and_missing_tokens(tmp_path):
    """Values written with 17 significant digits (parsed by pandas' own
    float parser, not always the correctly rounded double), exponents,
    infinities' neighbours and pandas' missing-value tokens."""
    rng = np.random.default_rng(2)
    fid, iid = _ids("numeric", rng)
    fam = str(tmp_path / "s.fam")
    _write_fam(fam, fid, iid)
    Y = _standardized(rng, 3)
    cols = [[f"{v:.17g}" for v in Y[0]], [f"{v:.10e}" for v in Y[1]],
            [repr(float(v)) for v in Y[2]]]
    for j, tok in enumerate(["NA", "nan", "NaN", "", "n/a", "null"]):
        cols[j % 3][j + 1] = tok
    a = str(tmp_path / "a.txt")
    _write_phen(a, ["FID", "IID", "A", "B", "C"], fid, iid, cols)
    _merge_both(tmp_path, [(a, ["A", "B", "C"])], fam)


def test_xstrtod_matches_pandas():
    """The float parser against pandas' on 17-digit, 6-digit, tiny, huge
    and subnormal values, and tokens that are not floats."""
    import io

    import pandas as pd

    rng = np.random.default_rng(3)
    x = rng.normal(size=3000)
    toks = ([f"{v:.17g}" for v in x] + [f"{v:.6f}" for v in x] + [repr(float(v)) for v in x]
            + [f"{v:.17g}" for v in x * 1e-7] + [f"{v:.20g}" for v in x * 1e9]
            + [f"{v:.3e}" for v in x[:300] * 1e-300]
            + ["1.", "-.5", "+3.25", ".5e3", "1e5", "2E-3", "123456789012345678901234",
               "0.000000000000000000000000012345678901234567890", "1e400", "-1e400", "-1e-700"])
    exp = pd.read_csv(io.StringIO("a\n" + "\n".join(toks) + "\n"))["a"].to_numpy()
    got = np.array([_xstrtod(t) for t in toks])
    assert np.array_equal(got.view(np.int64), exp.view(np.int64))
    for tok in ("1e", "e5", "1.2.3", "0x10", "--1", "1_0", "."):
        assert _xstrtod(tok) is None


def test_three_column_file_renamed(tmp_path):
    """A file with one trait column takes the requested name."""
    rng = np.random.default_rng(4)
    fid, iid = _ids("string", rng)
    fam = str(tmp_path / "s.fam")
    _write_fam(fam, fid, iid)
    a = str(tmp_path / "a.txt")
    _write_phen(a, ["IID", "FID", "whatever"], fid, iid, list(_standardized(rng, 1)))
    text = _merge_both(tmp_path, [(a, ["height"])], fam)
    assert text.startswith(b"FID\tIID\theight\n")


def test_merge_phenos_returns_columns(tmp_path):
    rng = np.random.default_rng(5)
    fid, iid = _ids("string", rng)
    fam = str(tmp_path / "s.fam")
    _write_fam(fam, fid, iid)
    Y = _standardized(rng, 2)
    a = str(tmp_path / "a.txt")
    _write_phen(a, ["FID", "IID", "T0", "T1"], fid, iid, list(Y), order=range(N - 1, -1, -1))
    merged = pp.merge_phenos([pp.PhenotypesFile(a, ["T1", "T0"])], fam)
    assert merged.fid == fid and merged.iid == iid and merged.names == ["T1", "T0"]
    np.testing.assert_allclose(merged.columns[0], Y[1], atol=5e-7)
    np.testing.assert_allclose(merged.columns[1], Y[0], atol=5e-7)


@pytest.mark.parametrize("fault", ["scaled", "shifted", "bad_header", "duplicate_ids"])
def test_refusals_match_jax(tmp_path, fault):
    rng = np.random.default_rng(6)
    fid, iid = _ids("string", rng)
    fam = str(tmp_path / "s.fam")
    _write_fam(fam, fid, iid)
    Y = _standardized(rng, 2)
    header = ["FID", "IID", "T0", "T1"]
    if fault == "scaled":
        Y[1] *= 1.5
    elif fault == "shifted":
        Y[0] += 0.3
    elif fault == "bad_header":
        header = ["ID", "IID", "T0", "T1"]
    elif fault == "duplicate_ids":
        iid = list(iid)
        iid[1] = iid[0]
    a = str(tmp_path / "a.txt")
    _write_phen(a, header, fid, iid, list(Y))
    for mod in (pp, jax_pp):
        with pytest.raises(ValueError):
            mod.make_merged_pheno_file([mod.PhenotypesFile(a, ["T0", "T1"])], fam,
                                       str(tmp_path / "out.phen"))


def test_is_standardized_matches_jax(tmp_path):
    import pandas as pd

    rng = np.random.default_rng(7)
    for scale, shift in ((1.0, 0.0), (1.05, 0.05), (1.2, 0.0), (1.0, -0.2)):
        Y = _standardized(rng, 3) * scale + shift
        Y[0, 3] = np.nan
        cols = {f"T{k}": Y[k] for k in range(3)}
        assert pp.is_standardized(cols) == jax_pp.is_standardized(pd.DataFrame(cols))
