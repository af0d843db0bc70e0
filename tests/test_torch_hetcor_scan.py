"""The hetcor combinatorial scan's kernel ``csrc/hetcor_scan.cu`` through its
wrapper (`cigwas_tpu_torch.ops.kernels.hetcor_sweep.hetcor_scan`): the
argument checks on the CPU, and on the card the kernel against its plain
version (`cigwas_tpu_torch.ops.pcorr.level_scan_hetcor_pre`) bit for bit.
No jax here: the card tests run where it is not installed
(``python -m pytest tests/test_torch_hetcor_scan.py -m cuda --noconftest``).
The plain version is held to the JAX package by tests/test_torch_hetcor.py,
and the launch plans by tests/test_torch_launch_plan.py."""

import math

import numpy as np
import pytest
import torch

from torch_parity import factor_panel, hetcor_ess, set_threads

from cigwas_tpu_torch.ops import pcorr
from cigwas_tpu_torch.ops.kernels import hetcor_sweep as hs
from cigwas_tpu_torch.ops.kernels.panel_gather import gather_local_panels2
from cigwas_tpu_torch.utils.combinatorics import colex_combinations_chunk
from cigwas_tpu_torch.utils.stats import hetcor_threshold

set_threads()

TH = hetcor_threshold(1e-4)
K = 512


def scan_case(seed: int, l: int, d: int, nt: int, dev: str, max_deg: int | None = None):
    """The arguments of one scan launch as the skeleton makes them: nt nodes
    at bucket width d with degrees up to max_deg (default d; a few nodes of
    degree l and below, which have no test), their panels gathered on dev
    from a factor panel with 10% NaN ESS and time indices 0-2, and the first
    wave of level-l sets (at most 256 chunks of K)."""
    rng = np.random.default_rng(seed)
    hi = min(d, max_deg or d)
    v = max(64, 2 * d + 8)
    C = factor_panel(rng, v)
    N = hetcor_ess(rng, v, 900, 0.1)
    t_ix = rng.integers(0, 3, v).astype(np.int32)
    node_ixs = rng.choice(v, nt, replace=False).astype(np.int32)
    deg = rng.integers(min(l + 1, hi), hi + 1, nt).astype(np.int32)
    deg[: nt // 8] = rng.integers(0, l + 1, nt // 8)
    nbrs = np.zeros((nt, d), np.int32)
    for i, x in enumerate(node_ixs):
        nbrs[i, : deg[i]] = np.sort(rng.choice(np.delete(np.arange(v), x), deg[i], False))
    sets = np.array([math.comb(int(g), l) for g in deg])
    nch = 1 << max(0, math.ceil(math.log2(max(1, -(-int(sets.max()) // K)))))
    nch = min(nch, 256)
    combos = colex_combinations_chunk(0, nch * K, l).reshape(nch, K, l).astype(np.int64)
    totals = np.minimum(sets, nch * K)
    left = np.clip(totals[None, :] - K * np.arange(nch)[:, None], 0, K)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    Ct, Nt, tt, nodes_t, nbrs_t, deg_t = (t(a) for a in (C, N, t_ix, node_ixs, nbrs, deg))
    panels = gather_local_panels2(Ct, Nt, nodes_t, nbrs_t, deg_t)
    return (*panels, tt[nbrs_t.long()].float(), tt[nodes_t.long()].float(), deg_t,
            t(combos), t(left), TH, l)


def test_scan_refuses_bad_arguments():
    """Dtypes, shapes and devices are checked before either route runs; the
    CPU route counts no launch."""
    args = list(scan_case(1, 4, 8, 4, "cpu"))
    before = dict(hs.launches)
    hs.hetcor_scan(*args)
    for i, bad, match in ((6, args[6].long(), "deg"), (7, args[7].int(), "combos_seq"),
                          (8, args[8][:, :2], "left_seq"), (0, args[0].double(), "C_x"),
                          (4, args[4][:, :3], "t_nbrs")):
        with pytest.raises(ValueError, match=match):
            hs.hetcor_scan(*args[:i], bad, *args[i + 1:])
    meta = [a.to("meta") if isinstance(a, torch.Tensor) else a for a in args]
    with pytest.raises(ValueError, match="unsupported device"):
        hs.hetcor_scan(*meta)
    assert hs.launches == before


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU build")


def _bitwise(args):
    hs.reset_launches()
    got = hs.hetcor_scan(*args)
    assert hs.launches["hetcor_scan"] == 1
    want = pcorr.level_scan_hetcor_pre(*args)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32)), (
        f"{int((got.view(torch.int32) != want.view(torch.int32)).sum())} margins differ")
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("l", range(1, 15))
@pytest.mark.parametrize("d", [16, 32])
def test_card_scan_equals_plain_at_the_hubs_widths(l, d):
    """The 10k merged input's stage 2: 16 hubs of degree up to 18 in the
    buckets of width 16 and 32, levels 4-14 (1-3 where the route is
    forced): margins bit for bit, some of them negative."""
    _card()
    got = _bitwise(scan_case(100 + l + d, l, d, 16, "cuda", max_deg=18))
    assert (got < 0).any() or l >= 12


@pytest.mark.cuda
@pytest.mark.parametrize("l", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("d", [64, 128, 256])
def test_card_scan_equals_plain_at_wide_buckets(l, d):
    """Buckets past the staged panels (d > 106-109): panels read through L2
    and the warps' minima in global scratch; a narrow bucket of few sets."""
    _card()
    _bitwise(scan_case(300 + l + d, l, d, 4, "cuda"))


@pytest.mark.cuda
def test_card_scan_refuses_and_counts():
    """A CUDA launch with a wrong dtype raises before launching; every call
    is one launch."""
    _card()
    args = list(scan_case(7, 6, 16, 8, "cuda"))
    hs.reset_launches()
    with pytest.raises(ValueError, match="deg"):
        hs.hetcor_scan(*args[:6], args[6].long(), *args[7:])
    with pytest.raises(ValueError, match="on cuda"):
        hs.hetcor_scan(*args[:7], args[7].cpu(), *args[8:])
    assert hs.launches["hetcor_scan"] == 0
    for n in range(1, 4):
        hs.hetcor_scan(*args)
        assert hs.launches["hetcor_scan"] == n
