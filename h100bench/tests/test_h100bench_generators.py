"""The traffic generators at tiny sizes: the recipe they copy, their files
and their seeds."""

from __future__ import annotations

import numpy as np
import torch

from h100bench import harness
from h100bench.reference import panel

from conftest import HERE

AR1 = harness.load_module(HERE / "generators" / "ar1_block.py", "ar1_block")
CFG = {"individuals": 3000, "traits": 3, "ld_ar1": 0.92, "logit_scale": 0.8,
       "planted_per_trait": 5, "effect": 0.2}


def _block(tmp_path, seed, markers=300, chunk=128):
    d = tmp_path / str(seed)
    d.mkdir(parents=True)
    data = AR1.generate(CFG, {"markers": markers, "chunk": chunk, "layout_seed": 3}, seed, str(d), "cpu")
    G = panel.read_bed(data["stem"] + ".bed", markers, CFG["individuals"], "cpu")
    return data, G, panel.read_phen(data["stem"] + ".phen")


def test_the_same_seed_makes_the_same_files_and_another_seed_others(tmp_path):
    seed = 2**31 + 5
    a, b, c = (_block(tmp_path / k, s) for k, s in (("a", seed), ("b", seed), ("c", seed + 1)))
    assert a[0]["planted"] == b[0]["planted"]
    assert torch.equal(a[1], b[1]) and np.array_equal(a[2], b[2])
    assert not torch.equal(a[1], c[1])
    # every seed plants the same markers, dealt to the traits in its own order
    assert sorted(k for _, k in a[0]["planted"]) == sorted(k for _, k in c[0]["planted"])


def test_the_packed_bed_holds_the_port_encoding(tmp_path):
    from cigwas_tpu_torch.io.bed import decode_bed_values

    data, G, _ = _block(tmp_path, 9, markers=40)
    raw = np.fromfile(data["stem"] + ".bed", dtype=np.uint8)[3:].reshape(40, -1)
    vals, valid = decode_bed_values(raw, CFG["individuals"])
    assert valid.all() and np.array_equal(vals, G.numpy().astype(vals.dtype))


def test_the_block_follows_the_recipe(tmp_path):
    """AR(1) linkage along the block whatever the chunk, genotypes in {0, 1,
    2} at logistic frequencies, traits standardised with their planted
    markers among the most correlated."""
    data, G, Y = _block(tmp_path, 21, markers=300, chunk=64)
    g = G.double().numpy()
    assert set(np.unique(g)) <= {0.0, 1.0, 2.0}
    r = np.corrcoef(g)
    near = np.mean([r[i, i + 1] for i in range(299)])
    far = np.mean([abs(r[i, i + 150]) for i in range(150)])
    assert near > 0.15 and far < 0.05
    # across a chunk's edge as within a chunk
    assert np.mean([r[i, i + 1] for i in (63, 127, 191, 255)]) > 0.1
    assert np.allclose(Y.mean(1), 0, atol=1e-5) and np.allclose(Y.std(1), 1, atol=1e-4)
    assert len(data["planted"]) == 3 * 5
    for t, k in data["planted"]:
        rk = abs(np.corrcoef(g[k], Y[t])[0, 1])
        assert rk > 0.1, (t, k, rk)
