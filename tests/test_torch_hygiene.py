"""Import rules of the port: no jax, no nvcc at import, no CPU fallback for
the card."""

import subprocess
import sys
import textwrap

import pytest
import torch

from torch_parity import set_threads

set_threads()

_TINY_BLOCK = textwrap.dedent(
    """
    import os, sys, tempfile
    import numpy as np
    from cigwas_tpu_torch.pipelines import cusk
    from cigwas_tpu_torch.host import (
        BED_PREFIX_COL_MAJ, MarkerBlock, encode_bed_values, prep_bed,
        write_marker_blocks_to_file,
    )
    rng = np.random.default_rng(0)
    m, n = 12, 400
    G = (rng.random((m, n)) < 0.3).astype(np.float32) + (rng.random((m, n)) < 0.3)
    y = 0.5 * (G[3] - G[3].mean()) + rng.normal(size=n)
    y = (y - y.mean()) / y.std()
    d = tempfile.mkdtemp()
    stem = os.path.join(d, "t")
    with open(stem + ".bed", "wb") as f:
        f.write(BED_PREFIX_COL_MAJ + encode_bed_values(G).tobytes())
    with open(stem + ".bim", "w") as f:
        f.writelines(f"1\\trs{i}\\t0\\t{i}\\tA\\tG\\n" for i in range(m))
    with open(stem + ".fam", "w") as f:
        f.writelines(f"F{i} I{i} 0 0 0 -9\\n" for i in range(n))
    with open(stem + ".phen", "w") as f:
        f.write("FID\\tIID\\tT0\\n")
        f.writelines(f"F{i}\\tI{i}\\t{y[i]:.6f}\\n" for i in range(n))
    prep_bed(stem)
    write_marker_blocks_to_file([MarkerBlock("1", 0, m - 1)], stem + ".blocks")
    res = cusk(stem + ".phen", stem, stem + ".blocks", 1e-3, 3, 14, 1, d, 0,
                  verbose=False, device="cpu")
    assert res is not None and res.num_markers() >= 1
    assert "jax" not in sys.modules, sorted(k for k in sys.modules if "jax" in k)
    print("OK")
    """
)


def test_port_never_imports_jax():
    """A fresh interpreter runs a tiny block through the port's cusk on the
    CPU without importing jax (the JAX package's own __init__ would, unless
    the port sets CIGWAS_TPU_NO_COMPILE_CACHE first)."""
    proc = subprocess.run(
        [sys.executable, "-c", _TINY_BLOCK], capture_output=True, text=True,
        timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("OK")


def test_kernel_modules_import_without_building():
    """Importing the kernel wrapper compiles nothing (this machine may have
    no nvcc); the build happens at the first launch on a card."""
    proc = subprocess.run(
        [sys.executable, "-c",
         "import cigwas_tpu_torch.ops.kernels.local_sweep as ls, "
         "cigwas_tpu_torch.ops.kernels.build as b; "
         "assert b._loaded == {} and ls.launches == {1: 0, 2: 0, 3: 0}; print('OK')"],
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr


def test_require_cuda_has_no_cpu_fallback():
    from cigwas_tpu_torch import require_cuda

    if torch.cuda.is_available():
        assert require_cuda().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            require_cuda()


def test_cpu_path_counts_no_launches():
    """The wrapper takes the plain version for CPU tensors and counts no
    kernel launch."""
    import numpy as np

    from cigwas_tpu_torch.ops.kernels import local_sweep as ls

    ls.reset_launches()
    C = torch.eye(16)
    nbrs = torch.arange(1, 9, dtype=torch.int32)[None, :]
    rho, pos = ls.local_sweep(C, torch.zeros(1, dtype=torch.int32), nbrs,
                              torch.tensor([8], dtype=torch.int32), 2)
    assert ls.launches == {1: 0, 2: 0, 3: 0}
    assert rho.shape == (1, 8) and pos.shape == (1, 8, 2)
    assert np.all(np.isfinite(rho.numpy()))
