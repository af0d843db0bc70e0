"""The port's multi-device skeleton step (`cigwas_tpu_torch.parallel.spmd.
build_multichip_cusk_step`) against the JAX package's on the CPU: the JAX
step on its (block, marker, sample) mesh of the 8 virtual CPU devices
(tests/conftest.py, as tests/test_parallel.py runs it), the port's on a mesh
of CPU entries of the same shape; the adjacency must match exactly. The same
inputs over other mesh shapes, the one-device (1, 1, 1) mesh among them,
must give the same adjacency.
"""

import numpy as np
import pytest
import torch

from torch_parity import set_threads

from cigwas_tpu.utils.stats import threshold_array
from cigwas_tpu_torch.parallel import build_multichip_cusk_step, make_mesh
from cigwas_tpu_torch.parallel.mesh import Mesh, device_array

set_threads()


def _inputs(seed: int, B: int = 2, m: int = 16, n: int = 64, p: int = 2, ld: float = 0.0):
    """2-bit codes (B, m, n) and standardised traits (B, p, n); with ld > 0
    neighbouring markers share genotypes, so the panel has LD edges."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, size=(B, m, n)).astype(np.int32)
    if ld:
        same = rng.random((B, m, n)) < ld
        for i in range(1, m):
            codes[:, i] = np.where(same[:, i], codes[:, i - 1], codes[:, i])
    phen = rng.normal(size=(B, p, n)).astype(np.float32)
    phen += 0.5 * (codes[:, :p] == 0)
    phen = (phen - phen.mean(axis=2, keepdims=True)) / phen.std(axis=2, keepdims=True)
    return codes, phen.astype(np.float32)


def _jax_step(codes, phen, th0, th1, shape=(2, 2, 2)):
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from cigwas_tpu.parallel import build_multichip_cusk_step as jax_build
    from cigwas_tpu.parallel import make_mesh as jax_mesh

    mesh = jax_mesh(int(np.prod(shape)), block=shape[0], marker=shape[1], sample=shape[2])
    step = jax_build(mesh, th0, th1)
    return np.asarray(step(
        jax.device_put(codes, NamedSharding(mesh, P("block", "marker", "sample"))),
        jax.device_put(phen, NamedSharding(mesh, P("block", None, "sample")))))


def _port_step(codes, phen, th0, th1, shape=(2, 2, 2)):
    mesh = make_mesh(int(np.prod(shape)), block=shape[0], marker=shape[1], sample=shape[2],
                     device="cpu")
    return build_multichip_cusk_step(mesh, th0, th1)(codes, phen).numpy()


@pytest.mark.parametrize("seed,ld", [(0, 0.0), (1, 0.0), (2, 0.7), (3, 0.85)])
def test_step_matches_jax(seed, ld):
    codes, phen = _inputs(seed, m=16, n=64, ld=ld)
    th = threshold_array(64, 0.05)
    got = _port_step(codes, phen, float(th[0]), float(th[1]))
    exp = _jax_step(codes, phen, float(th[0]), float(th[1]))
    assert got.shape == exp.shape == (2, 18, 18) and got.dtype == np.int32
    assert int((got != exp).sum()) == 0, "adjacency mismatches against the JAX step"
    assert np.array_equal(got, got.transpose(0, 2, 1))


@pytest.mark.parametrize("shape", [(1, 1, 1), (2, 1, 4), (1, 4, 2), (2, 4, 1)])
def test_step_is_the_same_over_any_mesh(shape):
    """Exact contingency counts; the float sums over ``sample`` in another
    order decide no pair differently on these inputs."""
    codes, phen = _inputs(4, m=32, n=128, ld=0.8)
    th = threshold_array(128, 0.05)
    ref = _port_step(codes, phen, float(th[0]), float(th[1]))
    got = _port_step(codes, phen, float(th[0]), float(th[1]), shape)
    assert np.array_equal(got, ref)
    assert ref.sum() > 0


def test_step_over_a_mesh_with_axes_in_another_order():
    """The step finds the axes by name."""
    codes, phen = _inputs(5, m=16, n=64)
    th = threshold_array(64, 0.05)
    ref = _port_step(codes, phen, float(th[0]), float(th[1]))
    devices = device_array([torch.device("cpu")] * 8, (2, 2, 2))
    mesh = Mesh(devices, ("sample", "block", "marker"))
    got = build_multichip_cusk_step(mesh, float(th[0]), float(th[1]))(codes, phen).numpy()
    assert np.array_equal(got, ref)


def test_step_refuses_what_does_not_split():
    th = threshold_array(64, 0.05)
    mesh = make_mesh(8, block=2, marker=2, sample=2, device="cpu")
    step = build_multichip_cusk_step(mesh, float(th[0]), float(th[1]))
    codes, phen = _inputs(6, B=2, m=15, n=64)
    with pytest.raises(ValueError):
        step(codes, phen)
    flat = Mesh(device_array([torch.device("cpu")] * 2, (2,)), ("marker",))
    with pytest.raises(ValueError):
        build_multichip_cusk_step(flat, float(th[0]), float(th[1]))


@pytest.mark.cuda
def test_card_step_equals_the_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    codes, phen = _inputs(7, m=32, n=128, ld=0.8)
    th = threshold_array(128, 0.05)
    mesh = make_mesh(8, block=2, marker=2, sample=2, devices=[torch.device("cuda", 0)] * 8)
    got = build_multichip_cusk_step(mesh, float(th[0]), float(th[1]))(
        torch.from_numpy(codes).cuda(), torch.from_numpy(phen).cuda()).cpu().numpy()
    assert np.array_equal(got, _port_step(codes, phen, float(th[0]), float(th[1])))
