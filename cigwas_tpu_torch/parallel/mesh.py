"""Device meshes for the block/marker/sample parallel axes
(`cigwas_tpu.parallel.mesh`).

The axes map the problem, not a transformer:

- ``block``  — data parallelism over LD blocks (the reference runs one
  process per block and merges files, `ci-gwas.py:100-104`),
- ``marker`` — the axis the engines of :mod:`cigwas_tpu_torch.parallel.sharded`
  shard: marker rows of a correlation panel and the node lists of every
  skeleton level,
- ``sample`` — individuals (absorbs the remainder of the device count).

A mesh is a numpy object array of ``torch.device`` with those axis names.
One process drives every device of it, and a device may appear more than
once: D entries that all name ``cuda:0`` run D shards on one card, each
shard's launches and copies as they would run on a card of its own.
"""

from __future__ import annotations

import numpy as np
import torch

from cigwas_tpu_torch.device import resolve

AXES = ("block", "marker", "sample")


class Mesh:
    """An n-D array of ``torch.device`` with named axes (`jax.sharding.Mesh`'s
    shape: ``devices``, ``axis_names``, ``shape`` {axis: size}, ``size``)."""

    def __init__(self, devices: np.ndarray, axis_names: tuple):
        devices = np.asarray(devices, dtype=object)
        if devices.ndim != len(axis_names):
            raise ValueError(f"{devices.ndim}-D devices for axes {axis_names}")
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, devices.shape))
        self.size = int(devices.size)

    def axis_devices(self, axis: str) -> tuple:
        """The devices along ``axis`` at index 0 of every other axis."""
        if axis not in self.axis_names:
            raise ValueError(f"mesh has no axis {axis!r}: {self.axis_names}")
        ax = self.axis_names.index(axis)
        line = np.moveaxis(self.devices, ax, -1).reshape(-1, self.devices.shape[ax])[0]
        return tuple(line)

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={[str(d) for d in self.devices.flat]})"


def device_array(devices, shape: tuple) -> np.ndarray:
    """An object array of the given devices in the given shape (numpy's
    reshape error when the sizes differ)."""
    arr = np.empty(len(devices), dtype=object)
    arr[:] = [torch.device(d) for d in devices]
    return arr.reshape(shape)


def visible_devices(n: int | None, device="cuda") -> list:
    """The first n devices of a type: on ``cuda`` the visible cards
    ``cuda:0..n-1`` (n=None: all of them; more than are visible raises, a
    mesh never shrinks); on ``cpu`` n entries of the CPU (n must be given)."""
    kind = torch.device(device).type
    if kind == "cpu":
        if n is None or n < 1:
            raise ValueError("a CPU mesh needs an explicit device count n >= 1")
        return [torch.device("cpu")] * n
    if kind != "cuda":
        raise ValueError(f"unsupported mesh device {device!r}")
    resolve("cuda")
    have = torch.cuda.device_count()
    n = have if n is None else n
    if not 1 <= n <= have:
        raise ValueError(f"{n} cards asked for, {have} visible")
    return [torch.device("cuda", i) for i in range(n)]


def make_mesh(n_devices: int | None = None, block: int = 1, marker: int = 1,
              sample: int | None = None, devices=None, device="cuda") -> Mesh:
    """Mesh with axes (block, marker, sample); sample absorbs the remainder
    (`cigwas_tpu.parallel.mesh.make_mesh`, same shape rule and errors).

    devices: an explicit list (it may repeat a device), else
    :func:`visible_devices` of ``device``. n_devices takes the first n of
    them; asking for more than there are raises."""
    if devices is None:
        devices = visible_devices(n_devices, device)
    devices = list(devices)
    if n_devices is None:
        n_devices = len(devices)
    if n_devices > len(devices):
        raise ValueError(f"{n_devices} devices asked for, {len(devices)} given")
    devices = devices[:n_devices]
    if sample is None:
        if n_devices % (block * marker) != 0:
            raise ValueError(
                f"{n_devices} devices not divisible by block*marker={block * marker}"
            )
        sample = n_devices // (block * marker)
    return Mesh(device_array(devices, (block, marker, sample)), AXES)


def flat_mesh(devices, axis: str = "marker") -> Mesh:
    """1-D mesh over the given devices."""
    devices = list(devices)
    return Mesh(device_array(devices, (len(devices),)), (axis,))
