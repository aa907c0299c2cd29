"""Mesh construction over the devices this process owns.

The port of `symbiont_tpu/parallel/mesh.py` (`local_device_count`,
`build_mesh`, `parse_mesh_spec`, `mesh_from_config`). A `Mesh` is what
`jax.sharding.Mesh` is to the JAX package: an array of devices with named
axes, owned by one process that computes over all of them.

Axes:
- "data"   — batch sharding (DP); embedding throughput scales on this axis.
- "tensor" — parameter sharding (TP) for decoder LMs too big for one card.

An explicit `devices=` list may name one device more than once: the
port's counterpart of the JAX package's virtual CPU devices. The CPU tests
build `[torch.device("cpu")] * 8`, and a one-card host can run a `[2, 1]`
mesh over `[cuda:0, cuda:0]`. Each entry still holds its own copy of
what is placed on it (`parallel/sharding.py`), as a card of its own would.

A mesh that spans processes (`init_distributed`, `torch.distributed`) is
not ported yet (ROADMAP A15 multi-host).
"""

from __future__ import annotations

import math
import re
from typing import Optional, Sequence

import numpy as np
import torch


class Mesh:
    """Devices on named axes: `devices` an object array of `torch.device`
    of shape `[size of each axis]`, `shape` the axis sizes by name."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        if devices.ndim != len(axis_names):
            raise ValueError(f"{devices.ndim}-d device array for axes {tuple(axis_names)}")
        self.devices = devices
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def device_list(self) -> list:
        """Every entry of the mesh in flat (row-major) order."""
        return list(self.devices.flat)

    @property
    def lead(self) -> torch.device:
        """The first entry: where results are gathered."""
        return self.devices.flat[0]

    def flat_index(self, **coords) -> int:
        """The flat index of the entry at `coords` (axis name → index; an
        axis not named is at 0)."""
        idx = tuple(coords.get(a, 0) for a in self.axis_names)
        return int(np.ravel_multi_index(idx, self.devices.shape))

    def device(self, **coords) -> torch.device:
        return self.devices.flat[self.flat_index(**coords)]

    def coords(self, i: int) -> dict:
        """Axis name → index of the flat entry `i`."""
        return dict(zip(self.axis_names,
                        (int(c) for c in np.unravel_index(i, self.devices.shape))))

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {[str(d) for d in self.device_list]})"


def local_devices() -> list:
    """The devices this process computes on: every CUDA device, or the CPU
    where there is none."""
    if torch.cuda.is_available():
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]


def local_device_count() -> int:
    return len(local_devices())


def build_mesh(shape: Optional[Sequence[int]] = None,
               axis_names: Sequence[str] = ("data", "tensor"),
               devices: Optional[Sequence] = None) -> Mesh:
    """Build a named mesh over `devices` (default: `local_devices()`).

    shape=None → all devices on the first axis, 1 on the rest (pure DP, the
    right default for the embedding models: TP is for LMs). Raises when the
    shape does not cover the devices."""
    devices = [torch.device(d) for d in (devices if devices is not None else local_devices())]
    n = len(devices)
    if shape is None:
        shape = [n] + [1] * (len(axis_names) - 1)
    shape = [int(s) for s in shape]
    if math.prod(shape) != n:
        raise ValueError(f"mesh shape {shape} does not cover {n} devices")
    arr = np.empty(n, dtype=object)
    arr[:] = devices
    return Mesh(arr.reshape(shape), tuple(axis_names))


def parse_mesh_spec(spec: str) -> list:
    """`"dp4xtp2"` → [4, 2] (also plain `"4x2"`, or `"8"` for pure DP).
    `dp<N>` is the 'data' axis, `tp<N>` the 'tensor' axis, in that order."""
    s = spec.strip().lower()
    m = re.fullmatch(r"dp(\d+)(?:xtp(\d+))?", s)
    if m:
        return [int(m.group(1)), int(m.group(2) or 1)]
    m = re.fullmatch(r"tp(\d+)", s)
    if m:
        return [1, int(m.group(1))]
    m = re.fullmatch(r"(\d+)(?:x(\d+))?", s)
    if m:
        return [int(m.group(1)), int(m.group(2) or 1)]
    raise ValueError(
        f"mesh spec {spec!r} not understood: use dpNxtpM, dpN, tpM, NxM or N")


def mesh_from_config(parallel_cfg, cpu: bool = False) -> Mesh:
    """The serving mesh from `ParallelConfig`: `mesh_shape` unset means all
    local devices on the 'data' axis, 1 on the rest. With `cpu` (every
    engine of the process asked for the CPU) the mesh repeats the CPU
    device to cover `mesh_shape`, the counterpart of JAX's virtual CPU
    devices. The runner calls this once at stack start and threads the
    result through TorchEngine, LmEngine and the vector store."""
    shape = parallel_cfg.mesh_shape
    devices = None
    if cpu:
        devices = [torch.device("cpu")] * (math.prod(shape) if shape else 1)
    return build_mesh(shape, tuple(parallel_cfg.axis_names), devices)


def axis_size(mesh: Optional[Mesh], axis: str) -> int:
    """The size of `axis` on `mesh` (1 for no mesh or no such axis)."""
    return 1 if mesh is None else int(mesh.shape.get(axis, 1))


def mesh_device(mesh: Mesh, device=None, force_cpu: bool = False) -> torch.device:
    """The device an engine over `mesh` answers on: the mesh's lead entry.
    A `device` or `force_cpu` that names another kind raises: an engine is
    never placed on a mesh other than the one its caller asked for."""
    lead = mesh.lead
    want = "cpu" if force_cpu else (None if device is None else torch.device(device).type)
    if want is not None and want != lead.type:
        raise ValueError(f"the engine is asked for {want} but the mesh is over {lead.type} "
                         f"({mesh})")
    return lead
