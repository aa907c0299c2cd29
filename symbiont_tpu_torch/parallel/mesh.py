"""Mesh construction over the devices of this process, or of every process.

The port of `symbiont_tpu/parallel/mesh.py` (`local_device_count`,
`init_distributed`, `build_mesh`, `parse_mesh_spec`, `mesh_from_config`).
A `Mesh` is what `jax.sharding.Mesh` is to the JAX package: an array of
devices with named axes.

Axes:
- "data"   — batch sharding (DP); embedding throughput scales on this axis.
- "tensor" — parameter sharding (TP) for decoder LMs too big for one card.

An explicit `devices=` list may name one device more than once: the
port's counterpart of the JAX package's virtual CPU devices. The CPU tests
build `[torch.device("cpu")] * 8`, and a one-card host can run a `[2, 1]`
mesh over `[cuda:0, cuda:0]`. Each entry still holds its own copy of
what is placed on it (`parallel/sharding.py`), as a card of its own would.

Multi-host (A15): `init_distributed` joins this process to a world of
processes over `torch.distributed`, as `jax.distributed.initialize` joins
a slice. The world's devices (`world_devices()`) are every process's
entries in process order, and `build_mesh` meshes over them by default. A
mesh over them spans processes: each entry belongs to one process
(`Mesh.process_index`), every process builds the same mesh in the same
order, so a flat index names the same entry everywhere, and a process
computes only on its own entries (`Mesh.local_entries`). Sums across the
processes of one line of the mesh go through that line's process group
(`Mesh.group`, made once when the mesh is built): NCCL where every process
has cards of its own, gloo where processes share a card (NCCL refuses two
ranks on one device) or compute on the CPU; under gloo a CUDA tensor
passes through host memory (`Group`). Host-side metadata (each process's
entries and which card each is) always goes over a gloo world group, as
JAX's coordinator service carries it.
"""

from __future__ import annotations

import datetime
import itertools
import logging
import math
import os
import re
from typing import Optional, Sequence

import numpy as np
import torch

log = logging.getLogger(__name__)

DIST_TIMEOUT_S = 60  # a peer missing from init or from a collective fails within this

# bytes this process passed to device collectives (all-reduce, broadcast)
# over a mesh that spans processes: the multi-process train step's traffic
collective_bytes = 0


class WorldDevice:
    """One entry of the world's device list: the device as its process
    names it, that process's index (as a `jax.Device` carries its
    `process_index`) and which card it is (`card`: a CUDA device's uuid,
    "cpu" for the CPU; None without `init_distributed`, which is the one
    reader)."""

    __slots__ = ("device", "process_index", "card")

    def __init__(self, device, process_index: int, card: Optional[str]):
        self.device, self.process_index, self.card = torch.device(device), process_index, card

    def __repr__(self) -> str:
        return f"{self.device}@{self.process_index}"


class Group:
    """The processes `ranks` of one line (or sub-grid) of a mesh and their
    process group. Device collectives sum or broadcast in place; under
    gloo (`host`) a CUDA tensor goes through a host copy."""

    __slots__ = ("ranks", "pg", "host")

    def __init__(self, ranks: tuple, pg, host: bool):
        self.ranks, self.pg, self.host = ranks, pg, host

    def _run(self, op, t: torch.Tensor, **kw) -> torch.Tensor:
        global collective_bytes
        collective_bytes += t.numel() * t.element_size()
        buf = t.cpu() if self.host and t.is_cuda else t
        op(buf, group=self.pg, **kw)
        if buf is not t:
            t.copy_(buf)
        return t

    def all_reduce_(self, t: torch.Tensor) -> torch.Tensor:
        """`t` (contiguous) summed over the group's processes, in place."""
        import torch.distributed as dist

        return self._run(dist.all_reduce, t)

    def broadcast_(self, t: torch.Tensor, src: int) -> torch.Tensor:
        """`t` (contiguous) set to process `src`'s, in place."""
        import torch.distributed as dist

        return self._run(dist.broadcast, t, src=src)

    def __repr__(self) -> str:
        return f"Group({list(self.ranks)}, {'gloo' if self.host else 'nccl'})"


class _World:
    """What `init_distributed` set up: this process's rank in a world of
    `size`, the world's entries, the backend of device collectives (and
    why), and one `Group` per set of ranks, made on first use."""

    def __init__(self, rank: int, size: int, devices: list, backend: str, why: str):
        self.rank, self.size, self.devices = rank, size, devices
        self.backend, self.why = backend, why
        self._groups: dict = {}

    def group(self, ranks) -> Group:
        """The group of `ranks`. `new_group` is a collective of the whole
        world, so every process asks for the same groups in the same order
        (each builds the same meshes in the same order)."""
        import torch.distributed as dist

        ranks = tuple(sorted(ranks))
        g = self._groups.get(ranks)
        if g is None:
            pg = (dist.group.WORLD if self.backend == "gloo" and len(ranks) == self.size
                  else dist.new_group(list(ranks), backend=self.backend,
                                      timeout=datetime.timedelta(seconds=DIST_TIMEOUT_S)))
            g = self._groups[ranks] = Group(ranks, pg, host=self.backend == "gloo")
        return g


_WORLD: Optional[_World] = None


def local_devices() -> list:
    """The devices this process computes on: every CUDA device, or the CPU
    where there is none."""
    if torch.cuda.is_available():
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]


def local_device_count() -> int:
    return len(local_devices())


def process_index() -> int:
    """This process's index in the world (0 without `init_distributed`)."""
    return 0 if _WORLD is None else _WORLD.rank


def process_count() -> int:
    return 1 if _WORLD is None else _WORLD.size


def _card(d: torch.device) -> str:
    """Which card a device is: a CUDA device's uuid, "cpu" for the CPU."""
    if d.type == "cuda":
        return str(torch.cuda.get_device_properties(d).uuid)
    return d.type


def world_devices() -> list:
    """Every process's entries in process order (`WorldDevice`), as
    `jax.devices()` spans the slice after `jax.distributed.initialize`;
    without `init_distributed`, this process's `local_devices()`."""
    if _WORLD is not None:
        return list(_WORLD.devices)
    return [WorldDevice(d, 0, None) for d in local_devices()]


def device_backend(cards: Sequence[Sequence[str]]) -> tuple:
    """The backend of device collectives for a world whose process p has
    entries on the cards `cards[p]` → (backend, why): "nccl" where every
    entry is a CUDA card and no card belongs to two processes, else
    "gloo" (the CPU; or a card shared by two processes, where NCCL refuses
    the second rank on that device). The rule decides; no failure does."""
    if any(c == "cpu" for cs in cards for c in cs):
        return "gloo", "entries on the CPU"
    owners: dict = {}
    for p, cs in enumerate(cards):
        for c in cs:
            owners.setdefault(c, set()).add(p)
    for c, ps in owners.items():
        if len(ps) > 1:
            return "gloo", (f"processes {sorted(ps)} share card {c} (NCCL refuses two ranks "
                            "on one device)")
    return "nccl", "every process on cards of its own"


def init_distributed(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     devices: Optional[Sequence] = None) -> int:
    """Multi-host bring-up: join this process to a world of
    `num_processes` processes whose coordinator (rank 0's TCP store) is at
    `coordinator` ("host:port"), as process `process_id`. `devices`: this
    process's mesh entries (default `local_devices()`; a list may repeat a
    device, as the CPU tests' 4 entries a process or two processes' cuda:0
    on one card). SYMBIONT_COORDINATOR / SYMBIONT_NUM_PROCESSES /
    SYMBIONT_PROCESS_ID give each argument left unset (the JAX package's
    rule). A peer missing for DIST_TIMEOUT_S fails the call.

    Gathers every process's entries over a gloo world group and picks the
    backend of device collectives by `device_backend` (logged). After
    this, `world_devices()` spans the world and `build_mesh` meshes over
    it. Returns the global entry count. A second call is a no-op."""
    global _WORLD
    if _WORLD is not None:
        return len(_WORLD.devices)
    import torch.distributed as dist

    coordinator = coordinator or os.environ.get("SYMBIONT_COORDINATOR")
    if num_processes is None and "SYMBIONT_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["SYMBIONT_NUM_PROCESSES"])
    if process_id is None and "SYMBIONT_PROCESS_ID" in os.environ:
        process_id = int(os.environ["SYMBIONT_PROCESS_ID"])
    if coordinator is None or num_processes is None or process_id is None:
        raise ValueError("init_distributed needs the coordinator (host:port), the number of "
                         "processes and this process's id: pass them or set "
                         "SYMBIONT_COORDINATOR, SYMBIONT_NUM_PROCESSES and SYMBIONT_PROCESS_ID")
    local = [torch.device(d) for d in (devices if devices is not None else local_devices())]
    dist.init_process_group("gloo", init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id,
                            timeout=datetime.timedelta(seconds=DIST_TIMEOUT_S))
    every = [None] * num_processes
    dist.all_gather_object(every, [(str(d), _card(d)) for d in local])
    backend, why = device_backend([[c for _, c in entries] for entries in every])
    _WORLD = _World(process_id, num_processes,
                    [WorldDevice(d, p, c) for p, entries in enumerate(every) for d, c in entries],
                    backend, why)
    log.info("init_distributed: process %d of %d, %d entries in the world, device "
             "collectives over %s (%s)", process_id, num_processes, len(_WORLD.devices),
             backend, why)
    return len(_WORLD.devices)


def distributed_backend() -> Optional[tuple]:
    """(backend, why) of device collectives after `init_distributed`, else None."""
    return None if _WORLD is None else (_WORLD.backend, _WORLD.why)


def shutdown_distributed() -> None:
    """Leave the world `init_distributed` joined (`jax.distributed.shutdown`)."""
    global _WORLD
    if _WORLD is None:
        return
    import torch.distributed as dist

    _WORLD = None
    dist.destroy_process_group()


class Mesh:
    """Devices on named axes: `devices` an object array of `torch.device`
    of shape `[size of each axis]`, `processes` the process of each entry,
    `shape` the axis sizes by name. Built from an array of `torch.device`
    (every entry this process's) or of `WorldDevice` (`world_devices()`,
    reshaped at will: the JAX tests' `devs.reshape(procs, n).T` pairs one
    entry of each process on an axis)."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        if devices.ndim != len(axis_names):
            raise ValueError(f"{devices.ndim}-d device array for axes {tuple(axis_names)}")
        me = process_index()
        flat = list(devices.flat)
        devs = np.empty(len(flat), dtype=object)
        devs[:] = [d.device if isinstance(d, WorldDevice) else torch.device(d) for d in flat]
        self.devices = devs.reshape(devices.shape)
        self.processes = np.array([d.process_index if isinstance(d, WorldDevice) else me
                                   for d in flat], dtype=np.int64).reshape(devices.shape)
        self.axis_names = tuple(axis_names)
        self.process = me
        self.local_entries = [i for i, p in enumerate(self.processes.flat) if p == me]
        self._groups = self._make_groups() if self.spans_processes else {}

    def _make_groups(self) -> dict:
        """One `Group` per (axes, coordinates of the other axes) whose
        sub-grid holds entries of more than one process, None for the
        rest: every line of every axis, and every larger sub-grid up to the
        whole mesh, in one fixed order."""
        groups = {}
        nd = self.devices.ndim
        for size in range(1, nd + 1):
            for axes in itertools.combinations(range(nd), size):
                others = [a for a in range(nd) if a not in axes]
                for at in np.ndindex(*(self.devices.shape[a] for a in others)):
                    index = [slice(None)] * nd
                    for a, c in zip(others, at):
                        index[a] = c
                    ranks = {int(p) for p in self.processes[tuple(index)].flat}
                    groups[(axes, at)] = _WORLD.group(ranks) if len(ranks) > 1 else None
        return groups

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
    def spans_processes(self) -> bool:
        return len(set(self.processes.flat)) > 1

    def process_index(self, i: int) -> int:
        """The process that owns the flat entry `i`."""
        return int(self.processes.flat[i])

    def is_local(self, i: int) -> bool:
        return self.process_index(i) == self.process

    @property
    def lead(self) -> torch.device:
        """This process's first entry: where its results are gathered
        (the first entry, on a mesh of one process)."""
        if not self.local_entries:
            raise ValueError(f"process {self.process} holds no entry of {self}")
        return self.devices.flat[self.local_entries[0]]

    def group(self, axes: Sequence[str], i: int) -> Optional[Group]:
        """The `Group` of the sub-grid through the flat entry `i` over
        `axes` (the line of one axis, or all of them: the whole mesh), or
        None where one process holds all of it."""
        if not self._groups:
            return None
        idx = tuple(sorted(self.axis_names.index(a) for a in axes))
        coords = np.unravel_index(i, self.devices.shape)
        return self._groups[(idx, tuple(int(coords[a]) for a in range(self.devices.ndim)
                                        if a not in idx))]

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
        where = ([str(d) for d in self.device_list] if not self.spans_processes else
                 [f"{d}@{p}" for d, p in zip(self.device_list, self.processes.flat)])
        return f"Mesh({self.shape}, {where})"


def refuse_spanning(mesh: Optional[Mesh], what: str,
                    item: str = "A15 multi-host serving") -> None:
    """Raise, naming the ROADMAP item, where `what` is asked to run over a
    mesh that spans processes and is not ported there."""
    if mesh is not None and mesh.spans_processes:
        raise ValueError(f"{what} over a mesh that spans processes is not ported "
                         f"(ROADMAP {item}): {mesh}")


def build_mesh(shape: Optional[Sequence[int]] = None,
               axis_names: Sequence[str] = ("data", "tensor"),
               devices: Optional[Sequence] = None) -> Mesh:
    """Build a named mesh over `devices` (default: `world_devices()`, this
    process's `local_devices()` without `init_distributed`).

    shape=None → all devices on the first axis, 1 on the rest (pure DP, the
    right default for the embedding models: TP is for LMs). Raises when the
    shape does not cover the devices."""
    devices = list(devices if devices is not None else world_devices())
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
    devices on the 'data' axis, 1 on the rest. With `cpu` (every engine
    of the process asked for the CPU) the mesh repeats the CPU device to
    cover `mesh_shape`, the counterpart of JAX's virtual CPU devices.
    After `init_distributed` the mesh is over the world's entries, as
    JAX's is; one that spans processes raises (serving across processes
    is ROADMAP's "A15 multi-host serving"). The runner calls this once at
    stack start and threads the result through TorchEngine, LmEngine and
    the vector store."""
    shape = parallel_cfg.mesh_shape
    devices = None
    if cpu and _WORLD is None:
        devices = [torch.device("cpu")] * (math.prod(shape) if shape else 1)
    mesh = build_mesh(shape, tuple(parallel_cfg.axis_names), devices)
    refuse_spanning(mesh, "the serving mesh")
    return mesh


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
