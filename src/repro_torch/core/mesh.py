"""The shard mesh — where each shard of a sharded plan lives.

A :class:`ShardMesh` is the port's counterpart of a JAX device mesh for the
graph engine: a shape, one name per axis, and one ``torch.device`` per mesh
position in row-major order.  Devices may repeat, so k shards can share one
card (``make_mesh((4,), ("data",))`` on a one-card host) or the CPU
(``devices=[torch.device("cpu")] * 4`` in the tests).  The sharded executor
(``repro_torch.core.plan``) runs each shard's local edgeMap on its device
and combines the O(n) outputs on ``devices[0]``.

A :class:`ProcessMesh` is the counterpart of ``shard_map``: one shard a
process, over an initialised ``torch.distributed`` group that the caller
started (``torchrun``, or ``torch.multiprocessing`` with ``file://`` init).
Its position is its rank in the group, row-major; the executor runs the one
local sweep and combines by collectives (``plan._combine_process``).
Nothing here starts a process group.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
import torch.distributed as dist

from ..device import resolve_device


def _check_axes(shape, axis_names):
    if len(shape) != len(axis_names):
        raise ValueError(f"shape {shape} and axis names {axis_names} differ in length")
    if len(set(axis_names)) != len(axis_names):
        raise ValueError(f"axis names repeat: {axis_names}")
    if any(int(s) < 1 for s in shape):
        raise ValueError(f"mesh sizes must be >= 1, got {shape}")


@dataclasses.dataclass(frozen=True)
class ShardMesh:
    shape: tuple          # sizes, one per axis
    axis_names: tuple     # names, one per axis
    devices: tuple        # torch.device per mesh position, row-major

    def __post_init__(self):
        _check_axes(self.shape, self.axis_names)
        if len(self.devices) != math.prod(self.shape):
            raise ValueError(f"a {self.shape} mesh needs {math.prod(self.shape)} devices, "
                             f"got {len(self.devices)}")

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    def axis_size(self, axis: str) -> int:
        if axis not in self.axis_names:
            raise ValueError(f"no mesh axis {axis!r}; the mesh has {self.axis_names}")
        return int(self.shape[self.axis_names.index(axis)])

    def shard_devices(self, axes: tuple) -> list:
        """The device of each shard when blocks split over ``axes`` (in that
        order, the first the slowest): shard s sits at the mesh position
        whose ``axes`` coordinates are s's row-major digits, every other
        axis at 0."""
        sizes = [self.axis_size(a) for a in axes]
        strides = [math.prod(self.shape[i + 1:]) for i in range(len(self.shape))]
        out = []
        for s in range(math.prod(sizes)):
            pos, rem = 0, s
            for a, size in zip(reversed(axes), reversed(sizes)):
                pos += (rem % size) * strides[self.axis_names.index(a)]
                rem //= size
            out.append(self.devices[pos])
        return out


def make_mesh(shape, axis_names, *, devices=None) -> ShardMesh:
    """A :class:`ShardMesh` of ``shape`` with ``axis_names``.  ``devices``
    lists one device per position (row-major); by default every position
    is the card (``cuda``), repeated."""
    shape = tuple(int(s) for s in shape)
    axis_names = tuple(axis_names)
    if devices is None:
        devices = [resolve_device(None)] * math.prod(shape)
    return ShardMesh(shape=shape, axis_names=axis_names,
                     devices=tuple(torch.device(d) for d in devices))


@dataclasses.dataclass(frozen=True, eq=False)
class ProcessMesh:
    """This process's place in a mesh of processes, one shard each.

    ``rank`` is the position in ``group`` (row-major over ``shape``),
    ``device`` where this rank's shard and vertex state live, ``backend``
    the group's (``gloo`` or ``nccl``).  ``axis_groups`` maps each axis to
    the subgroup of this rank's line along it (the ranks that differ from
    it in that coordinate only): the per-axis combine and the hierarchical
    sum run there.  Made by :func:`make_process_mesh`."""

    shape: tuple
    axis_names: tuple
    rank: int
    device: torch.device
    backend: str
    group: Any = None          # the process group (None: the default group)
    axis_groups: dict = dataclasses.field(default_factory=dict)

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    def axis_size(self, axis: str) -> int:
        if axis not in self.axis_names:
            raise ValueError(f"no mesh axis {axis!r}; the mesh has {self.axis_names}")
        return int(self.shape[self.axis_names.index(axis)])

    @property
    def coords(self) -> tuple:
        """This rank's coordinate along each axis."""
        out, rem = [], self.rank
        for size in reversed(self.shape):
            out.append(rem % size)
            rem //= size
        return tuple(reversed(out))

    def shard_index(self, axes: tuple) -> int:
        """The shard this rank holds when blocks split over ``axes`` (the
        first the slowest): its ``axes`` coordinates as row-major digits,
        as :meth:`ShardMesh.shard_devices` places shard s."""
        idx = 0
        for a in axes:
            idx = idx * self.axis_size(a) + self.coords[self.axis_names.index(a)]
        return idx


def _line_ranks(shape, axis: int, coords) -> list:
    """The group ranks of the line through ``coords`` along ``axis``."""
    strides = [math.prod(shape[i + 1:]) for i in range(len(shape))]
    base = sum(c * s for i, (c, s) in enumerate(zip(coords, strides)) if i != axis)
    return [base + j * strides[axis] for j in range(shape[axis])]


def _device_key(device: torch.device) -> str:
    """A device's identity across processes: the card's UUID, or the host
    device's name."""
    if device.type == "cuda":
        return f"cuda:{torch.cuda.get_device_properties(device).uuid}"
    return str(device)


def _refuse_shared_device(group, rank: int, size: int, device: torch.device):
    """NCCL cannot put two ranks of a group on one card: publish this rank's
    card through the default store and raise if another rank holds it.
    Through the store and not a collective, because an NCCL collective on a
    shared card fails (or hangs) instead of saying why."""
    store = dist.distributed_c10d._get_default_store()
    name = dist.distributed_c10d._get_process_group_name(group or dist.group.WORLD)
    # every rank makes its meshes in the same order: the count names this one
    seq = store.add(f"repro_torch/mesh/{name}/calls/{rank}", 1)
    prefix = f"repro_torch/mesh/{name}/{seq}/device"
    mine = _device_key(device)
    store.set(f"{prefix}/{rank}", mine)
    for r in range(size):
        if r != rank and store.get(f"{prefix}/{r}").decode() == mine:
            raise ValueError(
                f"ranks {min(r, rank)} and {max(r, rank)} of an NCCL group share the "
                f"device {device} ({mine}); NCCL needs one card a rank — give each rank "
                "its own card, or run the group under gloo")


def make_process_mesh(shape, axis_names, *, group=None, device=None) -> ProcessMesh:
    """This process's :class:`ProcessMesh` of ``shape`` over ``group`` (an
    initialised ``torch.distributed`` group; None: the default group).

    Every rank of ``group`` calls it, in the same order as its other
    meshes: the axis subgroups it makes are collective.  ``device=None``
    means the card (``cuda``).  Raises if no group is initialised, if the
    group's size is not ``prod(shape)``, or, under NCCL, if two ranks share
    a card.  The backend is the group's; nothing switches it."""
    shape = tuple(int(s) for s in shape)
    axis_names = tuple(axis_names)
    _check_axes(shape, axis_names)
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("make_process_mesh needs an initialised torch.distributed "
                           "group: call init_process_group in every rank first")
    size = dist.get_world_size(group)
    if size != math.prod(shape):
        raise ValueError(f"a {shape} process mesh needs {math.prod(shape)} ranks, the group "
                         f"has {size}")
    rank = dist.get_rank(group)
    backend = str(dist.get_backend(group))
    dev = resolve_device(device)
    if "nccl" in backend:
        _refuse_shared_device(group, rank, size, dev)
    mesh = ProcessMesh(shape=shape, axis_names=axis_names, rank=rank, device=dev,
                       backend=backend, group=group)
    if len(shape) == 1:
        return dataclasses.replace(mesh, axis_groups={axis_names[0]: group})
    groups = {}
    for i, name in enumerate(axis_names):
        line = _line_ranks(shape, i, mesh.coords)
        members = [r if group is None else dist.get_global_rank(group, r) for r in line]
        groups[name] = dist.new_group(members, backend=backend,
                                      use_local_synchronization=True)
    return dataclasses.replace(mesh, axis_groups=groups)
