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

Every rank of a process mesh must take the same decisions, or its
collectives combine different queries (or wait for a call that never
comes).  :func:`check_replicated`, :func:`check_same_digest` and
:func:`run_on_first_rank` hold the ranks to that; off a process mesh they
do nothing but call through.
"""
from __future__ import annotations

import dataclasses
import hashlib
import math
import struct
from typing import Any, Callable

import numpy as np
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


def collective(name):
    """``torch.distributed``'s single-tensor collective, by its current name
    where this torch has it (``reduce_scatter_single``), else the older one."""
    new = {"reduce_scatter": "reduce_scatter_single", "all_gather": "all_gather_single"}
    old = {"reduce_scatter": "reduce_scatter_tensor", "all_gather": "all_gather_into_tensor"}
    return getattr(dist, new[name], None) or getattr(dist, old[name])


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


def check_replicated(mesh, fields: dict, what: str) -> None:
    """Raise ``ValueError`` on every rank of a process mesh unless every rank
    passed equal ``fields`` (one ``all_gather_object``); the message names
    each field that differs and the ranks that differ from rank 0.  A no-op
    off a process mesh."""
    if not isinstance(mesh, ProcessMesh):
        return
    seen = [None] * mesh.size
    dist.all_gather_object(seen, fields, group=mesh.group)
    bad = []
    for key in sorted({k for f in seen for k in f}, key=repr):
        want = seen[0].get(key)
        ranks = [r for r, f in enumerate(seen) if f.get(key) != want]
        if ranks:
            got = ", ".join(f"rank {r} {seen[r].get(key)!r}" for r in ranks)
            bad.append(f"{key} (rank 0 {want!r}; {got})")
    if bad:
        raise ValueError(f"{what}: the ranks of the process mesh disagree on "
                         + "; ".join(bad) + ": every rank must construct the same object")


def _canonical(obj, out: list) -> None:
    """Append a byte encoding of ``obj`` that is the same in every process
    (``hash()`` of a str is salted a process): numbers by value, tensors
    and arrays by dtype, shape and bytes, dicts in key order."""
    if isinstance(obj, torch.Tensor):
        obj = obj.detach().cpu().numpy()
    if isinstance(obj, np.ndarray):
        out.append(f"a{obj.dtype.str}{obj.shape}:".encode())
        out.append(np.ascontiguousarray(obj).tobytes())
    elif isinstance(obj, (bool, np.bool_)):
        out.append(b"T" if obj else b"F")
    elif isinstance(obj, (int, np.integer)):
        out.append(f"i{int(obj)};".encode())
    elif isinstance(obj, (float, np.floating)):
        out.append(b"f" + struct.pack("<d", float(obj)))
    elif isinstance(obj, str):
        out.append(f"s{len(obj)}:{obj}".encode())
    elif isinstance(obj, bytes):
        out.append(f"b{len(obj)}:".encode() + obj)
    elif isinstance(obj, dict):
        out.append(f"d{len(obj)}:".encode())
        for k in sorted(obj, key=repr):
            _canonical(k, out)
            _canonical(obj[k], out)
    elif isinstance(obj, (list, tuple)):
        out.append(f"l{len(obj)}:".encode())
        for x in obj:
            _canonical(x, out)
    elif obj is None:
        out.append(b"N")
    else:
        raise TypeError(f"no canonical encoding for {type(obj).__name__}")


def digest(obj) -> bytes:
    """An 8-byte BLAKE2b digest of ``obj``'s canonical encoding."""
    parts: list = []
    _canonical(obj, parts)
    return hashlib.blake2b(b"".join(parts), digest_size=8).digest()


def check_same_digest(mesh, obj, what: str) -> None:
    """Raise ``ValueError`` on every rank of a process mesh unless every
    rank's ``obj`` has the same :func:`digest` (one 8-byte all-gather).  A
    no-op off a process mesh."""
    if not isinstance(mesh, ProcessMesh):
        return
    dev = mesh.device if "nccl" in mesh.backend else torch.device("cpu")
    mine = torch.tensor([int.from_bytes(digest(obj), "little", signed=True)],
                        dtype=torch.int64, device=dev)
    parts = [torch.empty_like(mine) for _ in range(mesh.size)]
    dist.all_gather(parts, mine, group=mesh.group)
    got = [int(p.item()) for p in parts]
    ranks = [r for r, v in enumerate(got) if v != got[0]]
    if ranks:
        raise ValueError(f"{what}: ranks {ranks} hold other work than rank 0: every rank must "
                         "submit the same stream with the same virtual time")


def run_on_first_rank(mesh, fn: Callable[[], Any], what: str) -> None:
    """Run ``fn`` once: on rank 0 of a process mesh alone (elsewhere, here).

    The other ranks wait for rank 0's status (one ``broadcast_object_list``,
    the barrier), so no rank returns before ``fn`` has finished; if it
    raised, every rank raises ``ValueError``."""
    if not isinstance(mesh, ProcessMesh):
        fn()
        return
    status, cause = [None], None
    if mesh.rank == 0:
        try:
            fn()
        except Exception as e:  # re-raised below, on every rank
            status, cause = [f"{type(e).__name__}: {e}"], e
    src = 0 if mesh.group is None else dist.get_global_rank(mesh.group, 0)
    dist.broadcast_object_list(status, src=src, group=mesh.group)
    if status[0] is not None:
        raise ValueError(f"{what} failed on rank 0: {status[0]}") from cause
