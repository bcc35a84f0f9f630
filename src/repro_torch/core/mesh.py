"""The shard mesh — where each shard of a sharded plan lives.

A :class:`ShardMesh` is the port's counterpart of a JAX device mesh for the
graph engine: a shape, one name per axis, and one ``torch.device`` per mesh
position in row-major order.  Devices may repeat, so k shards can share one
card (``make_mesh((4,), ("data",))`` on a one-card host) or the CPU
(``devices=[torch.device("cpu")] * 4`` in the tests).  The sharded executor
(``repro_torch.core.plan``) runs each shard's local edgeMap on its device
and combines the O(n) outputs on ``devices[0]``; nothing here starts a
process group.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from ..device import resolve_device


@dataclasses.dataclass(frozen=True)
class ShardMesh:
    shape: tuple          # sizes, one per axis
    axis_names: tuple     # names, one per axis
    devices: tuple        # torch.device per mesh position, row-major

    def __post_init__(self):
        if len(self.shape) != len(self.axis_names):
            raise ValueError(f"shape {self.shape} and axis names {self.axis_names} differ "
                             "in length")
        if len(set(self.axis_names)) != len(self.axis_names):
            raise ValueError(f"axis names repeat: {self.axis_names}")
        if any(int(s) < 1 for s in self.shape):
            raise ValueError(f"mesh sizes must be >= 1, got {self.shape}")
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
