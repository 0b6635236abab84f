"""A device mesh for one controlling process: named axes over an array of
``torch.device`` s.

JAX's mesh is single-controller: one Python process drives every device of
it.  This mesh is the same — no process group, no ranks: a shard function
becomes a Python loop over ``mesh.shard_devices(axis)`` that launches each
shard's work on that shard's device, and every transfer between shards goes
through ``parallel/collectives.py``.  ``mesh.shape`` is an ordered
``{axis: size}`` mapping, as jax's, so code written against
``mesh.shape.get(axis, 0)`` reads the same.

A device may fill several cells only when the caller lists it several times
(two shards on ``cuda:0``, eight on ``cpu``) — the counterpart of the
reference's ``--xla_force_host_platform_device_count``; shards that share a
device run one after another on its current stream.  ``launch/mesh.py``
builds meshes from the visible cards.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """Named axes over an object array of devices of the mesh's shape.

    Attributes:
      devices: numpy object array of ``torch.device``, one axis per name.
      axis_names: the axes' names, in the array's axis order.
    """

    devices: np.ndarray
    axis_names: Tuple[str, ...]

    def __post_init__(self):
        devices = np.array(self.devices, dtype=object)
        names = tuple(self.axis_names)
        if devices.ndim != len(names) or len(set(names)) != len(names):
            raise ValueError(f"mesh needs one distinct name per axis of its {devices.shape} "
                             f"device array, got {names}")
        if devices.size == 0:
            raise ValueError("mesh needs at least one device")
        for i, d in enumerate(devices.flat):
            devices.flat[i] = torch.device(d)
        devices.flags.writeable = False
        object.__setattr__(self, "devices", devices)
        object.__setattr__(self, "axis_names", names)

    @property
    def shape(self) -> "OrderedDict[str, int]":
        """Ordered ``{axis name: size}``."""
        return OrderedDict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        """Number of cells (devices, counted with repeats)."""
        return int(self.devices.size)

    @property
    def device_type(self) -> str:
        """The devices' one type (``"cuda"`` or ``"cpu"``); a mesh that mixes
        types raises."""
        types = {d.type for d in self.devices.flat}
        if len(types) != 1:
            raise ValueError(f"mesh mixes device types {sorted(types)}")
        return types.pop()

    def shard_devices(self, axis) -> Tuple[torch.device, ...]:
        """One device per index of ``axis``, taken at index 0 of every other
        axis (the other axes replicate what ``axis`` shards).  ``axis`` may
        be a tuple of names, whose indices run row-major (the first
        slowest), as a dimension split over several axes is; the empty
        tuple gives the first cell's device."""
        names = (axis,) if isinstance(axis, str) else tuple(axis)
        for a in names:
            if a not in self.axis_names:
                raise ValueError(f"mesh {dict(self.shape)} has no axis {a!r}")
        if not names:
            return (self.devices.flat[0],)
        ks = [self.axis_names.index(a) for a in names]
        index = tuple(slice(None) if i in ks else 0 for i in range(len(self.axis_names)))
        block = self.devices[index]  # its axes in mesh order
        block = block.transpose([sorted(ks).index(k) for k in ks])
        return tuple(block.reshape(-1))

    def sub(self, index) -> "Mesh":
        """The mesh at ``index`` ({axis name: position}) of the named axes,
        each kept with size 1 (the cells one shard of those axes runs on)."""
        for a in index:
            if a not in self.axis_names:
                raise ValueError(f"mesh {dict(self.shape)} has no axis {a!r}")
        sel = tuple(slice(index[a], index[a] + 1) if a in index else slice(None)
                    for a in self.axis_names)
        return Mesh(self.devices[sel], self.axis_names)

    def distinct_devices(self) -> Tuple[torch.device, ...]:
        """The mesh's devices without repeats, in cell order."""
        return tuple(dict.fromkeys(self.devices.flat))

    def _key(self):
        return self.axis_names, self.devices.shape, tuple(map(str, self.devices.flat))

    def __eq__(self, other) -> bool:
        return isinstance(other, Mesh) and self._key() == other._key()

    def __hash__(self) -> int:
        return hash(self._key())

    def __repr__(self) -> str:
        return f"Mesh({dict(self.shape)}, devices={[str(d) for d in self.devices.flat]})"
