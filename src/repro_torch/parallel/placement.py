"""Placements of tensors on a single-controller mesh: the counterparts of
``jax.sharding.PartitionSpec`` and ``NamedSharding``, under those names.

A :class:`PartitionSpec` is a tuple of per-dimension mesh axes (None, an
axis name, or a tuple of names: the dimension is cut into the product of
their sizes, row-major, the first name slowest), equal entry for entry to
the reference's.  A :class:`NamedSharding` pairs it with a mesh.  Its spec
arithmetic (``pieces``, ``shard_shape``) reads nothing of the mesh but
``mesh.shape``, so a stand-in object with a ``shape`` mapping serves for
placements computed without devices.  ``place`` puts a whole tensor on a
``parallel.Mesh`` as a :class:`Placed` value, one block per cell:

* a cell's block is the tensor's slice at the cell's coordinates along the
  axes that cut each dimension, on the cell's device;
* cells that share a device and a block share one tensor, so a replicated
  leaf has one copy per distinct device (none on the device the tensor is
  already on: the block is the tensor itself, or a view of it);
* ``Placed.gather`` reassembles the whole tensor on one device: gather
  after place is the identity, exactly.

``build`` makes a placed tensor block by block from a function of each
block's shape, coordinates and device, with no whole tensor anywhere
(``place`` is ``build`` of the given tensor's slices).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Tuple

import numpy as np
import torch


def _names(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


class PartitionSpec(tuple):
    """Per-dimension mesh axes; a one-name tuple is stored as the name and
    an empty one as None, as jax stores them."""

    def __new__(cls, *entries):
        norm = []
        for e in entries:
            if isinstance(e, (tuple, list)):
                e = tuple(e)
                e = e[0] if len(e) == 1 else (e or None)
            norm.append(e)
        return super().__new__(cls, norm)

    def axes(self, dim: int) -> Tuple[str, ...]:
        """The mesh axes that cut dimension ``dim`` (none past the spec's end)."""
        return _names(self[dim]) if dim < len(self) else ()

    def __repr__(self) -> str:
        return "PartitionSpec(" + ", ".join(map(repr, self)) + ")"


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """Which mesh axes cut which dimensions of a tensor on ``mesh``."""

    mesh: Any
    spec: PartitionSpec

    def __post_init__(self):
        spec = self.spec if isinstance(self.spec, PartitionSpec) else PartitionSpec(*self.spec)
        object.__setattr__(self, "spec", spec)
        used = [a for e in spec for a in _names(e)]
        for a in used:
            if a not in self.mesh.shape:
                raise ValueError(f"spec {spec} names axis {a!r}, not in mesh "
                                 f"{dict(self.mesh.shape)}")
        if len(set(used)) != len(used):
            raise ValueError(f"spec {spec} uses a mesh axis twice")

    def pieces(self, dim: int) -> int:
        """Into how many blocks dimension ``dim`` is cut."""
        out = 1
        for a in self.spec.axes(dim):
            out *= int(self.mesh.shape[a])
        return out

    @property
    def is_replicated(self) -> bool:
        return all(self.pieces(d) == 1 for d in range(len(self.spec)))

    def shard_shape(self, shape) -> Tuple[int, ...]:
        """The block shape of a tensor of ``shape`` (ValueError where a cut
        does not divide)."""
        shape = tuple(int(s) for s in shape)
        if len(self.spec) > len(shape):
            raise ValueError(f"spec {self.spec} has more entries than shape {shape} has dims")
        out = []
        for d, size in enumerate(shape):
            n = self.pieces(d)
            if size % n:
                raise ValueError(f"dim {d} of {shape} does not divide into {n} pieces "
                                 f"({self.spec})")
            out.append(size // n)
        return tuple(out)

    def block_coords(self, cell) -> Tuple[int, ...]:
        """Each cut dimension's block index at mesh cell ``cell`` (a
        multi-index into ``mesh.devices``)."""
        names = list(self.mesh.shape)
        sizes = dict(self.mesh.shape)
        out = []
        for d in range(len(self.spec)):
            idx = 0
            for a in self.spec.axes(d):
                idx = idx * sizes[a] + cell[names.index(a)]
            out.append(idx)
        return tuple(out)

    def build(self, shape, dtype, make_block) -> "Placed":
        """A tensor of ``shape`` made block by block, with no whole copy
        anywhere: ``make_block(block_shape, coords, device)`` makes each
        distinct block once, on the first cell's device that holds it;
        every other device that holds it gets a copy."""
        block = self.shard_shape(shape)
        blocks = np.empty(self.mesh.devices.shape, dtype=object)
        made: Dict[Tuple[int, ...], torch.Tensor] = {}
        copies: Dict[Tuple[torch.device, Tuple[int, ...]], torch.Tensor] = {}
        for cell in np.ndindex(*self.mesh.devices.shape):
            dev = self.mesh.devices[cell]
            coords = self.block_coords(cell)
            if coords not in made:
                made[coords] = make_block(block, coords, dev)
            key = (dev, coords)
            if key not in copies:
                copies[key] = made[coords].to(dev)
            blocks[cell] = copies[key]
        return Placed(self, blocks, tuple(shape), dtype)

    def place(self, x: torch.Tensor) -> "Placed":
        """``x`` as one block a cell of the mesh, each on its cell's device."""

        def make(block, coords, dev):
            sl = tuple(slice(c * b, (c + 1) * b) for c, b in zip(coords, block))
            return (x if self.is_replicated else x[sl]).to(dev).contiguous()

        return self.build(x.shape, x.dtype, make)


class Placed:
    """A tensor placed on a mesh: one block a cell (``blocks``, an object
    array of the mesh's shape; cells that share a device and a block share
    the tensor)."""

    __slots__ = ("sharding", "blocks", "shape", "dtype")

    def __init__(self, sharding: NamedSharding, blocks: np.ndarray, shape, dtype):
        self.sharding, self.blocks = sharding, blocks
        self.shape, self.dtype = tuple(shape), dtype

    def block(self, cell) -> torch.Tensor:
        """The block at mesh cell ``cell``."""
        return self.blocks[tuple(cell)]

    def map(self, fn) -> "Placed":
        """``fn`` of each distinct block, sharing kept (``fn`` must keep the
        block's device, shape and dtype)."""
        done: Dict[int, torch.Tensor] = {}
        blocks = np.empty(self.blocks.shape, dtype=object)
        for cell in np.ndindex(*self.blocks.shape):
            t = self.blocks[cell]
            if id(t) not in done:
                done[id(t)] = fn(t)
            blocks[cell] = done[id(t)]
        return Placed(self.sharding, blocks, self.shape, self.dtype)

    def distinct(self) -> List[torch.Tensor]:
        """Each distinct block tensor once, in cell order."""
        return list({id(t): t for t in self.blocks.flat}.values())

    def gather(self, device=None) -> torch.Tensor:
        """The whole tensor on ``device`` (default: the mesh's first)."""
        dev = torch.device(self.sharding.mesh.devices.flat[0] if device is None else device)
        grid = [self.sharding.pieces(d) for d in range(len(self.shape))]
        first: Dict[Tuple[int, ...], torch.Tensor] = {}
        for cell in np.ndindex(*self.blocks.shape):
            first.setdefault(self.sharding.block_coords(cell) + (0,) * (len(grid) - len(
                self.sharding.spec)), self.blocks[cell])
        if all(n == 1 for n in grid):
            return first[(0,) * len(grid)].to(dev)

        def cat(prefix: Tuple[int, ...]) -> torch.Tensor:
            d = len(prefix)
            if d == len(grid):
                return first[prefix].to(dev)
            if grid[d] == 1:
                return cat(prefix + (0,))
            return torch.cat([cat(prefix + (i,)) for i in range(grid[d])], dim=d)

        return cat(())

    def __repr__(self) -> str:
        return f"Placed(shape={self.shape}, dtype={self.dtype}, spec={self.sharding.spec})"


def first_cell(mesh, device) -> Tuple[int, ...]:
    """The first cell of ``mesh`` on ``device``."""
    dev = torch.device(device)
    for cell in np.ndindex(*mesh.devices.shape):
        if mesh.devices[cell] == dev:
            return cell
    raise ValueError(f"{dev} is not a device of {mesh}")
