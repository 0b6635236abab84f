"""Mesh constructors with the reference's shapes and axis names.

Functions, not module-level constants: importing this module touches no
device.  Without ``devices=`` a mesh takes the visible cards; when there
are fewer cards than the shape needs it raises ``ValueError`` (as
``jax.make_mesh`` does) and never falls back to the CPU.  A device may fill
several cells only when the caller lists it several times.

Production shapes (the reference's pods):
  single-pod: (16, 16)    axes (data, model)
  multi-pod:  (2, 16, 16) axes (pod, data, model)
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.parallel.mesh import Mesh


def visible_cards():
    """The visible CUDA devices (none without a card)."""
    if not torch.cuda.is_available():
        return []
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(shape: Sequence[int], axes: Sequence[str],
              devices: Optional[Sequence] = None) -> Mesh:
    """A mesh of ``shape`` named ``axes``: over ``devices`` (exactly
    prod(shape) of them, repeats allowed) or else the first prod(shape)
    visible cards."""
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    need = math.prod(shape)
    if devices is None:
        cards = visible_cards()
        if len(cards) < need:
            raise ValueError(f"Number of devices {len(cards)} must be >= the product of "
                             f"mesh_shape {shape}")
        devices = cards[:need]
    elif len(devices) != need:
        raise ValueError(f"{len(devices)} devices given for a mesh of shape {shape}")
    cells = np.empty(need, dtype=object)
    cells[:] = [torch.device(d) for d in devices]
    return Mesh(cells.reshape(shape), axes)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes)


def smoke_mesh(device: str = "cuda") -> Mesh:
    """A 1-D ``data`` mesh: over the visible cards, or over one CPU device
    with ``device="cpu"``."""
    if torch.device(device).type == "cpu":
        return make_mesh((1,), ("data",), devices=[torch.device(device)])
    return make_mesh((max(1, len(visible_cards())),), ("data",))
