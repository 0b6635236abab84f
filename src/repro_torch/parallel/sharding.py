"""Sharding helpers: logical-axis rules -> NamedShardings for whole step
signatures (params, optimizer state, batches, caches), and the placement of
trees on a mesh.

The resolution logic (maybe-shard divisibility, no axis reuse) lives in
models/common.py; this module packages it for the launchers, the serving
engine and the train step.  ``PartitionSpec`` and ``NamedSharding`` are
``parallel/placement.py``'s.  What this port executes on a mesh is data
parallelism: ``require_data_parallel_tree`` refuses, before anything is
allocated, a tree whose placement splits anything but batch dimensions over
the batch axes (tensor-parallel and FSDP/ZeRO execution wait for item
9b.3).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.models import common as cm
from repro_torch.parallel.placement import NamedSharding, PartitionSpec as P, Placed
from repro_torch.train.tree import tree_leaves, tree_map


def make_rules(part, extra: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    rules = dict(cm.DEFAULT_RULES)
    if part.fsdp:
        rules.update(cm.FSDP_RULES_OVERRIDE)
    if part.flash_decode:
        rules["kv_seq"] = "model"
    if extra:
        rules.update(extra)
    return rules


def batch_axes(mesh):
    return tuple(a for a in ("pod", "data") if a in mesh.shape)


def batch_spec(mesh, ndim: int, batch_dim: int = 0) -> P:
    """PartitionSpec sharding dim `batch_dim` over ("pod","data")."""
    ba = batch_axes(mesh)
    spec = [None] * ndim
    if ba:
        spec[batch_dim] = ba if len(ba) > 1 else ba[0]
    return P(*spec)


def named_sharding(mesh, spec: P) -> NamedSharding:
    return NamedSharding(mesh, spec)


def data_parallel_size(mesh) -> int:
    """The product of the mesh's batch axes' sizes."""
    dp = 1
    for a in batch_axes(mesh):
        dp *= mesh.shape[a]
    return dp


def shard_batch_tree(mesh, tree):
    """NamedShardings for a batch tree: dim 0 of every leaf is batch if it
    divides the dp size, else replicated."""
    dp = data_parallel_size(mesh)

    def one(leaf):
        shape = tuple(leaf.shape) if hasattr(leaf, "shape") else ()
        if len(shape) and shape[0] % dp == 0 and dp > 1:
            return NamedSharding(mesh, batch_spec(mesh, len(shape)))
        return NamedSharding(mesh, P())

    return tree_map(one, tree)


def step_shardings(model, mesh, shape_kind: str, B: int, S: int, rules=None):
    """(in_shardings, out_shardings) trees for a given step kind.

    train:  in = (params, batch) -> out (loss/metrics replicated)
    prefill: in = (params, batch, caches)
    decode: in = (params, tokens, positions, caches)
    """
    p_sh = model.param_shardings(mesh, rules)
    repl = NamedSharding(mesh, P())
    if shape_kind == "train":
        return p_sh, repl
    c_sh = model.cache_shardings(mesh, B, S, rules)
    return p_sh, c_sh


# --------------------------------------------------------------------------- #
# Port-only: the data-parallel rule and tree placement                         #
# --------------------------------------------------------------------------- #


def require_data_parallel_tree(shardings_tree, specs, what: str) -> None:
    """Raise ``NotImplementedError`` naming item 9b.3 when a leaf of the
    spec tree ``specs``, placed by the matching leaf of ``shardings_tree``,
    is split anywhere but a ``batch`` dimension over the batch axes (a
    parameter or optimizer-state leaf may not be split at all: it has no
    batch dimension)."""
    for sh, spec in zip(tree_leaves(shardings_tree), cm.spec_leaves(specs)):
        why = cm.split_refusal(sh, spec.axes)
        if why is not None:
            cm._needs_mesh(f"{what} on mesh {dict(sh.mesh.shape)}: a leaf of shape "
                           f"{spec.shape} has its {why}")


def place_tree(tree, shardings_tree):
    """Each tensor of ``tree`` placed by the matching NamedSharding (a leaf
    already placed by an equal sharding stays as it is)."""

    def one(x, sh):
        if isinstance(x, Placed):
            if x.sharding.spec == sh.spec and x.sharding.mesh == sh.mesh:
                return x
            x = x.gather()
        return sh.place(x)

    return tree_map(one, tree, shardings_tree)


def gather_tree(tree, device=None):
    """Every ``Placed`` leaf of ``tree`` gathered whole onto ``device``
    (default: each one's mesh's first device); other leaves as they are."""
    return tree_map(lambda x: x.gather(device) if isinstance(x, Placed) else x, tree)


def block_tree(tree, cell):
    """The tree of the blocks at mesh cell ``cell`` (plain tensors as they
    are)."""
    return tree_map(lambda x: x.block(cell) if isinstance(x, Placed) else x, tree)


@dataclasses.dataclass(frozen=True)
class DataShard:
    """One data-parallel shard of a batch on a mesh: its ``rows`` of the
    batch, the mesh ``cell`` it runs on and that cell's ``device``, and
    ``mesh``, the cells at its index of the batch axes (what its model
    calls take as their ``mesh=``)."""

    index: int
    rows: slice
    cell: Tuple[int, ...]
    device: torch.device
    mesh: Any


def data_shards(mesh, B: int) -> List[DataShard]:
    """The data-parallel shards of a batch of ``B`` rows: one per index of
    the batch axes (row-major, ``pod`` slowest), each holding contiguous
    rows, at index 0 of the other axes.  A batch that does not divide over
    the batch axes is replicated, as ``Model.batch_shardings`` places it,
    and runs once: one shard of every row on the mesh's first cell."""
    ba = batch_axes(mesh)
    dp = data_parallel_size(mesh)
    if B % dp:
        return [DataShard(0, slice(0, B), (0,) * len(mesh.axis_names), mesh.devices.flat[0],
                          mesh)]
    Bl = B // dp
    out = []
    for i in range(dp):
        idx = {a: int(j) for a, j in zip(ba, np.unravel_index(i, [mesh.shape[a] for a in ba]))} \
            if ba else {}
        cell = tuple(idx.get(a, 0) for a in mesh.axis_names)
        out.append(DataShard(i, slice(i * Bl, (i + 1) * Bl), cell, mesh.devices[cell],
                             mesh.sub(idx)))
    return out


def check_mesh(mesh, device_type: str, what: str) -> None:
    """A mesh a model's execution takes: a ``parallel.Mesh`` (TypeError
    otherwise) whose devices are of the model's type (ValueError)."""
    from repro_torch.parallel.mesh import Mesh

    if not isinstance(mesh, Mesh):
        raise TypeError(f"{what} takes a repro_torch.parallel.Mesh, got {type(mesh).__name__}")
    if mesh.device_type != device_type:
        raise ValueError(f"{what}: a mesh of {mesh.device_type} devices for a model on "
                         f"{device_type}")
