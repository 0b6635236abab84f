"""Sharding helpers: logical-axis rules -> NamedShardings for whole step
signatures (params, optimizer state, batches, caches), and the placement of
trees on a mesh.

The resolution logic (maybe-shard divisibility, no axis reuse) lives in
models/common.py; this module packages it for the launchers, the serving
engine and the train step.  ``PartitionSpec`` and ``NamedSharding`` are
``parallel/placement.py``'s.  What this port executes on a mesh:
data parallelism, and for serving tensor parallelism over ``model``
(``require_executable_tree(serving=True)``); anything else is refused,
before anything is allocated, naming its sub-item of item 9b.3.  A data
shard's cells along ``model`` are a :class:`ModelShards` (``model_shards``):
the serving path's per-layer loop over them.
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


def require_executable_tree(shardings_tree, specs, what: str, serving: bool = False) -> None:
    """Raise ``NotImplementedError`` naming its sub-item of 9b.3 when a leaf
    of the spec tree ``specs``, placed by the matching leaf of
    ``shardings_tree``, is split in a way this port does not execute
    (``models.common.split_refusal``: a batch dimension over the batch axes
    always runs; with ``serving`` the tensor-parallel serving splits over
    ``model`` too)."""
    for sh, spec in zip(tree_leaves(shardings_tree), cm.spec_leaves(specs)):
        why = cm.split_refusal(sh, spec.axes, serving)
        if why is not None:
            cm._needs_mesh(f"{what} on mesh {dict(sh.mesh.shape)}: a leaf of shape "
                           f"{spec.shape} has its {why[0]}", why[1])


def require_data_parallel_tree(shardings_tree, specs, what: str) -> None:
    """``require_executable_tree`` for training: a parameter or optimizer
    leaf may not be split at all (it has no batch dimension)."""
    require_executable_tree(shardings_tree, specs, what)


def place_tree(tree, shardings_tree, consume: bool = False):
    """Each tensor of ``tree`` placed by the matching NamedSharding (a leaf
    already placed by an equal sharding stays as it is).  Leaf by leaf;
    with ``consume`` each whole leaf is replaced in ``tree``'s own dicts by
    its placed value as soon as its blocks exist, so the whole tensor is
    freed then (unless the caller holds it elsewhere): the peak is the
    tree plus its largest leaf's blocks, where placing a copy would hold
    two trees."""

    def one(x, sh):
        if isinstance(x, Placed):
            if x.sharding.spec == sh.spec and x.sharding.mesh == sh.mesh:
                return x
            x = x.gather()
        return sh.place(x)

    if not consume:
        return tree_map(one, tree, shardings_tree)

    def walk(node, sh_node):
        for k in list(node):
            if isinstance(node[k], dict):
                walk(node[k], sh_node[k])
            else:
                node[k] = one(node[k], sh_node[k])
        return node

    return walk(tree, shardings_tree)


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


@dataclasses.dataclass(frozen=True)
class ModelShards:
    """The ``model`` shards of one data-parallel shard: ``mesh``, the cells
    at its index of the other axes (those axes kept with size 1); ``cells``,
    one cell of the whole mesh per index of ``model``; ``devices``, theirs.
    A per-layer loop over them runs the tensor-parallel model: ``each``
    calls a function once a shard (its own blocks), ``once`` once a
    distinct device (replicated values: shards that share a device share
    the result)."""

    mesh: Any
    cells: Tuple[Tuple[int, ...], ...]
    devices: Tuple[torch.device, ...]

    @property
    def n(self) -> int:
        return len(self.cells)

    def blocks(self, tree) -> list:
        """Each shard's block tree of the placed ``tree``."""
        return [block_tree(tree, c) for c in self.cells]

    def each(self, fn, *per_shard) -> list:
        return [fn(*args) for args in zip(*per_shard)]

    def once(self, fn, *per_shard) -> list:
        done: Dict[torch.device, Any] = {}
        out = []
        for dev, args in zip(self.devices, zip(*per_shard)):
            if dev not in done:
                done[dev] = fn(*args)
            out.append(done[dev])
        return out


def model_shards(mesh, cell) -> ModelShards:
    """The cells along ``model`` through ``cell`` (one cell of size 1 when
    the mesh has no ``model`` axis)."""
    names = mesh.axis_names
    cell = tuple(cell)
    if "model" not in names:
        return ModelShards(mesh.sub({a: cell[i] for i, a in enumerate(names)}), (cell,),
                           (mesh.devices[cell],))
    k = names.index("model")
    cells = tuple(cell[:k] + (j,) + cell[k + 1:] for j in range(mesh.shape["model"]))
    sub = mesh.sub({a: cell[i] for i, a in enumerate(names) if a != "model"})
    return ModelShards(sub, cells, tuple(mesh.devices[c] for c in cells))


def check_mesh(mesh, device_type: str, what: str) -> None:
    """A mesh a model's execution takes: a ``parallel.Mesh`` (TypeError
    otherwise) whose devices are of the model's type (ValueError)."""
    from repro_torch.parallel.mesh import Mesh

    if not isinstance(mesh, Mesh):
        raise TypeError(f"{what} takes a repro_torch.parallel.Mesh, got {type(mesh).__name__}")
    if mesh.device_type != device_type:
        raise ValueError(f"{what}: a mesh of {mesh.device_type} devices for a model on "
                         f"{device_type}")
