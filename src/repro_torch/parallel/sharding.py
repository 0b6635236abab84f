"""The LM's sharding helpers (logical-axis rules -> per-device placements of
parameters, optimizer state, batches and caches).  They are the LM half of
the multi-device work and are not ported yet: each raises
``NotImplementedError`` naming ROADMAP.md queue 1, item 9b."""
from __future__ import annotations


def _not_ported(name: str):
    raise NotImplementedError(
        f"{name} is not ported to repro_torch yet: the LM's mesh pieces wait for "
        "ROADMAP.md queue 1, item 9b"
    )


def make_rules(part, extra=None):
    _not_ported("make_rules")


def batch_spec(mesh, ndim: int, batch_dim: int = 0):
    _not_ported("batch_spec")


def named_sharding(mesh, spec):
    _not_ported("named_sharding")


def shard_batch_tree(mesh, tree):
    _not_ported("shard_batch_tree")


def step_shardings(model, mesh, shape_kind: str, B: int, S: int, rules=None):
    _not_ported("step_shardings")
