"""State-map algebra of the tiled decode: compose / prefix-fold per-tile
(S, S) transfer maps in the (min,+) semiring, plain PyTorch.

A span of trellis steps is summarized by its (S, S) *state map*
M[i, j] = best metric of any path that enters the span in state i and leaves
it in state j.  Maps compose in the (min,+) semiring (``compose_maps``),
``identity_map`` is the semiring unit, and ``prefix_maps`` left-folds a stack
of per-tile maps into exclusive prefixes — prefix p applied to the initial
metric vector is *exactly* the full-length forward path metrics at tile p's
entry seam.  Each compose is one add and an exact min per element, then the
clamp to NEG_UNREACHABLE, in the reference's order, so the maps equal the
reference's bit for bit.  ``seam_argmin`` pins the tie-break: the lowest
state index among minimizers.

The reference's Pallas ``minplus_matmul`` is not on the tiled path (its seam
uses this algebra too) and is not ported here.
"""
from __future__ import annotations

import torch

from repro_torch.core.trellis import NEG_UNREACHABLE


def identity_map(n_states: int, batch_shape: tuple = (), device="cpu") -> torch.Tensor:
    """The (min,+) unit: 0 on the diagonal, +inf (NEG_UNREACHABLE) off it."""
    eye = torch.eye(n_states, dtype=torch.bool, device=device)
    unit = torch.where(eye, 0.0, NEG_UNREACHABLE).to(torch.float32)
    return unit.expand(tuple(batch_shape) + (n_states, n_states))


def compose_maps(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Sequence a's span followed by b's: ``c[i,j] = min_k a[i,k] + b[k,j]``,
    clamped so stacked unreachable (BIG + BIG) entries stay at the semiring
    +inf.  a, b: (..., S, S) with matching batch dims."""
    c = (a[..., :, :, None] + b[..., None, :, :]).amin(dim=-2)
    return torch.clamp(c, max=NEG_UNREACHABLE)


def prefix_maps(mats: torch.Tensor):
    """Exclusive (min,+) prefixes of a stack of per-tile state maps.

    mats: (P, ..., S, S), tile 0 first.  Returns ``(excl, total)`` where
    ``excl[p] = mats[0] ∘ ... ∘ mats[p-1]`` (the identity at p = 0) and
    ``total`` composes all P maps — a left fold, the reference's association
    order.
    """
    S = mats.shape[-1]
    acc = identity_map(S, mats.shape[1:-2], mats.device)
    excl = []
    for m in mats:
        excl.append(acc)  # the *exclusive* prefix
        acc = compose_maps(acc, m)
    return torch.stack(excl), acc


def tile_entry_metrics(excl: torch.Tensor, init_state: int = 0) -> torch.Tensor:
    """Forward path metrics entering each tile, for paths that start the
    full sequence in ``init_state``: excl (P, ..., S, S) -> (P, ..., S)."""
    return excl[..., init_state, :]


def seam_argmin(metrics: torch.Tensor) -> torch.Tensor:
    """Winning state on a seam metric vector (..., S) -> (...) int32; ties go
    to the LOWEST state index (torch.argmin's first-occurrence rule, as
    jnp.argmin's and the open-trellis frontier's)."""
    return torch.argmin(metrics, dim=-1).to(torch.int32)
