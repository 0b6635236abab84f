"""Optimizers over nested dicts of tensors, updated in place.

AdamW keeps two float32 moments a parameter; Adafactor keeps factored
second moments, O(n+m) state per (n, m) matrix.  Both clip the gradients by
their global norm first.

Arithmetic follows the reference's order of rounding (a Python constant
meets a float32 tensor as a float32 value, as JAX's weak types do), but the
update writes into the parameter and state tensors it is given instead of
returning new trees (the reference's buffer donation), leaf by leaf and, for
large leaves, in slices along the first dimension: a 3.25 GB leaf never
needs more than a few slice-sized temporaries.  The clipped gradients are
never materialized as a tree: each slice is scaled as it is read.

Weight decay applies to leaves with ``ndim >= 2``, as in the reference.
Stacking the layers adds a dimension, so the stacked norm scales
``(layers, d)`` and the QKV biases are decayed too: a quirk of the
reference, kept.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Iterator, Tuple

import torch

from repro_torch.models import common as cm
from repro_torch.train.tree import tree_leaves, tree_map

#: elements of one slice of an in-place update (128 MB of float32)
SLICE_ELEMS = 1 << 25


def _f32(x) -> torch.Tensor:
    """A step or rate as a float32 scalar on the host (an operand passed by
    value to the device's kernels)."""
    return torch.as_tensor(x, dtype=torch.float32)


def _slices(t: torch.Tensor) -> Iterator[torch.Tensor]:
    """Views of ``t`` along its first dimension, each at most
    ``SLICE_ELEMS`` elements (at least one row)."""
    if t.dim() == 0 or t.numel() <= SLICE_ELEMS:
        yield t
        return
    rows = max(1, SLICE_ELEMS // (t.numel() // t.shape[0]))
    for r in range(0, t.shape[0], rows):
        yield t.narrow(0, r, min(rows, t.shape[0] - r))


# --------------------------------------------------------------------------- #
# Schedules                                                                    #
# --------------------------------------------------------------------------- #


def cosine_warmup(base_lr: float, warmup: int, total: int, min_frac: float = 0.1):
    """Linear warmup to ``base_lr``, then a cosine to ``min_frac`` of it.
    ``lr(step)`` is a float32 scalar on the host."""

    def lr(step):
        step = _f32(step)
        warm = base_lr * step / max(1.0, warmup)
        prog = torch.clamp((step - warmup) / max(1.0, total - warmup), 0.0, 1.0)
        cos = base_lr * (min_frac + (1 - min_frac) * 0.5 * (1 + torch.cos(math.pi * prog)))
        return torch.where(step < warmup, warm, cos)

    return lr


def _sq_norm(leaf: torch.Tensor) -> torch.Tensor:
    total = 0
    for s in _slices(leaf):
        total = total + torch.sum(torch.square(s.to(torch.float32)))
    return total


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in float32."""
    return torch.sqrt(sum(_sq_norm(leaf) for leaf in tree_leaves(tree)))


def _clip_scale(grads, max_norm: float) -> Tuple[torch.Tensor, torch.Tensor]:
    norm = global_norm(grads)
    return norm, torch.clamp(max_norm / torch.clamp_min(norm, 1e-9), max=1.0)


def _clipped(g: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``g * scale`` as the reference computes it: a bf16 gradient times the
    float32 scale promotes to float32 (torch would keep bf16 for a 0-dim
    scale)."""
    return g.to(torch.promote_types(g.dtype, torch.float32), copy=True).mul_(scale)


def clip_by_global_norm(tree, max_norm: float):
    """(the tree scaled so its global norm is at most ``max_norm``, the norm)."""
    norm, scale = _clip_scale(tree, max_norm)
    return tree_map(lambda g: _clipped(g, scale), tree), norm


def _write(p: torch.Tensor, new: torch.Tensor) -> None:
    """``p := new`` in ``p``'s dtype.  ``new`` is ``p.to(float32)`` updated
    in place: ``p`` itself when ``p`` is float32."""
    if new is not p:
        p.copy_(new)


# --------------------------------------------------------------------------- #
# AdamW                                                                        #
# --------------------------------------------------------------------------- #


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable
    update: Callable  # (grads, state, params, step, lr) -> (params, state, grad norm), in place
    state_specs: Callable  # param_specs -> state spec tree


def _zeros_f32(p: torch.Tensor) -> torch.Tensor:
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


def _f32_specs(param_specs):
    return cm.map_specs(lambda s: dataclasses.replace(s, dtype=torch.float32, init="zeros"),
                        param_specs)


def adamw(b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1, max_grad_norm=1.0) -> Optimizer:
    def init(params):
        return {"mu": tree_map(_zeros_f32, params), "nu": tree_map(_zeros_f32, params)}

    @torch.no_grad()
    def update(grads, state, params, step, lr):
        gnorm, scale = _clip_scale(grads, max_grad_norm)
        t = _f32(step) + 1.0
        c1 = 1.0 - b1 ** t
        c2 = 1.0 - b2 ** t
        lr = _f32(lr)
        for g, mu, nu, p in zip(tree_leaves(grads), tree_leaves(state["mu"]),
                                tree_leaves(state["nu"]), tree_leaves(params)):
            decay = p.dim() >= 2  # decoupled weight decay on matrices only
            for gs, mus, nus, ps in zip(_slices(g), _slices(mu), _slices(nu), _slices(p)):
                g32 = _clipped(gs, scale)
                mus.mul_(b1).add_(g32 * (1 - b1))
                nus.mul_(b2).add_((g32 * (1 - b2)).mul_(g32))
                upd = (mus / c1).div_((nus / c2).sqrt_().add_(eps))
                if decay:
                    upd.add_(ps.to(torch.float32) * weight_decay)
                _write(ps, ps.to(torch.float32).sub_(upd.mul_(lr)))
        return params, state, gnorm

    def state_specs(param_specs):
        m = _f32_specs(param_specs)
        return {"mu": m, "nu": m}

    return Optimizer(init, update, state_specs)


# --------------------------------------------------------------------------- #
# Adafactor (factored second moments)                                          #
# --------------------------------------------------------------------------- #


def adafactor(decay=0.8, eps=1e-30, clip_threshold=1.0, weight_decay=0.0,
              max_grad_norm=1.0, min_dim_size_to_factor=128) -> Optimizer:
    def _factored(shape) -> bool:
        return len(shape) >= 2 and shape[-1] >= min_dim_size_to_factor \
            and shape[-2] >= min_dim_size_to_factor

    def init(params):
        def one(p):
            if _factored(p.shape):
                return {"vr": torch.zeros(p.shape[:-1], dtype=torch.float32, device=p.device),
                        "vc": torch.zeros(p.shape[:-2] + p.shape[-1:], dtype=torch.float32,
                                          device=p.device)}
            return {"v": _zeros_f32(p)}

        return {"v": tree_map(one, params)}

    @torch.no_grad()
    def update(grads, state, params, step, lr):
        gnorm, scale = _clip_scale(grads, max_grad_norm)
        t = _f32(step) + 1.0
        beta = 1.0 - t ** (-decay)
        lr = _f32(lr)

        def upd(g, v, p):
            g = _clipped(g, scale)
            g2 = (g * g).add_(eps)
            if _factored(p.shape):
                vr = v["vr"].mul_(beta).add_(g2.mean(dim=-1).mul_(1 - beta))
                vc = v["vc"].mul_(beta).add_(g2.mean(dim=-2).mul_(1 - beta))
                denom = (vr / torch.clamp_min(vr.mean(dim=-1, keepdim=True), eps))[..., None] \
                    * vc[..., None, :]
            else:
                denom = v["v"].mul_(beta).add_(g2.mul_(1 - beta))
            u = g.mul_(torch.rsqrt(torch.clamp_min(denom, eps)))
            rms_u = torch.sqrt(torch.mean(u * u))
            u.div_(torch.clamp_min(rms_u / clip_threshold, 1.0))
            if weight_decay and p.dim() >= 2:
                u.add_(p.to(torch.float32) * weight_decay)
            _write(p, p.to(torch.float32).sub_(u.mul_(lr)))

        tree_map(upd, grads, state["v"], params)
        return params, state, gnorm

    def state_specs(param_specs):
        def one(s: cm.ParamSpec):
            f32 = dict(dtype=torch.float32, init="zeros")
            if _factored(s.shape):
                return {
                    "vr": dataclasses.replace(s, shape=s.shape[:-1], axes=s.axes[:-1], **f32),
                    "vc": dataclasses.replace(s, shape=s.shape[:-2] + s.shape[-1:],
                                              axes=s.axes[:-2] + s.axes[-1:], **f32),
                }
            return {"v": dataclasses.replace(s, **f32)}

        return {"v": cm.map_specs(one, param_specs)}

    return Optimizer(init, update, state_specs)


def get_optimizer(name: str, **kw) -> Optimizer:
    if name == "adamw":
        return adamw(**kw)
    if name == "adafactor":
        return adafactor(**kw)
    raise KeyError(name)
