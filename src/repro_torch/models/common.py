"""Model substrate: param-spec system, norms, dense/embedding, RoPE.

Params are plain nested dicts of tensors.  Every param is declared first as
a :class:`ParamSpec` carrying shape, dtype, *logical axis names* and an
initializer.  The spec tree gives, without any allocation, the tensors'
shapes and bytes (``spec_leaves``; ``serve.kv_cache.cache_bytes``), and
``init_params(specs, generator)`` materializes them on the generator's
device.  The reference's sharding helpers (``resolve_axes``,
``shardings``, ``logical_sharding``, ``constrain``) need a device mesh,
which the port does not have yet: they raise naming ROADMAP item 9b.

Numerics follow the reference's order of rounding: ``dense`` casts kernel
and input to the compute dtype, multiplies, then adds the bias cast to the
compute dtype; the norms compute in float32 and cast back; RoPE casts
``cos``/``sin`` to the input's dtype before they multiply.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

# ---------------------------------------------------------------------------- #
# Param specs                                                                   #
# ---------------------------------------------------------------------------- #


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]  # logical axis name per dim (None = replicated)
    init: str = "normal"  # normal | zeros | ones | embed
    scale: float = 1.0  # std multiplier for normal init (before fan-in scaling)
    fan_in: int = 0  # 0 -> no fan-in scaling
    dtype: torch.dtype = torch.float32

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} and axes {self.axes} differ in rank")

    @property
    def nbytes(self) -> int:
        return int(np.prod(self.shape)) * self.dtype.itemsize


def _is_spec(x) -> bool:
    return isinstance(x, ParamSpec)


def map_specs(fn: Callable[[ParamSpec], Any], specs):
    """The tree of ``fn(spec)`` for every leaf of a nested-dict spec tree.
    Leaves are visited in sorted key order (the reference's pytree order, so
    a generator's draws follow it); the result keeps the tree's key order."""
    if _is_spec(specs):
        return fn(specs)
    done = {k: map_specs(fn, specs[k]) for k in sorted(specs)}
    return {k: done[k] for k in specs}


def spec_leaves(specs) -> List[ParamSpec]:
    """The leaves of a spec tree, in sorted key order (the reference's
    pytree order)."""
    if _is_spec(specs):
        return [specs]
    return [leaf for k in sorted(specs) for leaf in spec_leaves(specs[k])]


def dtype_of(name) -> torch.dtype:
    """``"bfloat16"`` -> ``torch.bfloat16`` (a torch dtype passes through)."""
    return name if isinstance(name, torch.dtype) else getattr(torch, name)


def scalar(value: float, dtype: torch.dtype) -> torch.Tensor:
    """``value`` rounded to ``dtype``, as a 0-dim host tensor (an operand
    passed by value, no copy).  JAX rounds a Python scalar to the array's
    dtype before the op; torch would keep it in the op's wider math type."""
    return torch.tensor(value, dtype=dtype)


def init_params(specs, generator: torch.Generator, device=None):
    """Materialize a spec tree on ``device`` (default: the generator's),
    drawing from ``generator`` (torch raises unless it serves that device)
    leaf by leaf in sorted key order: the reference's distributions (normal with std
    ``scale``, over ``sqrt(fan_in)`` when set; ``embed`` std ``scale``;
    zeros; ones), drawn from torch's generator, so the numbers are not the
    reference's."""
    device = generator.device if device is None else device

    def one(spec: ParamSpec):
        if spec.init == "zeros":
            return torch.zeros(spec.shape, dtype=spec.dtype, device=device)
        if spec.init == "ones":
            return torch.ones(spec.shape, dtype=spec.dtype, device=device)
        std = spec.scale
        if spec.fan_in and spec.init != "embed":
            std = spec.scale / np.sqrt(spec.fan_in)
        t = torch.randn(spec.shape, generator=generator, device=device, dtype=torch.float32)
        return t.mul_(float(std)).to(spec.dtype)

    return map_specs(one, specs)


# ---------------------------------------------------------------------------- #
# Logical-axis -> mesh resolution (item 9b)                                     #
# ---------------------------------------------------------------------------- #


def _needs_mesh(name: str):
    raise NotImplementedError(
        f"{name} needs a device mesh, which repro_torch does not support yet "
        "(ROADMAP.md queue 1, item 9b)"
    )


def resolve_axes(mesh, rules, shape, axes):
    _needs_mesh("resolve_axes")


def shardings(specs, mesh, rules=None):
    _needs_mesh("shardings")


def logical_sharding(mesh, rules, shape, axes):
    _needs_mesh("logical_sharding")


def constrain(x, mesh, rules, axes):
    """Identity off-mesh (as the reference's); a mesh raises (item 9b)."""
    if mesh is None:
        return x
    _needs_mesh("constrain")


# ---------------------------------------------------------------------------- #
# Layers                                                                        #
# ---------------------------------------------------------------------------- #


def dense_spec(
    in_dims: Sequence[int],
    out_dims: Sequence[int],
    in_axes: Sequence[Optional[str]],
    out_axes: Sequence[Optional[str]],
    *,
    stack: int = 0,
    bias: bool = False,
    dtype=torch.float32,
    scale: float = 1.0,
):
    """Spec for a (possibly layer-stacked) dense kernel of shape
    (stack?, *in_dims, *out_dims)."""
    shape = tuple(in_dims) + tuple(out_dims)
    axes = tuple(in_axes) + tuple(out_axes)
    if stack:
        shape = (stack,) + shape
        axes = ("layers",) + axes
    fan_in = int(np.prod(in_dims))
    p = {"kernel": ParamSpec(shape, axes, "normal", scale, fan_in, dtype)}
    if bias:
        bshape = tuple(out_dims)
        baxes = tuple(out_axes)
        if stack:
            bshape = (stack,) + bshape
            baxes = ("layers",) + baxes
        p["bias"] = ParamSpec(bshape, baxes, "zeros", dtype=dtype)
    return p


def dense(params, x, spec: str, compute_dtype=torch.bfloat16):
    """Apply a dense layer given an einsum spec, e.g. '...d,dhq->...hq'."""
    kernel = params["kernel"].to(compute_dtype)
    y = torch.einsum(spec, x.to(compute_dtype), kernel)
    if "bias" in params:
        y = y + params["bias"].to(compute_dtype)
    return y


def norm_spec(d: int, *, stack: int = 0, style: str = "rms"):
    shape, axes = (d,), ("embed",)
    if stack:
        shape, axes = (stack, d), ("layers", "embed")
    init = "zeros" if style == "gemma" else "ones"
    p = {"scale": ParamSpec(shape, axes, init)}
    if style == "layer":
        p["bias"] = ParamSpec(shape, axes, "zeros")
    return p


def rmsnorm(params, x, eps: float = 1e-6, gemma: bool = False, compute_dtype=torch.bfloat16):
    x32 = x.to(torch.float32)
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    scale = params["scale"].to(torch.float32)
    if gemma:
        scale = scale + 1.0
    return (y * scale).to(compute_dtype)


def layernorm(params, x, eps: float = 1e-6, compute_dtype=torch.bfloat16):
    x32 = x.to(torch.float32)
    mu = x32.mean(dim=-1, keepdim=True)
    var = ((x32 - mu) ** 2).mean(dim=-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * params["scale"] + params["bias"]).to(compute_dtype)


def embed_spec(vocab: int, d: int, dtype=torch.float32):
    # std = 1/sqrt(d): keeps tied-head logits O(1) at init (gemma-style
    # embed_scale multiplies the *input* side back up by sqrt(d)).
    return {"embedding": ParamSpec((vocab, d), ("vocab", "embed"), "embed", d ** -0.5, 0, dtype)}


def embed_lookup(params, tokens, compute_dtype=torch.bfloat16):
    """Rows of the table in the compute dtype.  Gathering before the cast
    gives the same values as the reference's cast of the whole table."""
    return params["embedding"][tokens].to(compute_dtype)


def qknorm_spec(head_dim: int, stack: int = 0):
    shape, axes = (head_dim,), ("head_dim",)
    if stack:
        shape, axes = (stack, head_dim), ("layers", "head_dim")
    return {
        "q_scale": ParamSpec(shape, axes, "ones"),
        "k_scale": ParamSpec(shape, axes, "ones"),
    }


def headwise_rmsnorm(scale, x, eps=1e-6):
    """RMS norm over the last (head) dim; x: (..., head_dim)."""
    x32 = x.to(torch.float32)
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * scale.to(torch.float32)).to(x.dtype)


# ---------------------------------------------------------------------------- #
# RoPE                                                                          #
# ---------------------------------------------------------------------------- #


def rope_angles(positions: torch.Tensor, dim: int,
                theta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions: (..., S) int -> cos/sin (..., S, dim//2) float32."""
    exps = torch.arange(0, dim, 2, dtype=torch.float32, device=positions.device) / dim
    inv = 1.0 / (theta ** exps)
    ang = positions.to(torch.float32)[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: (..., S, H, D) with D even; cos/sin: (..., S, D//2)."""
    d2 = x.shape[-1] // 2
    x1, x2 = x[..., :d2], x[..., d2:]
    c = cos[..., None, :].to(x.dtype)
    s = sin[..., None, :].to(x.dtype)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def _gelu_tanh(x):
    # jax.nn.gelu's default is the tanh approximation; torch's is erf
    return F.gelu(x, approximate="tanh")


def activation(name: str) -> Callable:
    return {"silu": F.silu, "gelu": _gelu_tanh, "relu": F.relu}[name]

