"""Model substrate: param-spec system, norms, dense/embedding, RoPE.

Params are plain nested dicts of tensors.  Every param is declared first as
a :class:`ParamSpec` carrying shape, dtype, *logical axis names* and an
initializer.  The spec tree gives, without any allocation, the tensors'
shapes and bytes (``spec_leaves``; ``serve.kv_cache.cache_bytes``) and a
tree of shape-and-dtype stand-ins on the ``meta`` device (``abstract``, the
reference's ``ShapeDtypeStruct`` tree), and ``init_params(specs,
generator)`` materializes them on the generator's device.  The logical
axes resolve to mesh placements as the reference's do (``resolve_axes``,
``shardings``, ``logical_sharding``: ``parallel/placement.py``'s
``PartitionSpec``/``NamedSharding``, from ``mesh.shape`` alone);
``constrain`` is the identity on values and checks the placement is one
this port executes (data parallelism; the rest waits for item 9b.3).

Numerics follow the reference's order of rounding: ``dense`` casts kernel
and input to the compute dtype, multiplies, then adds the bias cast to the
compute dtype; the norms compute in float32 and cast back; RoPE casts
``cos``/``sin`` to the input's dtype before they multiply.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.parallel.placement import NamedSharding, PartitionSpec

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


def tree_leaves_with_specs(specs) -> Tuple[List[ParamSpec], Any]:
    """(leaves, structure) of a spec tree: the leaves in the reference's
    pytree order, and the spec tree itself as the structure
    (``train.tree.tree_unflatten(structure, leaves)`` rebuilds a tree of
    the same keys)."""
    return spec_leaves(specs), specs


def abstract(specs):
    """The tree of ``meta``-device tensors of each spec's shape and dtype:
    the reference's ``ShapeDtypeStruct`` tree.  Nothing is allocated."""
    return map_specs(lambda s: torch.empty(s.shape, dtype=s.dtype, device="meta"), specs)


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
# Logical-axis -> mesh resolution                                               #
# ---------------------------------------------------------------------------- #

# Default logical rules.  Values are mesh axis names (or tuples).  An axis is
# only actually sharded if the dim size divides the mesh axis size (maybe-shard
# semantics) — this is what makes e.g. kv_heads=2 resolve under model=16.
DEFAULT_RULES: Dict[str, Any] = {
    "batch": ("pod", "data"),
    "embed": None,
    "ff": "model",
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "vocab": "model",
    "expert": "model",
    "expert_ff": None,
    "kv_lora": None,
    "seq": None,
    "seq_shard": "model",  # activations under Megatron-SP
    "dstate": None,
    "dinner": "model",  # mamba/xlstm inner dim
    "layers": None,
    "conv": None,
    "capacity": None,
    "frontend": None,
}

FSDP_RULES_OVERRIDE: Dict[str, Any] = {
    # ZeRO-3: additionally shard the embed dim of weights over the data axis
    "embed": "data",
}

#: the mesh axes a batch dimension may be split over in this port's
#: execution (data parallelism); any other split waits for item 9b.3
BATCH_MESH_AXES = ("pod", "data")


def _needs_mesh(name: str):
    raise NotImplementedError(
        f"{name}: not supported by repro_torch yet (ROADMAP.md queue 1, item 9b.3: "
        "tensor-parallel and FSDP/ZeRO execution, multi-process meshes)"
    )


def _mesh_axis_size(mesh, axis) -> int:
    if axis is None:
        return 1
    if isinstance(axis, (tuple, list)):
        out = 1
        for a in axis:
            out *= _mesh_axis_size(mesh, a)
        return out
    return mesh.shape[axis] if axis in mesh.shape else 1


def resolve_axes(mesh, rules: Dict[str, Any], shape, axes) -> PartitionSpec:
    """Logical axes -> PartitionSpec with divisibility (maybe-shard) checks
    and no mesh axis used twice.  Reads nothing of ``mesh`` but
    ``mesh.shape``."""
    used = set()
    out = []
    for size, name in zip(shape, axes):
        mesh_axis = rules.get(name) if name else None
        if mesh_axis is None:
            out.append(None)
            continue
        axes_tuple = mesh_axis if isinstance(mesh_axis, tuple) else (mesh_axis,)
        # drop axes missing from mesh, already used, or non-dividing
        kept = [a for a in axes_tuple if a in mesh.shape and a not in used]
        if not kept:
            out.append(None)
            continue
        total = 1
        for a in kept:
            total *= mesh.shape[a]
        if size % total != 0:
            # try progressively shorter prefixes
            while kept:
                kept = kept[:-1]
                total = 1
                for a in kept:
                    total *= mesh.shape[a]
                if kept and size % total == 0:
                    break
            if not kept:
                out.append(None)
                continue
        used.update(kept)
        out.append(tuple(kept) if len(kept) > 1 else kept[0])
    while out and out[-1] is None:
        out.pop()
    return PartitionSpec(*out)


def shardings(specs, mesh, rules: Optional[Dict[str, Any]] = None):
    """NamedSharding tree for a spec tree."""
    rules = {**DEFAULT_RULES, **(rules or {})}
    return map_specs(lambda s: NamedSharding(mesh, resolve_axes(mesh, rules, s.shape, s.axes)),
                     specs)


def logical_sharding(mesh, rules, shape, axes) -> NamedSharding:
    rules = {**DEFAULT_RULES, **(rules or {})}
    return NamedSharding(mesh, resolve_axes(mesh, rules, shape, axes))


def split_refusal(sharding: NamedSharding, axes) -> Optional[str]:
    """Why a tensor of logical ``axes`` placed by ``sharding`` cannot run in
    this port's data-parallel execution (None when it can): a dimension cut
    into more than one piece other than a ``batch`` dimension cut over
    ``BATCH_MESH_AXES``."""
    for d, entry in enumerate(sharding.spec):
        if sharding.pieces(d) == 1:
            continue
        name = axes[d] if d < len(axes) else None
        cut = sharding.spec.axes(d)
        if name == "batch" and set(cut) <= set(BATCH_MESH_AXES):
            continue
        kind = "FSDP/ZeRO" if set(cut) <= set(BATCH_MESH_AXES) else "tensor-parallel"
        return f"dim {d} ({name}) split over {cut} ({kind})"
    return None


def require_data_parallel(mesh, rules, shape, axes, what: str) -> NamedSharding:
    """The placement of a tensor of ``shape``/``axes`` on ``mesh``; raises
    ``NotImplementedError`` naming item 9b.3 when it splits anything but a
    batch dimension over the batch axes."""
    sh = logical_sharding(mesh, rules, shape, axes)
    why = split_refusal(sh, axes)
    if why is not None:
        _needs_mesh(f"{what}: {why}")
    return sh


def constrain(x, mesh, rules, axes):
    """The reference's ``with_sharding_constraint`` by logical axes: the
    identity on values, on any mesh and off it.  On a mesh it validates
    that ``axes`` name each dimension of ``x`` and resolve to a placement
    this port executes (a batch split at most; else item 9b.3)."""
    if mesh is None:
        return x
    if len(axes) != x.dim():
        raise ValueError(f"constrain: {len(axes)} logical axes for a {x.dim()}-dim tensor")
    require_data_parallel(mesh, rules, tuple(x.shape), axes, "constrain")
    return x


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

