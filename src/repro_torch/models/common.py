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
this port executes.  What runs: data parallelism everywhere, and for
serving (prefill and decode) the ``model`` splits of heads, KV heads, ff,
vocab, experts and the cache's sequence (``split_refusal(serving=True)``);
the rest waits for the sub-items of item 9b.3 (``SUBITEMS``).

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
    return map_specs(lambda spec: init_block(spec, spec.shape, generator, device), specs)


def init_block(spec: ParamSpec, shape, generator: torch.Generator, device) -> torch.Tensor:
    """A tensor of ``shape`` (the spec's, or a block of it) drawn from
    ``spec``'s distribution on ``device`` (its std from the whole spec's
    fan-in)."""
    if spec.init == "zeros":
        return torch.zeros(shape, dtype=spec.dtype, device=device)
    if spec.init == "ones":
        return torch.ones(shape, dtype=spec.dtype, device=device)
    std = spec.scale
    if spec.fan_in and spec.init != "embed":
        std = spec.scale / np.sqrt(spec.fan_in)
    t = torch.randn(shape, generator=generator, device=device, dtype=torch.float32)
    return t.mul_(float(std)).to(spec.dtype)


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
#: execution (data parallelism)
BATCH_MESH_AXES = ("pod", "data")
#: the logical axes tensor-parallel serving splits over ``model``
SERVE_MODEL_AXES = ("heads", "kv_heads", "ff", "vocab", "expert", "kv_seq")
#: the block kinds tensor-parallel serving runs (mixers; ffns)
SERVE_MIXERS, SERVE_FFNS = ("attn", "attn_local"), ("mlp", "moe", "none")

#: ROADMAP.md item 9b.3's sub-items still open, each a refusal's reason
SUBITEMS = {
    "9b.3b": "tensor-parallel training: _xent_sharded, seq_shard_activations",
    "9b.3c": "FSDP/ZeRO execution over the batch axes",
    "9b.3d": "MLA, Mamba, xLSTM and the encoder-decoder family over model",
    "9b.3e": "the MoE data-parallel train step's aux exchange",
    "9b.3f": "multi-process meshes (--distributed)",
}


def _needs_mesh(name: str, item: str = "9b.3b"):
    raise NotImplementedError(
        f"{name}: not supported by repro_torch yet (ROADMAP.md queue 1, item {item}: "
        f"{SUBITEMS[item]})"
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


def split_refusal(sharding: NamedSharding, axes,
                  serving: bool = False) -> Optional[Tuple[str, str]]:
    """Why a tensor of logical ``axes`` placed by ``sharding`` cannot run in
    this port's execution, and the sub-item of 9b.3 that takes it (None
    when it can run).  A ``batch`` dimension cut over ``BATCH_MESH_AXES``
    always runs; with ``serving`` so does a dimension of
    ``SERVE_MODEL_AXES`` cut over ``model`` alone (tensor-parallel
    serving).  Any other cut over the batch axes is FSDP/ZeRO (9b.3c); any
    other cut is tensor-parallel training's (9b.3b)."""
    for d, entry in enumerate(sharding.spec):
        if sharding.pieces(d) == 1:
            continue
        name = axes[d] if d < len(axes) else None
        cut = sharding.spec.axes(d)
        if name == "batch" and set(cut) <= set(BATCH_MESH_AXES):
            continue
        if serving and name in SERVE_MODEL_AXES and cut == ("model",):
            continue
        if set(cut) <= set(BATCH_MESH_AXES):
            return f"dim {d} ({name}) split over {cut} (FSDP/ZeRO)", "9b.3c"
        return f"dim {d} ({name}) split over {cut} (tensor-parallel)", "9b.3b"
    return None


def require_data_parallel(mesh, rules, shape, axes, what: str) -> NamedSharding:
    """The placement of a tensor of ``shape``/``axes`` on ``mesh``; raises
    ``NotImplementedError`` naming its sub-item of 9b.3 when it splits
    anything but a batch dimension over the batch axes."""
    sh = logical_sharding(mesh, rules, shape, axes)
    why = split_refusal(sh, axes)
    if why is not None:
        _needs_mesh(f"{what}: {why[0]}", why[1])
    return sh


def require_servable(cfg, part, mesh, what: str) -> None:
    """Raise ``NotImplementedError`` naming its sub-item of 9b.3 when the
    configuration cannot be served tensor-parallel on ``mesh`` (its
    ``model`` axis above 1): the encoder-decoder family, a block kind
    other than ``SERVE_MIXERS``/``SERVE_FFNS`` (9b.3d), or
    ``seq_shard_activations`` (9b.3b)."""
    if _mesh_axis_size(mesh, "model") <= 1:
        return
    n = mesh.shape["model"]
    if cfg.family == "encdec":
        _needs_mesh(f"{what}: {cfg.name} (encoder-decoder) over model={n}", "9b.3d")
    for mixer, ffn in cfg.pattern:
        if mixer not in SERVE_MIXERS or ffn not in SERVE_FFNS:
            _needs_mesh(f"{what}: {cfg.name}'s {mixer!r}/{ffn!r} blocks over model={n}", "9b.3d")
    if part.seq_shard_activations:
        _needs_mesh(f"{what}: seq_shard_activations over model={n}", "9b.3b")


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


def dense_row_parallel(group, ps, xs, spec: str, compute_dtype, split: bool):
    """A dense layer over a group of model shards (``parallel.sharding.
    ModelShards``; ``ps`` each shard's parameter block, ``xs`` its input).
    Where the contracted dimension is ``split``, each shard's partial
    product of its blocks, summed by ``collectives.all_reduce`` (every
    shard gets the same bits), then the bias, if any; else the whole layer,
    once a device and never summed (a sum would count it n times)."""
    if not split:
        return group.once(lambda p, x: dense(p, x, spec, compute_dtype), ps, xs)
    from repro_torch.parallel import collectives

    parts = group.each(lambda p, x: torch.einsum(spec, x.to(compute_dtype),
                                                 p["kernel"].to(compute_dtype)), ps, xs)
    out = collectives.all_reduce(group.mesh, "model", parts)
    if "bias" in ps[0]:
        out = group.once(lambda p, y: y + p["bias"].to(compute_dtype), ps, out)
    return out


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


def embed_lookup_range(params, tokens, start: int, compute_dtype=torch.bfloat16):
    """The lookup in a block of the table that holds the vocabulary's rows
    ``[start, start + rows)``: each token's row there in the compute dtype,
    zeros for a token outside it (the blocks' lookups sum to the whole
    table's lookup exactly: one term a token is not zero)."""
    table = params["embedding"]
    local = tokens - start
    inside = (local >= 0) & (local < table.shape[0])
    rows = table[torch.where(inside, local, torch.zeros_like(local))].to(compute_dtype)
    return torch.where(inside[..., None], rows, torch.zeros((), dtype=compute_dtype,
                                                            device=rows.device))


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

