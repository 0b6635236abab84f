"""Shape-aware decode planner.

``plan_decode(spec, shape)`` picks a backend from the code family, the
problem shape (B, T, S) and the context.  The choice is a pure function of
its inputs, can always be overridden with ``backend=...``, and every plan
carries an ``explain()`` string.  The rules are the reference planner's, so
both name the same backend for the same (spec, shape, context):

  * explicit ``backend=`` override wins (validated against capabilities);
  * non-Viterbi code families route first — a TurboSpec to ``turbo``, an
    RSC CodecSpec to ``bcjr`` — so the shape rules below select only among
    the Viterbi backends;
  * a streaming context (``ctx.streaming``) with a multi-device ``data``
    (``ctx.batch_axis``) mesh axis -> ``sharded_stream``; otherwise ->
    ``streaming``;
  * long blocks (T >= LONG_BLOCK_T) -> ``seqparallel`` when a mesh is
    present and T divides across its ``ctx.mesh_axis``; without a usable
    mesh the rule ``long-conv-tiled``: the time-parallel ``tiled`` backend
    with the pinned ``ctx.tiles`` or ``kernels/tiling.default_tiles``
    (``parallel`` for trellises past the tiled cap).  The reference scores
    tile counts with ``_pick_tiles``; the port keeps it beside the rule but
    does not plan with it: on the H100 its count-based pick ran a K=7
    single 65542-step block 2x slower than ``default_tiles`` (ROADMAP §3);
  * everything else (short batched blocks) -> ``fused_packed`` (packed
    scan + traceback kernels; in-kernel branch metrics when the request
    carries raw symbols), ``parallel`` for trellises past the fused cap.

The planner runs on ``ctx.home()`` (the mesh's first device, else
``ctx.device``): ``"cuda"`` without a card raises here, before anything
runs.

``DecodePlan.predicted_costs()`` counts the planned decode on ``meta``
tensors (``roofline/op_cost.py``): the torch ops it dispatches and each
kernel by its formula, with no device touched.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Sequence, Tuple, Union

import torch

from repro_torch.core.trellis import ConvCode
from repro_torch.decode import backends as _backends  # noqa: F401  (populates the registry)
from repro_torch.decode.registry import RegisteredDecoder, get_decoder
from repro_torch.decode.request import DecodeContext, DecodeRequest, DecodeResult
from repro_torch.decode.spec import CodecSpec, spec_family
from repro_torch.kernels.tiling import MIN_TILE_CORE, default_tiles
from repro_torch.parallel.mesh import Mesh
from repro_torch.siso.turbo import TurboSpec

#: family -> SISO backend the planner routes non-Viterbi specs to.
FAMILY_BACKENDS = {"rsc": "bcjr", "turbo": "turbo"}

#: Above this many trellis steps the time-parallel decoders take over from
#: the sequential-scan forward pass.
LONG_BLOCK_T = 1024


@dataclasses.dataclass(frozen=True)
class DecodePlan:
    """A resolved decode: spec + shape + backend choice + why."""

    spec: Union[CodecSpec, TurboSpec]
    backend: str
    batch: int
    steps: int
    ctx: DecodeContext
    reason: str
    device_kind: str

    @property
    def decoder(self) -> RegisteredDecoder:
        return get_decoder(self.backend)

    def predicted_costs(self) -> Optional[dict]:
        """Counted flops/bytes of the planned decode: the backend run on
        ``meta`` zeros of the planned shape under the op-and-kernel counter
        (``roofline/op_cost.count_fn_costs``: the dispatched torch ops, each
        kernel by its formula) — no kernel launched, no host sync, nothing
        allocated on a device.  Returns {"flops", "bytes", "input_bytes"} or
        None for backends that cannot run on ``meta`` (host-side
        orchestration such as the stream schedulers, a mesh)."""
        from repro_torch.roofline.op_cost import count_fn_costs

        try:
            ctx = dataclasses.replace(self.ctx, device="meta")
            bm = torch.zeros((self.batch, self.steps, self.spec.table_width),
                             dtype=torch.float32, device="meta")
            return count_fn_costs(lambda t: self.decoder(self.spec, t, ctx=ctx).bits, bm)
        except Exception:
            return None

    def explain(self, costs: bool = False) -> str:
        """Human-readable plan summary; ``costs=True`` appends the counted
        prediction (flops, bytes moved and their ratio) when the backend
        runs on ``meta``."""
        caps = self.decoder.capabilities
        text = (
            f"plan: backend={self.backend!r} for shape (B={self.batch}, T={self.steps}, "
            f"S={self.spec.code.n_states}) on {self.device_kind}\n"
            f"  spec: {self.spec.describe()}\n"
            f"  why:  {self.reason}\n"
            f"  caps: mesh={caps.supports_mesh} streaming={caps.supports_streaming} "
            f"max_states={caps.max_states} needs_terminated={caps.needs_terminated}"
        )
        if costs:
            c = self.predicted_costs()
            if c is None:
                text += "\n  cost: untraceable (host-side orchestration backend)"
            else:
                intensity = c["flops"] / c["bytes"] if c["bytes"] else 0.0
                text += (
                    f"\n  cost: ~{c['flops']:.3g} flops, ~{c['bytes']:.3g} bytes "
                    f"moved ({intensity:.2f} flops/byte), "
                    f"{c['input_bytes']:.3g} input bytes"
                )
        return text

    def execute(self, bm_tables) -> DecodeResult:
        """Run the planned backend on (B, T, M) branch-metric tables."""
        result = self.decoder(self.spec, bm_tables, ctx=self.ctx)
        result.plan = self
        return result

    def execute_request(self, request: DecodeRequest) -> DecodeResult:
        """Run the plan on a DecodeRequest, routing raw channel output to
        the backend's in-kernel-metric entry when it has one — the bm table
        is only built for backends that need it.  Precomputed ``bm_tables``
        take precedence over ``received``."""
        if request.bm_tables is not None:
            return self.execute(request.bm_tables)
        if request.received is None:
            raise ValueError("DecodeRequest needs received or bm_tables")
        received = self.ctx.place(request.received)
        if self.decoder.from_received is None:
            return self.execute(self.spec.branch_metrics(received))
        bad = int((~torch.isfinite(received)).sum())
        if bad:
            # the in-kernel metric path skips every table build where bad
            # values would otherwise surface — guard here, or a single NaN
            # symbol poisons the whole decode
            raise ValueError(
                f"non-finite input: {bad} NaN/Inf value(s) in received "
                f"symbols {tuple(received.shape)} — in-kernel branch metrics "
                "would silently corrupt the path metrics"
            )
        result = self.decoder.decode_received(self.spec, received, ctx=self.ctx)
        result.plan = self
        return result


@functools.lru_cache(maxsize=128)
def _pick_tiles(spec: CodecSpec, B: int, T: int, device_kind: str, chunk: int,
                device: str) -> Tuple[int, str]:
    """Tile count for a long-block tiled decode, chosen from the counted
    costs: the tiled backend costed once per candidate P (the
    ``predicted_costs()`` that ``explain(costs=True)`` reports) and the
    argmin of (flops + bytes) / P taken — the critical path when the P
    tiles run side by side on the lane axis.  Candidates that cannot be
    costed are skipped; if none can, the shape default.  Cached per (spec,
    shape, device).  ``plan_decode`` does not call it (module doc)."""
    S = spec.code.n_states
    fallback = default_tiles(B, T, S)
    cap = max(1, T // MIN_TILE_CORE)
    candidates = sorted({p for p in (1, 2, 4, 8, 16, 32) if p <= cap} | {fallback})
    scored = {}
    for p in candidates:
        plan = DecodePlan(
            spec=spec, backend="tiled", batch=B, steps=T,
            ctx=DecodeContext(chunk=chunk, tiles=p, device=device),
            reason="tile-count candidate", device_kind=device_kind,
        )
        c = plan.predicted_costs()
        if c is not None:
            scored[p] = (c["flops"] + c["bytes"]) / p
    if not scored:
        return fallback, "predicted_costs untraceable -> shape default"
    best = min(scored, key=scored.get)
    return best, (
        f"argmin of predicted (flops+bytes)/P over P in {list(scored)} "
        "(roofline predicted_costs)"
    )


def _normalize_shape(shape: Sequence[int]) -> Tuple[int, int]:
    """Accept (B, T) or a full (B, T, M) bm-table shape."""
    if len(shape) in (2, 3):
        return int(shape[0]), int(shape[1])
    raise ValueError(f"shape must be (B, T) or (B, T, M), got {tuple(shape)}")


def _normalize_spec(spec):
    """Promote a bare ConvCode to a CodecSpec; family specs with their own
    encode/metric surface (TurboSpec) pass through untouched."""
    if isinstance(spec, (CodecSpec, ConvCode)):
        return CodecSpec.of(spec)
    if isinstance(spec, TurboSpec):
        return spec
    raise TypeError(f"expected CodecSpec, ConvCode or TurboSpec, got {type(spec).__name__}")


def _validate(decoder: RegisteredDecoder, spec, ctx: DecodeContext) -> None:
    caps = decoder.capabilities
    fam = spec_family(spec)
    if caps.family != fam:
        raise ValueError(
            f"backend {decoder.name!r} decodes the {caps.family!r} code family, "
            f"spec is {fam!r} — pick a backend registered for that family"
        )
    S = spec.code.n_states
    if caps.requires_mesh and ctx.mesh is None:
        raise ValueError(f"backend {decoder.name!r} requires a mesh (pass mesh=/ctx.mesh)")
    if caps.max_states is not None and S > caps.max_states:
        raise ValueError(
            f"backend {decoder.name!r} handles at most {caps.max_states} states, "
            f"spec has {S}"
        )
    if caps.needs_terminated and not spec.terminated:
        raise ValueError(f"backend {decoder.name!r} only decodes terminated trellises")
    if (caps.sharded_stream and ctx.mesh is not None
            and not int(ctx.mesh.shape.get(ctx.batch_axis, 0))):
        raise ValueError(
            f"backend {decoder.name!r} shards over mesh axis "
            f"{ctx.batch_axis!r}, which {ctx.mesh} lacks"
        )


def plan_decode(
    spec: Union[CodecSpec, ConvCode, TurboSpec],
    shape: Sequence[int],
    *,
    mesh: Optional[Mesh] = None,
    backend: Optional[str] = None,
    ctx: Optional[DecodeContext] = None,
) -> DecodePlan:
    """Pick (or validate) a decode backend for a (B, T[, M]) problem.

    Args:
      spec: the CodecSpec or TurboSpec (a bare ConvCode is promoted with
        defaults).
      shape: (B, T) or the full (B, T, M) branch-metric table shape.
      mesh: convenience override for ``ctx.mesh``.
      backend: explicit registry name — skips auto-selection (still
        capability-validated).
      ctx: execution context (device, mesh, streaming flag, pinned tiles).

    Returns:
      DecodePlan; ``plan.execute_request(request)`` runs it, ``plan.explain()``
      says why.
    """
    spec = _normalize_spec(spec)
    B, T = _normalize_shape(shape)
    ctx = ctx or DecodeContext()
    if mesh is not None:
        ctx = dataclasses.replace(ctx, mesh=mesh)
    dev = ctx.home()
    device_kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    S = spec.code.n_states

    fam = spec_family(spec)
    if backend is not None:
        choice, reason = backend, f"explicit backend={backend!r} override"
    elif fam in FAMILY_BACKENDS:
        choice = FAMILY_BACKENDS[fam]
        reason = (
            f"code family {fam!r} -> registry family rule routes to "
            f"{choice!r} (shape rules below select only among 'conv'/Viterbi "
            "backends)"
        )
    elif ctx.streaming:
        n_data = (
            int(ctx.mesh.shape.get(ctx.batch_axis, 0)) if ctx.mesh is not None else 0
        )
        sharded_max = get_decoder("sharded_stream").capabilities.max_states
        if n_data > 1 and (sharded_max is None or S <= sharded_max):
            choice = "sharded_stream"
            reason = (
                f"session context with a multi-device mesh "
                f"({ctx.batch_axis}={n_data}) -> one scheduler spanning the "
                f"{ctx.batch_axis!r} axis (slot table sharded per device)"
            )
        elif n_data > 1:
            choice = "streaming"
            reason = (
                f"session context, {ctx.batch_axis}={n_data} mesh, but S={S} "
                f"exceeds the sharded stream's cap ({sharded_max}) -> "
                "single-device windowed decode"
            )
        else:
            choice = "streaming"
            reason = "session context given -> windowed online decode (O(depth+chunk) memory)"
    elif T >= LONG_BLOCK_T:
        n = int(ctx.mesh.shape.get(ctx.mesh_axis, 0)) if ctx.mesh is not None else 0
        if n and T % n == 0:
            choice = "seqparallel"
            reason = (
                f"long block (T={T} >= {LONG_BLOCK_T}) with a mesh "
                f"({ctx.mesh_axis}={n}, T divisible) -> shard the time axis"
            )
        else:
            if ctx.mesh is None:
                why_not = "no mesh"
            elif not n:
                why_not = f"mesh lacks axis {ctx.mesh_axis!r}"
            else:
                why_not = f"T % {ctx.mesh_axis}={n} != 0"
            tiled_max = get_decoder("tiled").capabilities.max_states
            if tiled_max is not None and S > tiled_max:
                choice = "parallel"
                reason = (
                    f"long block (T={T} >= {LONG_BLOCK_T}), {why_not}, and "
                    f"S={S} exceeds the tiled cap ({tiled_max}) -> "
                    "single-device (min,+) associative scan"
                )
            else:
                choice = "tiled"
                if ctx.tiles is not None:
                    tiles, how = int(ctx.tiles), "ctx.tiles pinned by caller"
                else:
                    tiles, how = default_tiles(B, T, S), "kernels/tiling.default_tiles"
                    ctx = dataclasses.replace(ctx, tiles=tiles)
                reason = (
                    f"long block (T={T} >= {LONG_BLOCK_T}), {why_not} -> "
                    f"rule 'long-conv-tiled': time-parallel tiled decode, "
                    f"P={tiles} ({how})"
                )
    else:
        fused_max = get_decoder("fused_packed").capabilities.max_states
        if fused_max is not None and S > fused_max:
            choice = "parallel"
            reason = (
                f"short block but S={S} exceeds the fused cap ({fused_max}) -> chunked scan"
            )
        else:
            choice = "fused_packed"
            reason = (
                f"short batched block (T={T} < {LONG_BLOCK_T}) -> "
                "packed scan kernel with on-chip path metrics + packed "
                "traceback kernel"
            )

    decoder = get_decoder(choice)
    _validate(decoder, spec, ctx)
    return DecodePlan(
        spec=spec, backend=choice, batch=B, steps=T, ctx=ctx,
        reason=reason, device_kind=device_kind,
    )


def decode(
    request: Union[DecodeRequest, CodecSpec, ConvCode, TurboSpec],
    received=None,
    *,
    mesh: Optional[Mesh] = None,
    backend: Optional[str] = None,
    ctx: Optional[DecodeContext] = None,
) -> DecodeResult:
    """One-shot decode: plan + execute.

    Either ``decode(DecodeRequest(spec, received=rx))`` or the shorthand
    ``decode(spec, rx)``.  Returns a DecodeResult whose ``info_bits`` has
    flush bits stripped per the spec.  Runs on ``ctx.device`` (default
    ``"cuda"``; raises when no card is present), or over ``mesh``
    (``ctx.mesh``), whose devices must be of ``ctx.device``'s type.
    """
    if not isinstance(request, DecodeRequest):
        request = DecodeRequest(spec=_normalize_spec(request), received=received)
    plan = plan_decode(request.spec, request.shape(), mesh=mesh, backend=backend, ctx=ctx)
    return plan.execute_request(request)
