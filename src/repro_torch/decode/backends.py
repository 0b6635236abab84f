"""The decode backends on the DecoderRegistry.

Ported: ``fused_packed`` (the packed scan + traceback kernels, with a
raw-symbol entry that computes branch metrics in the scan kernel and a
bm-table entry that feeds the same kernel through ``table_weights``),
``fused`` (the scan with unpacked survivors + the plain traceback),
``tiled`` (the windowed scan + windowed traceback kernels, both entries),
``streaming`` (the carried unpacked scan behind a windowed stream session),
``parallel`` (the windowed scan, the (min,+) product, the carried unpacked
scan and the packed traceback kernels), ``seqparallel`` (the same kernels
over the shards of a device mesh, parallel/collectives.py),
``sharded_stream`` (a stream scheduler whose slots span the shards of a
mesh: the carried scan kernels and the packed traceback once per shard a
tick), ``bcjr`` and ``turbo`` (the two BCJR scan kernels, the SISO family)
and ``sequential`` (the plain oracle).  Importing this module (which
``repro_torch.decode`` does) populates the registry.
"""
from __future__ import annotations

import torch

from repro_torch.core.viterbi import viterbi_decode
from repro_torch.decode.registry import BackendCapabilities, register_decoder
from repro_torch.decode.request import DecodeContext, DecodeResult
from repro_torch.decode.spec import CodecSpec
from repro_torch.kernels.metrics import fused_metric_plan
from repro_torch.kernels.ops import (
    bcjr_llr_op,
    viterbi_decode_fused,
    viterbi_decode_fused_packed,
    viterbi_decode_packed,
    viterbi_decode_parallel_op,
    viterbi_decode_tiled_fused,
    viterbi_decode_tiled_op,
)
from repro_torch.kernels.tiling import default_tiles
from repro_torch.siso.turbo import turbo_decode

#: Largest trellis the fused scan takes: the planner's cap for the fused
#: routes, kept equal to the reference's so both pick the same backend (the
#: CUDA scan kernel's own limit, viterbi_scan.MAX_STATES, is the same 4096).
FUSED_MAX_STATES = 4096


def _result(spec, bits, metric, **diag) -> DecodeResult:
    return DecodeResult(bits=bits, path_metric=metric, spec=spec, diagnostics=diag)


@register_decoder(
    "fused",
    capabilities=BackendCapabilities(family="conv", max_states=FUSED_MAX_STATES),
)
def decode_fused(spec: CodecSpec, bm_tables, *, ctx: DecodeContext) -> DecodeResult:
    """Scan kernel with on-chip path metrics and unpacked int32 survivors
    (the paper's Texpand loop kept on the chip) + the plain torch traceback
    of core/viterbi.py."""
    bits, metric = viterbi_decode_fused(
        spec.code, ctx.place(bm_tables), terminated=spec.terminated
    )
    return _result(spec, bits, metric, backend="fused")


def _fused_packed_from_received(
    spec: CodecSpec, received, *, ctx: DecodeContext
) -> DecodeResult:
    """Raw-symbol entry: branch metrics computed in the scan kernel — the
    (B, T, M) bm table never exists."""
    plan = fused_metric_plan(spec.code, spec.metric, spec.puncture_array)
    bits, metric = viterbi_decode_fused_packed(
        plan, ctx.place(received), terminated=spec.terminated
    )
    return _result(spec, bits, metric, backend="fused_packed", metrics="in-kernel")


@register_decoder(
    "fused_packed",
    capabilities=BackendCapabilities(
        family="conv", max_states=FUSED_MAX_STATES, accepts_received=True
    ),
    from_received=_fused_packed_from_received,
)
def decode_fused_packed(spec: CodecSpec, bm_tables, *, ctx: DecodeContext) -> DecodeResult:
    """Packed forward scan kernel with on-chip path metrics and bit-packed
    survivors + packed traceback kernel; given raw symbols it also computes
    branch metrics in the scan kernel."""
    bits, metric = viterbi_decode_packed(
        spec.code, ctx.place(bm_tables), terminated=spec.terminated
    )
    return _result(spec, bits, metric, backend="fused_packed", metrics="table")


def _tile_count(ctx: DecodeContext, B: int, T: int, S: int) -> int:
    """ctx.tiles when the caller (or the planner) pinned one, else the
    shape-derived default.  A pinned count below 1 raises: it is never
    quietly replaced."""
    if ctx.tiles is None:
        return default_tiles(B, T, S)
    if int(ctx.tiles) < 1:
        raise ValueError(f"tiled backend needs ctx.tiles >= 1, got {ctx.tiles}")
    return int(ctx.tiles)


def _tiled_from_received(spec: CodecSpec, received, *, ctx: DecodeContext) -> DecodeResult:
    """Raw-symbol entry: each tile computes its branch metrics in the scan
    kernel."""
    received = ctx.place(received)
    B, T = received.shape[:2]
    n = _tile_count(ctx, B, T, spec.code.n_states)
    plan = fused_metric_plan(spec.code, spec.metric, spec.puncture_array)
    bits, metric = viterbi_decode_tiled_fused(
        plan, received, n_tiles=n, overlap=ctx.tile_overlap, terminated=spec.terminated
    )
    return _result(spec, bits, metric, backend="tiled", tiles=n,
                   overlap=ctx.tile_overlap, metrics="in-kernel")


@register_decoder(
    "tiled",
    capabilities=BackendCapabilities(
        family="conv", max_states=FUSED_MAX_STATES, accepts_received=True
    ),
    from_received=_tiled_from_received,
)
def decode_tiled(spec: CodecSpec, bm_tables, *, ctx: DecodeContext) -> DecodeResult:
    """Time-parallel tiled decode: T splits into ctx.tiles tiles that run
    through the windowed packed scan kernel as ONE launch (tiles on the lane
    axis), seams resolved by the min-plus state-map composition, every tile
    traced back in one windowed-traceback launch — exact in the default
    regime."""
    bm_tables = ctx.place(bm_tables)
    B, T = bm_tables.shape[:2]
    n = _tile_count(ctx, B, T, spec.code.n_states)
    bits, metric = viterbi_decode_tiled_op(
        spec.code, bm_tables, n_tiles=n, overlap=ctx.tile_overlap, terminated=spec.terminated
    )
    return _result(spec, bits, metric, backend="tiled", tiles=n,
                   overlap=ctx.tile_overlap, metrics="table")


@register_decoder("sequential", capabilities=BackendCapabilities(family="conv"))
def decode_sequential(spec: CodecSpec, bm_tables, *, ctx: DecodeContext) -> DecodeResult:
    """Plain sequential decoder — the oracle every other backend is tested
    against."""
    bits, metric = viterbi_decode(spec.code, ctx.place(bm_tables), terminated=spec.terminated)
    return _result(spec, bits, metric, backend="sequential")


@register_decoder("parallel", capabilities=BackendCapabilities(family="conv"))
def decode_parallel(spec: CodecSpec, bm_tables, *, ctx: DecodeContext) -> DecodeResult:
    """(min,+) associative scan over chunk transfer matrices — log-depth in
    the number of chunks, the single-device long-block decoder (trellises up
    to the scan kernels' 4096 states)."""
    bits, metric = viterbi_decode_parallel_op(
        spec.code, ctx.place(bm_tables), chunk=ctx.chunk, terminated=spec.terminated
    )
    return _result(spec, bits, metric, backend="parallel", chunk=ctx.chunk)


@register_decoder(
    "seqparallel",
    capabilities=BackendCapabilities(family="conv", supports_mesh=True, requires_mesh=True),
)
def decode_seqparallel(spec: CodecSpec, bm_tables, *, ctx: DecodeContext) -> DecodeResult:
    """Sequence-parallel decode over ``ctx.mesh``: the time axis is split
    across its ``ctx.mesh_axis`` shards, each shard's transfer matrix is
    all-gathered (n·S² floats a stream, independent of T), and each shard
    re-scans its chunk from the folded prefix (parallel/collectives.py)."""
    from repro_torch.parallel.collectives import viterbi_decode_seqparallel

    if ctx.mesh is None:
        raise ValueError("seqparallel backend needs ctx.mesh")
    bits, metric = viterbi_decode_seqparallel(
        spec.code, ctx.place(bm_tables), ctx.mesh, axis=ctx.mesh_axis,
        terminated=spec.terminated,
    )
    return _result(
        spec, bits, metric, backend="seqparallel",
        mesh_axis=ctx.mesh_axis, mesh_size=int(ctx.mesh.shape[ctx.mesh_axis]),
    )

@register_decoder(
    "sharded_stream",
    capabilities=BackendCapabilities(
        family="conv",
        supports_mesh=True,
        requires_mesh=True,
        supports_streaming=True,
        sharded_stream=True,
        online=True,
        max_states=FUSED_MAX_STATES,
    ),
)
def decode_sharded_stream(spec: CodecSpec, bm_tables, *, ctx: DecodeContext) -> DecodeResult:
    """Mesh-sharded continuous-batching scheduler: the (B, T, M) block runs
    as B streams through ONE StreamScheduler whose slot table, input arena
    and survivor ring are partitioned along ``ctx.batch_axis`` — every shard
    on that axis decodes its block of the slots each tick, on its device.
    Each block row enters through ``submit`` — the documented adapter over
    the scheduler's chunk-fed ingestion path (``online=True``: live callers
    use open_stream/submit_chunk against the same machinery)."""
    import numpy as np

    from repro_torch.parallel.collectives import mesh_axis_size
    from repro_torch.stream import StreamScheduler
    from repro_torch.stream.window import default_depth

    if ctx.mesh is None:
        raise ValueError("sharded_stream backend needs ctx.mesh")
    n = mesh_axis_size(ctx.mesh, ctx.batch_axis)
    if not n:
        raise ValueError(f"mesh lacks batch axis {ctx.batch_axis!r}")
    B = bm_tables.shape[0]
    depth = ctx.stream_depth if ctx.stream_depth is not None else default_depth(spec.code)
    n_slots = -(-B // n) * n  # the slot table must divide over the shards
    backend = "fused_packed" if ctx.chunk % 32 == 0 else "fused"
    sched = StreamScheduler(
        spec, n_slots=n_slots, chunk=ctx.chunk, depth=depth, backend=backend,
        device=ctx.device, mesh=ctx.mesh, mesh_axis=ctx.batch_axis,
    )
    tables = bm_tables.detach().cpu().numpy()  # the scheduler takes host rows
    for i in range(B):
        sched.submit(str(i), tables[i])
    out = sched.run()
    home = ctx.home()
    bits = torch.from_numpy(np.stack([out[str(i)][0] for i in range(B)])).to(home)
    metric = torch.tensor([out[str(i)][1] for i in range(B)], dtype=torch.float32, device=home)
    return _result(
        spec, bits, metric, backend="sharded_stream", shards=n,
        batch_axis=ctx.batch_axis, n_slots=n_slots, depth=depth, hot_loop=backend,
    )


def _bcjr_from_received(spec: CodecSpec, received, *, ctx: DecodeContext) -> DecodeResult:
    """Raw-symbol entry: channel output -> per-coded-bit LLR columns through
    the spec (puncture-masked), then the SISO kernels."""
    return decode_bcjr(spec, spec.branch_metrics(ctx.place(received)), ctx=ctx)


@register_decoder(
    "bcjr",
    capabilities=BackendCapabilities(
        family="rsc", max_states=FUSED_MAX_STATES, accepts_received=True
    ),
    from_received=_bcjr_from_received,
)
def decode_bcjr(spec: CodecSpec, llr_coded, *, ctx: DecodeContext) -> DecodeResult:
    """Max-log-MAP BCJR SISO decoder (the alpha and beta/LLR scan kernels)
    for recursive systematic codes — bits are LLR signs, posterior LLRs ride
    along in the diagnostics for iterative (turbo) consumers."""
    llr, metric = bcjr_llr_op(spec.code, ctx.place(llr_coded), terminated=spec.terminated)
    bits = (llr < 0).to(torch.int32)
    return _result(spec, bits, metric, backend="bcjr", llr=llr)


def _turbo_from_received(spec, received, *, ctx: DecodeContext) -> DecodeResult:
    """Raw-symbol entry: channel output -> depunctured stream LLRs through
    the TurboSpec, then the iterative loop."""
    return decode_turbo(spec, spec.channel_llrs(ctx.place(received)), ctx=ctx)


@register_decoder(
    "turbo",
    capabilities=BackendCapabilities(family="turbo", accepts_received=True),
    from_received=_turbo_from_received,
)
def decode_turbo(spec, llrs, *, ctx: DecodeContext) -> DecodeResult:
    """Iterative turbo decoder: two BCJR SISO passes per iteration exchanging
    scaled extrinsic LLRs through the spec's interleaver, early-exiting on
    LLR-sign agreement.  ``path_metric`` is the negated mean posterior |LLR|
    (lower = more confident, matching the minimized-metric convention)."""
    result = turbo_decode(spec, ctx.place(llrs), device=ctx.home())
    metric = -torch.mean(torch.abs(result.llr), dim=-1)
    return _result(
        spec, result.bits, metric, backend="turbo",
        iterations=result.iterations_run, converged=result.converged,
        agreement=result.agreement, llr=result.llr,
    )


@register_decoder(
    "streaming",
    capabilities=BackendCapabilities(family="conv", supports_streaming=True, online=True),
)
def decode_streaming(spec: CodecSpec, bm_tables, *, ctx: DecodeContext) -> DecodeResult:
    """Truncated-traceback sliding window over the carried chunk scan kernel
    (unpacked survivors) — O(depth + chunk) memory, the online path behind
    stream sessions (stream/)."""
    from repro_torch.stream.window import default_depth, viterbi_decode_windowed

    depth = ctx.stream_depth if ctx.stream_depth is not None else default_depth(spec.code)
    bits, metric = viterbi_decode_windowed(
        spec.code, ctx.place(bm_tables), depth=depth, chunk=ctx.chunk,
        terminated=spec.terminated,
    )
    return _result(spec, bits, metric, backend="streaming", depth=depth, chunk=ctx.chunk)
