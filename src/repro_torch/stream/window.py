"""Truncated-traceback sliding-window Viterbi — the streaming core.

After D ≈ 5·K steps all survivor paths merge with overwhelming probability,
so a decoder that traces back D steps from the current best state and
commits everything older is within noise of the full-block optimum and needs
O(D) memory for a stream of any length.

This module is the core shared by sessions and the scheduler:

  StreamState     carried across chunks: path metrics (B, S) and a
                  backpointer ring — (R, B, S) int32 for the unpacked
                  backends, (R/32, B, S) int32 packed survivor words for
                  ``fused_packed`` (R = depth + chunk).
  stream_step     advance C trellis steps (the carried unpacked scan
                  kernel, the carried packed scan kernel, or a plain torch
                  scan), shift the ring, traceback from the frontier, and
                  commit the C oldest window positions.
  stream_flush    final traceback over the whole ring at end of stream.
  viterbi_decode_windowed
                  offline (B, T, M) -> (B, T) decode through the streaming
                  machinery.

Backends: ``fused`` (kernels.ops.viterbi_forward_chunk_op: unpacked int32
ring, plain torch traceback), ``scan`` (plain torch reference), and
``fused_packed`` — bit-packed survivor ring (32× smaller), word-aligned ring
shifts (chunk % 32 == 0 and depth % 32 == 0; sessions round the depth up),
the packed traceback kernel over the words, and in-kernel branch metrics
when the caller feeds raw received symbols + folded metric weights.

Packed words and unpacked backpointers are both int32 here (the reference
tells them apart by dtype, uint32 vs int32), so the functions that take
either say which with an explicit ``packed`` flag.

Exactness: when depth >= T nothing commits before the flush, the ring holds
the whole history, and the flush traceback from the terminated state IS the
full-block Viterbi traceback.

On a device mesh (parallel/mesh.py, one controlling process) a state's slot
rows are cut into contiguous per-shard blocks, each on its shard's device
(``state_shardings``, ``shard_stream_state``), and the tick of the sharded
scheduler (``make_sharded_stream_step``) runs the gather and ``stream_step``
once per shard on that shard's device, with no transfer between shards:
slots are independent streams.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from repro_torch.core.acs import acs_step
from repro_torch.core.trellis import NEG_UNREACHABLE, ConvCode
from repro_torch.core.viterbi import _initial_pm, _traceback
from repro_torch.kernels import ops as _ops
from repro_torch.kernels.common import PACK_BITS, resolve_device
from repro_torch.kernels.metrics import fused_metric_plan
from repro_torch.kernels.survivors import unpack_survivors
from repro_torch.kernels.tiling import truncation_depth
from repro_torch.kernels.viterbi_scan import cached_table_weights

PACKED_BACKEND = "fused_packed"

BACKENDS = ("fused", PACKED_BACKEND, "scan")


def default_depth(code: ConvCode) -> int:
    """The textbook truncation rule, D = 5 * K (kernels.tiling owns it)."""
    return truncation_depth(code)


def packed_depth(depth: int) -> int:
    """Round a traceback depth up to the packed ring's word granularity.
    A deeper window only improves accuracy; the session lag grows with it."""
    return -(-depth // PACK_BITS) * PACK_BITS


def resolve_stream_backend(spec, chunk: int, depth: int, backend: str, inputs: str,
                           device="cuda"):
    """Shared session backend setup: validate the input kind, round the
    depth for the packed ring, and build the in-kernel metric plan.

    Returns (packed, depth, plan, weights): ``plan`` is the FusedMetricPlan
    for the packed backend (None otherwise); ``weights`` its folded kernel
    operands on ``device`` when raw symbols are fed (None -> bm-table
    weights).  ``device`` defaults to the card and raises without one.
    """
    if backend not in BACKENDS:
        raise KeyError(backend)
    packed = backend == PACKED_BACKEND
    if inputs not in ("bm", "received"):
        raise ValueError(f"inputs must be 'bm' or 'received', got {inputs!r}")
    if inputs == "received" and not packed:
        raise ValueError("inputs='received' needs the fused_packed backend")
    plan = weights = None
    if packed:
        if chunk % PACK_BITS:
            raise ValueError(f"{PACKED_BACKEND} streaming needs chunk % {PACK_BITS} == 0")
        depth = packed_depth(depth)
        plan = fused_metric_plan(spec.code, spec.metric, spec.puncture_array)
        if inputs == "received":
            weights = _ops.plan_weights(plan, resolve_device(device))
    return packed, depth, plan, weights


class DeviceCounters(NamedTuple):
    """Per-slot decode statistics accumulated on the device in every step.

    Every field is a (B,) tensor on the stream's device; the session carries
    them across steps like any other state and reads them back only at
    report time — device telemetry never adds a per-step host sync.

    ticks:            active steps this slot advanced through.
    starved_ticks:    steps the slot sat masked inactive.
    merge_depth_last: survivor merge depth after the latest active step.
    merge_depth_sum:  sum of per-step merge depths (mean = sum / ticks).
    merge_depth_max:  worst merge depth observed.
    renorm_sum:       accumulated |path-metric renormalization offset|.
    """

    ticks: torch.Tensor
    starved_ticks: torch.Tensor
    merge_depth_last: torch.Tensor
    merge_depth_sum: torch.Tensor
    merge_depth_max: torch.Tensor
    renorm_sum: torch.Tensor


def init_device_counters(batch: int, device="cuda") -> DeviceCounters:
    """Zeroed counters on ``device`` (the card by default; raises without one)."""
    device = resolve_device(device)
    z_i = torch.zeros((batch,), dtype=torch.int32, device=device)
    z_f = torch.zeros((batch,), dtype=torch.float32, device=device)
    return DeviceCounters(
        ticks=z_i, starved_ticks=z_i, merge_depth_last=z_i,
        merge_depth_sum=z_f, merge_depth_max=z_i, renorm_sum=z_f,
    )


def survivor_merge_depth(code: ConvCode, ring: torch.Tensor, packed: bool = False) -> torch.Tensor:
    """All-states-agree depth of a survivor ring: the smallest d such that
    tracing back d steps from the frontier collapses every state's survivor
    path onto one trellis node (R + 1 when the window never merges).

    ``ring``: (R, B, S) int32 backpointer parities, or packed (R/32, B, S)
    int32 words with ``packed=True``; returns (B,) int32.  An S-walker
    reverse walk over the ring in plain torch.
    """
    if packed:
        ring = unpack_ring(code, ring)
    R, B, S = ring.shape
    half = S // 2
    walkers = torch.arange(S, dtype=torch.int64, device=ring.device).expand(B, S)
    merged = torch.empty((R, B), dtype=torch.bool, device=ring.device)
    # reverse walk: merged[i] == "walkers coalesced after absorbing steps
    # R-1 .. i", i.e. within depth R - i of the frontier.  Coalesced walkers
    # stay coalesced, so merged is monotone in depth; the merge depth is the
    # shallowest True.
    for i in range(R - 1, -1, -1):
        j = torch.gather(ring[i].to(torch.int64), 1, walkers)
        walkers = 2 * (walkers & (half - 1)) + j
        merged[i] = (walkers == walkers[:, :1]).all(dim=1)
    steps = torch.arange(R, dtype=torch.int32, device=ring.device)[:, None]
    idx = torch.where(merged, steps, -1).amax(dim=0)
    return torch.where(idx >= 0, R - idx, R + 1).to(torch.int32)


class StreamState(NamedTuple):
    """Carried decode state — everything a stream needs across chunks.

    pm:   (B, S) float32 path metrics at the stream frontier (renormalized,
          see stream_step).
    ring: backpointer ring over the last R = depth + chunk steps; slot i
          holds the backpointers of absolute step ``t - R + i`` (pre-stream
          slots hold zeros and are never committed by the session
          bookkeeping).  (R, B, S) int32 unpacked, or (R/32, B, S) int32
          survivor words for the packed backend.
    """

    pm: torch.Tensor
    ring: torch.Tensor


def init_stream_state(
    code: ConvCode, batch: int, depth: int, chunk: int, packed: bool = False, device="cuda"
) -> StreamState:
    """Fresh state on ``device`` (the card by default; raises without one):
    paths start in state 0, empty ring."""
    device = resolve_device(device)
    R = depth + chunk
    if packed:
        if R % PACK_BITS:
            raise ValueError(
                f"packed ring needs (depth + chunk) % {PACK_BITS} == 0, "
                f"got depth={depth}, chunk={chunk} (see packed_depth())"
            )
        R //= PACK_BITS
    ring = torch.zeros((R, batch, code.n_states), dtype=torch.int32, device=device)
    return StreamState(pm=_initial_pm(code, (batch,), device), ring=ring)


def chunk_forward_scan(
    code: ConvCode, pm: torch.Tensor, bm_chunk: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain torch chunked forward pass (the oracle for the chunk scan
    kernels, and the path for odd-length stream tails).
    pm: (B, S); bm_chunk: (B, C, M) -> (new_pm, bps (C, B, S) int32)."""
    bps = []
    for t in range(bm_chunk.shape[1]):
        new_pm, bp = acs_step(code, pm, bm_chunk[:, t])
        pm = torch.clamp(new_pm, max=NEG_UNREACHABLE)
        bps.append(bp)
    return pm, torch.stack(bps)


def stream_step(
    code: ConvCode,
    state: StreamState,
    chunk_inputs: torch.Tensor,
    weights=None,
    active: Optional[torch.Tensor] = None,
    backend: str = "fused",
    normalize: bool = True,
    counters: Optional[DeviceCounters] = None,
):
    """One streaming update: advance C steps, commit the C oldest positions.

    Args:
      chunk_inputs: (B, C, M) branch metrics — or, for the packed backend
        with in-kernel metrics, (B, C, F) raw features matching ``weights``.
      weights: (b0, b1, rb) folded metric weights for ``fused_packed``
        (None -> the bm-table weights; ignored by the other backends).
      active: optional (B,) bool mask — rows where it is False keep their
        pm/ring EXACTLY as they were (the batched kernel still runs over
        them, but its result is discarded row-wise).  Advancing a real
        stream with zero branch metrics is NOT a no-op, so masked rows are
        re-selected, not fed zeros.  None == all rows active.
      backend: 'fused' (carried unpacked scan kernel), 'fused_packed'
        (carried packed scan kernel + packed traceback kernel; C % 32 == 0),
        or 'scan' (plain torch).
      normalize: subtract the per-stream min from the path metrics so an
        unbounded stream never overflows float32; the subtracted offset is
        returned so callers can reconstruct absolute metrics.
      counters: optional DeviceCounters to advance (merge depth, starved
        ticks, renorm magnitude).  When given the return value grows a
        fourth element — the updated counters — and the step gains the
        S-walker merge-depth walk; rows masked inactive keep their last
        merge depth and count a starved tick.

    Returns:
      new_state: state after the chunk (ring shifted by C).
      committed: (B, C) decoded bits for the C oldest window positions —
        positions [t - R, t - D) where t is the new frontier.  The caller
        masks off any that predate the stream start; rows masked inactive
        hold garbage the caller must ignore.
      offset_delta: (B,) the amount subtracted from the path metrics (0 for
        masked rows).
      counters: updated DeviceCounters — only when ``counters`` was passed.
    """
    pm, ring = state
    C = chunk_inputs.shape[1]
    packed = backend == PACKED_BACKEND
    if packed:
        if C % PACK_BITS:
            raise ValueError(f"{PACKED_BACKEND} needs chunk % {PACK_BITS} == 0, got {C}")
        w = cached_table_weights(code, chunk_inputs.device) if weights is None else weights
        new_pm, words = _ops.viterbi_forward_weighted_op(code, pm, chunk_inputs, w)
        ring = torch.cat([ring[C // PACK_BITS:], words], dim=0)
        best = torch.argmin(new_pm, dim=-1).to(torch.int32)
        bits = _ops.viterbi_traceback_op(code, ring, best, ring.shape[0] * PACK_BITS)
    else:
        if backend == "fused":
            new_pm, bps = _ops.viterbi_forward_chunk_op(code, pm, chunk_inputs)
        elif backend == "scan":
            new_pm, bps = chunk_forward_scan(code, pm, chunk_inputs)
        else:
            raise KeyError(backend)
        ring = torch.cat([ring[C:], bps], dim=0)
        # truncated traceback: from the best frontier state back through the
        # whole window; only the positions >= depth behind the frontier commit
        best = torch.argmin(new_pm, dim=-1).to(torch.int32)
        bits, _ = _traceback(code, ring, best)  # (B, R)
    committed = bits[:, :C]

    if normalize:
        delta = new_pm.amin(dim=-1)
        new_pm = torch.clamp(new_pm - delta[:, None], max=NEG_UNREACHABLE)
    else:
        delta = torch.zeros(new_pm.shape[:1], dtype=new_pm.dtype, device=new_pm.device)
    if active is not None:
        keep = active.to(torch.bool)
        new_pm = torch.where(keep[:, None], new_pm, pm)
        ring = torch.where(keep[None, :, None], ring, state.ring)
        delta = torch.where(keep, delta, torch.zeros_like(delta))
    new_state = StreamState(pm=new_pm, ring=ring)
    if counters is None:
        return new_state, committed, delta
    act = (
        active.to(torch.bool)
        if active is not None
        else torch.ones(new_pm.shape[:1], dtype=torch.bool, device=new_pm.device)
    )
    # merge depth on the post-mask ring: inactive rows kept their ring, so
    # the recomputed value equals their previous one — the where keeps the
    # bookkeeping explicit anyway.
    md = survivor_merge_depth(code, ring, packed=packed)
    advanced = act.to(torch.int32)
    counters = DeviceCounters(
        ticks=counters.ticks + advanced,
        starved_ticks=counters.starved_ticks + (1 - advanced),
        merge_depth_last=torch.where(act, md, counters.merge_depth_last),
        merge_depth_sum=counters.merge_depth_sum + torch.where(act, md, 0).to(torch.float32),
        merge_depth_max=torch.maximum(counters.merge_depth_max, md * advanced),
        renorm_sum=counters.renorm_sum + delta.abs().to(torch.float32),
    )
    return new_state, committed, delta, counters


@dataclasses.dataclass(frozen=True)
class SlotShards:
    """Where the slot rows of a tensor live on a mesh: its ``dim`` axis is
    cut into ``len(devices)`` contiguous equal blocks, block i on
    ``devices[i]`` — the counterpart of the reference's NamedSharding with
    the mesh axis at ``dim``.  A tensor in this layout is the tuple of its
    blocks."""

    devices: Tuple[torch.device, ...]
    dim: int

    def split(self, x) -> Tuple[torch.Tensor, ...]:
        """``x`` in this layout.  A whole tensor is cut into copies of its
        blocks on their devices (its ``dim`` must divide evenly); a sequence
        of blocks is kept, each moved only if it is not on its device."""
        n = len(self.devices)
        if isinstance(x, (tuple, list)):
            if len(x) != n:
                raise ValueError(f"{len(x)} blocks for {n} shards")
            return tuple(b.to(d) for b, d in zip(x, self.devices))
        size = x.shape[self.dim]
        if size % n:
            raise ValueError(f"dim {self.dim} of {tuple(x.shape)} does not divide over {n} shards")
        k = size // n
        return tuple(x.narrow(self.dim, i * k, k).to(d, copy=True).contiguous()
                     for i, d in enumerate(self.devices))


def mesh_slot_rows(mesh, axis: str, n_rows: int, what: str, device) -> SlotShards:
    """The slot-row layout of a stream component (a scheduler's slot table,
    a session's batch) of ``n_rows`` rows, named ``what`` in errors, on
    ``mesh``: a repro_torch Mesh with ``axis``, whose shards ``n_rows``
    divides and whose devices are of ``device``'s type — raises otherwise."""
    from repro_torch.parallel.collectives import mesh_axis_size
    from repro_torch.parallel.mesh import Mesh

    if not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a repro_torch.parallel.Mesh, got {type(mesh).__name__}")
    n = mesh_axis_size(mesh, axis)
    if not n:
        raise ValueError(f"mesh has no {axis!r} axis: {mesh}")
    if n_rows % n:
        raise ValueError(f"{what}={n_rows} must divide evenly over the {n} shards of mesh "
                         f"axis {axis!r}")
    if mesh.device_type != torch.device(device).type:
        raise ValueError(f"mesh devices are {mesh.device_type!r} but the stream's device is "
                         f"{str(device)!r}")
    return SlotShards(mesh.shard_devices(axis), 0)


def state_shardings(mesh, axis: str) -> StreamState:
    """The layouts that cut a StreamState along its batch/slot dimension over
    the ``axis`` shards of ``mesh``: pm (B, S) on dim 0, ring (R, B, S) on
    dim 1.  Every mesh-aware stream component (sessions, the sharded
    scheduler) shares it, so carried states move between them as they are."""
    devices = mesh.shard_devices(axis)
    return StreamState(pm=SlotShards(devices, 0), ring=SlotShards(devices, 1))


def shard_stream_state(mesh, axis: str, state: StreamState) -> StreamState:
    """``state`` in the per-shard layout: a StreamState whose pm and ring are
    tuples of per-shard blocks (no-op when it is already there)."""
    sh = state_shardings(mesh, axis)
    return StreamState(pm=sh.pm.split(state.pm), ring=sh.ring.split(state.ring))


def step_shards(
    code: ConvCode,
    state: StreamState,
    blocks: Sequence[torch.Tensor],
    weights: Sequence,
    active: Optional[Sequence[torch.Tensor]] = None,
    backend: str = "fused",
    normalize: bool = True,
    counters: Optional[DeviceCounters] = None,
):
    """``stream_step`` once per shard, each on its shard's device and its
    own rows: ``state`` and ``counters`` hold per-shard blocks, ``blocks``
    the shards' (rows, C, ·) inputs, ``weights`` each shard's weights (None
    entries for the bm-table weights), ``active`` each shard's mask.  Nothing
    moves between shards.  Returns stream_step's outputs with every tensor a
    tuple of per-shard blocks."""
    outs = [
        stream_step(
            code, StreamState(pm=pm, ring=ring), x, weights=w,
            active=None if active is None else active[i], backend=backend,
            normalize=normalize,
            counters=None if counters is None else DeviceCounters(*(c[i] for c in counters)),
        )
        for i, (pm, ring, x, w) in enumerate(zip(state.pm, state.ring, blocks, weights))
    ]
    new_state = StreamState(pm=tuple(o[0].pm for o in outs), ring=tuple(o[0].ring for o in outs))
    bits, delta = tuple(o[1] for o in outs), tuple(o[2] for o in outs)
    if counters is None:
        return new_state, bits, delta
    return new_state, bits, delta, DeviceCounters(*zip(*(o[3] for o in outs)))


#: (code, mesh, axis, chunk, backend, normalize, device_metrics) -> tick;
#: see make_sharded_stream_step (only weight-free configs are memoized).
_SHARDED_STEP_CACHE: dict = {}


def make_sharded_stream_step(
    code: ConvCode,
    mesh,
    axis: str,
    *,
    chunk: int,
    backend: str = "fused",
    normalize: bool = True,
    weights=None,
    device_metrics: bool = False,
):
    """Build the mesh-sharded per-tick update for the stream scheduler.

    One scheduler spans the ``axis`` (``data``) shards of ``mesh``: each
    shard holds a contiguous block of decode slots, its own input-arena slab
    and its block of the path metrics and survivor ring, and the tick — arena
    gather, forward scan, in-window traceback — runs once per shard on that
    shard's device (a Python loop over ``mesh.shard_devices(axis)``, the
    reference's shard_map).  There is NO transfer between shards: slots are
    independent streams.

    Returns ``tick(arena, idx, active, state) -> (state, bits, delta)``:
    ``arena`` the per-shard slabs (cap, W), ``idx`` the (n_slots, chunk)
    shard-LOCAL arena rows each slot decodes this tick (idle or starved slots
    point at the zero prefix) and ``active`` the (n_slots,) mask of slots
    whose state advances, each whole or already cut into per-shard blocks;
    ``state`` in the ``state_shardings`` layout.  Every output is a tuple of
    per-shard blocks.  With ``device_metrics=True`` the tick takes and
    returns DeviceCounters of per-shard blocks too: ``tick(arena, idx,
    active, state, counters) -> (state, bits, delta, counters)``.

    ``weights``: the ``fused_packed`` backend's folded metric weights for
    raw-symbol inputs (None: the bm-table weights), copied once to each
    shard's device here.  Weight-free ticks are memoized on the static
    configuration, so schedulers on the same (code, mesh, ...) share one.
    """
    cache_key = None
    if weights is None:
        cache_key = (code, mesh, axis, chunk, backend, normalize, device_metrics)
        cached = _SHARDED_STEP_CACHE.get(cache_key)
        if cached is not None:
            return cached
    if backend not in BACKENDS:
        raise KeyError(backend)
    layout = state_shardings(mesh, axis)
    rows = layout.pm  # idx, active, counters, bits and delta: slot rows on dim 0
    packed = backend == PACKED_BACKEND
    shard_weights = [
        tuple(w.to(d) for w in weights) if packed and weights is not None else None
        for d in rows.devices
    ]

    def run(arena, idx, active, state, counters):
        if len(arena) != len(rows.devices):
            raise ValueError(f"{len(arena)} arena slabs for {len(rows.devices)} shards")
        blocks = [
            slab.index_select(0, i.reshape(-1)).reshape(*i.shape, slab.shape[-1])
            for slab, i in zip(arena, rows.split(idx))
        ]
        return step_shards(
            code, shard_stream_state(mesh, axis, state), blocks, shard_weights,
            active=rows.split(active), backend=backend, normalize=normalize,
            counters=counters,
        )

    if device_metrics:

        def tick(arena, idx, active, state: StreamState, counters: DeviceCounters):
            return run(arena, idx, active, state,
                       DeviceCounters(*(rows.split(c) for c in counters)))

    else:

        def tick(arena, idx, active, state: StreamState):
            return run(arena, idx, active, state, None)

    if cache_key is not None:
        _SHARDED_STEP_CACHE[cache_key] = tick
    return tick


@functools.lru_cache(maxsize=None)
def jitted_stream_step(code: ConvCode, backend: str = "fused", normalize: bool = True):
    """stream_step bound to its static config, cached so every session with
    the same (code, backend, flags) shares one callable.  The port runs
    eagerly: nothing is traced or compiled here (the name keeps the
    reference's).  The callable takes (state, chunk_inputs[, weights[,
    active[, counters]]])."""
    return functools.partial(stream_step, code, backend=backend, normalize=normalize)


def unpack_ring(code: ConvCode, ring: torch.Tensor) -> torch.Tensor:
    """Packed (R/32, B, S) int32 ring -> unpacked (R, B, S) int32 — the
    off-hot-path escape hatch for odd-length tails."""
    return unpack_survivors(ring, ring.shape[0] * PACK_BITS)


def stream_flush(
    code: ConvCode, state: StreamState, terminated: bool = True, packed: bool = False
) -> Tuple[torch.Tensor, torch.Tensor]:
    """End-of-stream traceback over the full ring (``packed``: the ring holds
    survivor words, walked by the packed traceback kernel).

    Returns:
      bits: (B, R) bits for every ring position (caller slices the still-
        uncommitted tail).
      metric: (B,) winning path metric at the frontier (relative — add the
        session's accumulated normalization offset for the absolute value).
    """
    pm, ring = state
    B = pm.shape[0]
    if terminated:
        final_state = torch.zeros((B,), dtype=torch.int32, device=pm.device)
        metric = pm[:, 0]
    else:
        final_state = torch.argmin(pm, dim=-1).to(torch.int32)
        metric = pm.amin(dim=-1)
    if packed:
        bits = _ops.viterbi_traceback_op(code, ring, final_state, ring.shape[0] * PACK_BITS)
    else:
        bits, _ = _traceback(code, ring, final_state)
    return bits, metric


@functools.lru_cache(maxsize=None)
def jitted_stream_flush(code: ConvCode, terminated: bool = True, packed: bool = False):
    """stream_flush bound to its static config (eager, cached like
    :func:`jitted_stream_step`)."""
    return functools.partial(stream_flush, code, terminated=terminated, packed=packed)


@functools.lru_cache(maxsize=None)
def jitted_chunk_forward(code: ConvCode):
    """chunk_forward_scan bound to its code (odd-length stream tails)."""
    return functools.partial(chunk_forward_scan, code)


def viterbi_decode_windowed(
    code: ConvCode,
    bm_tables: torch.Tensor,
    depth: Optional[int] = None,
    chunk: int = 64,
    terminated: Optional[bool] = None,
    backend: str = "fused",
    normalize: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Offline sliding-window decode of a full (B, T, M) block on the device
    of ``bm_tables``.

    Shape-compatible with core.viterbi.viterbi_decode, but runs the
    O(depth + chunk) streaming path: bit-identical when depth >= T, and
    within truncation noise (vanishing for depth >~ 5K) otherwise.  ``code``
    may be a bare ConvCode or a full decode.CodecSpec; ``terminated``
    defaults to the spec's flag (True for a bare code).
    """
    from repro_torch.stream.session import StreamSession

    sess = StreamSession(
        code, batch=bm_tables.shape[0], chunk=chunk, depth=depth, backend=backend,
        normalize=normalize, device=bm_tables.device,
    )
    return sess.decode_all(bm_tables, terminated=terminated)
