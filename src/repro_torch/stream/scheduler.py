"""Continuous-batching stream scheduler with true online ingestion.

Thousands of independent broadcast streams, one batched kernel call a tick:
every live stream is pinned to a slot of a fixed (n_slots, chunk) decode
block — the same fixed-shape bucket discipline as serve/kv_cache.py — and
each ``step()`` tick advances ALL slots through one batched stream_step (the
carried scan kernel, and for ``fused_packed`` the packed traceback kernel,
on the card).  Streams join when a slot frees (FIFO admission), leave when
their input drains (the tail + final traceback run per-slot, off the hot
path), and their slot is recycled for the next pending stream: classic
continuous batching, applied to trellis decode instead of token decode.

**Ingestion is chunk-fed.**  A caller serving live connections opens a
stream, feeds rows as they arrive, and closes it at EOF:

    sched.open_stream("uplink-7")
    while rx := conn.recv_symbols():
        while True:                     # StreamBusy accepts NOTHING — keep
            try:                        # the same rx and retry once a tick
                sched.submit_chunk("uplink-7", rx)   # rows, any size
                break                   # has drained the bounded queue
            except StreamBusy:
                emit(sched.step())
        emit(sched.step())
    sched.close("uplink-7")             # finalizes the mid-chunk tail

or attaches a ChunkProducer (generator / callable / socket-fed push buffer,
see stream/ingest.py) that the tick loop polls within the stream's credit.
Every stream has a **bounded input queue** (``max_buffered`` unconsumed
rows): ``submit_chunk`` returns the remaining credit and raises StreamBusy
on overrun, so backpressure propagates to the source instead of buffering
without bound.  ``submit(stream_id, full_table)`` survives as a thin
adapter over this one path — open, feed the whole table as a single chunk,
close — so offline and online decode share every line of ingestion code.

A slot whose stream has no full chunk ready **idles without being evicted**:
the batched kernel still runs over it (fixed shapes — that is the whole
point of the bucket discipline) but its carried pm/ring are re-selected
unchanged (``stream_step(active=...)``), because advancing a real stream
with zero branch metrics is not a no-op.  Streams that close mid-chunk
retire through the same grouped tail-feed + batched flush as before.

Per-stream input rows are **device-resident**: accepted chunks are appended
to one device arena — the chunks accepted together (one tick's producer
polls, one admission) in ONE upload, staged through page-locked memory so
the copy does not block the host — and every tick gathers the
(n_slots, chunk, ·) decode block by per-slot row indices with one
``index_select``: no host-side packing of the block on the hot path.
Chunks of different streams interleave in arrival order, so a stream's rows
are tracked as explicit arena row indices (not a contiguous base offset);
the arena is compacted off the hot path when retired/consumed rows
dominate.  A steady-state tick's one synchronizing
call is the copy of its committed bits to the host.

The scheduler lives on one device, chosen at construction
(``device="cuda"`` by default, which raises without a card;
``device="cpu"`` runs every kernel's plain version).  The reference's
``mesh=`` sharding is not ported (ROADMAP.md queue 1, item 9b): passing a
mesh raises.  Decode results are bit-exact with the offline block decode of
the same symbols: arrival schedule and placement never change what a slot's
kernel sees.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Deque, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core.trellis import ConvCode
from repro_torch.core.viterbi import _initial_pm
from repro_torch.decode.spec import CodecSpec
from repro_torch.kernels.common import resolve_device
from repro_torch.obs import Telemetry
from repro_torch.obs.metrics import DEPTH_BUCKETS, LATENCY_BUCKETS_S, TICK_BUCKETS
from repro_torch.obs.trace import span
from repro_torch.serve.kv_cache import SlotAllocator
from repro_torch.stream import window as _w
from repro_torch.stream.ingest import ChunkProducer, StreamBusy, as_producer
from repro_torch.stream.resilience import StreamError, TickFault
from repro_torch.train.fault_tolerance import StragglerDetector

#: Tick-phase span names, in order, as they nest under the "tick" parent —
#: the children list Tracer.coverage() checks the tick against.
TICK_PHASES = ("ingest", "admit", "gather", "step", "commit")


@dataclasses.dataclass(eq=False)
class _Stream:
    """Per-stream bookkeeping (host side; the rows themselves live in the
    device arena once accepted).  ``eq=False``: streams are identities, and
    the generated __eq__ would compare ndarray fields."""

    stream_id: str
    terminated: bool
    max_buffered: int  # backpressure bound on unconsumed rows
    producer: Optional[ChunkProducer] = None
    closed: bool = False  # no more input will arrive (close() / EOF)
    slot: Optional[int] = None  # decode slot while admitted
    shard: int = 0  # arena slab of the stream's slot (always 0: one device)
    priority: int = 0  # overload shedding victimizes the lowest first
    deadline_tick: Optional[int] = None  # evict_expired() retires past this
    seq: int = 0  # admission sequence (shed tie-break: newest loses)
    fed: int = 0  # rows accepted into the device arena
    pos: int = 0  # steps consumed by the kernel
    committed: int = 0  # bits already emitted
    #: arena rows holding steps [pos, fed) — explicit indices, because
    #: chunks of concurrent streams interleave in the arena.
    rows: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros((0,), dtype=np.int32)
    )
    queued: List[np.ndarray] = dataclasses.field(default_factory=list)
    queued_rows: int = 0  # raw rows awaiting admission (no slot yet)
    out: List[np.ndarray] = dataclasses.field(default_factory=list)
    #: (cumulative_rows_after_chunk, arrival_monotonic_ts) per accepted
    #: chunk, popped as commits pass the chunk's last row — the bounded
    #: bookkeeping behind the arrival-to-commit latency histogram.
    arrivals: Deque[Tuple[int, float]] = dataclasses.field(default_factory=deque)

    @property
    def available(self) -> int:
        """Rows in the arena the kernel has not consumed yet."""
        return self.fed - self.pos

    @property
    def buffered(self) -> int:
        """Unconsumed rows anywhere (arena + pre-admission queue) — what the
        per-stream credit is charged against."""
        return self.fed - self.pos + self.queued_rows


@dataclasses.dataclass
class SchedulerStats:
    ticks: int = 0
    streams_submitted: int = 0
    streams_finished: int = 0
    slot_claims: int = 0
    steps_decoded: int = 0  # trellis steps actually consumed by streams
    arena_compactions: int = 0
    chunks_submitted: int = 0  # submit_chunk / producer deliveries accepted
    busy_rejections: int = 0  # StreamBusy raised by submit_chunk
    starved_slot_ticks: int = 0  # slot-ticks spent admitted-but-starved
    poisoned_rejections: int = 0  # chunks rejected for non-finite values
    streams_quarantined: int = 0  # streams failed by poison / producer crash
    streams_expired: int = 0  # streams retired by evict_expired (TTL)
    streams_shed: int = 0  # streams dropped by the overload policy
    tick_device_failures: int = 0  # step-phase TickFaults absorbed (retried)
    straggler_ticks: int = 0  # tick wall times flagged by StragglerDetector

    def asdict(self) -> Dict[str, int]:
        return dataclasses.asdict(self)


class StreamScheduler:
    """Continuous batching of independent Viterbi streams on one device.

    Args:
      spec: CodecSpec shared by all streams (a bare ConvCode is promoted);
        its ``terminated`` flag is the per-stream default.
      n_slots: decode-block batch size (fixed; streams beyond this queue
        FIFO until a slot frees).
      chunk: trellis steps per tick per slot.
      depth: truncated-traceback depth (default 5*K; rounded up to a
        multiple of 32 for the packed backend).
      backend: 'fused' | 'fused_packed' | 'scan' forward pass for the hot
        loop ('fused_packed': bit-packed survivor ring + traceback kernel).
      normalize: renormalize path metrics every tick (the offset is kept).
      device: where the state, the arena and the kernels live — the card by
        default (raises without one); ``"cpu"`` runs the plain versions.
        Resolved once per scheduler, so every tick and flush takes the same
        side of the kernel-or-plain rule.
      inputs: 'bm' — chunks are (t, M) branch-metric rows; 'received'
        (fused_packed only) — chunks are raw (t, n_out) channel symbols and
        branch metrics are computed in-kernel.
      max_buffered: default per-stream input-queue bound, in unconsumed rows
        (None -> 8 * chunk).  ``open_stream`` can override per stream.
      max_pending: overload bound on streams awaiting a slot (None: none).
      mesh: not ported yet — anything but None raises.
      telemetry: obs.Telemetry bundle.  The metrics registry (always live)
        absorbs SchedulerStats plus the arrival-to-commit latency histogram;
        an attached tracer records tick-phase spans (see TICK_PHASES);
        ``device_counters=True`` makes every tick accumulate per-stream
        survivor merge depth / starved ticks / renormalization magnitude
        into device tensors read only at retire / report time — the tick
        keeps exactly one host sync (the committed bits).

    Online usage (live connections):
      sched.open_stream("tv-0", producer=gen_of_chunks)  # or submit_chunk
      while serving:
          emitted = sched.step()           # {stream_id: np bits} this tick
      bits, metric = sched.pop_result("tv-0")

    Offline usage (whole table known) — the adapter over the same path:
      sched.submit("tv-0", bm_tables)      # == open + submit_chunk + close
      sched.run()
    """

    def __init__(
        self,
        spec: Union[CodecSpec, ConvCode],
        n_slots: int = 64,
        chunk: int = 64,
        depth: Optional[int] = None,
        backend: str = "fused",
        normalize: bool = True,
        device="cuda",
        inputs: str = "bm",
        max_buffered: Optional[int] = None,
        max_pending: Optional[int] = None,
        mesh: Optional[object] = None,
        telemetry: Optional[Telemetry] = None,
    ):
        if mesh is not None:
            raise NotImplementedError(
                "StreamScheduler(mesh=...) is not ported to repro_torch yet "
                "(ROADMAP.md queue 1, item 9b)"
            )
        self.spec = CodecSpec.of(spec)
        code = self.spec.code
        self.code = code
        self.n_slots = n_slots
        self.chunk = chunk
        self.depth = _w.default_depth(code) if depth is None else depth
        self.backend = backend
        self.normalize = normalize
        self.inputs = inputs
        if max_pending is not None and max_pending < 0:
            raise ValueError(f"max_pending must be >= 0, got {max_pending}")
        self.max_pending = max_pending
        self.max_buffered = 8 * chunk if max_buffered is None else int(max_buffered)
        if self.max_buffered < chunk:
            # rows only leave the queue in full-chunk ticks: a bound below
            # one chunk could never fill a tick and the stream would starve
            # forever with its credit pinned at zero
            raise ValueError(
                f"max_buffered ({self.max_buffered}) must be >= chunk ({chunk})"
            )
        # one device for the scheduler's life: every tick and flush takes the
        # same side of the kernel-or-plain rule (kernels/common.py)
        self.device = resolve_device(device)
        self.n_shards = 1
        self.slots_per_shard = n_slots
        self.packed, self.depth, self._plan, self._weights = _w.resolve_stream_backend(
            self.spec, chunk, self.depth, backend, inputs, self.device
        )
        self._width = (
            self._plan.n_features if inputs == "received" else code.n_symbols
        )
        self.state = _w.init_stream_state(
            code, n_slots, self.depth, chunk, packed=self.packed, device=self.device
        )
        self.offset = torch.zeros((n_slots,), dtype=torch.float32, device=self.device)
        self.alloc = SlotAllocator(n_slots)
        self.active: Dict[int, _Stream] = {}
        self.pending: Deque[_Stream] = deque()
        self._by_id: Dict[str, _Stream] = {}  # every OPEN stream, by id
        self.results: Dict[str, Tuple[np.ndarray, float]] = {}
        self.errors: Dict[str, StreamError] = {}  # early-terminated streams
        self.stats = SchedulerStats()
        self._seq = 0  # admission sequence counter (shed tie-break)
        #: straggler detection over per-tick wall time (only ticks that
        #: dispatched real device work — idle ticks would poison the EMA).
        self.straggler = StragglerDetector()
        #: test/chaos seam: called with the tick number at the top of the
        #: step phase; a raised TickFault drops the tick (state untouched).
        self.tick_fault_hook = None
        self.telemetry = telemetry if telemetry is not None else Telemetry()
        self._tracer = self.telemetry.tracer
        self._latency_hist = self.telemetry.metrics.histogram(
            "stream_arrival_to_commit_seconds",
            buckets=LATENCY_BUCKETS_S,
            help="seconds from chunk arrival to its last bit committing",
        )
        self._depth_hist = self.telemetry.metrics.histogram(
            "stream_merge_depth",
            buckets=DEPTH_BUCKETS,
            help="survivor merge depth of retiring streams (trellis steps)",
        )
        self._tick_hist = self.telemetry.metrics.histogram(
            "stream_tick_seconds",
            buckets=TICK_BUCKETS,
            help="wall time of scheduler ticks that dispatched work",
        )
        self._retry_hist = self.telemetry.metrics.histogram(
            "stream_busy_retry_ticks",
            buckets=DEPTH_BUCKETS,
            help="retry_after_ticks hints handed out with StreamBusy",
        )
        m = self.telemetry.metrics
        self._straggler_ctr = m.counter(
            "stream_tick_straggler_total",
            help="ticks whose wall time the StragglerDetector flagged",
        )
        self._quarantine_ctr = m.counter(
            "stream_quarantined_total",
            help="streams quarantined (poisoned chunk / producer error)",
        )
        self._expired_ctr = m.counter(
            "stream_expired_total", help="streams retired by TTL deadline"
        )
        self._shed_ctr = m.counter(
            "stream_shed_total", help="streams dropped by the overload policy"
        )
        self._device_failure_ctr = m.counter(
            "stream_tick_device_failures_total",
            help="tick device-step failures absorbed (tick dropped + retried)",
        )
        self._poison_ctr = m.counter(
            "stream_poisoned_chunks_total",
            help="chunks rejected for non-finite values or bad shape",
        )
        self._counters = (
            _w.init_device_counters(n_slots, self.device)
            if self.telemetry.device_counters
            else None
        )
        self._pm0_row = _initial_pm(code, (), self.device)  # (S,) fresh-slot path metrics
        # device-resident input arena (1, cap, ·) with rows [0, chunk) kept
        # zero — the read target for idle/starved slots — and each accepted
        # chunk appended to the used prefix.  Capacity grows geometrically
        # and the used prefix is compacted when consumed/retired rows exceed
        # _compact_ratio x the live rows (past _compact_floor, so toy
        # workloads never bother).
        self._arena = torch.zeros((1, chunk, self._width), dtype=torch.float32,
                                  device=self.device)
        self._arena_len = [chunk]  # used rows
        #: accepted feature rows (host tensors) holding arena rows
        #: [_arena_len, _arena_len + their count): written by _flush_rows in
        #: one upload before anything reads the arena
        self._pending_rows: List[torch.Tensor] = []
        self._pending_len = 0
        self._compact_ratio = 4
        self._compact_floor = 4096
        self._step_fn = _w.jitted_stream_step(code, backend=backend, normalize=normalize)
        self._gather = _gather_block  # an attribute: tests count a tick's gathers

    # ------------------------------ intake ------------------------------ #

    def open_stream(
        self,
        stream_id: str,
        *,
        terminated: Optional[bool] = None,
        producer=None,
        max_buffered: Optional[int] = None,
        priority: int = 0,
        ttl_ticks: Optional[int] = None,
    ) -> None:
        """Register a stream for chunk-fed decode.  It queues for a slot
        immediately (FIFO) and may sit admitted-but-starved until rows
        arrive via ``submit_chunk`` or the attached ``producer``.

        Args:
          terminated: stream ends in state 0 (defaults to the spec's flag).
          producer: optional chunk source polled every tick within the
            stream's credit — a ChunkProducer, a generator/iterable of row
            arrays, or a poll callable (see stream/ingest.py).  When it
            reports ``exhausted`` the stream is closed automatically.
          max_buffered: per-stream override of the input-queue bound.
          priority: overload-shedding rank — when ``max_pending`` is
            exceeded the LOWEST priority open stream is shed first (newest
            among equals; see ``errors`` for the structured record).
          ttl_ticks: optional deadline, in scheduler ticks from now; once it
            passes, ``evict_expired()`` (run at the top of every tick)
            retires the stream with a partial-result flush and an "expired"
            StreamError.
        """
        if terminated is None:
            terminated = self.spec.terminated
        if stream_id in self._by_id or stream_id in self.results:
            raise KeyError(f"duplicate stream_id {stream_id!r}")
        bound = self.max_buffered if max_buffered is None else int(max_buffered)
        if bound < self.chunk:
            raise ValueError(
                f"max_buffered ({bound}) must be >= chunk ({self.chunk}): a "
                "smaller bound can never buffer a full decode chunk, so the "
                "stream would starve forever"
            )
        if ttl_ticks is not None and ttl_ticks <= 0:
            raise ValueError(f"ttl_ticks must be > 0, got {ttl_ticks}")
        st = _Stream(
            stream_id=stream_id,
            terminated=bool(terminated),
            max_buffered=bound,
            producer=as_producer(producer) if producer is not None else None,
            priority=int(priority),
            deadline_tick=(
                None if ttl_ticks is None else self.stats.ticks + int(ttl_ticks)
            ),
            seq=self._seq,
        )
        self._seq += 1
        self._by_id[stream_id] = st
        self.pending.append(st)
        self.stats.streams_submitted += 1
        self._admit()
        self._shed_overload()

    def submit_chunk(self, stream_id: str, rows, *, close: bool = False) -> int:
        """Feed ``rows`` ((t, M) bm rows or (t, n_out) received symbols per
        the scheduler's ``inputs`` kind; any t >= 0; a host array-like) to an
        open stream.

        Returns the stream's remaining credit (rows its bounded queue can
        still take).  Raises StreamBusy — accepting nothing — when the chunk
        exceeds the current credit; callers throttle and retry after ticks
        drain the queue.  ``close=True`` marks EOF after accepting the rows
        (same as a separate ``close()``)."""
        st = self._open(stream_id)
        if st.closed:
            raise RuntimeError(f"stream {stream_id!r} is closed")
        rows = np.asarray(rows, dtype=np.float32)
        self._check_rows(rows)
        n = rows.shape[0]
        if n:
            credit = st.max_buffered - st.buffered
            if n > credit:
                self.stats.busy_rejections += 1
                # hint horizon: ticks until the queue can take this chunk —
                # capped at the queue bound, since a chunk larger than
                # max_buffered must be split and can never fit whole
                retry = self._retry_after_ticks(
                    st, min(n, st.max_buffered) - max(0, credit)
                )
                self._retry_hist.observe(retry)
                raise StreamBusy(
                    stream_id, max(0, credit), n, retry_after_ticks=retry
                )
            self._accept_rows(st, rows)
            self.stats.chunks_submitted += 1
        if close:
            st.closed = True
        self._admit()
        return max(0, st.max_buffered - st.buffered)

    def attach_producer(self, stream_id: str, producer) -> None:
        """Attach (or replace) a chunk source on an open stream — the
        re-attach half of snapshot/restore, since producers are deliberately
        not serialized (see stream/resilience.py)."""
        st = self._open(stream_id)
        if st.closed:
            raise RuntimeError(f"stream {stream_id!r} is closed")
        st.producer = as_producer(producer)

    def close(self, stream_id: str) -> None:
        """Mark EOF: no more chunks will arrive.  The stream retires once its
        remaining buffered rows (including a mid-chunk tail shorter than one
        decode chunk) are drained — idempotent."""
        self._open(stream_id).closed = True

    def credit(self, stream_id: str) -> int:
        """Rows the stream's bounded input queue can accept right now."""
        st = self._open(stream_id)
        return max(0, st.max_buffered - st.buffered)

    def submit(self, stream_id: str, bm_tables, terminated: Optional[bool] = None) -> None:
        """Whole-table submission — a thin ADAPTER over the chunk path (the
        scheduler's one ingestion code path): opens the stream with enough
        credit for the full table, feeds it as a single chunk, and closes
        it.  bm_tables: (T, M) branch metrics — or raw (T, n_out) received
        symbols for ``inputs='received'``."""
        bm = np.asarray(bm_tables, dtype=np.float32)
        self._check_rows(bm)
        self.open_stream(
            stream_id,
            terminated=terminated,
            max_buffered=max(self.max_buffered, bm.shape[0]),
        )
        self.submit_chunk(stream_id, bm, close=True)

    def evict(self, stream_id: str) -> Optional[np.ndarray]:
        """Cancel a stream.  Returns the bits committed so far (or None if it
        was still awaiting a slot); the slot is recycled immediately.  Any
        attached producer is detached (its undelivered rows — pending credit
        included — are simply never polled again)."""
        st = self._by_id.pop(stream_id, None)
        if st is None:
            raise KeyError(stream_id)
        st.producer = None
        if st.slot is None:
            self.pending.remove(st)
            return None
        partial = self._collect(st)
        del self.active[st.slot]
        self.alloc.release(st.slot)  # state is re-initialized at next claim
        st.slot = None
        self._admit()
        return partial

    def evict_expired(self) -> List[str]:
        """Retire every open stream whose TTL deadline has passed: partial
        result flushed into ``results``, an "expired" StreamError recorded in
        ``errors``, slot recycled.  Runs at the top of every tick; callable
        directly too.  Returns the expired stream ids."""
        now_tick = self.stats.ticks
        expired = [
            st for st in list(self._by_id.values())
            if st.deadline_tick is not None and now_tick >= st.deadline_tick
        ]
        for st in expired:
            self._retire_early(
                st, "expired",
                f"deadline tick {st.deadline_tick} passed at tick {now_tick}",
            )
            self.stats.streams_expired += 1
            self._expired_ctr.inc()
        return [st.stream_id for st in expired]

    def pop_error(self, stream_id: str) -> StreamError:
        """Structured record of an early-terminated stream (+ drop), the
        error-side sibling of ``pop_result``."""
        return self.errors.pop(stream_id)

    # ------------------------------ ticking ------------------------------ #

    def pending_work(self) -> bool:
        return bool(self.active or self.pending)

    def step(self) -> Dict[str, np.ndarray]:
        """One scheduler tick: poll producers, retire drained streams, admit
        pending ones, then advance every slot with a full chunk ready
        through ONE batched stream_step (slots without one idle, state
        untouched).  Returns the bits each stream newly committed this tick.

        When a tracer is attached the tick records a parent ``tick`` span
        with the TICK_PHASES children; disabled tracing costs one ``is
        None`` check per phase (see obs.trace.span)."""
        t0 = time.monotonic()
        ticks_before = self.stats.ticks
        with span(self._tracer, "tick"):
            out = self._step_traced()
        # straggler detection: only ticks that dispatched real device work
        # feed the EMA — idle/starved ticks are microseconds and would make
        # every working tick look like an outlier.
        if self.stats.ticks > ticks_before:
            self._observe_tick_time(time.monotonic() - t0)
        return out

    def _observe_tick_time(self, dt: float) -> None:
        self._tick_hist.observe(dt)
        if self.straggler.observe(self.stats.ticks, dt):
            self.stats.straggler_ticks += 1
            self._straggler_ctr.inc()

    def _step_traced(self) -> Dict[str, np.ndarray]:
        tr = self._tracer
        with span(tr, "ingest"):
            self.evict_expired()
            self._poll_producers()
        # 1. retire closed streams that cannot fill a full chunk (tail +
        #    flush run batched over all slots retiring this tick — off the
        #    hot path), re-admit, and repeat: an admitted pending stream may
        #    itself be closed with less than a chunk buffered and must
        #    retire before the gather sees it.
        with span(tr, "admit"):
            self._admit()
            while True:
                drained = [
                    slot for slot, st in self.active.items()
                    if st.closed and st.available < self.chunk
                ]
                if not drained:
                    break
                self._finish_slots(drained)
                self._admit()
        # 2. slots with a full chunk of rows ready advance; admitted slots
        #    that are starved (open stream, no chunk yet) idle masked —
        #    their gather reads the zero prefix and their carried state is
        #    re-selected unchanged inside stream_step.
        with span(tr, "gather"):
            ready = [
                slot for slot, st in self.active.items()
                if st.available >= self.chunk
            ]
            self.stats.starved_slot_ticks += len(self.active) - len(ready)
            if not ready:
                return {}
            idx = np.zeros((self.n_slots, self.chunk), dtype=np.int32)
            mask = np.zeros((self.n_slots,), dtype=bool)
            for slot in ready:
                idx[slot] = self.active[slot].rows[: self.chunk]
                mask[slot] = True
            idx_t, mask_t = self._upload(idx), self._upload(mask)

        # 3. the one batched call for all live streams.  The span measures
        #    the host's enqueue, not device time: the only forced sync stays
        #    the bits transfer in the commit phase.
        with span(tr, "step"):
            try:
                if self.tick_fault_hook is not None:
                    # chaos/test seam: a raised TickFault simulates a
                    # transient device-step failure BEFORE any carried state
                    # is reassigned — the tick drops, the next one retries
                    # the identical gather, the decode is unchanged.
                    self.tick_fault_hook(self.stats.ticks)
                block = self._gather(self._arena, idx_t)  # (n_slots, chunk, ·)
                weights = self._weights if self.packed else None
                if self._counters is not None:
                    self.state, bits, delta, self._counters = self._step_fn(
                        self.state, block, weights, mask_t,
                        counters=self._counters,
                    )
                else:
                    self.state, bits, delta = self._step_fn(
                        self.state, block, weights, mask_t
                    )
            except TickFault:
                self.stats.tick_device_failures += 1
                self._device_failure_ctr.inc()
                return {}
            self.offset = self.offset + delta

        # 4. the tick's ONE host sync, then distribute newly-final bits.
        with span(tr, "commit"):
            # the sanctioned device->host transfer: every other per-tick
            # value stays device-resident (DeviceCounters, arena, ring)
            bits_np = bits.cpu().numpy()
            self.stats.ticks += 1
            self.stats.steps_decoded += len(ready) * self.chunk
            now = time.monotonic()
            emitted: Dict[str, np.ndarray] = {}
            for slot in ready:
                st = self.active[slot]
                st.rows = st.rows[self.chunk :]
                st.pos += self.chunk
                committable = max(0, st.pos - self.depth)
                n_new = committable - st.committed
                st.committed = committable
                self._observe_commit_latency(st, now)
                if n_new:
                    fresh = bits_np[slot, self.chunk - n_new :]
                    st.out.append(fresh)
                    emitted[st.stream_id] = fresh
            return emitted

    def run(self) -> Dict[str, Tuple[np.ndarray, float]]:
        """Drain everything; returns {stream_id: (bits (T,), metric)}.

        Every open stream must either be closed or have a producer attached:
        a stream waiting on future ``submit_chunk`` calls can never make
        progress inside this loop, so that state raises instead of spinning
        (producer-fed streams busy-poll — their source delivers on its own
        clock)."""
        while self.pending_work():
            marker = self._progress_marker()
            self.step()
            if marker == self._progress_marker() and not any(
                st.producer is not None and not st.closed
                for st in self._by_id.values()
            ):
                starved = sorted(
                    st.stream_id for st in self._by_id.values() if not st.closed
                )
                raise RuntimeError(
                    f"StreamScheduler.run() stalled: open streams {starved} are "
                    "starved with no producer attached — drive step() from your "
                    "serving loop, attach a ChunkProducer, or close() them"
                )
        return self.results

    def _progress_marker(self) -> Tuple[int, int, int]:
        return (
            self.stats.ticks,
            self.stats.streams_finished,
            sum(st.fed + st.queued_rows for st in self._by_id.values()),
        )

    def result(self, stream_id: str) -> Tuple[np.ndarray, float]:
        return self.results[stream_id]

    def pop_result(self, stream_id: str) -> Tuple[np.ndarray, float]:
        """result() + drop — long-lived servers must use this (or otherwise
        prune ``results``) so finished-stream outputs don't accumulate
        forever."""
        return self.results.pop(stream_id)

    def utilization(self) -> float:
        return self.alloc.utilization()

    def load_report(self) -> Dict[str, object]:
        """Occupancy and queue depth (one shard: the scheduler spans one
        device) plus the global scalars, all from this controller's
        bookkeeping.  Callers throttle on the queue-depth numbers:
        ``queued_rows_total`` is how much input sits unconsumed on-device,
        ``starved_active`` how many slots are idling for lack of it.

        ``latency_s`` summarizes the arrival-to-commit histogram (always
        tracked); with device counters enabled the report also carries
        ``merge_depth`` — per active stream, the survivor merge-depth
        last/mean/max plus starved ticks and renormalization magnitude,
        read back here (an explicit drain point, never per tick)."""
        per_shard = np.zeros((self.n_shards,), dtype=np.int32)
        per_shard_queued = np.zeros((self.n_shards,), dtype=np.int32)
        starved = 0
        for slot, st in self.active.items():
            shard = slot // self.slots_per_shard
            per_shard[shard] += 1
            per_shard_queued[shard] += st.available
            if not st.closed and st.available < self.chunk:
                starved += 1
        pending_rows = sum(st.queued_rows for st in self.pending)
        active_total = int(per_shard.sum())
        report: Dict[str, object] = {
            "n_shards": self.n_shards,
            "per_shard_active": per_shard.tolist(),
            "per_shard_queued_rows": per_shard_queued.tolist(),
            "active_total": active_total,
            "pending_total": len(self.pending),
            "queued_rows_total": int(per_shard_queued.sum()),
            "pending_rows": pending_rows,
            # deepest single stream queue (vs its max_buffered bound) — the
            # number a throttling caller compares against the credit limit
            "max_stream_queued_rows": max(
                (st.buffered for st in self._by_id.values()), default=0
            ),
            "starved_active": starved,
            "utilization": active_total / self.n_slots,
            "latency_s": self._latency_hist.summary(),
        }
        if self._counters is not None:
            report["merge_depth"] = self.device_counter_report()
        return report

    def device_counter_report(self) -> Dict[str, Dict[str, float]]:
        """Read the device counters back for every ACTIVE stream:
        {stream_id: {ticks, starved_ticks, merge_depth_last, merge_depth_mean,
        merge_depth_max, renorm_sum}}.  One host transfer per counter leaf,
        only when called — never on the tick path."""
        if self._counters is None:
            raise RuntimeError(
                "device counters are off — construct the scheduler with "
                "telemetry=Telemetry(device_counters=True)"
            )
        leaves = {
            name: x.cpu().numpy()
            for name, x in zip(_w.DeviceCounters._fields, self._counters)
        }
        out: Dict[str, Dict[str, float]] = {}
        for slot, st in self.active.items():
            ticks = int(leaves["ticks"][slot])
            out[st.stream_id] = {
                "ticks": ticks,
                "starved_ticks": int(leaves["starved_ticks"][slot]),
                "merge_depth_last": int(leaves["merge_depth_last"][slot]),
                "merge_depth_mean": (
                    float(leaves["merge_depth_sum"][slot]) / ticks if ticks else 0.0
                ),
                "merge_depth_max": int(leaves["merge_depth_max"][slot]),
                "renorm_sum": float(leaves["renorm_sum"][slot]),
            }
        return out

    def metrics_snapshot(self) -> Dict[str, object]:
        """Mirror SchedulerStats into the metrics registry and return one
        JSON-ready snapshot (scalars + histogram summaries)."""
        m = self.telemetry.metrics
        for name, v in self.stats.asdict().items():
            m.counter(
                f"scheduler_{name}", help=f"SchedulerStats.{name}"
            ).set(v)
        m.gauge("scheduler_active_slots").set(len(self.active))
        m.gauge("scheduler_pending_streams").set(len(self.pending))
        m.gauge("scheduler_utilization").set(self.utilization())
        return m.snapshot()

    def metrics_text(self) -> str:
        """Prometheus text exposition of the scheduler's registry."""
        self.metrics_snapshot()
        return self.telemetry.metrics.render()

    # --------------------------- snapshot/restore --------------------------- #

    def snapshot(self):
        """Freeze the full serving state — slot table, device arena rows,
        path metrics, survivor ring, renorm offsets, DeviceCounters,
        per-stream queues/credits, stats/results/errors — into a versioned
        on-host :class:`~repro_torch.stream.resilience.StreamSnapshot`.  The
        scheduler is untouched and keeps serving.  Call between ticks (every
        call site is one: the API is host-driven)."""
        from repro_torch.stream.resilience import snapshot_scheduler

        return snapshot_scheduler(self)

    @classmethod
    def restore(
        cls,
        snap,
        *,
        mesh: Optional[object] = None,
        telemetry: Optional[Telemetry] = None,
        device="cuda",
    ) -> "StreamScheduler":
        """Resume a snapshot on a fresh scheduler on ``device`` — committed
        output bit-exact vs the uninterrupted run.  Producers are not
        restored; re-attach with ``attach_producer``."""
        from repro_torch.stream.resilience import restore_scheduler

        return restore_scheduler(snap, mesh=mesh, telemetry=telemetry, device=device)

    # ------------------------------ internals ------------------------------ #

    def _shard_of(self, slot: int) -> int:
        return slot // self.slots_per_shard

    def _open(self, stream_id: str) -> _Stream:
        try:
            return self._by_id[stream_id]
        except KeyError:
            raise KeyError(
                f"unknown or finished stream {stream_id!r} (open_stream first)"
            ) from None

    def _upload(self, a: np.ndarray) -> torch.Tensor:
        """A host array as a tensor on the scheduler's device.  On the card
        the copy is staged through page-locked memory and does not block the
        host: a copy from pageable memory synchronizes the stream, and the
        tick's one sync is the committed bits."""
        t = torch.from_numpy(np.ascontiguousarray(a))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    def _check_rows(self, rows: np.ndarray) -> None:
        expected = (
            self.code.n_out if self.inputs == "received" else self.code.n_symbols
        )
        kind = "received symbols" if self.inputs == "received" else "bm tables"
        if rows.ndim != 2 or rows.shape[1] != expected:
            raise ValueError(
                f"{self.inputs!r} streams take {kind} shaped (t, {expected}), "
                f"got {rows.shape}"
            )
        if rows.size and not np.isfinite(rows).all():
            # a single NaN/Inf symbol would corrupt path metrics for EVERY
            # stream in the batch tick (renormalization subtracts a max over
            # the slot axis) — reject at the boundary, poison nothing.
            bad = int(np.count_nonzero(~np.isfinite(rows)))
            self.stats.poisoned_rejections += 1
            self._poison_ctr.inc()
            raise ValueError(
                f"non-finite input: {bad} NaN/Inf value(s) in a {rows.shape} "
                "chunk — non-finite symbols corrupt path metrics for the "
                "whole batch tick"
            )

    def _accept_rows(self, st: _Stream, rows: np.ndarray) -> None:
        """Route accepted rows: straight into the arena for admitted streams,
        host-side queue otherwise (no slot claimed yet)."""
        # latency bookkeeping: a chunk counts as committed once the commit
        # watermark passes its LAST row (fed + queued_rows is the cumulative
        # arrival count regardless of which side of admission the rows land)
        st.arrivals.append(
            (st.fed + st.queued_rows + rows.shape[0], time.monotonic())
        )
        if st.slot is not None:
            self._append_stream_rows(st, rows)
        else:
            st.queued.append(rows)
            st.queued_rows += rows.shape[0]

    def _observe_commit_latency(self, st: _Stream, now: float) -> None:
        while st.arrivals and st.arrivals[0][0] <= st.committed:
            _, ts = st.arrivals.popleft()
            self._latency_hist.observe(now - ts)

    def _append_stream_rows(self, st: _Stream, rows: np.ndarray) -> None:
        """Reserve the next arena rows for a chunk and extend the stream's
        row map; the rows reach the card at the next ``_flush_rows``.
        Features are built here chunk-by-chunk, on the host (``t0=st.fed``
        keeps the puncture phase right no matter how arrival sizes slice the
        stream; the features are the symbols times 0/1 masks, exact on any
        device)."""
        data = torch.from_numpy(rows)
        if self.inputs == "received":
            data = self._plan.features(data, t0=st.fed)
        start = self._arena_len[st.shard] + self._pending_len
        self._pending_rows.append(data)
        self._pending_len += rows.shape[0]
        st.rows = np.concatenate(
            [st.rows, np.arange(start, start + rows.shape[0], dtype=np.int32)]
        )
        st.fed += rows.shape[0]

    def _flush_rows(self) -> None:
        """Write the reserved rows into the arena, one upload for all."""
        if not self._pending_rows:
            return
        block = torch.cat(self._pending_rows)
        self._pending_rows, self._pending_len = [], 0
        self._append_rows(0, self._upload(block.numpy()))

    def _poll_producers(self) -> None:
        """Pull from attached producers into each stream's queue, never past
        its credit — the scheduler-side half of the backpressure contract.

        One stream's fault never fails the tick: a poisoned chunk (bad
        values/shape) or a raised producer exception quarantines THAT stream
        — partial result flushed, structured StreamError recorded — and the
        loop moves on to the next producer."""
        for st in list(self.active.values()) + list(self.pending):
            if st.producer is None or st.closed:
                continue
            try:
                credit = st.max_buffered - st.buffered
                if credit > 0:
                    got = st.producer.poll(credit)
                    if got is not None:
                        got = np.asarray(got, dtype=np.float32)
                        if got.shape[0]:
                            self._check_rows(got)
                            if got.shape[0] > credit:
                                raise ValueError(
                                    f"producer for {st.stream_id!r} returned "
                                    f"{got.shape[0]} rows against credit {credit}"
                                )
                            self._accept_rows(st, got)
                            self.stats.chunks_submitted += 1
                if st.producer.exhausted:
                    st.closed = True
            except ValueError as e:
                self._quarantine(st, "poisoned_chunk", repr(e))
            except Exception as e:  # noqa: BLE001 — producer code is untrusted
                self._quarantine(st, "producer_error", repr(e))
        self._flush_rows()

    # --------------------- graceful degradation --------------------- #

    def _quarantine(self, st: _Stream, reason: str, detail: str) -> None:
        self._retire_early(st, reason, detail)
        self.stats.streams_quarantined += 1
        self._quarantine_ctr.inc()

    def _retire_early(self, st: _Stream, reason: str, detail: str) -> None:
        """Fail ONE stream without failing the tick: flush the partial
        result it already DECODED (committed prefix + the traceback window),
        recycle the slot, and record a structured StreamError in ``errors``.
        Buffered-but-undecoded input is dropped — a failing stream's salvage
        is its decoded prefix, and a multi-hundred-row backlog cannot pass
        through the flush tail-feed (the survivor ring only spans
        depth + chunk steps)."""
        st.producer = None
        st.closed = True
        st.queued, st.queued_rows = [], 0
        st.rows = st.rows[:0]
        st.fed = st.pos
        # an early cut is a truncation: the encoder never flushed to state 0
        # at the cut point, so the final traceback must start from the best
        # state, not the terminated=True state-0 path
        st.terminated = False
        if st.slot is not None:
            self._finish_slots([st.slot])
        else:
            self.pending.remove(st)
            del self._by_id[st.stream_id]
        result = self.results.get(st.stream_id)
        self.errors[st.stream_id] = StreamError(
            stream_id=st.stream_id,
            reason=reason,
            detail=detail,
            tick=self.stats.ticks,
            committed_bits=0 if result is None else int(result[0].shape[0]),
        )
        self._admit()

    def _shed_overload(self) -> None:
        """Overload policy: when the pending queue outgrows ``max_pending``,
        shed the globally lowest-priority open stream (pending preferred over
        active among equals, newest last-in first) with a partial-result
        flush — admission never stalls, and the victim is recorded in
        ``errors`` rather than silently dropped."""
        if self.max_pending is None:
            return
        while len(self.pending) > self.max_pending:
            victim = min(
                self._by_id.values(),
                key=lambda s: (s.priority, 0 if s.slot is None else 1, -s.seq),
            )
            self._retire_early(
                victim, "shed",
                f"overload: {len(self.pending)} pending > max_pending "
                f"{self.max_pending}; priority {victim.priority} shed",
            )
            self.stats.streams_shed += 1
            self._shed_ctr.inc()

    def _retry_after_ticks(self, st: _Stream, deficit: int) -> int:
        """Backoff hint handed out with StreamBusy: admitted streams drain
        one chunk per tick, so the deficit converts directly; a pending
        stream first waits out its FIFO position (approximated as one tick
        per admission ahead of it)."""
        ticks = max(1, -(-int(deficit) // self.chunk))
        if st.slot is None:
            try:
                ticks += self.pending.index(st) + 1
            except ValueError:
                ticks += 1
        return ticks

    def _admit(self) -> None:
        while self.pending and self.alloc.free:
            st = self.pending.popleft()
            slot = self.alloc.claim(st.stream_id)
            # reset at CLAIM time, not release time: a recycled slot's pm/ring
            # must not leak the previous resident's state into the
            # start-in-state-0 constraint (paper §IV-B) for the next stream.
            self._reset_slot(slot)
            st.slot = slot
            st.shard = self._shard_of(slot)
            self.active[slot] = st
            self.stats.slot_claims += 1
            if st.queued:
                queued, st.queued, st.queued_rows = st.queued, [], 0
                self._append_stream_rows(st, np.concatenate(queued, axis=0))
        self._maybe_compact()

    def _append_rows(self, shard: int, rows: torch.Tensor) -> int:
        """Write rows into the arena's used prefix, doubling the capacity as
        needed; returns the start row."""
        start = self._arena_len[shard]
        need = start + rows.shape[0]
        cap = self._arena.shape[1]
        if need > cap:
            new_cap = max(2 * cap, need)
            self._arena = torch.cat(
                [
                    self._arena,
                    torch.zeros((self.n_shards, new_cap - cap, self._width),
                                dtype=torch.float32, device=self.device),
                ],
                dim=1,
            )
        self._arena[shard, start:need] = rows
        self._arena_len[shard] = need
        return start

    def _maybe_compact(self) -> None:
        """Rebuild the arena's used prefix from its live (unconsumed)
        segments when dead rows dominate (off the hot path; keeps long-lived
        servers bounded).  Capacity is kept when the live rows fit."""
        self._flush_rows()
        live = sum(st.available for st in self.active.values()) + sum(
            st.queued_rows for st in self._by_id.values()
        )
        if sum(self._arena_len) <= max(
            self._compact_ratio * (live + self.n_shards * self.chunk),
            self._compact_floor,
        ):
            return
        with span(self._tracer, "compact"):
            self._compact()

    def _compact(self) -> None:
        cap = self._arena.shape[1]
        parts = [torch.zeros((self.chunk, self._width), dtype=torch.float32,
                             device=self.device)]
        cursor = self.chunk
        for st in self.active.values():
            n = st.available
            if n:
                parts.append(self._arena[st.shard].index_select(0, self._upload(st.rows)))
            st.rows = np.arange(cursor, cursor + n, dtype=np.int32)
            cursor += n
        parts.append(torch.zeros((max(cap - cursor, 0), self._width), dtype=torch.float32,
                                 device=self.device))
        self._arena = torch.cat(parts, dim=0)[None]
        self._arena_len[0] = cursor
        self.stats.arena_compactions += 1

    def _collect(self, st: _Stream) -> np.ndarray:
        return (
            np.concatenate(st.out) if st.out else np.zeros((0,), dtype=np.int32)
        ).astype(np.int32)

    def _reset_slot(self, slot: int) -> None:
        # indexed writes into the carried tensors: every tick's stream_step
        # returns fresh pm/ring/counter tensors, so nothing a caller holds
        # from an earlier tick aliases what is overwritten here
        self.state.pm[slot] = self._pm0_row
        self.state.ring[:, slot] = 0
        self.offset[slot] = 0.0
        if self._counters is not None:
            # counters reset at claim for the same reason as pm/ring: the
            # recycled slot must not leak the previous resident's statistics
            for x in self._counters:
                x[slot] = 0

    def _tail_rows(self, st: _Stream) -> torch.Tensor:
        """(r, M) bm tables for a stream's remaining sub-chunk tail, gathered
        from the arena by row index (raw features go through the metric
        plan)."""
        seg = self._arena[st.shard].index_select(0, self._upload(st.rows))
        if self.inputs == "received":
            return self._plan.bm_from_features(seg)
        return seg

    def _finish_slots(self, slots: Sequence[int]) -> None:
        """Tail-feed + final traceback for every drained stream retiring this
        tick, then recycle the slots.  Tails are fed grouped by length (one
        chunk_forward_scan per distinct tail length) and the final traceback
        over all retirees runs as ONE batched stream_flush per termination
        kind — not one dispatch per slot.  Each batched call covers only the
        retiring rows: the reference pads them to ``n_slots`` rows so a jit
        sees one shape, which changes no result and has no use in an eager
        decode.  Packed survivor rings are unpacked here, once, off the hot
        path."""
        self._flush_rows()  # the tails read the arena
        with span(self._tracer, "flush"):
            self._finish_slots_traced(slots)

    def _finish_slots_traced(self, slots: Sequence[int]) -> None:
        streams = [(slot, self.active.pop(slot)) for slot in slots]
        if self._counters is not None:
            # retirement IS the device-counter drain point: one host read of
            # the (B,) merge-depth leaf for the whole cohort, off the hot path
            md_last = self._counters.merge_depth_last.cpu().numpy()
            for slot, _ in streams:
                self._depth_hist.observe(int(md_last[slot]))

        pm_frontier, ring = self.state
        if self.packed:
            ring = _w.unpack_ring(self.code, ring)  # (R, n_slots, S)

        # tail-feed, grouped by tail length r (each group one batched call)
        by_r: Dict[int, List[Tuple[int, _Stream]]] = {}
        for slot, st in streams:
            by_r.setdefault(st.available, []).append((slot, st))
        ordered: List[Tuple[int, _Stream]] = []
        pm_parts: List[torch.Tensor] = []
        ring_parts: List[torch.Tensor] = []
        for r, group in sorted(by_r.items()):
            idx = self._upload(np.asarray([slot for slot, _ in group], dtype=np.int64))
            pm_g = pm_frontier[idx]  # (n, S)
            ring_g = ring[:, idx]  # (R, n, S)
            if r > 0:
                tails = torch.stack([self._tail_rows(st) for _, st in group])  # (n, r, M)
                pm_g, bps = _w.jitted_chunk_forward(self.code)(pm_g, tails)
                ring_g = torch.cat([ring_g[r:], bps], dim=0)
                for _, st in group:
                    st.pos += r
                    st.rows = st.rows[r:]
            ordered.extend(group)
            pm_parts.append(pm_g)
            ring_parts.append(ring_g)
        pm_all = torch.cat(pm_parts, dim=0)  # (n_total, S)
        ring_all = torch.cat(ring_parts, dim=1)  # (R, n_total, S)

        # one flush per termination kind (a single call in the common case
        # of uniformly-terminated streams)
        flushed: Dict[int, Tuple[np.ndarray, float]] = {}
        for term in (True, False):
            rows = [i for i, (_, st) in enumerate(ordered) if st.terminated == term]
            if not rows:
                continue
            sel = self._upload(np.asarray(rows, dtype=np.int64))
            bits, metric = _w.jitted_stream_flush(self.code, terminated=term, packed=False)(
                _w.StreamState(pm=pm_all[sel], ring=ring_all[:, sel])
            )
            bits_np, metric_np = bits.cpu().numpy(), metric.cpu().numpy()
            for k, i in enumerate(rows):
                flushed[i] = (bits_np[k], float(metric_np[k]))

        R = ring.shape[0]
        offset_np = self.offset.cpu().numpy()  # one transfer, not one per slot
        now = time.monotonic()
        for i, (slot, st) in enumerate(ordered):
            bits_i, metric_i = flushed[i]
            n_rest = st.pos - st.committed
            if n_rest:
                st.out.append(bits_i[R - n_rest :])
            st.committed = st.pos
            self._observe_commit_latency(st, now)
            self.results[st.stream_id] = (
                self._collect(st), metric_i + float(offset_np[slot])
            )
            self.stats.streams_finished += 1
            st.slot = None
            del self._by_id[st.stream_id]
            self.alloc.release(slot)  # state is re-initialized at next claim


def _gather_block(arena: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The tick's decode block: arena rows ``idx`` (n_slots, chunk) ->
    (n_slots, chunk, width), one ``index_select``."""
    return arena[0].index_select(0, idx.reshape(-1)).reshape(*idx.shape, arena.shape[2])
