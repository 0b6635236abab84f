"""Serving resilience: crash-consistent snapshot/restore for the scheduler.

A drain/migrate primitive: freeze a live :class:`~repro_torch.stream.StreamScheduler`
— mid-decode, with streams at arbitrary window positions — move the frozen
state to another process or card, and resume such that every bit committed
after the restore is IDENTICAL to the uninterrupted run.

The snapshot is taken at a tick boundary (the scheduler API is host-driven,
so every call site is one) and covers every piece of carried serving state:

  * per-stream host bookkeeping — id, termination flag, closed/credit state,
    fed/pos/committed watermarks, priority, deadline, pre-admission queue;
  * the device plane, copied to host numpy and keyed per STREAM rather than
    per slot, so a restore is a pure re-layout: path-metric row,
    survivor-ring column, accumulated renormalization offset, DeviceCounters
    leaves.  The port holds packed survivor words and unpacked backpointers
    both as int32, so each image carries the ``packed`` flag that says which
    its ring column holds (the reference tells them apart by dtype, uint32
    against int32);
  * the stream's unconsumed input arena rows, extracted post-feature-
    transform (puncture phase is baked in at accept time, so replaying them
    through ``features`` again would corrupt the decode — restore appends
    them verbatim);
  * scheduler-scope state: SchedulerStats (tick count continues, so absolute
    deadline ticks stay valid), finished-stream results, structured stream
    errors, and the straggler detector's EMA.

What is deliberately NOT captured: attached producers (a generator or socket
cannot be serialized — re-attach with ``StreamScheduler.attach_producer``
after restoring) and the arrival-latency bookkeeping (monotonic timestamps
do not survive a host move; the latency histogram restarts).

``save``/``load`` serialize through pickle — the payload is plain dataclass
+ numpy + CodecSpec state of this package, so a snapshot is loaded only by
the package that wrote it.  Only load snapshots you wrote (the usual pickle
trust boundary).
"""
from __future__ import annotations

import dataclasses
import pickle
from typing import Dict, List, Optional, Tuple

import numpy as np

#: Bump when the snapshot layout changes; ``restore_scheduler`` refuses a
#: mismatched snapshot instead of mis-reading it.
SNAPSHOT_VERSION = 1


class TickFault(RuntimeError):
    """A transient failure of one scheduler tick's device step.

    The tick that observes it is dropped WITHOUT mutating any carried state
    (the fault is raised before the step's results are assigned), so the
    next tick retries the identical gather and the decode is unchanged.
    ``chaos.InjectedDeviceFault`` subclasses this to simulate device-step
    failures; the scheduler counts every occurrence in
    ``stream_tick_device_failures_total``.
    """


@dataclasses.dataclass
class StreamError:
    """Structured record of why a stream was terminated early.

    One stream's fault must never fail the tick: poisoned chunks, crashed
    producers, expired deadlines, and overload shedding all resolve to one
    of these in ``StreamScheduler.errors`` (keyed by stream id), alongside
    whatever partial result the flush could still commit to ``results``.

    reason: "poisoned_chunk" | "producer_error" | "expired" | "shed".
    detail: human-readable cause (repr of the offending exception, the
      deadline that passed, the priority that lost).
    tick:   scheduler tick count when the stream was terminated.
    committed_bits: bits the stream had delivered by then (including the
      partial-result flush, when one ran).
    """

    stream_id: str
    reason: str
    detail: str
    tick: int
    committed_bits: int = 0

    def __str__(self) -> str:  # readable in logs / pytest output
        return (
            f"StreamError({self.stream_id!r}: {self.reason} at tick "
            f"{self.tick}, {self.committed_bits} bits committed — {self.detail})"
        )


@dataclasses.dataclass
class StreamImage:
    """One open stream, frozen — everything needed to resume it anywhere."""

    stream_id: str
    terminated: bool
    closed: bool
    max_buffered: int
    priority: int
    deadline_tick: Optional[int]
    fed: int
    pos: int
    committed: int
    #: raw pre-admission chunks (feature transform happens at admission)
    queued: List[np.ndarray]
    #: bits already committed but not yet retired into ``results``
    out: List[np.ndarray]
    #: original slot (ordering only — restore may re-place the stream)
    slot: Optional[int] = None
    #: unconsumed arena rows [pos, fed), post-feature-transform
    arena_rows: Optional[np.ndarray] = None
    #: device plane, per stream (active streams only)
    pm: Optional[np.ndarray] = None
    #: (R/32, S) packed survivor words or (R, S) unpacked backpointers, int32
    ring: Optional[np.ndarray] = None
    #: ``ring`` holds packed survivor words (the fused_packed backend)
    packed: bool = False
    offset: float = 0.0
    counters: Optional[Dict[str, np.ndarray]] = None


@dataclasses.dataclass
class StreamSnapshot:
    """Versioned on-host checkpoint of a whole StreamScheduler."""

    version: int
    spec: object  # CodecSpec — shared by every stream (scheduler contract)
    config: Dict[str, object]
    active: List[StreamImage]  # in slot order (restore re-places in order)
    pending: List[StreamImage]  # FIFO admission order
    stats: Dict[str, int]
    results: Dict[str, Tuple[np.ndarray, float]]
    errors: Dict[str, StreamError]
    straggler: Dict[str, float]

    def save(self, path) -> None:
        with open(path, "wb") as f:
            pickle.dump(self, f)

    @staticmethod
    def load(path) -> "StreamSnapshot":
        with open(path, "rb") as f:
            snap = pickle.load(f)
        if not isinstance(snap, StreamSnapshot):
            raise TypeError(f"{path} is not a StreamSnapshot")
        return snap

    @property
    def stream_ids(self) -> List[str]:
        return [im.stream_id for im in self.active + self.pending]


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy()


def snapshot_scheduler(sched) -> StreamSnapshot:
    """Freeze ``sched`` into a StreamSnapshot (the scheduler is untouched
    and keeps serving).  Called between ticks — every device tensor is
    copied to the host here, once, off the hot path."""
    pm_np = _host(sched.state.pm)
    ring_np = _host(sched.state.ring)
    offset_np = _host(sched.offset)
    arena_np = _host(sched._arena)
    ctr_np = (
        {name: _host(leaf) for name, leaf in zip(type(sched._counters)._fields, sched._counters)}
        if sched._counters is not None
        else None
    )

    def image(st) -> StreamImage:
        im = StreamImage(
            stream_id=st.stream_id,
            terminated=st.terminated,
            closed=st.closed,
            max_buffered=st.max_buffered,
            priority=st.priority,
            deadline_tick=st.deadline_tick,
            fed=st.fed,
            pos=st.pos,
            committed=st.committed,
            queued=[np.array(c) for c in st.queued],
            out=list(st.out),
            slot=st.slot,
        )
        if st.slot is not None:
            im.arena_rows = arena_np[st.shard][st.rows].copy()
            im.pm = pm_np[st.slot].copy()
            im.ring = ring_np[:, st.slot].copy()
            im.packed = sched.packed
            im.offset = float(offset_np[st.slot])
            if ctr_np is not None:
                im.counters = {k: v[st.slot].copy() for k, v in ctr_np.items()}
        return im

    active = [image(st) for _, st in sorted(sched.active.items())]
    pending = [image(st) for st in sched.pending]
    return StreamSnapshot(
        version=SNAPSHOT_VERSION,
        spec=sched.spec,
        config={
            "n_slots": sched.n_slots,
            "chunk": sched.chunk,
            "depth": sched.depth,
            "backend": sched.backend,
            "inputs": sched.inputs,
            "normalize": sched.normalize,
            "max_buffered": sched.max_buffered,
            "max_pending": sched.max_pending,
        },
        active=active,
        pending=pending,
        stats=sched.stats.asdict(),
        results=dict(sched.results),
        errors=dict(sched.errors),
        straggler={
            "mean": sched.straggler.mean,
            "var": sched.straggler.var,
            "n": sched.straggler.n,
        },
    )


def restore_scheduler(
    snap: StreamSnapshot,
    *,
    mesh=None,
    telemetry=None,
    device="cuda",
):
    """Build a fresh StreamScheduler on ``device`` resuming exactly where
    ``snap`` froze.

    The snapshot is keyed per stream, so each stream's pm row / ring column /
    arena rows land wherever its NEW slot lives, on whichever device the
    restore targets (a snapshot taken on the card restores on the CPU and
    the other way round).  Committed output after the restore is bit-exact
    with the uninterrupted run.  ``mesh`` raises as the scheduler's does.

    Producers are not restored — re-attach with ``attach_producer``.
    """
    if snap.version != SNAPSHOT_VERSION:
        raise ValueError(
            f"snapshot version {snap.version} != supported {SNAPSHOT_VERSION}"
        )
    import torch

    from repro_torch.stream import window as _w
    from repro_torch.stream.scheduler import SchedulerStats, StreamScheduler, _Stream

    cfg = snap.config
    sched = StreamScheduler(
        snap.spec,
        n_slots=cfg["n_slots"],
        chunk=cfg["chunk"],
        depth=cfg["depth"],
        backend=cfg["backend"],
        normalize=cfg["normalize"],
        device=device,
        inputs=cfg["inputs"],
        max_buffered=cfg["max_buffered"],
        max_pending=cfg["max_pending"],
        mesh=mesh,
        telemetry=telemetry,
    )

    def stream_of(im: StreamImage) -> _Stream:
        return _Stream(
            stream_id=im.stream_id,
            terminated=im.terminated,
            max_buffered=im.max_buffered,
            closed=im.closed,
            priority=im.priority,
            deadline_tick=im.deadline_tick,
            fed=im.fed,
            pos=im.pos,
            committed=im.committed,
            queued=list(im.queued),
            queued_rows=sum(c.shape[0] for c in im.queued),
            out=list(im.out),
        )

    # device plane rebuilt host-side in one pass (numpy), then uploaded once
    pm = _host(sched.state.pm).copy()
    ring = _host(sched.state.ring).copy()
    offset = np.zeros((sched.n_slots,), dtype=np.float32)
    ctrs = (
        {k: _host(v).copy() for k, v in zip(_w.DeviceCounters._fields, sched._counters)}
        if sched._counters is not None
        else None
    )
    for im in snap.active:
        if im.packed != sched.packed:
            raise ValueError(
                f"stream {im.stream_id!r}: snapshot ring is "
                f"{'packed' if im.packed else 'unpacked'}, the {sched.backend!r} "
                "backend's is not"
            )
        st = stream_of(im)
        slot = sched.alloc.claim(st.stream_id)
        if slot is None:
            raise ValueError("snapshot holds more active streams than the scheduler's slots")
        st.slot = slot
        st.shard = sched._shard_of(slot)
        sched.active[slot] = st
        sched._by_id[st.stream_id] = st
        pm[slot] = im.pm
        ring[:, slot] = im.ring
        offset[slot] = im.offset
        if ctrs is not None and im.counters is not None:
            for k in ctrs:
                ctrs[k][slot] = im.counters[k]
        n = im.arena_rows.shape[0] if im.arena_rows is not None else 0
        if n:
            start = sched._append_rows(st.shard, sched._upload(im.arena_rows))
            st.rows = np.arange(start, start + n, dtype=np.int32)
    dev = sched.device
    sched.state = _w.StreamState(pm=torch.from_numpy(pm).to(dev),
                                 ring=torch.from_numpy(ring).to(dev))
    sched.offset = torch.from_numpy(offset).to(dev)
    if ctrs is not None:
        sched._counters = _w.DeviceCounters(
            **{k: torch.from_numpy(v).to(dev) for k, v in ctrs.items()}
        )

    for im in snap.pending:
        st = stream_of(im)
        sched.pending.append(st)
        sched._by_id[st.stream_id] = st

    sched.stats = SchedulerStats(**snap.stats)
    sched.results = dict(snap.results)
    sched.errors = dict(snap.errors)
    sched.straggler.mean = snap.straggler["mean"]
    sched.straggler.var = snap.straggler["var"]
    sched.straggler.n = int(snap.straggler["n"])
    return sched
