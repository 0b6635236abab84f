"""Chunk producers + backpressure types — the online-ingestion layer.

The scheduler no longer needs a stream's whole (T, ·) table up front:
callers open a stream, feed rows as they arrive (``submit_chunk``), and
close it when the connection ends.  This module is the adapter layer between
whatever is producing symbols — a generator, a polling callback, a socket
reader thread — and that chunk-fed scheduler API:

  ChunkProducer       the pull protocol the scheduler polls every tick:
                      ``poll(max_rows)`` returns up to max_rows new rows (or
                      None when nothing is ready yet), ``exhausted`` flips
                      when the source has ended.
  GeneratorProducer   wraps any iterator/generator of row arrays; chunks
                      larger than the scheduler's credit are split and the
                      remainder buffered, so arbitrary arrival sizes respect
                      backpressure.
  CallableProducer    wraps a poll function ``fn(max_rows) -> rows | None``
                      (raise StopIteration to end the stream) — the shape a
                      rate-limited or device-driven source naturally takes.
  PushProducer        thread-safe bounded buffer for push-style sources: a
                      socket reader or asyncio callback ``feed()``s rows from
                      its own thread/task and ``close()``s at EOF; the
                      scheduler drains it from the tick loop.

  StreamBusy          raised by ``StreamScheduler.submit_chunk`` when a
                      stream's bounded input queue cannot take the chunk;
                      carries the remaining ``credit`` so callers throttle
                      instead of guessing.

Backpressure contract: every producer is polled with the stream's current
credit (max_buffered - rows not yet consumed by the decoder) and must return
at most that many rows; direct ``submit_chunk`` callers get the same signal
as a returned credit count, or ``StreamBusy`` when they overrun it.
"""
from __future__ import annotations

import threading
from collections import deque
from typing import Callable, Deque, Iterable, Iterator, List, Optional, Protocol, Union

import numpy as np


class StreamBusy(RuntimeError):
    """A stream's bounded input queue cannot accept the offered chunk.

    Attributes:
      stream_id: the stream whose queue is full.
      credit: rows the queue can still take right now (retry with a chunk of
        at most this many rows, or wait for ticks to drain the queue).
      retry_after_ticks: scheduler's drain-rate estimate of how many ticks
        until the queue can take this chunk — back off this many ticks
        instead of hot-spinning (see RateLimitedProducer.pump).
    """

    def __init__(
        self,
        stream_id: str,
        credit: int,
        offered: int,
        retry_after_ticks: int = 1,
    ):
        self.stream_id = stream_id
        self.credit = credit
        self.offered = offered
        self.retry_after_ticks = retry_after_ticks
        super().__init__(
            f"stream {stream_id!r} queue full: offered {offered} rows, "
            f"credit {credit} — retry in ~{retry_after_ticks} tick(s) or "
            "send <= credit rows"
        )


class ChunkProducer(Protocol):
    """What the scheduler polls each tick for a producer-fed stream."""

    def poll(self, max_rows: int) -> Optional[np.ndarray]:
        """Return up to ``max_rows`` new (t, ·) rows, or None when no data is
        ready yet.  Must never return more than ``max_rows`` rows."""
        ...

    @property
    def exhausted(self) -> bool:
        """True once the source has ended and every buffered row has been
        handed out — the scheduler then closes the stream."""
        ...


def _as_rows(rows) -> np.ndarray:
    out = np.asarray(rows, dtype=np.float32)
    if out.ndim != 2:
        raise ValueError(f"producer rows must be 2-D (t, width), got {out.shape}")
    return out


class _CreditPolledProducer:
    """Shared pull-producer core: leftover splitting + the fill-credit loop.

    Subclasses implement ``_pull(max_rows) -> rows | None`` — None (or an
    empty array) means nothing ready right now, StopIteration means the
    source has ended.  ``poll`` keeps pulling until the credit is filled,
    the source pauses, or it ends: one source chunk per poll would cap
    ingest at a chunk per TICK and leave the rest of the credit idle, and a
    chunk bigger than the credit is split with the remainder served on
    later polls, so arbitrary arrival sizes honor backpressure."""

    def __init__(self):
        self._leftover: Optional[np.ndarray] = None
        self._done = False

    def _pull(self, max_rows: int) -> Optional[np.ndarray]:
        raise NotImplementedError

    def poll(self, max_rows: int) -> Optional[np.ndarray]:
        if max_rows <= 0:
            return None
        parts: List[np.ndarray] = []
        took = 0
        if self._leftover is not None:
            out, rest = self._leftover[:max_rows], self._leftover[max_rows:]
            parts.append(out)
            took = out.shape[0]
            self._leftover = rest if rest.shape[0] else None
        while took < max_rows and not self._done and self._leftover is None:
            try:
                got = self._pull(max_rows - took)
            except StopIteration:
                self._done = True
                break
            if got is None:
                break
            got = _as_rows(got)
            if not got.shape[0]:
                break
            out, rest = got[: max_rows - took], got[max_rows - took :]
            parts.append(out)
            took += out.shape[0]
            self._leftover = rest if rest.shape[0] else None
        return np.concatenate(parts, axis=0) if took else None

    @property
    def exhausted(self) -> bool:
        return self._done and self._leftover is None


class GeneratorProducer(_CreditPolledProducer):
    """ChunkProducer over any iterator/generator of (t, ·) row arrays."""

    def __init__(self, source: Union[Iterable, Iterator]):
        super().__init__()
        self._it = iter(source)

    def _pull(self, max_rows: int) -> Optional[np.ndarray]:
        return next(self._it)  # StopIteration propagates = end of stream


class CallableProducer(_CreditPolledProducer):
    """ChunkProducer over a poll function ``fn(max_rows) -> rows | None``.

    ``fn`` returns None (or an empty array) when nothing is ready and raises
    StopIteration when the source has ended."""

    def __init__(self, fn: Callable[[int], Optional[np.ndarray]]):
        super().__init__()
        self._fn = fn

    def _pull(self, max_rows: int) -> Optional[np.ndarray]:
        return self._fn(max_rows)


class PushProducer:
    """Thread-safe bounded buffer for push-style (socket / async) sources.

    The I/O side calls ``feed(rows)`` from its own thread or event-loop task
    — a socket reader pushing demodulated symbols, an asyncio protocol's
    ``data_received`` — and ``close()`` at EOF; the scheduler's tick loop
    polls rows back out.  ``feed`` raises StreamBusy when the buffer is full
    (``block=False``) or blocks until the tick loop drains it (default), so
    backpressure propagates all the way to the source:

        prod = PushProducer(max_rows=4 * chunk)
        sched.open_stream("uplink-7", producer=prod)
        # in the reader thread / protocol callback:
        prod.feed(symbol_rows)          # blocks when the decoder lags
        prod.close()                    # on EOF
    """

    def __init__(self, max_rows: int = 4096):
        if max_rows < 1:
            raise ValueError("max_rows must be >= 1")
        self.max_rows = max_rows
        self._chunks: Deque[np.ndarray] = deque()
        self._buffered = 0
        self._closed = False
        self._cv = threading.Condition()

    def feed(self, rows, block: bool = True, timeout: Optional[float] = None) -> None:
        import time

        rows = _as_rows(rows)
        if not rows.shape[0]:
            return
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cv:
            if self._closed:
                raise RuntimeError("PushProducer is closed")
            if not block and self._buffered + rows.shape[0] > self.max_rows:
                raise StreamBusy(
                    "<push-producer>", self.max_rows - self._buffered, rows.shape[0]
                )
            while self._buffered + rows.shape[0] > self.max_rows:
                # a single deadline across wake-ups: partial drains notify the
                # condition, and a per-wait timeout would reset on every one
                remaining = None if deadline is None else deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    raise StreamBusy(
                        "<push-producer>", self.max_rows - self._buffered,
                        rows.shape[0],
                    )
                if not self._cv.wait(remaining):
                    raise StreamBusy(
                        "<push-producer>", self.max_rows - self._buffered,
                        rows.shape[0],
                    )
            self._chunks.append(rows)
            self._buffered += rows.shape[0]

    def close(self) -> None:
        with self._cv:
            self._closed = True
            self._cv.notify_all()

    def poll(self, max_rows: int) -> Optional[np.ndarray]:
        if max_rows <= 0:
            return None
        with self._cv:
            if not self._chunks:
                return None
            parts: List[np.ndarray] = []
            took = 0
            while self._chunks and took < max_rows:
                head = self._chunks[0]
                take = min(head.shape[0], max_rows - took)
                parts.append(head[:take])
                if take == head.shape[0]:
                    self._chunks.popleft()
                else:
                    self._chunks[0] = head[take:]
                took += take
            self._buffered -= took
            self._cv.notify_all()
        return np.concatenate(parts, axis=0) if parts else None

    @property
    def exhausted(self) -> bool:
        with self._cv:
            return self._closed and not self._chunks


class RateLimitedProducer:
    """Release an in-memory (T, ·) table at ``rows_per_s`` — a steady-state
    load model for driving the scheduler (and a handy stand-in for a live
    feed in examples/tests).

    Rows become available as the clock advances (fractional accumulation, so
    low rates work); ``poll`` hands out whatever is both available and within
    the scheduler's credit, stamping arrival times for latency accounting.
    """

    def __init__(self, table: np.ndarray, rows_per_s: float, clock=None):
        import time

        self._table = _as_rows(table)
        self._rate = float(rows_per_s)
        self._clock = clock or time.monotonic
        self._t0 = self._clock()
        self._served = 0
        #: (end_row_exclusive, arrival_time) per released chunk — the
        #: latency bookkeeping a load generator reads.
        self.arrivals: List[tuple] = []
        # push-side (pump) state: rows a StreamBusy refused, ticks left to
        # back off, and the convergence counters tests assert on
        self._hold: Optional[np.ndarray] = None
        self._backoff = 0
        self._closed_sent = False
        self.busy_events = 0  # StreamBusy raised against this producer
        self.skipped_pumps = 0  # pump calls skipped while backing off

    def poll(self, max_rows: int) -> Optional[np.ndarray]:
        if max_rows <= 0 or self._served >= self._table.shape[0]:
            return None
        now = self._clock()
        released = int((now - self._t0) * self._rate)
        ready = min(released, self._table.shape[0]) - self._served
        n = min(ready, max_rows)
        if n <= 0:
            return None
        out = self._table[self._served : self._served + n]
        self._served += n
        self.arrivals.append((self._served, now))
        return out

    @property
    def exhausted(self) -> bool:
        return self._served >= self._table.shape[0]

    def pump(self, sched, stream_id: str, *, close: bool = True) -> int:
        """Push-side feeding that honors ``StreamBusy.retry_after_ticks``.

        Call once per scheduler tick from the serving loop (instead of
        attaching the producer for pull-side polling): releases whatever the
        rate limit has made available and submits it with ``submit_chunk``.
        On StreamBusy the refused rows are held and the next
        ``retry_after_ticks`` pump calls are skipped entirely — the backoff
        loop converges to the drain rate instead of hot-spinning one
        rejected submit per tick (``busy_events`` / ``skipped_pumps`` count
        both sides, so tests can assert convergence).  Returns the rows
        accepted this call; closes the stream at EOF when ``close``.
        """
        if self._backoff > 0:
            self._backoff -= 1
            self.skipped_pumps += 1
            return 0
        rows = self._hold
        self._hold = None
        if rows is None:
            rows = self.poll(self._table.shape[0])
        accepted = 0
        if rows is not None and rows.shape[0]:
            try:
                sched.submit_chunk(stream_id, rows)
                accepted = rows.shape[0]
            except StreamBusy as e:
                self.busy_events += 1
                if e.credit > 0:
                    # partial acceptance: fill the remaining credit now
                    # (guaranteed to fit) and hold only the overflow
                    sched.submit_chunk(stream_id, rows[: e.credit])
                    accepted = e.credit
                self._hold = rows[accepted:]
                self._backoff = max(1, int(e.retry_after_ticks))
        if (
            close
            and not self._closed_sent
            and self.exhausted
            and self._hold is None
        ):
            sched.close(stream_id)
            self._closed_sent = True
        return accepted


def as_producer(source) -> ChunkProducer:
    """Coerce a source to a ChunkProducer: producers pass through, callables
    become CallableProducer, iterables/generators become GeneratorProducer."""
    if hasattr(source, "poll") and hasattr(source, "exhausted"):
        return source
    if callable(source):
        return CallableProducer(source)
    return GeneratorProducer(source)
