"""Deterministic fault injection for the streaming decode plane.

A production decode plane must survive producer crashes, poisoned inputs,
stalls, and flaky device steps — and every survival claim needs a harness
that can actually produce those faults, reproducibly, with a record of what
was injected so tests can assert both SURVIVAL (the scheduler kept serving)
and DETECTION (every fault shows up in the ``obs`` metrics).  This module
is that harness; the degradation machinery it exercises (quarantine, TTL
eviction, overload shedding, tick retry) lives in the scheduler itself.

Fault classes (all seeded, all per-stream deterministic):

  producer_exception   the producer raises mid-poll — a crashed connection.
                       The scheduler quarantines the ONE stream
                       ("producer_error"), flushes its partial result, and
                       the tick never sees the exception.
  producer_stall       poll returns None — a silent source.  The slot idles
                       (starved ticks), bit-exactness unaffected.
  slow_drip            poll hands out a single row — degenerate arrival
                       sizes; the arrival-invariance contract absorbs it.
  corrupt_nan / corrupt_inf
                       a random element of an otherwise-valid chunk becomes
                       non-finite — the poisoned-input case that silently
                       corrupted a whole batch tick before value validation;
                       now quarantined as "poisoned_chunk".
  corrupt_shape        the chunk loses a column — a framing bug upstream;
                       quarantined as "poisoned_chunk".
  device_step_failure  ``install_tick_faults`` hooks the tick's step phase
                       to raise :class:`InjectedDeviceFault` — the scheduler
                       drops the tick without touching carried state and
                       retries the identical gather next tick.
  clock_skew           :class:`ChaosClock` jumps a rate-limited producer's
                       clock forward — bursty arrival, never a decode change.

Every injection is recorded twice: in the injector's own ``injected``
counter dict (the harness-side ledger tests read back) and, when a
metrics registry is supplied, as ``chaos_injected_total`` plus a per-class
``chaos_<class>_total`` counter in the same registry the scheduler exposes
through ``metrics_text()``.
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import Dict, Optional

import numpy as np

from repro_torch.stream.resilience import TickFault

#: Every fault class a ChaosPolicy can inject, in catalog order.
FAULT_CLASSES = (
    "producer_exception",
    "producer_stall",
    "slow_drip",
    "corrupt_nan",
    "corrupt_inf",
    "corrupt_shape",
    "device_step_failure",
    "clock_skew",
)


class ChaosProducerError(RuntimeError):
    """The simulated producer crash ChaosProducer raises mid-poll."""


class InjectedDeviceFault(TickFault):
    """Simulated device-step failure (see install_tick_faults)."""


@dataclasses.dataclass(frozen=True)
class ChaosPolicy:
    """Per-poll / per-tick injection probabilities, seeded.

    Each field is the probability that the corresponding fault fires on one
    producer poll (or one tick, for ``device_step_failure``).  Streams
    derive independent deterministic RNGs from (seed, stream_id), so a run
    with the same policy, streams, and arrival schedule injects the same
    faults — the chaos suite is reproducible, not flaky.
    """

    seed: int = 0
    producer_exception: float = 0.0
    producer_stall: float = 0.0
    slow_drip: float = 0.0
    corrupt_nan: float = 0.0
    corrupt_inf: float = 0.0
    corrupt_shape: float = 0.0
    device_step_failure: float = 0.0
    clock_skew: float = 0.0

    def rate(self, cls: str) -> float:
        return float(getattr(self, cls))

    @classmethod
    def producer_mix(cls, p: float, seed: int = 0) -> "ChaosPolicy":
        """A producer-fault mix: probability ``p`` split across
        the recoverable producer faults plus a light corruption tail."""
        return cls(
            seed=seed,
            producer_stall=p / 2,
            slow_drip=p / 4,
            producer_exception=p / 8,
            corrupt_nan=p / 8,
        )


class FaultInjector:
    """Shared seeded ledger: decides fault firings and records them."""

    def __init__(self, policy: ChaosPolicy, scope: str, metrics=None):
        self.policy = policy
        # stable per-scope stream: independent of python hash randomization
        self._rng = np.random.RandomState(
            (policy.seed ^ zlib.crc32(scope.encode())) % (2 ** 31)
        )
        self._metrics = metrics
        self.injected: Dict[str, int] = {}

    def trip(self, cls: str) -> bool:
        p = self.policy.rate(cls)
        if p <= 0.0 or self._rng.random_sample() >= p:
            return False
        self.record(cls)
        return True

    def record(self, cls: str) -> None:
        self.injected[cls] = self.injected.get(cls, 0) + 1
        if self._metrics is not None:
            self._metrics.counter(
                "chaos_injected_total", help="faults injected by the chaos harness"
            ).inc()
            self._metrics.counter(
                f"chaos_{cls}_total", help=f"injected {cls} faults"
            ).inc()


class ChaosProducer:
    """Wrap any ChunkProducer with seeded producer-side fault injection.

    Fault precedence per poll: exception > stall > slow_drip; corruption
    applies to whatever rows the inner producer returned.  After an injected
    exception the producer is dead (a crashed connection does not come
    back): further polls raise again until the scheduler quarantines the
    stream — which it does on the first one.
    """

    def __init__(
        self,
        inner,
        policy: ChaosPolicy,
        stream_id: str = "",
        metrics=None,
    ):
        from repro_torch.stream.ingest import as_producer

        self.inner = as_producer(inner)
        self.injector = FaultInjector(policy, f"producer:{stream_id}", metrics)
        self._crashed = False

    @property
    def injected(self) -> Dict[str, int]:
        return self.injector.injected

    def poll(self, max_rows: int) -> Optional[np.ndarray]:
        if self._crashed:
            raise ChaosProducerError("producer already crashed")
        if self.injector.trip("producer_exception"):
            self._crashed = True
            raise ChaosProducerError("injected producer crash")
        if self.injector.trip("producer_stall"):
            return None
        if self.injector.trip("slow_drip"):
            max_rows = min(max_rows, 1)
        rows = self.inner.poll(max_rows)
        if rows is None or not rows.shape[0]:
            return rows
        if self.injector.trip("corrupt_nan"):
            rows = self._poison(rows, np.nan)
        if self.injector.trip("corrupt_inf"):
            rows = self._poison(rows, np.inf)
        if self.injector.trip("corrupt_shape"):
            rows = rows[:, :-1] if rows.shape[1] > 1 else np.repeat(rows, 2, axis=1)
        return rows

    def _poison(self, rows: np.ndarray, value: float) -> np.ndarray:
        rows = np.array(rows, dtype=np.float32)
        r = self.injector._rng
        rows[r.randint(rows.shape[0]), r.randint(rows.shape[1])] = value
        return rows

    @property
    def exhausted(self) -> bool:
        return not self._crashed and self.inner.exhausted


class ChaosClock:
    """Monotonic clock with seeded forward jumps (clock skew on a
    rate-limited producer: rows burst out early, arrival-invariance keeps
    the decode identical).  Pass as ``RateLimitedProducer(..., clock=...)``.
    """

    def __init__(self, policy: ChaosPolicy, max_skew_s: float = 0.25,
                 clock=None, metrics=None):
        import time

        self._clock = clock or time.monotonic
        self._skew = 0.0
        self._max_skew_s = max_skew_s
        self.injector = FaultInjector(policy, "clock", metrics)

    def __call__(self) -> float:
        if self.injector.trip("clock_skew"):
            # forward-only: a monotonic clock never runs backwards, but NTP
            # steps and VM freezes make it jump ahead
            self._skew += self.injector._rng.random_sample() * self._max_skew_s
        return self._clock() + self._skew


def install_tick_faults(sched, policy: ChaosPolicy) -> FaultInjector:
    """Arm ``sched`` with simulated device-step failures: each tick's step
    phase raises :class:`InjectedDeviceFault` with the policy's probability.
    The scheduler survives by construction — the fault fires before any
    carried state is reassigned, the tick is dropped and counted
    (``stream_tick_device_failures_total``), and the next tick retries the
    same gather.  Returns the injector (its ``injected`` dict is the
    harness-side ledger).  Uninstall with ``sched.tick_fault_hook = None``.
    """
    injector = FaultInjector(policy, "tick", sched.telemetry.metrics)

    def hook(tick: int) -> None:
        if injector.trip("device_step_failure"):
            raise InjectedDeviceFault(f"injected device failure at tick {tick}")

    sched.tick_fault_hook = hook
    return injector
