"""Metrics core: counters, gauges, fixed-bucket histograms, one registry.

The streaming plane needs numbers a routing tier can throttle on (p95
arrival-to-commit latency, queue depths) and the adaptive-traceback work
needs per-stream survivor statistics — both are *metrics*, not log lines.
This module is the low-overhead primitive layer those consumers share:

  Counter / Gauge     plain monotone / last-value cells (python ints and
                      floats — observing one is an attribute add, no locks,
                      no allocation on the hot path).
  Histogram           fixed upper-bound buckets chosen at construction, so
                      ``observe`` is a bisect + two adds; quantiles are
                      estimated from the bucket boundaries (clamped to the
                      exactly-tracked min/max), never from stored samples —
                      memory is O(buckets) no matter how many observations.
  MetricsRegistry     name -> instrument, ``snapshot()`` as one plain dict,
                      Prometheus-style text exposition via ``render()``.

plus :func:`percentile`, the ONE nearest-rank helper every place that
summarizes a list of raw latencies must use (the ad-hoc copies it replaces
indexed into unsorted arrays and crashed on empty input).
"""
from __future__ import annotations

import bisect
import dataclasses
import math
from typing import Dict, Iterable, List, Optional, Sequence, Tuple


def percentile(values: Sequence[float], q: float, default: float = 0.0) -> float:
    """Nearest-rank percentile of raw samples (q in [0, 1]).

    Sorts a copy (callers need not pre-sort) and returns ``default`` for an
    empty sequence instead of crashing — the two bugs of the ad-hoc
    ``sorted_lat[int(q * (len - 1))]`` copies this replaces.
    """
    if not 0.0 <= q <= 1.0:
        raise ValueError(f"q must be in [0, 1], got {q}")
    vals = sorted(values)
    if not vals:
        return default
    return float(vals[int(round(q * (len(vals) - 1)))])


#: Default latency buckets: 1 ms .. ~8.7 min, doubling — 20 buckets cover
#: everything from a warm device tick to a cold-build stall.
LATENCY_BUCKETS_S: Tuple[float, ...] = tuple(0.001 * 2 ** i for i in range(20))

#: Default merge-depth buckets (trellis steps): survivor windows are tens to
#: a few hundred steps deep.
DEPTH_BUCKETS: Tuple[float, ...] = (1, 2, 4, 8, 12, 16, 24, 32, 48, 64, 96,
                                    128, 192, 256, 384, 512)

#: Tick wall-time buckets (seconds): 100 µs .. ~1.6 s, doubling — the input
#: resolution the StragglerDetector's z-score flags against.
TICK_BUCKETS: Tuple[float, ...] = tuple(0.0001 * 2 ** i for i in range(15))


@dataclasses.dataclass
class Counter:
    """Monotone event count.  ``inc`` only — resets mean a new Counter."""

    name: str
    help: str = ""
    value: float = 0.0

    def inc(self, n: float = 1.0) -> None:
        self.value += n

    def set(self, v: float) -> None:
        """Absorb an externally-kept monotone count (e.g. SchedulerStats
        fields mirrored into the registry at snapshot time)."""
        self.value = float(v)


@dataclasses.dataclass
class Gauge:
    """Last-value instrument (queue depth, utilization, ...)."""

    name: str
    help: str = ""
    value: float = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def inc(self, n: float = 1.0) -> None:
        self.value += n

    def dec(self, n: float = 1.0) -> None:
        self.value -= n


class Histogram:
    """Fixed-bucket histogram: cumulative-style buckets + exact count/sum/
    min/max.  ``observe`` is O(log buckets); quantiles are bucket-boundary
    estimates clamped into the exact [min, max] envelope, so ``q(0.5) <=
    q(0.95)`` holds by construction and a single observation reports itself
    exactly."""

    def __init__(self, name: str, buckets: Iterable[float], help: str = ""):
        self.name = name
        self.help = help
        self.uppers: List[float] = sorted(float(b) for b in buckets)
        if not self.uppers:
            raise ValueError("histogram needs at least one bucket bound")
        # counts[i] <-> uppers[i]; counts[-1] is the +inf overflow bucket
        self.counts: List[int] = [0] * (len(self.uppers) + 1)
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf

    def observe(self, v: float) -> None:
        v = float(v)
        self.counts[bisect.bisect_left(self.uppers, v)] += 1
        self.count += 1
        self.sum += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def quantile(self, q: float) -> float:
        """Bucket-upper-bound estimate of the q-quantile (q in [0, 1])."""
        if self.count == 0:
            return 0.0
        target = max(1, math.ceil(q * self.count))
        cum = 0
        for i, c in enumerate(self.counts):
            cum += c
            if cum >= target:
                upper = self.uppers[i] if i < len(self.uppers) else self.max
                return float(min(max(upper, self.min), self.max))
        return float(self.max)

    def summary(self) -> Dict[str, float]:
        """The load_report / bench shape: count, mean, p50, p95, max."""
        return {
            "count": self.count,
            "mean": self.mean,
            "p50": self.quantile(0.5),
            "p95": self.quantile(0.95),
            "max": self.max if self.count else 0.0,
        }


class MetricsRegistry:
    """Get-or-create instrument registry with one snapshot/exposition view.

    Not thread-safe by design: every scheduler/session owns its own registry
    and mutates it from its own control thread (the same discipline as the
    rest of the host-side bookkeeping).
    """

    def __init__(self) -> None:
        self._instruments: Dict[str, object] = {}

    def _get(self, cls, name: str, help: str, **kwargs):
        inst = self._instruments.get(name)
        if inst is None:
            inst = cls(name=name, help=help, **kwargs) if cls is not Histogram \
                else cls(name, kwargs["buckets"], help=help)
            self._instruments[name] = inst
        elif not isinstance(inst, cls):
            raise TypeError(
                f"metric {name!r} already registered as {type(inst).__name__}"
            )
        return inst

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(Gauge, name, help)

    def histogram(
        self, name: str, buckets: Optional[Iterable[float]] = None, help: str = ""
    ) -> Histogram:
        return self._get(
            Histogram, name, help, buckets=tuple(buckets or LATENCY_BUCKETS_S)
        )

    def snapshot(self) -> Dict[str, object]:
        """One plain dict: scalars for counters/gauges, summary dicts for
        histograms — JSON-ready, the shape ``load_report`` re-exports."""
        out: Dict[str, object] = {}
        for name, inst in sorted(self._instruments.items()):
            out[name] = (
                inst.summary() if isinstance(inst, Histogram) else inst.value
            )
        return out

    def render(self) -> str:
        """Prometheus text exposition (text/plain; version 0.0.4)."""
        lines: List[str] = []
        for name, inst in sorted(self._instruments.items()):
            if inst.help:
                lines.append(f"# HELP {name} {inst.help}")
            if isinstance(inst, Counter):
                lines.append(f"# TYPE {name} counter")
                lines.append(f"{name} {_fmt(inst.value)}")
            elif isinstance(inst, Gauge):
                lines.append(f"# TYPE {name} gauge")
                lines.append(f"{name} {_fmt(inst.value)}")
            else:
                lines.append(f"# TYPE {name} histogram")
                cum = 0
                for upper, c in zip(inst.uppers, inst.counts):
                    cum += c
                    lines.append(f'{name}_bucket{{le="{_fmt(upper)}"}} {cum}')
                lines.append(f'{name}_bucket{{le="+Inf"}} {inst.count}')
                lines.append(f"{name}_sum {_fmt(inst.sum)}")
                lines.append(f"{name}_count {inst.count}")
        return "\n".join(lines) + "\n"


def _fmt(v: float) -> str:
    return repr(int(v)) if float(v).is_integer() and abs(v) < 1e15 else repr(float(v))
