"""Tick-phase tracing: nested wall-clock spans, Perfetto + JSONL export.

A Tracer records *complete* spans (begin timestamp + duration, Chrome trace
``"ph": "X"``) around the phases of a scheduler tick — admission, gather,
forward+traceback, compaction, flush — so "where does a tick spend its
time" is a picture, not a guess.  Design constraints, in order:

  * off by default: every instrumented call site goes through
    :func:`span`, which returns a shared no-op context manager when the
    tracer is ``None`` — the disabled cost is one ``is None`` check;
  * cheap when on: a span is two ``perf_counter_ns`` calls and one tuple
    append (no dict building, no formatting) — well under the <2% budget
    against a millisecond-scale stream step;
  * standard consumers: ``write_chrome`` emits a ``trace.json`` loadable by
    Perfetto / ``chrome://tracing``; ``write_jsonl`` emits one structured
    event per line for ad-hoc processing.

Spans nest by time containment on one track, which is exactly how Perfetto
renders "X" events — a ``tick`` parent with phase children needs no
explicit parent ids.
"""
from __future__ import annotations

import json
import threading
import time
from typing import Dict, List, Optional, Tuple


class _Span:
    """Context manager for one live span (allocated only when tracing)."""

    __slots__ = ("tracer", "name", "t0")

    def __init__(self, tracer: "Tracer", name: str):
        self.tracer = tracer
        self.name = name

    def __enter__(self) -> "_Span":
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        self.tracer._events.append(
            (self.name, self.t0, time.perf_counter_ns() - self.t0)
        )


class _NullSpan:
    """The disabled path: one shared instance, no state, no clock reads."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> None:
        pass


_NULL_SPAN = _NullSpan()


def span(tracer: Optional["Tracer"], name: str):
    """``with span(tracer, "gather"): ...`` — a real span when ``tracer`` is
    live, the shared no-op otherwise.  The ONE call-site idiom for optional
    tracing (hot paths never branch on telemetry themselves)."""
    return _NULL_SPAN if tracer is None else _Span(tracer, name)


class Tracer:
    """Span recorder for one instrumented component.

    Events live in memory as (name, t0_ns, dur_ns) tuples until exported;
    a steady server should export + ``clear()`` periodically (a span is 3
    machine words — ~1M spans per 100 MB)."""

    def __init__(self, process_name: str = "repro_torch") -> None:
        self.process_name = process_name
        self._events: List[Tuple[str, int, int]] = []
        self._t_origin = time.perf_counter_ns()

    # ------------------------------ recording ------------------------------ #

    def span(self, name: str) -> _Span:
        return _Span(self, name)

    def instant(self, name: str) -> None:
        """Zero-duration marker (admissions, evictions, compactions)."""
        self._events.append((name, time.perf_counter_ns(), 0))

    def clear(self) -> None:
        self._events.clear()

    # ------------------------------ queries ------------------------------ #

    def __len__(self) -> int:
        return len(self._events)

    def durations_s(self, name: str) -> List[float]:
        """Seconds spent in every completed span called ``name``."""
        return [d * 1e-9 for n, _, d in self._events if n == name]

    def total_s(self, name: str) -> float:
        return sum(self.durations_s(name))

    def coverage(self, parent: str, children: Tuple[str, ...]) -> float:
        """Fraction of ``parent`` span time covered by ``children`` spans —
        the "do the phase spans account for the tick" acceptance number."""
        total = self.total_s(parent)
        if total == 0.0:
            return 0.0
        return sum(self.total_s(c) for c in children) / total

    # ------------------------------ export ------------------------------ #

    def chrome_events(self) -> List[Dict]:
        """Chrome trace event list (``ph: "X"`` complete events, µs units)."""
        tid = threading.get_ident() % 2 ** 31
        events: List[Dict] = [
            {
                "ph": "M",
                "name": "process_name",
                "pid": 1,
                "tid": tid,
                "args": {"name": self.process_name},
            }
        ]
        for name, t0, dur in self._events:
            events.append(
                {
                    "ph": "X",
                    "name": name,
                    "pid": 1,
                    "tid": tid,
                    "ts": (t0 - self._t_origin) / 1e3,
                    "dur": dur / 1e3,
                }
            )
        return events

    def write_chrome(self, path) -> None:
        """Perfetto / chrome://tracing loadable ``trace.json``."""
        payload = {
            "traceEvents": self.chrome_events(),
            "displayTimeUnit": "ms",
        }
        with open(path, "w") as f:
            json.dump(payload, f)

    def write_jsonl(self, path) -> None:
        """One structured event per line: {"name", "t_s", "dur_s"}."""
        with open(path, "w") as f:
            for name, t0, dur in self._events:
                f.write(
                    json.dumps(
                        {
                            "name": name,
                            "t_s": (t0 - self._t_origin) * 1e-9,
                            "dur_s": dur * 1e-9,
                        }
                    )
                    + "\n"
                )
