"""Telemetry plane for the streaming decode system (a pure-Python copy of
the reference's ``repro.obs``).

metrics.py — counters / gauges / fixed-bucket histograms, one registry with
             ``snapshot()`` and Prometheus text exposition; the shared
             ``percentile`` helper every latency summary must use.
trace.py   — tick-phase spans (admission / gather / step / commit / flush),
             exported as Perfetto ``trace.json`` + JSONL; one ``is None``
             check when disabled.
log.py     — structured key=value stdlib-logging wrapper for scripts.

:class:`Telemetry` bundles the per-component knobs: a metrics registry
(always on — a counter bump is an attribute add), an optional tracer (off
by default), and the ``device_counters`` flag that makes every stream step
accumulate per-stream decode statistics (survivor merge depth, starved
ticks, renormalization magnitude) into a device-resident buffer that is
flushed only at drain / report time — never one host sync per tick.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.obs.log import ObsLogger, get_logger, kv
from repro_torch.obs.metrics import (
    DEPTH_BUCKETS,
    LATENCY_BUCKETS_S,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    percentile,
)
from repro_torch.obs.trace import Tracer, span


@dataclasses.dataclass
class Telemetry:
    """Per-component telemetry configuration + state.

    metrics:          registry the component records into (always live).
    tracer:           span recorder; ``None`` (default) disables tracing.
    device_counters:  collect per-stream decode counters on the device in
                      every stream step (merge depth, starved ticks, renorm
                      magnitude).
                      Changes what every step returns, so it is a construction-time
                      flag, not a runtime toggle.
    """

    metrics: MetricsRegistry = dataclasses.field(default_factory=MetricsRegistry)
    tracer: Optional[Tracer] = None
    device_counters: bool = False

    @classmethod
    def enabled(cls, device_counters: bool = True,
                process_name: str = "repro_torch") -> "Telemetry":
        """Everything on: tracing + metrics + device-side counters."""
        return cls(
            metrics=MetricsRegistry(),
            tracer=Tracer(process_name),
            device_counters=device_counters,
        )


__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "ObsLogger",
    "Telemetry",
    "Tracer",
    "DEPTH_BUCKETS",
    "LATENCY_BUCKETS_S",
    "get_logger",
    "kv",
    "percentile",
    "span",
]
