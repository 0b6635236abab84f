"""Streaming Viterbi subsystem: online decode for unbounded bitstreams.

window.py   — truncated-traceback sliding-window core (stream_step on the
              carried scan kernels, flush, windowed block decode)
session.py  — stateful per-stream sessions, O(depth + chunk) memory

The reference's scheduler, ingestion, resilience and chaos layers are a
later slice (ROADMAP.md queue 1, item 5); only what is ported is exported.
"""
from repro_torch.stream.session import StreamSession
from repro_torch.stream.window import (
    DeviceCounters,
    StreamState,
    chunk_forward_scan,
    default_depth,
    init_device_counters,
    init_stream_state,
    packed_depth,
    stream_flush,
    stream_step,
    survivor_merge_depth,
    viterbi_decode_windowed,
)

__all__ = [
    "DeviceCounters",
    "StreamSession",
    "StreamState",
    "chunk_forward_scan",
    "default_depth",
    "init_device_counters",
    "init_stream_state",
    "packed_depth",
    "stream_flush",
    "stream_step",
    "survivor_merge_depth",
    "viterbi_decode_windowed",
]
