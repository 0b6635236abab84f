"""Streaming Viterbi subsystem: online decode for unbounded bitstreams.

window.py     — truncated-traceback sliding-window core (stream_step on the
                carried scan kernels, flush, windowed block decode)
session.py    — stateful per-stream sessions, O(depth + chunk) memory
scheduler.py  — continuous batching of many streams into one batched kernel
                call a tick, chunk-fed with per-stream backpressure
ingest.py     — ChunkProducer adapters (generator / callable / push-fed) and
                the StreamBusy backpressure signal
resilience.py — crash-consistent snapshot/restore (drain/migrate primitive)
                + the StreamError / TickFault degradation types
chaos.py      — deterministic seeded fault injection harness

The scheduler and sessions take a device mesh (``mesh=``): slots are cut
into per-shard blocks on the ``data`` axis (``state_shardings``,
``shard_stream_state``, ``make_sharded_stream_step``).
"""
from repro_torch.stream.chaos import (
    FAULT_CLASSES,
    ChaosClock,
    ChaosPolicy,
    ChaosProducer,
    ChaosProducerError,
    FaultInjector,
    InjectedDeviceFault,
    install_tick_faults,
)
from repro_torch.stream.ingest import (
    CallableProducer,
    ChunkProducer,
    GeneratorProducer,
    PushProducer,
    RateLimitedProducer,
    StreamBusy,
    as_producer,
)
from repro_torch.stream.resilience import (
    SNAPSHOT_VERSION,
    StreamError,
    StreamSnapshot,
    TickFault,
)
from repro_torch.stream.scheduler import SchedulerStats, StreamScheduler
from repro_torch.stream.session import StreamSession
from repro_torch.stream.window import (
    StreamState,
    chunk_forward_scan,
    default_depth,
    init_stream_state,
    make_sharded_stream_step,
    packed_depth,
    shard_stream_state,
    state_shardings,
    stream_flush,
    stream_step,
    viterbi_decode_windowed,
)

__all__ = [
    "StreamState",
    "StreamSession",
    "StreamScheduler",
    "SchedulerStats",
    "StreamBusy",
    "StreamError",
    "StreamSnapshot",
    "SNAPSHOT_VERSION",
    "TickFault",
    "FAULT_CLASSES",
    "ChaosClock",
    "ChaosPolicy",
    "ChaosProducer",
    "ChaosProducerError",
    "FaultInjector",
    "InjectedDeviceFault",
    "install_tick_faults",
    "ChunkProducer",
    "GeneratorProducer",
    "CallableProducer",
    "PushProducer",
    "RateLimitedProducer",
    "as_producer",
    "chunk_forward_scan",
    "default_depth",
    "init_stream_state",
    "make_sharded_stream_step",
    "packed_depth",
    "shard_stream_state",
    "state_shardings",
    "stream_flush",
    "stream_step",
    "viterbi_decode_windowed",
]
