"""Serving-side bookkeeping.  Only the slot allocator and the length buckets
of ``kv_cache`` are ported so far: the stream scheduler's continuous batching
takes its slots from :class:`SlotAllocator`.  The serving engine and
``cache_bytes`` need the LM models (ROADMAP queue 1, item 11)."""
from repro_torch.serve.kv_cache import DEFAULT_BUCKETS, SlotAllocator, pick_bucket

__all__ = ["DEFAULT_BUCKETS", "SlotAllocator", "pick_bucket"]
