"""Serving-side pieces: token <-> bitstream packing (``bits``), and the slot
allocator and length buckets of ``kv_cache`` — the stream scheduler's
continuous batching takes its slots from :class:`SlotAllocator`.  The
serving engine and ``cache_bytes`` need the LM models (ROADMAP queue 1,
item 11)."""
from repro_torch.serve.bits import bits_to_tokens, tokens_to_bits
from repro_torch.serve.kv_cache import DEFAULT_BUCKETS, SlotAllocator, pick_bucket

__all__ = ["DEFAULT_BUCKETS", "SlotAllocator", "bits_to_tokens", "pick_bucket", "tokens_to_bits"]
