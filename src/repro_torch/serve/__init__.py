"""Serving-side pieces: the batched LM serving engine (``engine``),
token <-> bitstream packing (``bits``), and the KV-cache bookkeeping of
``kv_cache`` (length buckets, ``cache_bytes``, and the slot allocator the
stream scheduler's continuous batching takes its slots from)."""
from repro_torch.serve.bits import bits_to_tokens, tokens_to_bits
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.kv_cache import DEFAULT_BUCKETS, SlotAllocator, cache_bytes, pick_bucket

__all__ = ["DEFAULT_BUCKETS", "ServeEngine", "SlotAllocator", "bits_to_tokens", "cache_bytes",
           "pick_bucket", "tokens_to_bits"]
