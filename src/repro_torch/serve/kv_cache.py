"""KV-cache bookkeeping for the serving engine (pure Python).

The cache *layouts* are owned by the models (``models/transformer.cache_specs``);
this module adds length buckets (compile-once per bucket on the reference;
here the fixed shapes a batched decode block keeps), batched slot
assignment for continuous batching, and ``cache_bytes``, the memory
accounting over a model's cache layout.
"""
from __future__ import annotations

import bisect
import dataclasses
from typing import Dict, List, Optional, Tuple

from repro_torch.models.common import spec_leaves

DEFAULT_BUCKETS = (1024, 4096, 16384, 32768, 131072, 524288)


def pick_bucket(prompt_len: int, max_new: int,
                buckets: Tuple[int, ...] = DEFAULT_BUCKETS) -> int:
    need = prompt_len + max_new
    i = bisect.bisect_left(buckets, need)
    if i == len(buckets):
        raise ValueError(f"request needs {need} tokens > max bucket {buckets[-1]}")
    return buckets[i]


def cache_bytes(model, B: int, S: int) -> int:
    """Total cache bytes for a (batch, bucket) — for admission control."""
    return sum(leaf.nbytes for leaf in spec_leaves(model.cache_specs(B, S)))


@dataclasses.dataclass
class SlotAllocator:
    """Continuous batching: fixed B decode slots, requests claim/release."""

    n_slots: int
    free: Optional[List[int]] = None
    active: Dict[int, str] = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        if self.free is None:
            self.free = list(range(self.n_slots))

    def claim(self, request_id: str) -> Optional[int]:
        if not self.free:
            return None
        slot = self.free.pop()
        self.active[slot] = request_id
        return slot

    def release(self, slot: int) -> None:
        self.active.pop(slot, None)
        self.free.append(slot)

    def utilization(self) -> float:
        return len(self.active) / self.n_slots
