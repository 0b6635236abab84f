"""Serving-side slot and bucket bookkeeping (pure Python).

Length buckets (compile-once per bucket on the reference; here the fixed
shapes a batched decode block keeps) and batched slot assignment for
continuous batching.  ``cache_bytes``, the memory accounting over a model's
cache layout, waits for the LM models (ROADMAP queue 1, item 11).
"""
from __future__ import annotations

import bisect
import dataclasses
from typing import Dict, List, Optional, Tuple

DEFAULT_BUCKETS = (1024, 4096, 16384, 32768, 131072, 524288)


def pick_bucket(prompt_len: int, max_new: int,
                buckets: Tuple[int, ...] = DEFAULT_BUCKETS) -> int:
    need = prompt_len + max_new
    i = bisect.bisect_left(buckets, need)
    if i == len(buckets):
        raise ValueError(f"request needs {need} tokens > max bucket {buckets[-1]}")
    return buckets[i]


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
