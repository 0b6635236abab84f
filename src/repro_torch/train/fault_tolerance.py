"""Fault-tolerance utilities: straggler detection.

Per-step time is the cheapest health signal a loop has: a straggling host or
a slow scheduler tick shows up as a step-time outlier long before anything
fails.  The detector keeps an EMA of step time and variance and flags
z-score outliers.  ``elastic_mesh`` (rebuilding a device mesh over the
surviving devices) waits for the multi-device work (ROADMAP queue 1, item 9b).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, List, Optional


@dataclasses.dataclass
class StragglerDetector:
    zscore: float = 4.0
    decay: float = 0.95
    warmup_steps: int = 5
    mean: float = 0.0
    var: float = 0.0
    n: int = 0
    events: List[dict] = dataclasses.field(default_factory=list)
    on_straggler: Optional[Callable[[int, float], None]] = None

    def observe(self, step: int, dt: float) -> bool:
        """Returns True if this step is a straggler outlier."""
        self.n += 1
        if self.n <= self.warmup_steps:
            # prime the EMA; never flag during warmup (includes the first
            # kernel build)
            w = 1.0 / self.n
            self.mean = (1 - w) * self.mean + w * dt
            self.var = (1 - w) * self.var + w * (dt - self.mean) ** 2
            return False
        std = math.sqrt(max(self.var, 1e-12))
        z = (dt - self.mean) / max(std, 0.05 * max(self.mean, 1e-9))
        is_straggler = z > self.zscore
        if is_straggler:
            self.events.append({"step": step, "time_s": dt, "z": z})
            if self.on_straggler is not None:
                self.on_straggler(step, z)
        else:  # only fold healthy steps into the baseline
            self.mean = self.decay * self.mean + (1 - self.decay) * dt
            self.var = self.decay * self.var + (1 - self.decay) * (dt - self.mean) ** 2
        return is_straggler
