"""Fault-tolerance utilities: straggler detection and elastic mesh rebuild.

Per-step time is the cheapest health signal a loop has: a straggling host or
a slow scheduler tick shows up as a step-time outlier long before anything
fails.  The detector keeps an EMA of step time and variance and flags
z-score outliers; the mitigation is to snapshot and restart onto the
surviving devices (``elastic_mesh``).
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


def elastic_mesh(prefer_shape, axes, devices=None):
    """Build the largest mesh of the preferred shape that the surviving
    device set supports, halving the *leading* (data-parallel) axis first —
    a snapshot restored onto the result resumes with reduced throughput
    instead of failing.  ``devices``: the survivors (repeats allowed), else
    the visible cards; an empty set raises ``ValueError``.  Returns a
    ``repro_torch.parallel.Mesh``."""
    import numpy as np

    from repro_torch.launch.mesh import visible_cards
    from repro_torch.parallel.mesh import Mesh

    devices = list(devices if devices is not None else visible_cards())
    if not devices:
        raise ValueError("elastic_mesh: no devices to build a mesh on")
    shape = list(prefer_shape)
    while shape[0] > 1 and math.prod(shape) > len(devices):
        shape[0] //= 2
    if math.prod(shape) > len(devices):
        # drop axes entirely until it fits (last resort: single device)
        shape = [1] * len(prefer_shape)
    cells = np.empty(math.prod(shape), dtype=object)
    cells[:] = devices[:cells.size]
    return Mesh(cells.reshape(shape), tuple(axes))
