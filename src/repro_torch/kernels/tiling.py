"""Time-tiling plans for the tiled (time-parallel) decode route.

A long block's T trellis steps split into P tiles that all run through the
windowed packed scan *in one launch*: the tiles are folded into the lane
(batch) axis, so the launch's time loop shrinks from T to ``span`` ≈ T/P
steps and the critical path with it.  Every tile gets a uniform ``span`` of
rows so the launch stays rectangular; where a tile's real coverage is shorter
(the warm-up of tile 0 reaches before step 0, the last tile's core runs past
T, T % P != 0, T % 32 != 0) the per-lane validity windows of
kernels/viterbi_scan.py and kernels/survivors.py pass the extra steps through
untouched.

Two seam-resolution regimes, selected by ``overlap``:

  exact (overlap == 0)      tiles abut; seams are resolved exactly by the
                            min-plus state-map composition of
                            kernels/minplus.py (two passes, see
                            ops.viterbi_decode_tiled_op).
  truncated (0 < overlap)   each tile is re-warmed from a uniform-zero
                            metric vector over ``overlap`` extra leading
                            steps; one pass, approximate when overlap < the
                            truncation depth 5·K.

``ops.viterbi_decode_tiled_op`` promotes any requested overlap >= the
truncation depth to the exact regime.  Plain numpy: plans are built on the
host, never on the card.
"""
from __future__ import annotations

import dataclasses

import numpy as np

#: The textbook truncated-traceback depth multiplier (D = 5·K) — the one
#: definition; stream/window.default_depth reads it through truncation_depth.
DEPTH_MULTIPLIER = 5

#: A tile shorter than this wastes more launch overhead than it saves;
#: default_tiles will not split below it.
MIN_TILE_CORE = 128


def truncation_depth(code) -> int:
    """Survivor-merge depth after which truncation is conventionally safe."""
    return DEPTH_MULTIPLIER * code.constraint


@dataclasses.dataclass(frozen=True)
class TilePlan:
    """How one length-T sequence folds into a rectangular tile launch.

    Attributes:
      steps: T, the real trellis length.
      n_tiles: effective tile count (<= the requested count when T is short).
      core: steps each tile owns; tile p's core is [p*core, (p+1)*core) ∩ [0, T).
      overlap: warm-up steps prepended to each core (0 = exact seams).
      span: overlap + core — the uniform per-launch step count.
    """

    steps: int
    n_tiles: int
    core: int
    overlap: int
    span: int

    @property
    def exact(self) -> bool:
        return self.overlap == 0

    def tile_length(self, p: int) -> int:
        """Real (core) steps owned by tile p — the last tile may be ragged."""
        return min(self.steps - p * self.core, self.core)

    def windows(self):
        """Per-tile validity windows within the span: (lo, hi) int32 (P,)
        arrays.  Row r of tile p's span is global step
        ``p*core - overlap + r``; rows outside [0, T) are invalid."""
        p = np.arange(self.n_tiles)
        g0 = p * self.core - self.overlap  # global step of span row 0
        lo = np.maximum(0, -g0)
        hi = np.minimum(self.span, self.steps - g0)
        return lo.astype(np.int32), hi.astype(np.int32)

    def gather_index(self) -> np.ndarray:
        """(P, span) global step index feeding each span row, clipped to
        [0, T) — clipped rows are invalid per ``windows`` and pass through."""
        p = np.arange(self.n_tiles)[:, None]
        idx = p * self.core - self.overlap + np.arange(self.span)[None, :]
        return np.clip(idx, 0, self.steps - 1).astype(np.int32)


def plan_tiles(T: int, n_tiles: int, overlap: int = 0) -> TilePlan:
    """Normalize a requested tiling to a valid TilePlan.

    The core length is ceil(T / n_tiles); the effective tile count then
    shrinks to ceil(T / core), which absorbs every awkward request (more
    tiles than steps, T % P != 0, overlap longer than the sequence).
    """
    if T < 1:
        raise ValueError(f"need at least one trellis step, got T={T}")
    n_tiles = max(1, min(int(n_tiles), T))
    core = -(-T // n_tiles)
    n_eff = -(-T // core)
    overlap = max(0, min(int(overlap), T))
    return TilePlan(
        steps=T, n_tiles=n_eff, core=core, overlap=overlap, span=core + overlap
    )


def default_tiles(B: int, T: int, S: int, lane_budget: int = 512) -> int:
    """Default tile count for a (B, T, S) problem: the largest power of two
    that keeps every tile at least MIN_TILE_CORE steps and the widest folded
    launch (B·P·S lanes) within ``lane_budget`` lanes."""
    P = 1
    while P * 2 <= T // MIN_TILE_CORE and B * (P * 2) * S <= lane_budget:
        P *= 2
    return P
