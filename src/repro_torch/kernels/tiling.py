"""Default tile count for the tiled (time-parallel) decode route.

Only what the planner's ``long-conv-tiled`` rule reads is here; the tile
plans themselves come with the tiled backend.
"""
from __future__ import annotations

#: A tile shorter than this wastes more launch overhead than it saves;
#: default_tiles will not split below it.
MIN_TILE_CORE = 128


def default_tiles(B: int, T: int, S: int, lane_budget: int = 512) -> int:
    """Default tile count for a (B, T, S) problem: the largest power of two
    that keeps every tile at least MIN_TILE_CORE steps and the widest folded
    launch (B·P·S lanes) within ``lane_budget`` lanes."""
    P = 1
    while P * 2 <= T // MIN_TILE_CORE and B * (P * 2) * S <= lane_budget:
        P *= 2
    return P
