"""Public wrappers around the kernels: the packed and tiled decode pipelines
and the streaming chunk ops.

  packed        viterbi_decode_packed: bm tables in, packed survivors, packed
                traceback kernel.
  fused+packed  viterbi_decode_fused_packed: raw received symbols in, branch
                metrics computed in the scan kernel (kernels/metrics.py),
                packed survivors, packed traceback — the short-block hot path.
  tiled         viterbi_decode_tiled_op / viterbi_decode_tiled_fused: a long
                block split into P time tiles that ride the lane axis of the
                windowed scan, seams resolved exactly by the min-plus algebra
                of kernels/minplus.py (or by a truncated warm-up).
  chunk ops     viterbi_forward_weighted_op with a carried ``pm0`` (the packed
                streaming step) and viterbi_forward_chunk_op (unpacked
                survivors from bm tables, the ``streaming`` backend's step).

Every function keeps the reference's user layout: inputs (B, T, F) or
(B, T, M), metrics (B, S), packed survivors (W, B, S), unpacked survivors
(C, B, S), bits (B, T).  Each decode derives every operand from its input
tensor's device, so all the kernels of one decode launch (CUDA) or all run
their plain versions (CPU) — see kernels/common.py.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.trellis import ConvCode
from repro_torch.kernels import minplus as _minplus
from repro_torch.kernels import survivors as _surv
from repro_torch.kernels import tiling as _tiling
from repro_torch.kernels import viterbi_scan as _vscan
from repro_torch.kernels.metrics import FusedMetricPlan

Weights = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def viterbi_forward_weighted_op(
    code: ConvCode,
    pm0: Optional[torch.Tensor],
    data_btf: torch.Tensor,
    weights: Weights,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Generic packed forward: any (b0, b1, rb) metric weights, optional
    carried pm0 (None -> state-0 init).  data_btf: (B, T, F) -> final_pm
    (B, S), packed (W, B, S).  The streaming subsystem calls this directly
    with its per-session weights."""
    b0, b1, rb = weights
    data = data_btf.to(torch.float32).contiguous()
    if pm0 is None:
        return _vscan.viterbi_scan_packed(code, data, b0, b1, rb)
    pm = pm0.to(torch.float32).contiguous()
    return _vscan.viterbi_scan_packed_carry(code, pm, data, b0, b1, rb)


def viterbi_forward_chunk_op(
    code: ConvCode, pm: torch.Tensor, bm_chunk: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked forward pass with carried path metrics and unpacked survivors
    — the ``streaming`` backend's step.  The caller owns the cross-chunk
    state (path metrics and a traceback ring, see stream/session.py).

    Args:
      pm: (B, S) float32 path metrics entering the chunk.
      bm_chunk: (B, C, M) branch-metric tables for the chunk.
    Returns:
      new_pm: (B, S) path metrics after the chunk.
      bps: (C, B, S) int32 backpointer parities (traceback layout).
    """
    return _vscan.viterbi_scan_carry(
        code, pm.to(torch.float32).contiguous(), bm_chunk.to(torch.float32).contiguous()
    )


def viterbi_forward_packed_op(
    code: ConvCode, bm_tables: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward pass with bit-packed survivors from precomputed bm tables.
    bm_tables: (B, T, M) -> final_pm (B, S), packed (ceil(T/32), B, S)."""
    return viterbi_forward_weighted_op(
        code, None, bm_tables, _vscan.table_weights(code, bm_tables.device)
    )


def viterbi_forward_fused_op(
    plan: FusedMetricPlan, received: torch.Tensor, t0: int = 0
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward pass with **in-kernel branch metrics** + packed survivors.
    received: (B, T, n_out) raw channel symbols (hard bits or soft values).
    Returns final_pm (B, S), packed (ceil(T/32), B, S)."""
    feats = plan.features(received, t0)
    return viterbi_forward_weighted_op(plan.code, None, feats, plan.folded(received.device))


def viterbi_traceback_op(
    code: ConvCode, packed: torch.Tensor, final_state: torch.Tensor, T: int
) -> torch.Tensor:
    """Traceback over packed survivors.  packed: (W, B, S) int32;
    final_state: (B,) -> bits (B, T) int32."""
    return _surv.traceback_packed(
        code, packed.contiguous(), final_state.to(torch.int32).contiguous(), T
    )


def _frontier(final_pm: torch.Tensor, terminated: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """Traceback start state + winning metric from (B, S) frontier metrics.
    An open trellis starts from the lowest-index argmin (torch.argmin returns
    the first minimal index, as jnp.argmin does)."""
    if terminated:
        final_state = torch.zeros(final_pm.shape[:1], dtype=torch.int32, device=final_pm.device)
        metric = final_pm[:, 0]
    else:
        final_state = torch.argmin(final_pm, dim=-1).to(torch.int32)
        metric = final_pm.min(dim=-1).values
    return final_state, metric


def viterbi_decode_packed(
    code: ConvCode, bm_tables: torch.Tensor, terminated: bool = True
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Packed decode from bm tables: (B, T, M) -> (bits (B, T), metric (B,))."""
    T = bm_tables.shape[1]
    final_pm, packed = viterbi_forward_packed_op(code, bm_tables)
    final_state, metric = _frontier(final_pm, terminated)
    return viterbi_traceback_op(code, packed, final_state, T), metric


def viterbi_decode_fused_packed(
    plan: FusedMetricPlan, received: torch.Tensor, terminated: bool = True
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The short-block hot path: raw received symbols in, branch metrics
    computed in the scan kernel, bit-packed survivors, packed traceback.
    received: (B, T, n_out) -> (bits (B, T), metric (B,))."""
    T = received.shape[1]
    final_pm, packed = viterbi_forward_fused_op(plan, received)
    final_state, metric = _frontier(final_pm, terminated)
    return viterbi_traceback_op(plan.code, packed, final_state, T), metric


# --------------------------------------------------------------------------- #
# Time-parallel tiled decode: P tiles of one long block ride the lane axis.   #
# --------------------------------------------------------------------------- #


def _tile_lane_row(per_tile: np.ndarray, B: int, S: int = 1, device="cpu") -> torch.Tensor:
    """Per-tile (P,) int vector -> per-lane (B*P*S,) int32 row in the
    canonical lane order (b outer, p middle, s inner)."""
    v = np.repeat(np.tile(np.asarray(per_tile, np.int32), B), S)
    return torch.from_numpy(v).to(device)


def _tile_data(data_btf: torch.Tensor, tp: _tiling.TilePlan) -> torch.Tensor:
    """(B, T, F) -> (B*P, span, F) float32: every tile's span gathered onto
    the lane axis, lanes (b, p)."""
    B, _, F = data_btf.shape
    idx = torch.from_numpy(tp.gather_index()).long().to(data_btf.device)  # (P, span)
    tiles = data_btf.to(torch.float32)[:, idx]  # (B, P, span, F)
    return tiles.reshape(B * tp.n_tiles, tp.span, F)


def _tiled_weighted_decode(
    code: ConvCode,
    data_btf: torch.Tensor,
    weights: Weights,
    n_tiles: int,
    overlap: Optional[int],
    terminated: bool,
    capture: Optional[dict] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Shared tiled-decode core (see viterbi_decode_tiled_op for the
    contract).  data_btf: (B, T, F) user layout + (b0, b1, rb) weights on
    its device.

    ``capture``: an optional dict that receives the operands of every kernel
    launch of a P > 1 decode — ``pass1`` (exact mode only), ``pass2`` and
    ``traceback`` hold each launch's argument tuple; ``maps`` (the pass-1
    transfer maps fed to the seam prefix) and ``packed`` (the pass-2 words)
    the intermediates between them — so a kernel can be timed alone on
    exactly what the decode gave it."""
    B, T, F = data_btf.shape
    S = code.n_states
    dev = data_btf.device
    # any overlap covering the truncation depth is promoted to the exact
    # two-pass seam resolution: strictly better and guaranteed bit-exact
    exact = overlap is None or int(overlap) >= _tiling.truncation_depth(code)
    tp = _tiling.plan_tiles(T, n_tiles, 0 if exact else int(overlap))
    P, V = tp.n_tiles, tp.span
    if P == 1:
        # degenerate tiling: the plain packed pipeline IS the exact decode
        final_pm, packed = viterbi_forward_weighted_op(code, None, data_btf, weights)
        final_state, metric = _frontier(final_pm, terminated)
        return viterbi_traceback_op(code, packed, final_state, T), metric

    b0, b1, rb = weights
    lo_np, hi_np = tp.windows()
    tiles = _tile_data(data_btf, tp)  # (B*P, V, F), lanes (b, p)
    eye = _minplus.identity_map(S, device=dev)  # row j: unit entry in state j

    if exact:
        # pass 1 — per-tile (S, S) transfer maps: the S unit-entry-state
        # problems of every tile also ride the lane axis (lanes (b, p, j)),
        # so the map build costs one span-deep launch, not S of them
        pass1 = (
            code, eye.repeat(B * P, 1), tiles.repeat_interleave(S, dim=0), b0, b1, rb,
            _tile_lane_row(lo_np, B, S, dev), _tile_lane_row(hi_np, B, S, dev),
        )
        fpm1 = _vscan.viterbi_scan_packed_window(*pass1)[0]  # survivors unused
        # map[p, b, i, j] = best metric entering tile p in state i, leaving j
        maps = fpm1.reshape(B, P, S, S).transpose(0, 1)
        if capture is not None:
            capture.update(pass1=pass1, maps=maps)
        del pass1  # frees the S-fold repeated operands before pass 2
        excl, total = _minplus.prefix_maps(maps)
        entry = _minplus.tile_entry_metrics(excl)  # (P, B, S): exact seam pms
        final_state, metric = _frontier(total[:, 0, :], terminated)
        pm0 = entry.transpose(0, 1).reshape(B * P, S)  # lanes (b, p)
    else:
        # truncated warm-up: tile 0 enters in state 0, later tiles enter
        # "cold" (uniform 0) and converge over the overlap steps
        is_first = (torch.arange(B * P, device=dev) % P == 0)[:, None]
        pm0 = torch.where(is_first, eye[0], 0.0)

    # forward over all tiles at once — survivors for V steps per tile
    pass2 = (
        code, pm0.contiguous(), tiles, b0, b1, rb,
        _tile_lane_row(lo_np, B, 1, dev), _tile_lane_row(hi_np, B, 1, dev),
    )
    fpm2, packed2 = _vscan.viterbi_scan_packed_window(*pass2)
    if not exact:
        # approximate frontier: the last tile's span covers the block end;
        # its metric is relative (warm-up re-zeroed the earlier history)
        final_state, metric = _frontier(fpm2.reshape(B, P, S)[:, -1], terminated)

    # traceback — every tile from EVERY candidate exit state in one launch
    # (lanes (b, p, s)); each lane also reports the state it entered on, so
    # seam states resolve by chaining exit -> entry from the final frontier:
    # exactly the walk the sequential traceback would have done, tie-breaks
    # included
    ov = tp.overlap
    lanes = B * P * S
    walk = (
        code, packed2.repeat_interleave(S, dim=1),
        _tile_lane_row(np.arange(S), B * P, 1, dev),
        torch.full((lanes,), ov, dtype=torch.int32, device=dev),
        _tile_lane_row(hi_np, B, S, dev),
    )
    bits_all, ent = _surv.traceback_packed_window(*walk)
    if capture is not None:
        capture.update(pass2=pass2, packed=packed2, traceback=walk)
    del walk  # frees the S-fold repeated words before the stitch
    bits_r = bits_all[:, :V].reshape(B, P, S, V)
    ent = ent.reshape(B, P, S)

    # stitch: walk the seam chain backwards, keep each tile's core bits
    rows = torch.arange(B, device=dev)
    state = final_state.long()  # (B,) exit state of the last tile
    pieces: List[torch.Tensor] = []
    for p in range(P - 1, -1, -1):
        pieces.append(bits_r[rows, p, state, ov:int(hi_np[p])])  # (B, tile_length(p))
        state = ent[rows, p, state].long()
    return torch.cat(pieces[::-1], dim=1), metric


def viterbi_decode_tiled_op(
    code: ConvCode,
    bm_tables: torch.Tensor,
    n_tiles: int,
    overlap: Optional[int] = None,
    terminated: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Time-parallel tiled decode: split T into ``n_tiles`` tiles that all
    run through the windowed packed scan in one launch, resolve the tile
    seams, and trace every tile back in parallel.

    ``overlap`` picks the seam regime (kernels/tiling.py): ``None`` or any
    value >= the truncation depth 5·K -> **exact** two-pass mode — per-tile
    (S, S) transfer maps composed with the min-plus algebra of
    kernels/minplus.py seed each tile's re-scan with the exact full-length
    forward metrics, so survivors, bits and metric equal the un-tiled decode
    wherever the metric sums are exact.  ``0 <= overlap < 5·K`` ->
    single-pass truncated warm-up: each tile re-converges from a cold metric
    vector over ``overlap`` extra steps — approximate.

    bm_tables: (B, T, M) -> (bits (B, T), metric (B,)).
    """
    return _tiled_weighted_decode(
        code, bm_tables, _vscan.table_weights(code, bm_tables.device), n_tiles, overlap,
        terminated,
    )


def viterbi_decode_tiled_fused(
    plan: FusedMetricPlan,
    received: torch.Tensor,
    n_tiles: int,
    overlap: Optional[int] = None,
    terminated: bool = True,
    capture: Optional[dict] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`viterbi_decode_tiled_op` fed raw received symbols — branch
    metrics are computed in the scan kernel per tile (kernels/metrics.py), so
    the (B, T, M) table never exists.  received: (B, T, n_out).  ``capture``
    collects each kernel launch's operands (see _tiled_weighted_decode)."""
    feats = plan.features(received, 0)
    return _tiled_weighted_decode(
        plan.code, feats, plan.folded(received.device), n_tiles, overlap, terminated, capture
    )
