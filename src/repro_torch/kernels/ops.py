"""Public wrappers around the kernels: the decode pipelines, the paper's
one-step instruction, the streaming chunk ops and the SISO op.

  texpand       texpand_op: ONE fused ACS step (the paper's Texpand).
  classic       viterbi_decode_fused: bm tables in, unpacked (T, B, S) int32
                survivors out of the scan kernel, the plain torch traceback
                of core/viterbi.py (as the reference's XLA scan).
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
  parallel      viterbi_decode_parallel_op: the block-parallel decode — chunk
                transfer matrices from the windowed scan, a log-depth
                associative scan over chunks with the (min,+) product kernel,
                a carried re-scan of every chunk, the packed traceback.
  SISO          bcjr_llr_op: max-log-MAP BCJR of one RSC block, the alpha
                scan then the fused beta/LLR scan (kernels/bcjr.py).
  (min,+)       minplus_matmul_op: the reference op's clamped product
                over any batch shape.

Every function keeps the reference's user layout: inputs (B, T, F) or
(B, T, M), metrics (B, S), packed survivors (W, B, S), unpacked survivors
(T, B, S), bits (B, T), LLRs (B, T).  Each decode derives every operand from its input
tensor's device, so all the kernels of one decode launch (CUDA) or all run
their plain versions (CPU) — see kernels/common.py.
"""
from __future__ import annotations

import math
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.trellis import NEG_UNREACHABLE, ConvCode
from repro_torch.core.viterbi import _associative_scan, _traceback
from repro_torch.kernels import bcjr as _bcjr
from repro_torch.kernels import minplus as _minplus
from repro_torch.kernels import survivors as _surv
from repro_torch.kernels import texpand as _texpand
from repro_torch.kernels import tiling as _tiling
from repro_torch.kernels import viterbi_scan as _vscan
from repro_torch.kernels.metrics import FusedMetricPlan

Weights = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def texpand_op(
    code: ConvCode, pm: torch.Tensor, bm_table: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The paper's instruction: one fused ACS step in user layout.
    pm: (B, S); bm_table: (B, M) -> new_pm (B, S) float32, bp (B, S) int32."""
    return _texpand.texpand(
        code, pm.to(torch.float32).contiguous(), bm_table.to(torch.float32).contiguous()
    )


def viterbi_forward_op(
    code: ConvCode, bm_tables: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full forward pass with unpacked survivors.  bm_tables: (B, T, M) ->
    final_pm (B, S) and backpointers (T, B, S) int32 (traceback layout)."""
    return _vscan.viterbi_scan(code, bm_tables.to(torch.float32).contiguous())


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
        code, None, bm_tables, _vscan.cached_table_weights(code, bm_tables.device)
    )


def plan_weights(plan: FusedMetricPlan, device) -> Weights:
    """A metric plan's folded weights on ``device``, uploaded once per
    (values, device) with their row operands (viterbi_scan.device_weights):
    a second decode of the same spec builds and copies nothing."""
    return _vscan.device_weights(*plan.folded_arrays(), device)


def viterbi_forward_fused_op(
    plan: FusedMetricPlan, received: torch.Tensor, t0: int = 0
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward pass with **in-kernel branch metrics** + packed survivors.
    received: (B, T, n_out) raw channel symbols (hard bits or soft values).
    Returns final_pm (B, S), packed (ceil(T/32), B, S)."""
    feats = plan.features(received, t0)
    return viterbi_forward_weighted_op(plan.code, None, feats, plan_weights(plan, received.device))


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


def viterbi_decode_fused(
    code: ConvCode, bm_tables: torch.Tensor, terminated: bool = True
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scan kernel with unpacked survivors + the plain traceback of
    core/viterbi.py.  bm_tables: (B, T, M) -> (bits (B, T), metric (B,))."""
    final_pm, bps = viterbi_forward_op(code, bm_tables)
    final_state, metric = _frontier(final_pm, terminated)
    bits, _ = _traceback(code, bps, final_state)
    return bits, metric


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
    # per_tile is a host array of the tile plan: no device read
    v = np.repeat(np.tile(np.asarray(per_tile, np.int32), B), S)  # repr-lint: allow[RPR003]
    return torch.from_numpy(v).to(device)


def _tile_data(data_btf: torch.Tensor, tp: _tiling.TilePlan) -> torch.Tensor:
    """(B, T, F) -> (B*P, span, F) float32: every tile's span gathered onto
    the lane axis, lanes (b, p)."""
    B, _, F = data_btf.shape
    idx = torch.from_numpy(tp.gather_index()).to(data_btf.device).long()  # (P, span)
    tiles = data_btf.to(torch.float32)[:, idx]  # (B, P, span, F)
    return tiles.reshape(B * tp.n_tiles, tp.span, F)


def _window_steps(lo: np.ndarray, hi: np.ndarray, lanes_each: int) -> int:
    """Lane-steps inside per-tile (or per-chunk) host windows ``[lo, hi)``,
    each window shared by ``lanes_each`` lanes: the work a windowed kernel
    launch does, which its cost records."""
    # host arrays of the tile or chunk plan: no device read
    return lanes_each * int(np.maximum(hi - lo, 0).sum())  # repr-lint: allow[RPR003]


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
        fpm1 = _vscan.viterbi_scan_packed_window(
            *pass1, steps=_window_steps(lo_np, hi_np, B * S))[0]  # survivors unused
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
    fpm2, packed2 = _vscan.viterbi_scan_packed_window(
        *pass2, steps=_window_steps(lo_np, hi_np, B))
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
    bits_all, ent = _surv.traceback_packed_window(
        *walk, steps=_window_steps(np.full_like(hi_np, ov), hi_np, B * S))
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
        code, bm_tables, _vscan.cached_table_weights(code, bm_tables.device), n_tiles, overlap,
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
        plan.code, feats, plan_weights(plan, received.device), n_tiles, overlap, terminated,
        capture
    )


def bcjr_llr_op(
    code,
    llr_coded: torch.Tensor,
    llr_apriori: Optional[torch.Tensor] = None,
    terminated: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Max-log-MAP SISO decode of one RSC code block (kernels/bcjr.py): the
    forward (alpha) scan, then the time-reversed scan that fuses the beta
    recursion with the per-step LLR.  Both kernels run on the device of
    ``llr_coded``.

    Args:
      code: an RSC code (duck-typed — kernels/ never imports siso/).
      llr_coded: (B, T, n_out) per-coded-bit channel LLRs, convention
        ``lambda = log P(0)/P(1)`` (punctured positions = 0).
      llr_apriori: (B, T) a-priori LLRs on the info bits (None -> zeros).
      terminated: trellis flushed to state 0 (beta seeded there) vs open.
    Returns:
      llr: (B, T) float32 a-posteriori LLRs (negative -> decide bit 1).
      metric: (B,) float32 best-path terminal cost.
    """
    B, T, _ = llr_coded.shape
    coded = llr_coded.to(torch.float32)
    if llr_apriori is None:
        llr_apriori = torch.zeros((B, T), dtype=torch.float32, device=coded.device)
    feat = torch.cat([coded, llr_apriori.to(torch.float32)[..., None]], dim=-1)
    feat = feat.permute(1, 2, 0).contiguous()  # (T, F, B): lanes fastest
    alphas, final_pm = _bcjr.bcjr_alpha_scan(code, feat)
    llr = _bcjr.bcjr_beta_llr_scan(code, alphas, feat, terminated)
    metric = final_pm[0] if terminated else final_pm.min(dim=0).values
    return llr.T.contiguous(), metric


# --------------------------------------------------------------------------- #
# Block-parallel decode: (min,+) associative scan over chunk transfer maps.   #
# --------------------------------------------------------------------------- #


def minplus_matmul_op(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched (min,+) product as the reference op computes it: any batch
    shape, the kernel's accumulator from 1e30, then ``min(out, 1e30)``.  The
    reference pads to its blocks with 1e30, which can only add candidates of
    at least 2e30 that the clamp removes, so no padding is needed here.
    a: (..., I, K), b: (..., K, J) -> (..., I, J) float32."""
    batch = a.shape[:-2]
    I, K = a.shape[-2:]
    J = b.shape[-1]
    a3 = a.to(torch.float32).reshape((-1, I, K)).contiguous()
    b3 = b.to(torch.float32).reshape((-1, K, J)).contiguous()
    out = _minplus.minplus_matmul(a3, b3, NEG_UNREACHABLE)
    return torch.clamp(out, max=NEG_UNREACHABLE).reshape(batch + (I, J))


def _minplus_unclamped(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The associative scan's combine: the product kernel from +inf, as the
    reference's jnp ``minplus_matmul`` (no clamp)."""
    return _minplus.minplus_matmul(a, b, math.inf)


def chunk_transfer_maps(
    code: ConvCode, chunks: torch.Tensor, hi: np.ndarray, capture: Optional[dict] = None,
) -> torch.Tensor:
    """Each chunk's (S, S) transfer matrix through the windowed packed scan:
    ``[b, c, i, s]`` is the best metric of a path that enters chunk c in
    state i and leaves it in state s.  The S unit entry states ride the lane
    axis with the chunks (lanes (b, c, i)); outside [0, hi[c]) a lane's
    metrics pass through untouched, which is the reference's masked matrix
    of a short last chunk.

    chunks: (B*nc, C, M) float32 contiguous, lanes (b, c); hi: (nc,) host
    ints, the valid steps of each chunk.  Returns (B, nc, S, S).  Chunks
    that are all whole (hi == C) fill their windows' upper ends on the
    device; otherwise the per-lane row is uploaded (one host sync).
    ``capture`` receives ``pass1`` (the scan's arguments) and ``mats``."""
    S = code.n_states
    dev = chunks.device
    n_lanes, C = chunks.shape[:2]
    B = n_lanes // len(hi)
    lanes = n_lanes * S
    if np.all(hi == C):
        upper = torch.full((lanes,), C, dtype=torch.int32, device=dev)
    else:
        upper = _tile_lane_row(hi, B, S, dev)
    b0, b1, rb = _vscan.cached_table_weights(code, dev)
    pass1 = (
        code, _minplus.identity_map(S, device=dev).repeat(n_lanes, 1),
        chunks.repeat_interleave(S, dim=0), b0, b1, rb,
        torch.zeros((lanes,), dtype=torch.int32, device=dev), upper,
    )
    mats = _vscan.viterbi_scan_packed_window(
        *pass1, steps=_window_steps(np.zeros_like(hi), hi, B * S))[0].reshape(B, len(hi), S, S)
    if capture is not None:
        capture.update(pass1=pass1, mats=mats)
    return mats


def rescan_chunks(
    code: ConvCode, entry: torch.Tensor, chunks: torch.Tensor, whole_words: bool
) -> Tuple[tuple, torch.Tensor]:
    """Re-scan chunks from the metrics entering them, for their survivors.

    entry: (L, S) float32; chunks: (L, C, M) float32 contiguous.  Returns
    (the scan's arguments, the survivors): whole packed words (C/32, L, S)
    through the packed carried scan (#3) when ``whole_words`` (C a multiple
    of 32), else selects (C, L, S) through the unpacked carried scan (#7)."""
    entry = entry.contiguous()
    if whole_words:
        args = (code, entry, chunks, *_vscan.cached_table_weights(code, chunks.device))
        return args, _vscan.viterbi_scan_packed_carry(*args)[1]
    args = (code, entry, chunks)
    return args, _vscan.viterbi_scan_carry(*args)[1]


def walk_survivors(
    code: ConvCode, survivors: torch.Tensor, packed: bool, frontier_pm: torch.Tensor,
    terminated: bool, T: int, capture: Optional[dict] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The last step of a chunked decode: the survivors ((T, B, S) selects,
    or (ceil(T/32), B, S) words when ``packed``) walked by the packed
    traceback from the frontier of the (B, S) metrics ``frontier_pm``.
    Returns (bits (B, T), metric (B,)); ``capture`` receives ``walk`` (the
    traceback's arguments)."""
    final_state, metric = _frontier(frontier_pm, terminated)
    walk = (code, survivors if packed else _surv.pack_survivors(survivors), final_state, T)
    if capture is not None:
        capture["walk"] = walk
    return viterbi_traceback_op(*walk), metric


def viterbi_decode_parallel_op(
    code: ConvCode,
    bm_tables: torch.Tensor,
    chunk: int = 64,
    terminated: bool = True,
    capture: Optional[dict] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """core.viterbi.viterbi_decode_parallel through the kernels, equal to it
    bit for bit (bits and metrics, soft included):

    1. transfer matrices: the windowed packed scan over B·nc·S lanes (lanes
       (b, c, i) run chunk c from a unit metric in state i), the last chunk
       windowed to its valid steps — tiled pass 1's construction;
    2. prefixes: the reference's associative-scan tree over the chunk axis
       with the (min,+) product kernel from +inf (unclamped, as jnp's);
    3. backpointers: the carried unpacked scan over B·nc lanes, each chunk
       seeded with row 0 of its exclusive prefix (the metrics entering it
       from state 0);
    4. the selects packed 32 to a word and walked by the packed traceback.

    bm_tables: (B, T, M) -> (bits (B, T), metric (B,)).  Takes trellises up
    to the scan kernels' SCAN_MAX_STATES (raises above it, before any work).
    ``capture``: an optional dict that receives the operands of each step
    — ``pass1`` (the windowed scan's arguments), ``mats`` (the (B, nc, S, S)
    transfer matrices the associative scan takes), ``rescan`` (the carried
    scan's arguments), ``bps`` (the (T, B, S) selects) and ``walk`` (the
    packed traceback's arguments) — so each step can be timed alone on
    exactly what the decode gave it.
    """
    B, T, M = bm_tables.shape
    S = code.n_states
    if S > _vscan.MAX_STATES:
        raise ValueError(f"parallel decode: S={S} exceeds the scan kernels' "
                         f"{_vscan.MAX_STATES} states")
    if chunk < 1:
        raise ValueError(f"parallel decode needs chunk >= 1, got {chunk}")
    dev = bm_tables.device
    bm = bm_tables.to(torch.float32)
    pad = (-T) % chunk
    if pad:
        bm = torch.nn.functional.pad(bm, (0, 0, 0, pad))
    nc = (T + pad) // chunk
    chunks = bm.reshape(B * nc, chunk, M).contiguous()  # lanes (b, c)

    # 1. the chunks' transfer matrices, the last one windowed to its steps
    hi = np.full((nc,), chunk, np.int32)
    hi[-1] = T - (nc - 1) * chunk
    mats = chunk_transfer_maps(code, chunks, hi, capture)

    # 2. inclusive prefixes; row 0 of the exclusive ones seeds each chunk
    prefixes = _associative_scan(_minplus_unclamped, mats, axis=1)
    del mats
    unit = _minplus.identity_map(S, device=dev)[0]
    entry = torch.cat([unit.expand(B, 1, S), prefixes[:, :-1, 0, :]], dim=1)  # (B, nc, S)
    frontier = prefixes[:, -1, 0, :].clone()
    del prefixes

    # 3. every chunk re-scanned at once into selects (chunk, B*nc, S)
    rescan, sel = rescan_chunks(code, entry.reshape(B * nc, S), chunks, whole_words=False)
    bps = sel.reshape(chunk, B, nc, S).permute(2, 0, 1, 3).reshape(nc * chunk, B, S)[:T]
    del sel
    if capture is not None:
        capture.update(rescan=rescan, bps=bps)

    # 4. the walk
    return walk_survivors(code, bps, False, frontier, terminated, T, capture)
