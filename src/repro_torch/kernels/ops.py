"""Public wrappers around the kernels: the packed decode pipeline.

  packed        viterbi_decode_packed: bm tables in, packed survivors, packed
                traceback kernel.
  fused+packed  viterbi_decode_fused_packed: raw received symbols in, branch
                metrics computed in the scan kernel (kernels/metrics.py),
                packed survivors, packed traceback — the short-block hot path.

Every function keeps the reference's user layout: inputs (B, T, F) or
(B, T, M), final metrics (B, S), packed survivors (W, B, S), bits (B, T).
Each decode derives every operand from its input tensor's device, so the
scan and the traceback of one decode both launch their kernels (CUDA) or
both run their plain versions (CPU) — see kernels/common.py.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core.trellis import ConvCode
from repro_torch.kernels import survivors as _surv
from repro_torch.kernels import viterbi_scan as _vscan
from repro_torch.kernels.metrics import FusedMetricPlan


def viterbi_forward_weighted_op(
    code: ConvCode,
    data_btf: torch.Tensor,
    weights: Tuple[torch.Tensor, torch.Tensor, torch.Tensor],
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Generic packed forward from state 0 with any (b0, b1, rb) metric
    weights.  data_btf: (B, T, F) -> final_pm (B, S), packed (W, B, S)."""
    b0, b1, rb = weights
    data = data_btf.to(torch.float32).contiguous()
    return _vscan.viterbi_scan_packed(code, data, b0, b1, rb)


def viterbi_forward_packed_op(
    code: ConvCode, bm_tables: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward pass with bit-packed survivors from precomputed bm tables.
    bm_tables: (B, T, M) -> final_pm (B, S), packed (ceil(T/32), B, S)."""
    return viterbi_forward_weighted_op(
        code, bm_tables, _vscan.table_weights(code, bm_tables.device)
    )


def viterbi_forward_fused_op(
    plan: FusedMetricPlan, received: torch.Tensor, t0: int = 0
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward pass with **in-kernel branch metrics** + packed survivors.
    received: (B, T, n_out) raw channel symbols (hard bits or soft values).
    Returns final_pm (B, S), packed (ceil(T/32), B, S)."""
    feats = plan.features(received, t0)
    return viterbi_forward_weighted_op(plan.code, feats, plan.folded(received.device))


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
