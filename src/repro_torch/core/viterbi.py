"""Sequential Viterbi decoder — the oracle every other path is held against.

Consumes *branch-metric tables* (see channel.py) so that hard and soft
decision decoding share one code path.  A Python loop over time of plain
tensor ops: on any device it is a chain of library ops, never a kernel of
this package.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core.acs import acs_step
from repro_torch.core.trellis import NEG_UNREACHABLE, ConvCode


def _initial_pm(code: ConvCode, batch_shape, device="cpu") -> torch.Tensor:
    """Paths start in state 0 (paper §IV-B)."""
    pm0 = torch.full(tuple(batch_shape) + (code.n_states,), NEG_UNREACHABLE,
                     dtype=torch.float32, device=device)
    pm0[..., 0] = 0.0
    return pm0


def _traceback(code: ConvCode, bps: torch.Tensor, final_state: torch.Tensor):
    """Trace back through backpointers.

    Args:
      bps: (T, B, S) int32 backpointer parity bits.
      final_state: (B,) int32.
    Returns:
      bits: (B, T) decoded input bits (u_t = MSB of s_t).
      states: (B, T) the surviving state sequence s_1..s_T.
    """
    K = code.constraint
    half = code.n_states // 2
    T = bps.shape[0]
    s = final_state.to(torch.int64)
    bits, states = [], []
    for t in range(T - 1, -1, -1):
        u = s >> (K - 2)  # input bit that produced s
        v = s & (half - 1)  # 0 when half == 1 (K=2)
        j = torch.gather(bps[t], 1, s[:, None])[:, 0].to(torch.int64)
        bits.append(u)
        states.append(s)
        s = 2 * v + j
    bits_bt = torch.stack(bits[::-1], dim=1).to(torch.int32)
    states_bt = torch.stack(states[::-1], dim=1).to(torch.int32)
    return bits_bt, states_bt


def viterbi_decode(
    code: ConvCode,
    bm_tables: torch.Tensor,
    terminated: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sequential-scan Viterbi decoder (the faithful baseline).

    Args:
      bm_tables: (B, T, n_symbols) float32 branch-metric tables (minimize).
      terminated: trellis ends in state 0 (flush bits appended at encode).

    Returns:
      bits: (B, T) decoded input bits (including flush bits if terminated).
      metric: (B,) the winning path metric.
    """
    B, T, _ = bm_tables.shape
    bm_tables = bm_tables.to(torch.float32)
    pm = _initial_pm(code, (B,), bm_tables.device)
    bps = []
    for t in range(T):
        pm, bp = acs_step(code, pm, bm_tables[:, t])
        bps.append(bp)
    if terminated:
        final_state = torch.zeros((B,), dtype=torch.int32, device=pm.device)
        metric = pm[..., 0]
    else:
        final_state = torch.argmin(pm, dim=-1).to(torch.int32)
        metric = pm.min(dim=-1).values
    bits, _ = _traceback(code, torch.stack(bps), final_state)
    return bits, metric
