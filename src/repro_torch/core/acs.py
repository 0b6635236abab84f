"""Plain Add-Compare-Select step — the paper's `Texpand` primitive.

The butterfly formulation of core/trellis.py: the branch metrics of every
(input bit u, low state v, predecessor parity j) come from one index into
the per-step table, and the two predecessors of ``s' = u*S/2 + v`` are the
adjacent pair ``2v, 2v+1`` — a reshape, no gather over states.
"""
from __future__ import annotations

import torch

from repro_torch.core.trellis import ConvCode


def acs_step(code: ConvCode, pm: torch.Tensor, bm_table: torch.Tensor):
    """One trellis-expansion (ACS) step for all states, batched.

    Args:
      pm: (..., S) float32 path metrics.
      bm_table: (..., n_symbols) float32 per-step branch-metric table
        (bm_table[c] = metric of emitting symbol c at this step).

    Returns:
      new_pm: (..., S) updated path metrics.
      bp: (..., S) int32 backpointer bit j ∈ {0,1}; predecessor of successor
        state ``s' = u*S/2 + v`` is ``2v + j``.  Ties select j=0 (the paper's
        lowest-state rule, since 2v < 2v+1).
    """
    S = code.n_states
    idx = torch.from_numpy(code.butterfly_code).to(bm_table.device).long()
    bm = bm_table[..., idx]  # (..., 2, S/2, 2)
    pm2 = pm.reshape(pm.shape[:-1] + (S // 2, 2))  # pm2[..., v, j] = pm[..., 2v+j]
    cand = pm2[..., None, :, :] + bm  # (..., 2, S/2, 2)
    take1 = cand[..., 1] < cand[..., 0]  # strict: ties -> j=0 (lowest pred state)
    new_pm = torch.where(take1, cand[..., 1], cand[..., 0])
    new_pm = new_pm.reshape(pm.shape[:-1] + (S,))
    bp = take1.to(torch.int32).reshape(pm.shape[:-1] + (S,))
    return new_pm, bp
