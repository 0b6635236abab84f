"""Plain Add-Compare-Select step — the paper's `Texpand` primitive — and the
paper's "without custom instruction" baseline.

The butterfly formulation of core/trellis.py: the branch metrics of every
(input bit u, low state v, predecessor parity j) come from one index into
the per-step table, and the two predecessors of ``s' = u*S/2 + v`` are the
adjacent pair ``2v, 2v+1`` — a reshape, no gather over states.
:func:`acs_step_unfused` is the same step as the paper's plain assembly
writes it: one add, one compare and one select per transition.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.core.trellis import ConvCode


@functools.lru_cache(maxsize=None)
def _butterfly_index(code: ConvCode, device: torch.device) -> torch.Tensor:
    """The code's (2, S/2, 2) butterfly symbol index as int64 on ``device``,
    uploaded once per (code, device): a step copies nothing from the host."""
    return torch.from_numpy(code.butterfly_code).long().to(device)


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
    bm = bm_table[..., _butterfly_index(code, bm_table.device)]  # (..., 2, S/2, 2)
    pm2 = pm.reshape(pm.shape[:-1] + (S // 2, 2))  # pm2[..., v, j] = pm[..., 2v+j]
    cand = pm2[..., None, :, :] + bm  # (..., 2, S/2, 2)
    take1 = cand[..., 1] < cand[..., 0]  # strict: ties -> j=0 (lowest pred state)
    new_pm = torch.where(take1, cand[..., 1], cand[..., 0])
    new_pm = new_pm.reshape(pm.shape[:-1] + (S,))
    bp = take1.to(torch.int32).reshape(pm.shape[:-1] + (S,))
    return new_pm, bp


def acs_step_unfused(code: ConvCode, pm: torch.Tensor, bm_table: torch.Tensor):
    """Deliberately *unfused* ACS, mirroring the paper's plain-assembly
    trellis function: for each predecessor state p and input u, an explicit
    ADD of the branch metric, a COMPARE against the incumbent and a SELECT
    of the survivor — a handful of torch ops per transition, 2S transitions
    a step.  The op count is what the paper's comparison measures, so the
    loop is kept as written (updates go into two fresh tensors in place).

    Semantically :func:`acs_step`: the same new metrics; the second output is
    the survivor's predecessor parity ``p & 1`` (int32), which equals
    :func:`acs_step`'s select bit.  Strict ``<``: the earlier p wins ties.
    """
    S = code.n_states
    nxt = code.next_state  # (S, 2) numpy: the loop bounds are host constants
    bcode = code.branch_code  # (S, 2)
    new_pm = torch.full(pm.shape, 3.4e38, dtype=pm.dtype, device=pm.device)
    best_pred_parity = torch.zeros(pm.shape, dtype=torch.int32, device=pm.device)
    for p in range(S):
        for u in (0, 1):
            sp = int(nxt[p, u])
            cand = pm[..., p] + bm_table[..., int(bcode[p, u])]  # ADD
            incumbent = new_pm[..., sp]
            better = cand < incumbent  # COMPARE (strict: earlier p wins ties)
            new_pm[..., sp] = torch.where(better, cand, incumbent)  # SELECT
            best_pred_parity[..., sp] = torch.where(better, p & 1, best_pred_parity[..., sp])
    return new_pm, best_pred_parity
