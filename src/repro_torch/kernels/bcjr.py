"""Max-log-MAP BCJR scans: two CUDA kernels, each beside its plain PyTorch
version.

  bcjr_alpha_scan      the forward recursion over the RSC butterfly
                       (``A_{t+1}(s') = min_j [A(2v+j) + b_j(s') . x_t]``,
                       subtract-min renormalised each step); it emits every
                       pre-update ``A_t``, which the backward pass needs, and
                       the final metrics with the shifts added back.
  bcjr_beta_llr_scan   the time-reversed beta recursion fused with the
                       max-log LLR ``L_t = min cost_1 - min cost_0`` (negative
                       means bit 1); beta starts at state 0 (terminated) or
                       at zeros (open).

Every metric is a min-domain cost with ``lambda = log P(0)/P(1)``.  The
operands are the cached tables of an RSC code (duck-typed: ``n_states``,
``n_features``, ``alpha_weights``, ``beta_weights``, ``llr_weights``,
``next_state`` — ``kernels/`` never imports ``siso/``).

On a CUDA tensor a wrapper launches ``csrc/bcjr.cu`` (see its header for the
design and the launch choice built for each S); on a CPU tensor it runs the
plain version, which follows the Pallas bodies of the reference
(``kernels/bcjr.py:_alpha_kernel``, ``_make_beta_kernel``) step for step in
their float order, with the one-hot gathers taken as the exact index
selections they are.  Each is counted
under its own name in ``launch_counts`` / ``plain_counts``.

Layouts: the reference's kernel layout, lanes fastest — feat (T, F, B),
alphas (T, S, B), final_pm (S, B), llr (T, B).
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Tuple

import numpy as np
import torch

from repro_torch.core.trellis import NEG_UNREACHABLE
from repro_torch.kernels import _build
from repro_torch.kernels.common import (
    distinct_rows, launch_counts, launch_guard, plain_counts, route)
from repro_torch.roofline import op_cost

ALPHA_NAME = "bcjr_alpha_scan"
BETA_NAME = "bcjr_beta_llr_scan"

#: Largest trellis the kernels take: a group of at most 32 threads holds a
#: lane's S metrics in registers, at most 8 a thread.
MAX_STATES = 64
#: Largest per-step feature width (n_out channel LLRs + one a-priori LLR).
MAX_FEATURES = 8


@dataclasses.dataclass(frozen=True)
class BCJROperands:
    """An RSC code's tables on one device: (S, F) float32 weights of the
    alpha, beta and LLR branches and the (S, 2) int32 next-state table (the
    plain versions' operands); the kernels' form of the same tables — the
    (R, F) distinct weight rows, one (S,) int32 state -> row map for each
    weight table (``rows[b0_row] == b0``, ...) and the (S, 2) int32 register
    bits ``next_state >= S/2``."""

    b0: torch.Tensor
    b1: torch.Tensor
    c0: torch.Tensor
    c1: torch.Tensor
    w0: torch.Tensor
    w1: torch.Tensor
    next_state: torch.Tensor
    rows: torch.Tensor
    b0_row: torch.Tensor
    b1_row: torch.Tensor
    c0_row: torch.Tensor
    c1_row: torch.Tensor
    w0_row: torch.Tensor
    w1_row: torch.Tensor
    reg_bit: torch.Tensor

    @property
    def n_rows(self) -> int:
        return self.rows.shape[0]


@functools.lru_cache(maxsize=None)
def operands(code, device: torch.device) -> BCJROperands:
    """The code's tables uploaded once per (code, device)."""
    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device).contiguous()

    tables = (*code.alpha_weights, *code.beta_weights, *code.llr_weights)
    # host tables of the code (numpy in, numpy out): no device read
    rows, maps = distinct_rows(*(np.asarray(w, dtype=np.float32) for w in tables))  # repr-lint: allow[RPR003]
    reg_bit = (np.asarray(code.next_state) >= code.n_states // 2).astype(np.int32)  # repr-lint: allow[RPR003]
    return BCJROperands(*(put(w) for w in tables), put(code.next_state), put(rows),
                        *(put(m) for m in maps), put(reg_bit))


def _initial(S: int, B: int, device, state0: bool) -> torch.Tensor:
    """(S, B): state 0 at 0 and every other state unreachable, or all 0."""
    col = torch.zeros((S, B), dtype=torch.float32, device=device)
    if state0:
        col[1:] = NEG_UNREACHABLE
    return col


def _dots(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(S, B) = w (S, F) . x (F, B), summed f = 0 .. F-1 from 0, as the
    kernel sums."""
    m = torch.zeros((w.shape[0], x.shape[1]), dtype=torch.float32, device=x.device)
    for f in range(w.shape[1]):
        m = m + w[:, f:f + 1] * x[f:f + 1]
    return m


def bcjr_alpha_scan_plain(code, feat: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`bcjr_alpha_scan`."""
    T, _, B = feat.shape
    S = code.n_states
    op = operands(code, feat.device)
    big = torch.tensor(NEG_UNREACHABLE, dtype=torch.float32, device=feat.device)
    alpha = _initial(S, B, feat.device, state0=True)
    acc = torch.zeros((1, B), dtype=torch.float32, device=feat.device)
    alphas = torch.empty((T, S, B), dtype=torch.float32, device=feat.device)
    for t in range(T):
        alphas[t] = alpha  # pre-update A_t
        x = feat[t]
        pairs = alpha.reshape(S // 2, 2, B)  # pairs[v, j] = A(2v + j)
        cand0 = pairs[:, 0].repeat(2, 1) + _dots(op.b0, x)  # s' = a*S/2 + v
        cand1 = pairs[:, 1].repeat(2, 1) + _dots(op.b1, x)
        new = torch.minimum(cand0, cand1)
        shift = new.amin(dim=0, keepdim=True)
        alpha = torch.minimum(new - shift, big)
        acc = acc + shift
    return alphas, alpha + acc


def bcjr_beta_llr_scan_plain(code, alphas: torch.Tensor, feat: torch.Tensor,
                             terminated: bool = False) -> torch.Tensor:
    """Plain version of :func:`bcjr_beta_llr_scan`."""
    T, S, B = alphas.shape
    dev = feat.device
    op = operands(code, dev)
    big = torch.tensor(NEG_UNREACHABLE, dtype=torch.float32, device=dev)
    succ0, succ1 = op.next_state[:, 0].long(), op.next_state[:, 1].long()
    low = torch.arange(S, device=dev) >> 1  # N_0: p -> p >> 1
    high = low + S // 2                     # N_1: p -> S/2 + (p >> 1)
    beta = _initial(S, B, dev, state0=bool(terminated))
    llr = torch.empty((T, B), dtype=torch.float32, device=dev)
    for t in range(T - 1, -1, -1):
        alpha, x = alphas[t], feat[t]
        cost0 = (alpha + _dots(op.w0, x)) + beta[succ0]
        cost1 = (alpha + _dots(op.w1, x)) + beta[succ1]
        llr[t] = cost1.amin(dim=0) - cost0.amin(dim=0)
        new = torch.minimum(beta[low] + _dots(op.c0, x), beta[high] + _dots(op.c1, x))
        new = new - new.amin(dim=0, keepdim=True)
        beta = torch.minimum(new, big)
    return llr


def _check(name: str, code, tensors) -> None:
    S, F = code.n_states, code.n_features
    if S > MAX_STATES or S < 2 or S & (S - 1):
        raise ValueError(f"{name}: S={S} outside the kernel's powers of two 2..{MAX_STATES}")
    if F > MAX_FEATURES:
        raise ValueError(f"{name}: F={F} exceeds the kernel's {MAX_FEATURES} features")
    for what, t, shape in tensors:
        if t.dim() != len(shape) or any(w is not None and d != w for d, w in zip(t.shape, shape)):
            raise ValueError(f"{name}: {what} must be {shape}, got {tuple(t.shape)}")
        if min(t.shape) < 1:
            raise ValueError(f"{name}: {what} {tuple(t.shape)} is empty")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: {what} must be torch.float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {what} must be contiguous")


@functools.lru_cache(maxsize=None)
def _launcher(symbol: str, n_ptr: int, n_int: int):
    lib = _build.load("bcjr")
    fn = getattr(lib, symbol)
    fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


def bcjr_alpha_scan(code, feat: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward (alpha) scan.

    Args:
      code: an RSC code (its cached tables are the operands).
      feat: (T, F, B) float32 per-step features (channel LLRs + a-priori LLR).
    Returns:
      alphas: (T, S, B) float32 — the pre-update metrics A_t (A_0 is the
        state-0 init), renormalised per step.
      final_pm: (S, B) float32 — A_T in absolute cost units (the per-step
        shifts added back).
    """
    _check(ALPHA_NAME, code, [("feat", feat, (None, code.n_features, None))])
    where = route(ALPHA_NAME, (feat,))
    T, F, B = feat.shape
    S = code.n_states
    op = operands(code, feat.device)
    with op_cost.kernel(ALPHA_NAME, op_cost.bcjr_alpha_cost, B, T, F, S, op.n_rows):
        if where == "cpu":
            plain_counts[ALPHA_NAME] += 1
            return bcjr_alpha_scan_plain(code, feat)
        alphas = torch.empty((T, S, B), dtype=torch.float32, device=feat.device)
        final_pm = torch.empty((S, B), dtype=torch.float32, device=feat.device)
        if where == "meta":
            return alphas, final_pm
        lib, fn = _launcher("bcjr_alpha_scan_launch", 6, 5)
        with launch_guard(feat):
            err = fn(op.rows.data_ptr(), op.b0_row.data_ptr(), op.b1_row.data_ptr(),
                     feat.data_ptr(), alphas.data_ptr(), final_pm.data_ptr(), B, T, F, S,
                     op.n_rows, torch.cuda.current_stream(feat.device).cuda_stream)
        _build.raise_on_error(lib, "bcjr_error_string", ALPHA_NAME, err)
        launch_counts[ALPHA_NAME] += 1
        return alphas, final_pm


def bcjr_beta_llr_scan(code, alphas: torch.Tensor, feat: torch.Tensor,
                       terminated: bool = False) -> torch.Tensor:
    """Backward (beta) scan fused with max-log LLR extraction.

    Args:
      alphas: (T, S, B) pre-update forward metrics from bcjr_alpha_scan.
      feat: (T, F, B) the features the forward pass consumed.
      terminated: the trellis ends in state 0 (beta starts [0, 1e30, ...])
        or is open (beta starts at zeros).
    Returns:
      llr: (T, B) float32 — ``log P(u_t=0) - log P(u_t=1)`` in the max-log
        approximation; decide bit 1 where negative.
    """
    T, F = feat.shape[:2]
    _check(BETA_NAME, code, [("feat", feat, (None, code.n_features, None)),
                             ("alphas", alphas, (T, code.n_states, feat.shape[2]))])
    where = route(BETA_NAME, (alphas, feat))
    B, S = feat.shape[2], code.n_states
    op = operands(code, feat.device)
    with op_cost.kernel(BETA_NAME, op_cost.bcjr_beta_cost, B, T, F, S, op.n_rows):
        if where == "cpu":
            plain_counts[BETA_NAME] += 1
            return bcjr_beta_llr_scan_plain(code, alphas, feat, terminated)
        llr = torch.empty((T, B), dtype=torch.float32, device=feat.device)
        if where == "meta":
            return llr
        lib, fn = _launcher("bcjr_beta_llr_scan_launch", 9, 6)
        with launch_guard(feat):
            err = fn(op.rows.data_ptr(), op.c0_row.data_ptr(), op.c1_row.data_ptr(),
                     op.w0_row.data_ptr(), op.w1_row.data_ptr(), op.reg_bit.data_ptr(),
                     alphas.data_ptr(), feat.data_ptr(), llr.data_ptr(), B, T, F, S, op.n_rows,
                     int(bool(terminated)), torch.cuda.current_stream(feat.device).cuda_stream)
        _build.raise_on_error(lib, "bcjr_error_string", BETA_NAME, err)
        launch_counts[BETA_NAME] += 1
        return llr
