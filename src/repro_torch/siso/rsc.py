"""Recursive systematic convolutional (RSC) codes — the SISO trellis.

Turbo constituents are *recursive* systematic codes: the shift register
feeds back through ``feedback`` (g0) and the transmitted outputs are the
systematic bit plus one parity per ``forward`` polynomial (g1, ...).

Register/state convention mirrors core/trellis.py: the register at time t
holds ``[a_t, a_{t-1}, ..., a_{t-K+1}]`` (newest first) where ``a_t`` is the
*feedback-combined* bit ``a = u XOR parity(g0 & state)``; the state is the
top K-1 bits after the shift, ``s_t = (a_t << (K-2)) | (s_{t-1} >> 1)``.

The crucial consequence: with ``a`` in the role ConvCode gives the input
bit, the RSC trellis has the IDENTICAL de Bruijn butterfly connectivity —
successor ``s' = a*S/2 + v`` with predecessors ``p0 = 2v`` and ``p1 = 2v+1``
— so the ACS kernels' predecessor indexing carries over unchanged.  Only
the labelling differs: the transition ``p -> s'`` consumes input
``u = a XOR f(p)`` (``f(p) = parity(g0 & p)``) and emits
``[u, parity(g_j & reg), ...]``.

Branch costs are affine in per-bit log-likelihood ratios (the same trick as
kernels/metrics.py fused metric plans): with the convention
``lambda = log P(bit=0) / P(bit=1)`` the cost of a transition is
``sum_j x_j * lambda_c[j] + u * lambda_a`` — a ``(S, F)`` weight matrix
times the F = n_out + 1 per-step feature column ``[channel LLRs, a-priori
LLR]``.  The cached properties below bake those weights, plus the gather
matrices of the backward/LLR recursion, as numpy constants.  The BCJR
kernels and their plain versions read the weight tables and ``next_state``
and index the butterfly directly; the one-hot matrices are the reference's
operands, kept so the tables can be held against it table for table.
"""
from __future__ import annotations

import dataclasses
from functools import cached_property
from typing import Tuple

import numpy as np
import torch

from repro_torch.core.trellis import _parity


@dataclasses.dataclass(frozen=True)
class RSCCode:
    """Rate 1/(1+len(forward)) recursive systematic convolutional code.

    Attributes:
      constraint: constraint length K (register holds K bits).
      feedback: recursion polynomial g0 (K bits, monic: bit K-1 — the tap on
        the current bit — must be set; bits K-2..0 tap the state).
      forward: parity generator polynomials, each of K bits over the
        *feedback-combined* register (bit K-1 taps ``a_t``).
    """

    constraint: int = 3
    feedback: int = 0b111
    forward: Tuple[int, ...] = (0b101,)

    def __post_init__(self):
        K = self.constraint
        if K < 2:
            raise ValueError("constraint length must be >= 2")
        if not (1 << (K - 1)) <= self.feedback < (1 << K):
            raise ValueError(
                f"feedback poly {self.feedback:#o} must be monic in K={K} bits"
            )
        if not self.forward:
            raise ValueError("need at least one forward (parity) polynomial")
        for g in self.forward:
            if not 0 <= g < (1 << K):
                raise ValueError(f"poly {g:#o} does not fit in K={K} bits")

    # ------------------------------ shape ------------------------------ #

    @property
    def n_parity(self) -> int:
        return len(self.forward)

    @property
    def n_out(self) -> int:
        """Coded bits per input bit: systematic + parities."""
        return 1 + self.n_parity

    @property
    def n_states(self) -> int:
        return 1 << (self.constraint - 1)

    @property
    def n_symbols(self) -> int:
        return 1 << self.n_out

    @property
    def n_features(self) -> int:
        """Per-step feature width: n_out channel LLRs + one a-priori LLR."""
        return self.n_out + 1

    # ------------------------------ tables ----------------------------- #

    @cached_property
    def feedback_bits(self) -> np.ndarray:
        """(S,) int32: f(s) = parity(g0 & s) — the recursion term."""
        return np.array(
            [_parity(self.feedback & s) for s in range(self.n_states)],
            dtype=np.int32,
        )

    @cached_property
    def next_state(self) -> np.ndarray:
        """(S, 2) int32: successor of (state=p, input=u)."""
        K, S = self.constraint, self.n_states
        nxt = np.zeros((S, 2), dtype=np.int32)
        for p in range(S):
            for u in (0, 1):
                a = u ^ int(self.feedback_bits[p])
                nxt[p, u] = (a << (K - 2)) | (p >> 1)
        return nxt

    @cached_property
    def out_bits(self) -> np.ndarray:
        """(S, 2, n_out) int32: coded bits of transition (state=p, input=u),
        systematic bit first."""
        K, S = self.constraint, self.n_states
        out = np.zeros((S, 2, self.n_out), dtype=np.int32)
        for p in range(S):
            for u in (0, 1):
                a = u ^ int(self.feedback_bits[p])
                reg = (a << (K - 1)) | p
                out[p, u, 0] = u
                for j, g in enumerate(self.forward):
                    out[p, u, 1 + j] = _parity(g & reg)
        return out

    def _weight_row(self, p: int, u: int) -> np.ndarray:
        """(F,) cost weights of transition (p, u): coded bits then u (the
        a-priori tap)."""
        row = np.zeros(self.n_features, dtype=np.float32)
        row[: self.n_out] = self.out_bits[p, u]
        row[self.n_out] = u
        return row

    @cached_property
    def select_matrices(self) -> Tuple[np.ndarray, np.ndarray]:
        """(P0, P1) as in ConvCode: ``P_j[s', 2v+j] = 1`` — identical
        butterfly connectivity (the reference alpha scan's operand)."""
        S = self.n_states
        half = S // 2
        P0 = np.zeros((S, S), dtype=np.float32)
        P1 = np.zeros((S, S), dtype=np.float32)
        for sp in range(S):
            v = sp % half
            P0[sp, 2 * v] = 1.0
            P1[sp, 2 * v + 1] = 1.0
        return P0, P1

    @cached_property
    def alpha_weights(self) -> Tuple[np.ndarray, np.ndarray]:
        """(b0, b1), each (S, F): row s' holds the branch-cost weights of the
        transition arriving from predecessor ``p_j = 2v + j``."""
        S, F = self.n_states, self.n_features
        half = S // 2
        b0 = np.zeros((S, F), dtype=np.float32)
        b1 = np.zeros((S, F), dtype=np.float32)
        for sp in range(S):
            a, v = sp // half, sp % half
            for j, b in ((0, b0), (1, b1)):
                p = 2 * v + j
                u = a ^ int(self.feedback_bits[p])
                b[sp] = self._weight_row(p, u)
        return b0, b1

    @cached_property
    def beta_matrices(self) -> Tuple[np.ndarray, np.ndarray]:
        """(N0, N1), each (S, S): ``N_a[p, s'] = 1`` iff s' is the successor
        of p under new register bit a — the backward-recursion gathers."""
        S = self.n_states
        half = S // 2
        N0 = np.zeros((S, S), dtype=np.float32)
        N1 = np.zeros((S, S), dtype=np.float32)
        for p in range(S):
            for a, N in ((0, N0), (1, N1)):
                N[p, a * half + (p >> 1)] = 1.0
        return N0, N1

    @cached_property
    def beta_weights(self) -> Tuple[np.ndarray, np.ndarray]:
        """(c0, c1), each (S, F): branch-cost weights of the transition
        leaving p under new register bit a (input ``u = a XOR f(p)``)."""
        S, F = self.n_states, self.n_features
        c0 = np.zeros((S, F), dtype=np.float32)
        c1 = np.zeros((S, F), dtype=np.float32)
        for p in range(S):
            for a, c in ((0, c0), (1, c1)):
                c[p] = self._weight_row(p, a ^ int(self.feedback_bits[p]))
        return c0, c1

    @cached_property
    def llr_matrices(self) -> Tuple[np.ndarray, np.ndarray]:
        """(U0, U1), each (S, S): ``U_u[p, s'] = 1`` iff s' is the successor
        of p under *input bit* u — the per-hypothesis gathers of the LLR
        extraction (min over transitions with u fixed)."""
        S = self.n_states
        U0 = np.zeros((S, S), dtype=np.float32)
        U1 = np.zeros((S, S), dtype=np.float32)
        for p in range(S):
            for u, U in ((0, U0), (1, U1)):
                U[p, self.next_state[p, u]] = 1.0
        return U0, U1

    @cached_property
    def llr_weights(self) -> Tuple[np.ndarray, np.ndarray]:
        """(w0, w1), each (S, F): branch-cost weights of the transition
        leaving p under input bit u."""
        S, F = self.n_states, self.n_features
        w0 = np.zeros((S, F), dtype=np.float32)
        w1 = np.zeros((S, F), dtype=np.float32)
        for p in range(S):
            for u, w in ((0, w0), (1, w1)):
                w[p] = self._weight_row(p, u)
        return w0, w1

    # ------------------------------ encode ----------------------------- #

    @property
    def n_flush(self) -> int:
        return self.constraint - 1

    def encode(self, bits: torch.Tensor, terminate: bool = True) -> torch.Tensor:
        """(..., T) info bits -> (..., T [+ n_flush], n_out) int32 coded bits
        on ``bits.device``.

        The recursion makes this a genuine sequential loop over T (unlike
        the windowed feed-forward encoder).  Termination drives the register
        to zero with the state-dependent tail ``u = f(s)`` (so ``a = 0`` each
        flush step); tail bits are transmitted like any others.
        """
        bits = torch.as_tensor(bits).to(torch.int64)
        lead, T = bits.shape[:-1], bits.shape[-1]
        flat = bits.reshape(-1, T)
        dev = flat.device
        nxt = torch.from_numpy(self.next_state).long().to(dev)
        out = torch.from_numpy(self.out_bits).to(dev)
        fb = torch.from_numpy(self.feedback_bits).long().to(dev)
        s = torch.zeros(flat.shape[0], dtype=torch.int64, device=dev)
        steps = []
        for t in range(T):
            u = flat[:, t]
            steps.append(out[s, u])
            s = nxt[s, u]
        if terminate:
            for _ in range(self.n_flush):
                u = fb[s]
                steps.append(out[s, u])
                s = nxt[s, u]
        coded = torch.stack(steps, dim=1)  # (B, T [+ n_flush], n_out)
        return coded.reshape(lead + coded.shape[1:]).to(torch.int32)


# Named codes used by tests / benchmarks.
RSC_K3_75 = RSCCode(3, 0b111, (0b101,))      # recursive (1, 5/7): the textbook SISO toy
RSC_K4_LTE = RSCCode(4, 0o13, (0o15,))       # the LTE turbo constituent (13, 15)_oct
