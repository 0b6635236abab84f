"""Convolutional-code / trellis specification (numpy tables).

State convention: the encoder register at time t holds
``[u_t, u_{t-1}, ..., u_{t-K+1}]`` (K bits, newest first).  The *state* is
the top K-1 bits **after** the shift, i.e. ``s_t = (u_t << (K-2)) |
(s_{t-1} >> 1)``.

Butterfly structure: write the successor state as ``s' = u * S/2 + v``
(``u`` = MSB = the input bit that produced the transition, ``v`` = low K-2
bits).  Its two predecessors are ``p0 = 2v`` and ``p1 = 2v + 1``.

Tie-break rule (paper §IV-B): when the two arriving path weights are equal,
the path arriving from the **lowest-numbered state** survives.  Since
``p0 = 2v < p1 = 2v+1``, the ACS select prefers ``j=0`` on ties (strict
``<`` when testing the ``j=1`` candidate).

The tables are plain numpy, built once per code and cached; the one-hot
matrices are kept because the fused metric plans fold their weights through
them (kernels/metrics.py), not because any kernel multiplies by them.
"""
from __future__ import annotations

import dataclasses
from functools import cached_property
from typing import Tuple

import numpy as np

# A value that acts as +inf in (min,+) arithmetic but stays finite so that
# repeated additions never produce NaN (inf - inf).
NEG_UNREACHABLE = 1e30


def _parity(x: int) -> int:
    return bin(x).count("1") & 1


@dataclasses.dataclass(frozen=True)
class ConvCode:
    """Rate 1/n feed-forward convolutional code.

    Attributes:
      constraint: constraint length K (register holds K bits).
      polys: generator polynomials, one per output bit, as integers of K bits.
        Bit ``K-1`` (MSB) taps the *current* input bit ``u_t``; bit 0 taps the
        oldest bit ``u_{t-K+1}``.
    """

    constraint: int = 3
    polys: Tuple[int, ...] = (0b111, 0b101)  # the standard (7,5) K=3 code

    def __post_init__(self):
        if self.constraint < 2:
            raise ValueError("constraint length must be >= 2")
        for g in self.polys:
            if not 0 <= g < (1 << self.constraint):
                raise ValueError(f"poly {g:#o} does not fit in K={self.constraint} bits")

    @property
    def n_out(self) -> int:
        """Output bits per input bit (rate is 1/n_out)."""
        return len(self.polys)

    @property
    def n_states(self) -> int:
        return 1 << (self.constraint - 1)

    @property
    def n_symbols(self) -> int:
        """Number of distinct output symbols (packed output bit patterns)."""
        return 1 << self.n_out

    @cached_property
    def branch_code(self) -> np.ndarray:
        """(S, 2) int32: packed output symbol for transition (state=p, input=u)."""
        K, S = self.constraint, self.n_states
        out = np.zeros((S, 2), dtype=np.int32)
        for p in range(S):
            for u in (0, 1):
                reg = (u << (K - 1)) | p
                c = 0
                for g in self.polys:
                    c = (c << 1) | _parity(g & reg)
                out[p, u] = c
        return out

    @cached_property
    def next_state(self) -> np.ndarray:
        """(S, 2) int32: successor state for (state=p, input=u)."""
        K, S = self.constraint, self.n_states
        nxt = np.zeros((S, 2), dtype=np.int32)
        for p in range(S):
            for u in (0, 1):
                nxt[p, u] = (u << (K - 2)) | (p >> 1)
        return nxt

    @cached_property
    def butterfly_code(self) -> np.ndarray:
        """(2, S//2, 2) int32: ``butterfly_code[u, v, j]`` is the output symbol
        of the transition from predecessor ``p = 2v + j`` into successor
        ``s' = u*S/2 + v``."""
        S = self.n_states
        bc = self.branch_code
        out = np.zeros((2, S // 2, 2), dtype=np.int32)
        for u in (0, 1):
            for v in range(S // 2):
                for j in (0, 1):
                    out[u, v, j] = bc[2 * v + j, u]
        return out

    @cached_property
    def butterfly_onehot(self) -> np.ndarray:
        """(2, S//2, 2, n_symbols) float32 one-hot of ``butterfly_code``."""
        oh = np.zeros((2, self.n_states // 2, 2, self.n_symbols), dtype=np.float32)
        code = self.butterfly_code
        for u in (0, 1):
            for v in range(self.n_states // 2):
                for j in (0, 1):
                    oh[u, v, j, code[u, v, j]] = 1.0
        return oh

    @cached_property
    def select_matrices(self) -> Tuple[np.ndarray, np.ndarray]:
        """(P0, P1), each (S, S) float32 one-hot: ``P_j[s', p] = 1`` iff
        ``p = 2v + j`` is the j-th predecessor of ``s' = u*S/2 + v``."""
        S = self.n_states
        P0 = np.zeros((S, S), dtype=np.float32)
        P1 = np.zeros((S, S), dtype=np.float32)
        half = S // 2
        for sp in range(S):
            v = sp % half
            P0[sp, 2 * v] = 1.0
            P1[sp, 2 * v + 1] = 1.0
        return P0, P1

    @cached_property
    def branch_onehot_pair(self) -> Tuple[np.ndarray, np.ndarray]:
        """(OH0, OH1), each (S, n_symbols) float32: ``OH_j[s', c] = 1`` iff
        symbol c is emitted on the transition from predecessor ``2v+j`` into
        successor s'."""
        S, M = self.n_states, self.n_symbols
        half = S // 2
        bc = self.branch_code
        OH0 = np.zeros((S, M), dtype=np.float32)
        OH1 = np.zeros((S, M), dtype=np.float32)
        for sp in range(S):
            u, v = sp // half, sp % half
            OH0[sp, bc[2 * v, u]] = 1.0
            OH1[sp, bc[2 * v + 1, u]] = 1.0
        return OH0, OH1

    @cached_property
    def hamming_table(self) -> np.ndarray:
        """(n_symbols, n_symbols) float32: popcount(a XOR b)."""
        M = self.n_symbols
        t = np.zeros((M, M), dtype=np.float32)
        for a in range(M):
            for b in range(M):
                t[a, b] = bin(a ^ b).count("1")
        return t

    @cached_property
    def symbol_bits(self) -> np.ndarray:
        """(n_symbols, n_out) float32: bit expansion of each packed symbol."""
        M, n = self.n_symbols, self.n_out
        t = np.zeros((M, n), dtype=np.float32)
        for c in range(M):
            for j in range(n):
                t[c, j] = (c >> (n - 1 - j)) & 1
        return t


# Named codes used throughout tests and chip_smoke.py.
CODE_K3_STD = ConvCode(3, (0b111, 0b101))        # (7,5): the textbook K=3 code
CODE_K3_PAPER = ConvCode(3, (0b110, 0b010))      # the encoder of the paper's Fig. 1(b)
CODE_K5_GSM = ConvCode(5, (0b10011, 0b11101))    # GSM full-rate (23, 35)_oct, K=5
CODE_K7_NASA = ConvCode(7, (0o171, 0o133))       # NASA/Voyager K=7 (171,133)


def paper_expansion_calls(n_coded_bits: int, code: ConvCode = CODE_K3_STD) -> int:
    """Number of trellis-expansion calls as counted by the paper (§V).

    For the 4-state K=3 trellis and 12 coded bits the paper counts 19 calls:
    the active-state frontier grows 1, 2, 4, 4, ... so the total over
    T = n_coded_bits / n_out steps is ``sum_t min(2^t, S)``.
    """
    T = n_coded_bits // code.n_out
    S = code.n_states
    return int(sum(min(2 ** t, S) for t in range(T)))
