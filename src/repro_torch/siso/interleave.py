"""Interleavers as hashable specs (pure numpy).

A turbo code is defined by its constituent RSC code *and* its interleaver,
so the interleaver is part of the hashable TurboSpec.  Both kinds here are
frozen dataclasses of ints whose permutation tables are derived lazily
(cached) — the spec itself stays tiny and hashable, like ConvCode/RSCCode.

Convention: ``interleaved[k] = natural[permutation[k]]`` — i.e.
``interleave(x) = x[perm]`` and ``deinterleave(y) = y[inverse]``.
"""
from __future__ import annotations

import dataclasses
from functools import cached_property

import numpy as np


@dataclasses.dataclass(frozen=True)
class BlockInterleaver:
    """Classic row-column interleaver: write row-major into a (rows, cols)
    matrix, read column-major."""

    rows: int
    cols: int

    def __post_init__(self):
        if self.rows < 1 or self.cols < 1:
            raise ValueError("rows and cols must be positive")

    @property
    def n(self) -> int:
        return self.rows * self.cols

    @cached_property
    def permutation(self) -> np.ndarray:
        k = np.arange(self.n)
        # k-th read (column-major) hits element (k % rows, k // rows)
        return ((k % self.rows) * self.cols + k // self.rows).astype(np.int32)

    @cached_property
    def inverse(self) -> np.ndarray:
        return np.argsort(self.permutation).astype(np.int32)


@dataclasses.dataclass(frozen=True)
class QPPInterleaver:
    """Quadratic permutation polynomial interleaver (the LTE turbo family):
    ``pi(k) = (f1*k + f2*k^2) mod n``.

    Contention-free and maximally spread for the standardized (n, f1, f2)
    triples; the constructor verifies the polynomial actually permutes
    [0, n) so a bad triple fails loudly at spec-construction time.
    """

    n: int
    f1: int
    f2: int

    def __post_init__(self):
        if self.n < 2:
            raise ValueError("interleaver length must be >= 2")
        perm = self._compute()
        if len(np.unique(perm)) != self.n:
            raise ValueError(
                f"(f1={self.f1}, f2={self.f2}) is not a permutation polynomial "
                f"mod {self.n}"
            )

    def _compute(self) -> np.ndarray:
        k = np.arange(self.n, dtype=np.int64)
        return ((self.f1 * k + self.f2 * k * k) % self.n).astype(np.int32)

    @cached_property
    def permutation(self) -> np.ndarray:
        return self._compute()

    @cached_property
    def inverse(self) -> np.ndarray:
        return np.argsort(self.permutation).astype(np.int32)
