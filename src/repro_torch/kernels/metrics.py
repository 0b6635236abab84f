"""In-kernel branch metrics: fold the metric computation into the scan kernel.

Every branch metric this package uses is affine in the received symbols:

  hard (Hamming)        bm(c) = Σ_j (1 - 2 x_cj) r_j + Σ_j x_cj
  hard + puncture mask  bm(c) = Σ_j (1 - 2 x_cj)(m_j r_j) + Σ_j x_cj m_j
  soft (correlation)    bm(c) = Σ_j (2 x_cj - 1) y_j      (mask pre-applied)

i.e. ``bm = W @ feat + bias`` with a static (M, F) weight, a static (M,)
bias, and F = n (or 2n punctured-hard) per-step *features*.  Folding W
through the branch one-hots (exact row selections) gives per-successor
weights ``b_j`` and biases ``rb_j``, so the scan kernel computes
``b_j · feat_t + rb_j`` from raw received symbols and never reads a
(T, M) table.  Every weight is 0 or ±1, so each product is exact: hard
plans are integer-exact, soft plans round once per added feature.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core.puncture import pattern_mask
from repro_torch.core.trellis import ConvCode


@functools.lru_cache(maxsize=None)
def _phase_mask(
    code: ConvCode, T: int, pattern: Tuple[Tuple[int, ...], ...], phase: int
) -> torch.Tensor:
    """(T, n) 0/1 CPU puncture mask for trellis steps starting at ``phase``
    within the pattern period (callers reduce an absolute t0 mod period, so
    the key space — and the cache — is bounded by the period)."""
    # the pattern is a host tuple: no device read
    return pattern_mask(code, phase + T, np.asarray(pattern))[phase:]  # repr-lint: allow[RPR003]


@dataclasses.dataclass(frozen=True)
class FusedMetricPlan:
    """Static affine form of one branch metric + how its features are built."""

    code: ConvCode
    metric: str  # "hard" | "soft"
    puncture: Optional[Tuple[Tuple[int, ...], ...]]
    weight: np.ndarray  # (M, F) float32
    bias: np.ndarray  # (M,) float32

    @property
    def n_features(self) -> int:
        return self.weight.shape[1]

    def features(self, received: torch.Tensor, t0: int = 0) -> torch.Tensor:
        """(..., T, n_out) raw channel output -> (..., T, F) float32 kernel
        features on ``received.device``.  ``t0`` is the absolute trellis step
        of the first row — it phases the puncture mask."""
        r = received.to(torch.float32)
        if self.puncture is None:
            return r
        period = len(self.puncture[0])
        mask = _phase_mask(self.code, r.shape[-2], self.puncture, t0 % period)
        mask = mask.to(r.device)
        if self.metric == "soft":
            return r * mask  # erased positions correlate to 0
        return torch.cat([r * mask, mask.expand(r.shape)], dim=-1)

    def bm_from_features(self, feats: torch.Tensor) -> torch.Tensor:
        """(..., T, F) features -> (..., T, M) bm tables: the affine form
        evaluated outside the kernel."""
        W = torch.from_numpy(self.weight).to(feats.device)
        bias = torch.from_numpy(self.bias).to(feats.device)
        return torch.einsum("...tf,mf->...tm", feats, W) + bias

    def bm_tables(self, received: torch.Tensor, t0: int = 0) -> torch.Tensor:
        """(..., T, n_out) raw symbols -> (..., T, M) bm tables."""
        return self.bm_from_features(self.features(received, t0))

    def folded_arrays(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """The kernel operands as host float32 arrays: b0 (S, F), b1 (S, F),
        rb (S, 2).  The branch one-hots are 0/1 row selectors, so ``OH_j @ W``
        just re-indexes W per successor state — exact."""
        OH0, OH1 = self.code.branch_onehot_pair
        rb = np.stack([OH0 @ self.bias, OH1 @ self.bias], axis=1)
        return tuple(a.astype(np.float32) for a in (OH0 @ self.weight, OH1 @ self.weight, rb))

    def folded(self, device="cpu") -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """:meth:`folded_arrays` as new tensors on ``device``."""
        return tuple(torch.tensor(a, device=device) for a in self.folded_arrays())


def fused_metric_plan(
    code: ConvCode,
    metric: str = "hard",
    puncture: Optional[np.ndarray] = None,
) -> FusedMetricPlan:
    """Build the affine in-kernel form of a branch metric (see module doc)."""
    if metric not in ("hard", "soft"):
        raise ValueError(f"metric must be 'hard' or 'soft', got {metric!r}")
    # plan construction reads the code's host tables only: no device read
    X = np.asarray(code.symbol_bits, np.float64)  # repr-lint: allow[RPR003]
    punct = (
        None if puncture is None
        else tuple(tuple(int(v) for v in row) for row in puncture)
    )
    if metric == "soft":
        W = 2.0 * X - 1.0
        bias = np.zeros((X.shape[0],))
    elif punct is None:
        W = 1.0 - 2.0 * X
        bias = X.sum(axis=1)
    else:
        # features are [masked bits | mask]: Σ m|r-x| = (1-2X)@(mr) + X@m
        W = np.concatenate([1.0 - 2.0 * X, X], axis=1)
        bias = np.zeros((X.shape[0],))
    return FusedMetricPlan(
        code=code,
        metric=metric,
        puncture=punct,
        weight=W.astype(np.float32),
        bias=bias.astype(np.float32),
    )
