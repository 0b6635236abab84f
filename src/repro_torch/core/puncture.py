"""Rate-compatible punctured convolutional codes.

Patterns are (n_out, period) 0/1 arrays; e.g. rate-2/3 from rate-1/2:
P = [[1, 1], [1, 0]] — every second bit of the second stream is dropped.
Punctured positions are erasures: they contribute 0 to every branch metric,
so the same decoders handle every punctured rate.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.trellis import ConvCode

# standard patterns (period aligned per input bit)
PUNCTURE_2_3 = np.array([[1, 1], [1, 0]])
PUNCTURE_3_4 = np.array([[1, 1, 0], [1, 0, 1]])
PUNCTURE_5_6 = np.array([[1, 1, 0, 1, 0], [1, 0, 1, 0, 1]])

#: WIMAX-style turbo puncturing over the [systematic, parity1, parity2]
#: streams: keep every systematic bit, alternate the parities -> rate 1/2
#: from the rate-1/3 mother turbo code.
PUNCTURE_TURBO_1_2 = np.array([[1, 1], [1, 0], [0, 1]])


def pattern_mask(code, T: int, pattern: np.ndarray, device="cpu") -> torch.Tensor:
    """(T, n_out) float32 0/1 mask from a (n_out, period) pattern.

    ``code`` is anything with an ``n_out`` or a bare int stream count.
    """
    n_out = code if isinstance(code, int) else code.n_out
    n, period = pattern.shape
    if n != n_out:
        raise ValueError(f"pattern has {n} rows, code has n_out={n_out}")
    reps = -(-T // period)
    mask = np.tile(pattern.T, (reps, 1))[:T]  # (T, n_out)
    return torch.tensor(mask, dtype=torch.float32, device=device)


def puncture(code: ConvCode, coded_bits: torch.Tensor, pattern: np.ndarray) -> torch.Tensor:
    """Apply a puncture mask: (..., T, n_out) coded bits with the punctured
    positions zeroed (not transmitted), float32 as the reference's (the
    int32 bits times the float32 mask promote)."""
    mask = pattern_mask(code, coded_bits.shape[-2], pattern, coded_bits.device)
    return coded_bits * mask


def punctured_hard_metrics(code: ConvCode, received_bits: torch.Tensor,
                           pattern: np.ndarray) -> torch.Tensor:
    """Hamming branch metrics with punctured positions as erasures.

    received_bits: (..., T, n_out) where punctured positions are arbitrary.
    Returns (..., T, n_symbols): per-symbol distance counting ONLY
    transmitted positions.
    """
    dev = received_bits.device
    T = received_bits.shape[-2]
    mask = pattern_mask(code, T, pattern, dev)  # (T, n)
    bits = torch.from_numpy(code.symbol_bits).to(dev)  # (M, n)
    r = received_bits.to(torch.float32)[..., None, :]  # (..., T, 1, n)
    diff = torch.abs(r - bits[None, :, :])  # (..., T, M, n)
    return (diff * mask[:, None, :]).sum(-1)


def effective_rate(code, pattern: np.ndarray) -> float:
    """k/n after puncturing: period input bits -> surviving coded bits."""
    period = pattern.shape[1]
    return period / float(pattern.sum())
