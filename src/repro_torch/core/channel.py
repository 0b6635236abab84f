"""Channel models + branch-metric table construction (hard & soft decision).

The random channels draw from a caller-owned ``torch.Generator``, which must
live on the same device as the tensors it perturbs.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.encoder import pack_symbols
from repro_torch.core.trellis import ConvCode


def bsc(gen: torch.Generator, coded_bits: torch.Tensor, flip_prob: float) -> torch.Tensor:
    """Binary symmetric channel: flip each bit with probability ``flip_prob``."""
    u = torch.rand(coded_bits.shape, generator=gen, device=coded_bits.device)
    flips = (u < flip_prob).to(torch.int32)
    return coded_bits.to(torch.int32) ^ flips


def bpsk_modulate(coded_bits: torch.Tensor) -> torch.Tensor:
    """Map bit {0,1} -> symbol {+1,-1}."""
    return 1.0 - 2.0 * coded_bits.to(torch.float32)


def awgn(gen: torch.Generator, symbols: torch.Tensor, snr_db: float) -> torch.Tensor:
    """Add white Gaussian noise at the given Es/N0 (dB); unit symbol energy."""
    snr = 10.0 ** (snr_db / 10.0)
    sigma = math.sqrt(1.0 / (2.0 * snr))
    noise = torch.randn(symbols.shape, generator=gen, device=symbols.device)
    return symbols + sigma * noise


def hard_branch_metrics(code: ConvCode, received_bits: torch.Tensor) -> torch.Tensor:
    """Hamming branch-metric tables.

    Args:
      received_bits: (..., T, n_out) hard bits.
    Returns:
      (..., T, n_symbols) float32 where entry c = hamming(r_t, symbol c).
    """
    r = pack_symbols(code, received_bits).long()  # (..., T)
    table = torch.from_numpy(code.hamming_table).to(received_bits.device)
    return table[r]


def soft_branch_metrics(code: ConvCode, received_values: torch.Tensor) -> torch.Tensor:
    """Soft (correlation) branch-metric tables, to be MINIMIZED:
    ``bm(c) = sum_j y_j * (2*bit_j(c) - 1)``.

    Args:
      received_values: (..., T, n_out) real channel outputs.
    Returns:
      (..., T, n_symbols) float32.
    """
    bits = torch.from_numpy(code.symbol_bits).to(received_values.device)
    x = 2.0 * bits - 1.0  # (M, n)
    return torch.einsum("...tj,mj->...tm", received_values.to(torch.float32), x)
