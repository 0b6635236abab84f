"""Convolutional encoder over GF(2), in PyTorch.

Output bit j at time t is the GF(2) inner product of generator polynomial j
with the register window ``[u_t, ..., u_{t-K+1}]``.
"""
from __future__ import annotations

import torch

from repro_torch.core.trellis import ConvCode


def encode(code: ConvCode, bits: torch.Tensor, terminate: bool = True) -> torch.Tensor:
    """Encode information bits.

    Args:
      code: the convolutional code.
      bits: (..., T) tensor of {0,1} information bits.
      terminate: if True, append K-1 zero flush bits (the trellis starts AND
        ends in state 0).

    Returns:
      (..., T_out, n_out) int32 coded bits on ``bits.device``, where
      T_out = T + (K-1 if terminate else 0).
    """
    bits = bits.to(torch.int32)
    K = code.constraint
    zeros = bits.new_zeros(bits.shape[:-1] + (K - 1,))
    if terminate:
        bits = torch.cat([bits, zeros], dim=-1)
    T = bits.shape[-1]
    pad = torch.cat([zeros, bits], dim=-1)
    dev = bits.device
    # window[..., t, i] = u_{t-i} (zero before start)
    idx = (torch.arange(T, device=dev)[:, None] + (K - 1)
           - torch.arange(K, device=dev)[None, :])
    window = pad[..., idx]  # (..., T, K)
    # generator taps: poly bit (K-1-i) multiplies u_{t-i}
    taps = torch.tensor(
        [[(g >> (K - 1 - i)) & 1 for i in range(K)] for g in code.polys],
        dtype=torch.int32, device=dev,
    )  # (n, K)
    out = (window[..., None, :] * taps).sum(-1) % 2  # GF(2) inner product
    return out.to(torch.int32)


def pack_symbols(code: ConvCode, coded_bits: torch.Tensor) -> torch.Tensor:
    """Pack (..., T, n_out) coded bits into (..., T) int32 symbols."""
    n = code.n_out
    weights = torch.tensor([1 << (n - 1 - j) for j in range(n)], dtype=torch.int32,
                           device=coded_bits.device)
    return (coded_bits.to(torch.int32) * weights).sum(-1).to(torch.int32)


def unpack_symbols(code: ConvCode, symbols: torch.Tensor) -> torch.Tensor:
    """Unpack (..., T) int32 symbols into (..., T, n_out) bits."""
    n = code.n_out
    shifts = torch.tensor([n - 1 - j for j in range(n)], dtype=torch.int32,
                          device=symbols.device)
    return (symbols.to(torch.int32)[..., None] >> shifts) & 1
