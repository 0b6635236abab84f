"""Token <-> bitstream packing for the serving pipeline.

The serving scenario treats LM output as a bitstream to be channel-coded:
tokens are unpacked MSB-first into bits, pushed through a codec from
``repro_torch.decode`` / ``repro_torch.siso``, and re-packed after decoding.
Both directions are shifts and a sum: CUDA has no integer matmul, so the
reference's integer einsum has no direct counterpart on the card.
"""
from __future__ import annotations

import torch


def _msb_first_shifts(bits_per_token: int, device) -> torch.Tensor:
    return torch.arange(bits_per_token - 1, -1, -1, device=device)


def tokens_to_bits(tokens: torch.Tensor, bits_per_token: int) -> torch.Tensor:
    """(B, T) integer tokens -> (B, T*bits) {0,1} int32, MSB-first — LM
    output as a bitstream."""
    bits = (tokens[..., None] >> _msb_first_shifts(bits_per_token, tokens.device)) & 1
    return bits.reshape(tokens.shape[0], -1).to(torch.int32)


def bits_to_tokens(bits: torch.Tensor, bits_per_token: int) -> torch.Tensor:
    """(B, T*bits) {0,1} MSB-first -> (B, T) int32 tokens."""
    B, n = bits.shape
    bits = bits.reshape(B, n // bits_per_token, bits_per_token).to(torch.int64)
    return (bits << _msb_first_shifts(bits_per_token, bits.device)).sum(-1).to(torch.int32)
