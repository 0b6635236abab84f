"""Bit-packed survivor memory: pack/unpack helpers + the traceback kernel.

  pack_survivors / unpack_survivors
      (T, ...) {0,1} backpointer parities <-> (ceil(T/32), ...) int32 words,
      32 steps per word along time (bit p of word w = step 32*w + p; tail
      bits of a partial last word are zero).  The words hold uint32 bits in
      int32 storage; ``(w >> p) & 1`` reads a bit correctly under the
      arithmetic shift.  Plain PyTorch, layout-agnostic over the trailing axes.

  traceback_packed
      Walks the packed words of ``viterbi_scan_packed`` from each stream's
      final state back to step 0 and writes the decoded (B, T) bits.  On a
      CUDA tensor it launches ``csrc/survivors.cu``; on a CPU tensor it runs
      ``traceback_packed_plain``, the same walk in plain PyTorch.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.trellis import ConvCode
from repro_torch.kernels import _build
from repro_torch.kernels.common import PACK_BITS, launch_counts, on_card, plain_counts

NAME = "traceback_packed"


def n_words(T: int) -> int:
    """Packed words needed for T trellis steps."""
    return -(-T // PACK_BITS)


def pack_survivors(bps: torch.Tensor) -> torch.Tensor:
    """Pack {0,1} survivor parities 32-per-word along the leading (time) axis.

    Args:
      bps: (T, ...) integer 0/1 backpointer parities (any trailing layout).
    Returns:
      (ceil(T/32), ...) int32; bit p of word w is step ``32*w + p``.
    """
    words = torch.zeros((n_words(bps.shape[0]),) + tuple(bps.shape[1:]), dtype=torch.int64,
                        device=bps.device)
    for p in range(PACK_BITS):
        steps = bps[p::PACK_BITS].to(torch.int64)  # steps 32*w + p, w = 0, 1, ...
        words[: steps.shape[0]] |= steps << p
    return torch.where(words >= 2 ** 31, words - 2 ** 32, words).to(torch.int32)


def unpack_survivors(packed: torch.Tensor, T: int) -> torch.Tensor:
    """Inverse of :func:`pack_survivors`: (W, ...) int32 -> (T, ...) int32."""
    shifts = torch.arange(PACK_BITS, dtype=torch.int32, device=packed.device).reshape(
        (1, PACK_BITS) + (1,) * (packed.dim() - 1))
    bits = (packed[:, None] >> shifts) & 1
    return bits.reshape((packed.shape[0] * PACK_BITS,) + tuple(packed.shape[1:]))[:T]


def traceback_packed_plain(
    code: ConvCode, packed: torch.Tensor, final_state: torch.Tensor, T: int
) -> torch.Tensor:
    """The traceback walk in plain PyTorch (survivors.py:_make_traceback_kernel):
    per step emit ``u = s >> (K-2)``, then ``s = 2(s & (S/2-1)) + bit``."""
    K, S = code.constraint, code.n_states
    B = packed.shape[1]
    s = final_state.to(torch.int64) & (S - 1)
    rows = torch.arange(B, device=packed.device)
    bits = torch.empty((B, T), dtype=torch.int32, device=packed.device)
    for t in range(T - 1, -1, -1):
        word = packed[t // PACK_BITS, rows, s]
        bit = (word >> (t % PACK_BITS)) & 1
        bits[:, t] = (s >> (K - 2)).to(torch.int32)
        s = 2 * (s & (S // 2 - 1)) + bit.to(torch.int64)
    return bits


@functools.lru_cache(maxsize=None)
def _launcher():
    lib = _build.load("survivors")
    fn = lib.traceback_packed_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


def traceback_packed(
    code: ConvCode, packed: torch.Tensor, final_state: torch.Tensor, T: int
) -> torch.Tensor:
    """Trace back through packed survivors.

    Args:
      packed: (W, B, S) int32 survivor words, W = ceil(T/32).
      final_state: (B,) int32 state each stream starts its walk from.
      T: trellis steps actually encoded (T <= 32*W; tail bits ignored).
    Returns:
      bits: (B, T) int32 decoded input bits.
    """
    S = code.n_states
    if packed.dim() != 3 or packed.shape[2] != S or packed.shape[0] != n_words(T) or T < 1:
        raise ValueError(
            f"{NAME}: packed must be (ceil(T/32), B, {S}) for T={T}, got {tuple(packed.shape)}")
    B = packed.shape[1]
    if tuple(final_state.shape) != (B,):
        raise ValueError(f"{NAME}: final_state must be ({B},), got {tuple(final_state.shape)}")
    for name, t in (("packed", packed), ("final_state", final_state)):
        if t.dtype != torch.int32:
            raise TypeError(f"{NAME}: {name} must be int32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{NAME}: {name} must be contiguous")
    if not on_card(NAME, (packed, final_state)):
        plain_counts[NAME] += 1
        return traceback_packed_plain(code, packed, final_state, T)
    bits = torch.empty((B, T), dtype=torch.int32, device=packed.device)
    lib, fn = _launcher()
    err = fn(packed.data_ptr(), final_state.data_ptr(), bits.data_ptr(),
             B, T, S, code.constraint, torch.cuda.current_stream(packed.device).cuda_stream)
    _build.raise_on_error(lib, "survivors_error_string", NAME, err)
    launch_counts[NAME] += 1
    return bits
