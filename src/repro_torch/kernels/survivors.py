"""Bit-packed survivor memory: pack/unpack helpers + the traceback kernel.

  pack_survivors / unpack_survivors
      (T, ...) {0,1} backpointer parities <-> (ceil(T/32), ...) int32 words,
      32 steps per word along time (bit p of word w = step 32*w + p; tail
      bits of a partial last word are zero).  The words hold uint32 bits in
      int32 storage; ``(w >> p) & 1`` reads a bit correctly under the
      arithmetic shift.  Plain PyTorch, layout-agnostic over the trailing axes.

  traceback_packed
      Walks the packed words of ``viterbi_scan_packed`` from each stream's
      final state back to step 0 and writes the decoded (B, T) bits.

  traceback_packed_window
      The same walk restricted to a per-lane step window [lo, hi): outside
      it the state passes through unchanged and the emitted bit is 0.  Also
      returns the state each lane holds after the walk — its state at step
      ``lo``, i.e. a time tile's *entry* state, which the tiled decoder
      chains exit -> entry across tile seams.

On a CUDA tensor each traceback launches its kernel in ``csrc/survivors.cu``;
on a CPU tensor it runs its ``*_plain`` version, the same walk in plain
PyTorch.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.trellis import ConvCode
from repro_torch.kernels import _build
from repro_torch.kernels.common import PACK_BITS, launch_counts, on_card, plain_counts

NAME = "traceback_packed"
WINDOW_NAME = "traceback_packed_window"


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


def traceback_packed_window_plain(
    code: ConvCode, packed: torch.Tensor, final_state: torch.Tensor, lo: torch.Tensor,
    hi: torch.Tensor,
):
    """The windowed walk in plain PyTorch
    (survivors.py:_make_traceback_window_kernel): over all 32W steps, a step
    t is taken only where lo <= t < hi."""
    K, S = code.constraint, code.n_states
    W, B = packed.shape[:2]
    s = final_state.to(torch.int64) & (S - 1)
    rows = torch.arange(B, device=packed.device)
    bits = torch.empty((B, W * PACK_BITS), dtype=torch.int32, device=packed.device)
    for t in range(W * PACK_BITS - 1, -1, -1):
        valid = (t >= lo) & (t < hi)
        word = packed[t // PACK_BITS, rows, s]
        bit = (word >> (t % PACK_BITS)) & 1
        bits[:, t] = torch.where(valid, s >> (K - 2), 0).to(torch.int32)
        s = torch.where(valid, 2 * (s & (S // 2 - 1)) + bit.to(torch.int64), s)
    return bits, s.to(torch.int32)


@functools.lru_cache(maxsize=None)
def _launcher(symbol: str, n_ptr: int):
    lib = _build.load("survivors")
    fn = getattr(lib, symbol)
    fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


def _check_int32(name: str, operands) -> None:
    for what, t in operands:
        if t.dtype != torch.int32:
            raise TypeError(f"{name}: {what} must be int32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {what} must be contiguous")


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
    _check_int32(NAME, (("packed", packed), ("final_state", final_state)))
    if not on_card(NAME, (packed, final_state)):
        plain_counts[NAME] += 1
        return traceback_packed_plain(code, packed, final_state, T)
    bits = torch.empty((B, T), dtype=torch.int32, device=packed.device)
    lib, fn = _launcher("traceback_packed_launch", 3)
    err = fn(packed.data_ptr(), final_state.data_ptr(), bits.data_ptr(),
             B, T, S, code.constraint, torch.cuda.current_stream(packed.device).cuda_stream)
    _build.raise_on_error(lib, "survivors_error_string", NAME, err)
    launch_counts[NAME] += 1
    return bits


def traceback_packed_window(
    code: ConvCode, packed: torch.Tensor, final_state: torch.Tensor, lo: torch.Tensor,
    hi: torch.Tensor,
):
    """Windowed traceback: walk packed survivors through per-lane [lo, hi).

    Args:
      packed: (W, B, S) int32 survivor words.
      final_state: (B,) int32 state each lane starts walking from (its state
        at step ``hi``).
      lo, hi: (B,) int32 per-lane walk windows; steps outside emit bit 0 and
        leave the state untouched.
    Returns:
      bits: (B, 32*W) int32 decoded bits (0 outside the window).
      entry_state: (B,) int32 the state each lane reached at step ``lo`` —
      for a time tile, the state on the seam with the previous tile.
    """
    S = code.n_states
    if packed.dim() != 3 or packed.shape[2] != S or packed.shape[0] < 1:
        raise ValueError(f"{WINDOW_NAME}: packed must be (W, B, {S}), got {tuple(packed.shape)}")
    W, B = packed.shape[:2]
    for what, t in (("final_state", final_state), ("lo", lo), ("hi", hi)):
        if tuple(t.shape) != (B,):
            raise ValueError(f"{WINDOW_NAME}: {what} must be ({B},), got {tuple(t.shape)}")
    _check_int32(WINDOW_NAME, (("packed", packed), ("final_state", final_state), ("lo", lo),
                               ("hi", hi)))
    if not on_card(WINDOW_NAME, (packed, final_state, lo, hi)):
        plain_counts[WINDOW_NAME] += 1
        return traceback_packed_window_plain(code, packed, final_state, lo, hi)
    bits = torch.empty((B, W * PACK_BITS), dtype=torch.int32, device=packed.device)
    entry = torch.empty((B,), dtype=torch.int32, device=packed.device)
    lib, fn = _launcher("traceback_packed_window_launch", 6)
    err = fn(packed.data_ptr(), final_state.data_ptr(), lo.data_ptr(), hi.data_ptr(),
             bits.data_ptr(), entry.data_ptr(), B, W, S, code.constraint,
             torch.cuda.current_stream(packed.device).cuda_stream)
    _build.raise_on_error(lib, "survivors_error_string", WINDOW_NAME, err)
    launch_counts[WINDOW_NAME] += 1
    return bits, entry
