"""Full-sequence packed Viterbi forward pass: a CUDA kernel and its plain
PyTorch version.

``viterbi_scan_packed`` runs all T add-compare-select steps of B streams
with the path metrics resident on chip, computes each step's branch metrics
from a per-step input of F values through ``(S, F)`` weights, and emits the
select bits packed 32 steps per word.  With the branch one-hots as weights
(``table_weights``) and F = M the input is a precomputed bm table; with the
folded weights of kernels/metrics.py and F = n (2n punctured-hard) it is the
raw received symbols.

On a CUDA tensor the wrapper launches ``csrc/viterbi_scan.cu`` (see its
header for the design); on a CPU tensor it runs ``viterbi_scan_packed_plain``,
which follows the Pallas body step by step on the same operands.

Layouts (the reference's user layout, no transposes): data (B, T, F),
final_pm (B, S), packed (W, B, S) int32 words holding the uint32 bits.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from repro_torch.core.trellis import NEG_UNREACHABLE, ConvCode
from repro_torch.kernels import _build
from repro_torch.kernels.common import PACK_BITS, launch_counts, on_card, plain_counts
from repro_torch.kernels.survivors import pack_survivors

#: Largest trellis the kernel takes (256 threads x 16 states each).
MAX_STATES = 4096

NAME = "viterbi_scan_packed"


def table_weights(code: ConvCode, device="cpu") -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Weights that make the scan consume precomputed bm tables: the branch
    one-hots select bm[c] per transition, bias contributes 0."""
    OH0, OH1 = code.branch_onehot_pair
    rb = torch.zeros((code.n_states, 2), dtype=torch.float32, device=device)
    return torch.tensor(OH0, device=device), torch.tensor(OH1, device=device), rb


def viterbi_scan_packed_plain(
    code: ConvCode, data: torch.Tensor, b0: torch.Tensor, b1: torch.Tensor, rb: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The scan in plain PyTorch, step for step as the Pallas body
    (viterbi_scan.py:_make_scan_kernel) and in the kernel's float order."""
    B, T, F = data.shape
    S = code.n_states
    dev = data.device
    pm = torch.full((B, S), NEG_UNREACHABLE, dtype=torch.float32, device=dev)
    pm[:, 0] = 0.0  # paths start in state 0
    big = torch.tensor(NEG_UNREACHABLE, dtype=torch.float32, device=dev)
    selects = torch.empty((T, B, S), dtype=torch.bool, device=dev)
    for t in range(T):
        x = data[:, t, :]  # (B, F)
        m0 = torch.zeros((B, S), dtype=torch.float32, device=dev)
        m1 = torch.zeros((B, S), dtype=torch.float32, device=dev)
        for f in range(F):
            m0 = m0 + b0[:, f] * x[:, f:f + 1]
            m1 = m1 + b1[:, f] * x[:, f:f + 1]
        pm2 = pm.reshape(B, S // 2, 2)  # pm2[:, v, j] = pm[:, 2v+j]
        p0 = pm2[..., 0].repeat(1, 2)  # predecessor 2v of s' = u*S/2 + v
        p1 = pm2[..., 1].repeat(1, 2)
        c0 = (p0 + m0) + rb[:, 0]
        c1 = (p1 + m1) + rb[:, 1]
        take1 = c1 < c0
        pm = torch.minimum(torch.where(take1, c1, c0), big)
        selects[t] = take1
    return pm, pack_survivors(selects)


@functools.lru_cache(maxsize=None)
def _launcher():
    lib = _build.load("viterbi_scan")
    fn = lib.viterbi_scan_packed_launch
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


def _check(code: ConvCode, data, b0, b1, rb) -> None:
    S = code.n_states
    if S > MAX_STATES:
        raise ValueError(f"{NAME}: S={S} exceeds the kernel's {MAX_STATES} states")
    if data.dim() != 3 or data.shape[1] < 1 or data.shape[0] < 1:
        raise ValueError(f"{NAME}: data must be (B, T, F) with B, T >= 1, got {tuple(data.shape)}")
    F = data.shape[2]
    for name, t, shape in (("b0", b0, (S, F)), ("b1", b1, (S, F)), ("rb", rb, (S, 2))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{NAME}: {name} must be {shape}, got {tuple(t.shape)}")
    for name, t in (("data", data), ("b0", b0), ("b1", b1), ("rb", rb)):
        if t.dtype != torch.float32:
            raise TypeError(f"{NAME}: {name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{NAME}: {name} must be contiguous")


def viterbi_scan_packed(
    code: ConvCode, data: torch.Tensor, b0: torch.Tensor, b1: torch.Tensor, rb: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward scan with bit-packed survivors and in-kernel branch metrics.

    Args:
      data: (B, T, F) float32 per-step inputs (bm tables or raw features).
      b0, b1: (S, F) float32 per-parity metric weights.
      rb: (S, 2) float32 per-parity metric bias.
    Returns:
      final_pm: (B, S) float32.
      packed: (ceil(T/32), B, S) int32 — bit p of word w is the ACS select
        of step ``32*w + p`` (tail bits of a partial last word are zero).
    """
    _check(code, data, b0, b1, rb)
    if not on_card(NAME, (data, b0, b1, rb)):
        plain_counts[NAME] += 1
        return viterbi_scan_packed_plain(code, data, b0, b1, rb)
    B, T, F = data.shape
    S = code.n_states
    final_pm = torch.empty((B, S), dtype=torch.float32, device=data.device)
    packed = torch.empty((-(-T // PACK_BITS), B, S), dtype=torch.int32, device=data.device)
    lib, fn = _launcher()
    err = fn(data.data_ptr(), b0.data_ptr(), b1.data_ptr(), rb.data_ptr(),
             final_pm.data_ptr(), packed.data_ptr(), B, T, F, S,
             torch.cuda.current_stream(data.device).cuda_stream)
    _build.raise_on_error(lib, "viterbi_scan_error_string", NAME, err)
    launch_counts[NAME] += 1
    return final_pm, packed
