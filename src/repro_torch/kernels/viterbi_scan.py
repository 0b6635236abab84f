"""Forward ACS scans: one CUDA kernel template and its plain PyTorch version.

Five variants of one scan, each a TPU kernel of the reference
(``_make_scan_kernel(carry, pack, windowed)``) and each its own name in
``launch_counts`` / ``plain_counts``:

  viterbi_scan_packed         from state 0, select bits packed 32 steps per
                              word — the short-block decode path
  viterbi_scan_packed_carry   the same seeded from carried metrics ``pm0`` —
                              the packed streaming session's chunk scan
  viterbi_scan_packed_window  seeded, with a per-lane ``[lo, hi)`` step window
                              (outside it the metrics pass through untouched
                              and the select bit is 0) — both tiled passes
  viterbi_scan_carry          seeded, bm tables in, one int32 select per
                              (step, lane, state) — the ``streaming`` chunk op
  viterbi_scan                from state 0, bm tables in, one int32 select
                              per (step, lane, state) — the ``fused`` backend

Each step computes its branch metrics from a per-step input of F values
through ``(S, F)`` weights.  With the branch one-hots as weights
(``table_weights``) and F = M the input is a precomputed bm table; with the
folded weights of kernels/metrics.py and F = n (2n punctured-hard) it is the
raw received symbols.

On a CUDA tensor a wrapper launches ``csrc/viterbi_scan.cu`` (see its header
for the two designs: the carried chunk scans run the chain kernel, on the
distinct weight rows of :func:`row_operands`; the others the block kernel);
on a CPU tensor it runs ``_scan_plain``, which follows the Pallas body step
by step on the same operands.

Layouts (the reference's user layout, no transposes): data (B, T, F), pm0
and final_pm (B, S), lo and hi (B,) int32, packed (W, B, S) int32 words
holding the uint32 bits, unpacked selects (T, B, S) int32.
"""
from __future__ import annotations

import ctypes
import functools
import weakref
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core.trellis import NEG_UNREACHABLE, ConvCode
from repro_torch.kernels import _build
from repro_torch.kernels.common import (
    PACK_BITS, distinct_rows, launch_counts, on_card, plain_counts)
from repro_torch.kernels.survivors import pack_survivors

#: Largest trellis the kernels take (block design: 256 threads x 16 states;
#: chain design: 512 threads x 8 states).
MAX_STATES = 4096

NAME = "viterbi_scan_packed"
CARRY_NAME = "viterbi_scan_packed_carry"
WINDOW_NAME = "viterbi_scan_packed_window"
UNPACKED_CARRY_NAME = "viterbi_scan_carry"
UNPACKED_NAME = "viterbi_scan"

Window = Optional[Tuple[torch.Tensor, torch.Tensor]]


def table_weights(code: ConvCode, device="cpu") -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Weights that make the scan consume precomputed bm tables: the branch
    one-hots select bm[c] per transition, bias contributes 0."""
    OH0, OH1 = code.branch_onehot_pair
    rb = torch.zeros((code.n_states, 2), dtype=torch.float32, device=device)
    return torch.tensor(OH0, device=device), torch.tensor(OH1, device=device), rb


@functools.lru_cache(maxsize=None)
def cached_table_weights(code: ConvCode, device: torch.device):
    """``table_weights`` uploaded once per (code, device): the stream chunk ops
    run once per chunk and would otherwise copy them to the card, and derive
    their distinct rows (:func:`row_operands`), each time."""
    return table_weights(code, device)


def _scan_plain(
    code: ConvCode, pm0: Optional[torch.Tensor], data: torch.Tensor, b0: torch.Tensor,
    b1: torch.Tensor, rb: torch.Tensor, window: Window = None, pack: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every scan variant in plain PyTorch, step for step as the Pallas body
    (viterbi_scan.py:_make_scan_kernel) and in the kernel's float order."""
    B, T, F = data.shape
    S = code.n_states
    dev = data.device
    if pm0 is None:
        pm = torch.full((B, S), NEG_UNREACHABLE, dtype=torch.float32, device=dev)
        pm[:, 0] = 0.0  # paths start in state 0
    else:
        pm = pm0
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
        new_pm = torch.minimum(torch.where(take1, c1, c0), big)
        if window is not None:
            # outside a lane's [lo, hi) the metrics pass through untouched
            # (unclamped) and the select bit is 0
            lo, hi = window
            valid = ((t >= lo) & (t < hi))[:, None]
            take1 = take1 & valid
            new_pm = torch.where(valid, new_pm, pm)
        pm = new_pm
        selects[t] = take1
    return pm, (pack_survivors(selects) if pack else selects.to(torch.int32))


def viterbi_scan_packed_plain(
    code: ConvCode, data: torch.Tensor, b0: torch.Tensor, b1: torch.Tensor, rb: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`viterbi_scan_packed`."""
    return _scan_plain(code, None, data, b0, b1, rb)


def viterbi_scan_packed_carry_plain(
    code: ConvCode, pm0: torch.Tensor, data: torch.Tensor, b0: torch.Tensor,
    b1: torch.Tensor, rb: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`viterbi_scan_packed_carry`."""
    return _scan_plain(code, pm0, data, b0, b1, rb)


def viterbi_scan_packed_window_plain(
    code: ConvCode, pm0: torch.Tensor, data: torch.Tensor, b0: torch.Tensor,
    b1: torch.Tensor, rb: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`viterbi_scan_packed_window`."""
    return _scan_plain(code, pm0, data, b0, b1, rb, window=(lo, hi))


def viterbi_scan_plain(code: ConvCode, bm_tables: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`viterbi_scan`."""
    b0, b1, rb = cached_table_weights(code, bm_tables.device)
    return _scan_plain(code, None, bm_tables, b0, b1, rb, pack=False)


def viterbi_scan_carry_plain(
    code: ConvCode, pm0: torch.Tensor, bm_tables: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`viterbi_scan_carry`."""
    b0, b1, rb = cached_table_weights(code, bm_tables.device)
    return _scan_plain(code, pm0, bm_tables, b0, b1, rb, pack=False)


#: (id, version) of each weight tensor -> (weak references, row operands)
_ROWS: dict = {}


def _version(t: torch.Tensor) -> int:
    try:
        return t._version
    except RuntimeError:  # inference tensors keep no version counter
        return -1


def row_operands(b0: torch.Tensor, b1: torch.Tensor, rb: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The chain kernel's form of (S, F) weights ``b0``, ``b1`` and (S, 2)
    bias ``rb``: the (R, F + 1) float32 distinct rows (weights, bias) of
    ``(b0, rb[:, 0])`` and ``(b1, rb[:, 1])`` in order of first appearance,
    and the (S, 2) int32 map with ``rows[maps[:, j], :F] == b_j`` and
    ``rows[maps[:, j], F] == rb[:, j]`` bit for bit.  R = M for folded and
    table weights, at most 2S for any.  On the weights' device; built once
    per weight tensor (again when one is modified in place)."""
    key = tuple((id(t), _version(t)) for t in (b0, b1, rb))
    hit = _ROWS.get(key)
    if hit is not None and all(ref() is t for ref, t in zip(hit[0], (b0, b1, rb))):
        return hit[1]
    bias = rb.detach().cpu().numpy()
    rows, maps = distinct_rows(*(
        np.concatenate([b.detach().cpu().numpy(), bias[:, j:j + 1]], axis=1)
        for j, b in enumerate((b0, b1))))
    out = (torch.from_numpy(rows).to(b0.device),
           torch.from_numpy(np.stack(maps, axis=1)).to(b0.device))
    _ROWS[key] = (tuple(weakref.ref(t) for t in (b0, b1, rb)), out)
    weakref.finalize(b0, _ROWS.pop, key, None)
    return out


@functools.lru_cache(maxsize=None)
def _launcher(symbol: str, n_ptr: int, n_int: int):
    """The C entry point ``symbol`` of the built library, typed: ``n_ptr``
    pointers, then ``n_int`` ints (B, T, F, S and, for the chain kernel, R)
    and the stream."""
    lib = _build.load("viterbi_scan")
    fn = getattr(lib, symbol)
    fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


def _check(name: str, code: ConvCode, pm0, data, b0, b1, rb, window: Window) -> None:
    S = code.n_states
    if S > MAX_STATES:
        raise ValueError(f"{name}: S={S} exceeds the kernel's {MAX_STATES} states")
    if data.dim() != 3 or data.shape[1] < 1 or data.shape[0] < 1:
        raise ValueError(f"{name}: data must be (B, T, F) with B, T >= 1, got {tuple(data.shape)}")
    B, _, F = data.shape
    f32, i32 = torch.float32, torch.int32
    operands = [("data", data, None, f32), ("b0", b0, (S, F), f32), ("b1", b1, (S, F), f32),
                ("rb", rb, (S, 2), f32)]
    if pm0 is not None:
        operands.append(("pm0", pm0, (B, S), f32))
    if window is not None:
        operands += [("lo", window[0], (B,), i32), ("hi", window[1], (B,), i32)]
    for what, t, shape, dtype in operands:
        if shape is not None and tuple(t.shape) != shape:
            raise ValueError(f"{name}: {what} must be {shape}, got {tuple(t.shape)}")
        if t.dtype != dtype:
            raise TypeError(f"{name}: {what} must be {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {what} must be contiguous")


def _scan(name: str, code: ConvCode, pm0, data, b0, b1, rb, window: Window = None,
          pack: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """Validate, then launch the kernel (CUDA tensors) or run the plain
    version (CPU tensors), counting which one ran under ``name``."""
    _check(name, code, pm0, data, b0, b1, rb, window)
    operands = (data, b0, b1, rb) + (() if pm0 is None else (pm0,)) + (window or ())
    if not on_card(name, operands):
        plain_counts[name] += 1
        return _scan_plain(code, pm0, data, b0, b1, rb, window, pack)
    B, T, F = data.shape
    S = code.n_states
    final_pm = torch.empty((B, S), dtype=torch.float32, device=data.device)
    rows = -(-T // PACK_BITS) if pack else T
    survivors = torch.empty((rows, B, S), dtype=torch.int32, device=data.device)
    if pm0 is not None and window is None:  # the carried chunk scans: the chain kernel
        table, maps = row_operands(b0, b1, rb)
        inputs, ints = (pm0, data, table, maps), (B, T, F, S, table.shape[0])
    else:
        inputs = tuple(t for t in (pm0, data, b0, b1, rb, *(window or ())) if t is not None)
        ints = (B, T, F, S)
    ptrs = [t.data_ptr() for t in inputs] + [final_pm.data_ptr(), survivors.data_ptr()]
    lib, fn = _launcher(f"{name}_launch", len(ptrs), len(ints))
    err = fn(*ptrs, *ints, torch.cuda.current_stream(data.device).cuda_stream)
    _build.raise_on_error(lib, "viterbi_scan_error_string", name, err)
    launch_counts[name] += 1
    return final_pm, survivors


def viterbi_scan_packed(
    code: ConvCode, data: torch.Tensor, b0: torch.Tensor, b1: torch.Tensor, rb: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward scan from state 0 with bit-packed survivors and in-kernel
    branch metrics.

    Args:
      data: (B, T, F) float32 per-step inputs (bm tables or raw features).
      b0, b1: (S, F) float32 per-parity metric weights.
      rb: (S, 2) float32 per-parity metric bias.
    Returns:
      final_pm: (B, S) float32.
      packed: (ceil(T/32), B, S) int32 — bit p of word w is the ACS select
        of step ``32*w + p`` (tail bits of a partial last word are zero).
    """
    return _scan(NAME, code, None, data, b0, b1, rb)


def viterbi_scan_packed_carry(
    code: ConvCode, pm0: torch.Tensor, data: torch.Tensor, b0: torch.Tensor,
    b1: torch.Tensor, rb: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`viterbi_scan_packed` seeded from carried path metrics — the
    packed streaming hot path (pm0: (B, S) float32 entering the chunk)."""
    return _scan(CARRY_NAME, code, pm0, data, b0, b1, rb)


def viterbi_scan_packed_window(
    code: ConvCode, pm0: torch.Tensor, data: torch.Tensor, b0: torch.Tensor,
    b1: torch.Tensor, rb: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`viterbi_scan_packed_carry` with a per-lane step-validity window
    — the tiled-decode launch (P time-tiles folded onto the lane axis, each
    lane's tile covering a different slice of the sequence).

    Args:
      pm0: (B, S) float32 metrics entering each lane's window (held
        untouched through any leading invalid steps).
      lo, hi: (B,) int32 — lane b runs ACS only on steps lo[b] <= t < hi[b]
        of this launch; elsewhere the metrics pass through and the survivor
        bit is 0.
    Returns: final_pm (B, S) float32; packed (ceil(T/32), B, S) int32.
    """
    return _scan(WINDOW_NAME, code, pm0, data, b0, b1, rb, window=(lo, hi))


def viterbi_scan_carry(
    code: ConvCode, pm0: torch.Tensor, bm_tables: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked ACS scan with carried state and unpacked survivors: run C
    steps of bm tables starting from ``pm0`` — the ``streaming`` backend's
    chunk scan.

    Args:
      pm0: (B, S) float32 path metrics entering the chunk.
      bm_tables: (B, C, M) float32 branch-metric tables.
    Returns:
      final_pm: (B, S) float32; bps: (C, B, S) int32 backpointer parities.
    """
    b0, b1, rb = cached_table_weights(code, bm_tables.device)
    return _scan(UNPACKED_CARRY_NAME, code, pm0, bm_tables, b0, b1, rb, pack=False)


def viterbi_scan(code: ConvCode, bm_tables: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward scan from state 0 over precomputed bm tables with unpacked
    survivors — the ``fused`` backend's scan.

    Args:
      bm_tables: (B, T, M) float32 branch-metric tables.
    Returns:
      final_pm: (B, S) float32; bps: (T, B, S) int32 backpointer parities.
    """
    b0, b1, rb = cached_table_weights(code, bm_tables.device)
    return _scan(UNPACKED_NAME, code, None, bm_tables, b0, b1, rb, pack=False)
