"""Forward ACS scans: the CUDA kernels and their plain PyTorch version.

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
for the design: every entry runs on the distinct weight rows of
:func:`row_operands`); on a CPU tensor it runs ``_scan_plain``, which follows
the Pallas body step by step on the same operands.

Weights that a decode builds from host arrays (a metric plan's folded
weights, the bm-table one-hots) come from :func:`device_weights`: uploaded
once per (values, device), with their row operands derived on the host as
they are uploaded, so no decode copies weights back from the card.

Layouts (the reference's user layout, no transposes): data (B, T, F), pm0
and final_pm (B, S), lo and hi (B,) int32, packed (W, B, S) int32 words
holding the uint32 bits, unpacked selects (T, B, S) int32.
"""
from __future__ import annotations

import ctypes
import functools
import weakref
from collections import Counter
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core.trellis import NEG_UNREACHABLE, ConvCode
from repro_torch.kernels import _build
from repro_torch.kernels.common import (
    PACK_BITS, distinct_rows, launch_counts, launch_guard, plain_counts, route)
from repro_torch.kernels.survivors import pack_survivors
from repro_torch.roofline import op_cost

#: Largest trellis the kernels take (up to 1024 threads a stream, at most 8
#: states a thread).
MAX_STATES = 4096

NAME = "viterbi_scan_packed"
CARRY_NAME = "viterbi_scan_packed_carry"
WINDOW_NAME = "viterbi_scan_packed_window"
UNPACKED_CARRY_NAME = "viterbi_scan_carry"
UNPACKED_NAME = "viterbi_scan"

Window = Optional[Tuple[torch.Tensor, torch.Tensor]]


def _table_arrays(code: ConvCode):
    OH0, OH1 = code.branch_onehot_pair
    return OH0, OH1, np.zeros((code.n_states, 2), dtype=np.float32)


def table_weights(code: ConvCode, device="cpu") -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Weights that make the scan consume precomputed bm tables: the branch
    one-hots select bm[c] per transition, bias contributes 0."""
    return tuple(torch.tensor(a, device=device) for a in _table_arrays(code))


def cached_table_weights(code: ConvCode, device):
    """``table_weights`` on ``device`` through :func:`device_weights`: the same
    tensors every call, their row operands derived on the host (the stream
    chunk ops call it once a chunk)."""
    return device_weights(*_table_arrays(code), device)


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
#: (device, shape, bytes of b0, b1, rb) -> the weight tensors of device_weights
_WEIGHTS: dict = {}
#: row-operand builds: "host" from host arrays as device_weights uploads them,
#: "copy" from weight tensors read back by row_operands (a device->host copy
#: when they lie on the card)
row_builds: Counter = Counter()


def _version(t: torch.Tensor) -> int:
    try:
        return t._version
    except RuntimeError:  # inference tensors keep no version counter
        return -1


def _key(weights) -> tuple:
    return tuple((id(t), _version(t)) for t in weights)


def _remember(weights, b0: np.ndarray, b1: np.ndarray, rb: np.ndarray):
    """Derive the row operands of host arrays ``b0, b1, rb``, put them on the
    device of ``weights`` (the same values as tensors) and keep them for
    :func:`row_operands`."""
    rows, maps = distinct_rows(*(np.concatenate([b, rb[:, j:j + 1]], axis=1)
                                 for j, b in enumerate((b0, b1))))
    dev = weights[0].device
    out = (torch.from_numpy(rows).to(dev), torch.from_numpy(np.stack(maps, axis=1)).to(dev))
    key = _key(weights)
    _ROWS[key] = (tuple(weakref.ref(t) for t in weights), out)
    weakref.finalize(weights[0], _ROWS.pop, key, None)
    return out


def row_operands(b0: torch.Tensor, b1: torch.Tensor, rb: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The chain kernel's form of (S, F) weights ``b0``, ``b1`` and (S, 2)
    bias ``rb``: the (R, F + 1) float32 distinct rows (weights, bias) of
    ``(b0, rb[:, 0])`` and ``(b1, rb[:, 1])`` in order of first appearance,
    and the (S, 2) int32 map with ``rows[maps[:, j], :F] == b_j`` and
    ``rows[maps[:, j], F] == rb[:, j]`` bit for bit.  R = M for folded and
    table weights, at most 2S for any.  On the weights' device; built once
    per weight tensor (again when one is modified in place) by copying the
    weights to the host, except for the tensors of :func:`device_weights`,
    whose rows were derived from its host arrays."""
    hit = _ROWS.get(_key((b0, b1, rb)))
    if hit is not None and all(ref() is t for ref, t in zip(hit[0], (b0, b1, rb))):
        return hit[1]
    row_builds["copy"] += 1
    # a cache miss (counted in row_builds) copies the weights to the host
    # once; device_weights' tensors never take this copy
    host = [t.detach().cpu().numpy() for t in (b0, b1, rb)]  # repr-lint: allow[RPR003]
    return _remember((b0, b1, rb), *host)


def device_weights(b0: np.ndarray, b1: np.ndarray, rb: np.ndarray, device
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Host weights ``b0``, ``b1`` (S, F) and bias ``rb`` (S, 2) as float32
    tensors on ``device``, uploaded once per (values, device): every call with
    equal values returns the same tensors, whose row operands
    (:func:`row_operands`) were derived from the host arrays on the first, so
    they never come back from the device.  The tensors are shared: do not
    modify them in place."""
    arrays = tuple(np.ascontiguousarray(a, dtype=np.float32) for a in (b0, b1, rb))
    dev = torch.device(device)
    key = (dev, arrays[0].shape) + tuple(a.tobytes() for a in arrays)
    hit = _WEIGHTS.get(key)
    if hit is None:
        hit = tuple(torch.tensor(a, device=dev) for a in arrays)
        _remember(hit, *arrays)
        row_builds["host"] += 1
        _WEIGHTS[key] = hit
    return hit


@functools.lru_cache(maxsize=None)
def _launcher(symbol: str, n_ptr: int, n_int: int):
    """The C entry point ``symbol`` of the built library, typed: ``n_ptr``
    pointers, then ``n_int`` ints (B, T, F, S, R) and the stream."""
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
          pack: bool = True, steps: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Validate, then launch the kernel (CUDA tensors), run the plain
    version (CPU tensors) or return empty outputs (meta tensors), counting
    which one ran under ``name`` and recording the kernel's cost
    (``steps``: the lane-steps inside the windows, when the caller knows
    them)."""
    _check(name, code, pm0, data, b0, b1, rb, window)
    operands = (data, b0, b1, rb) + (() if pm0 is None else (pm0,)) + (window or ())
    where = route(name, operands)
    B, T, F = data.shape
    S = code.n_states
    with op_cost.kernel(name, op_cost.scan_cost, B, T, F, S, code.n_symbols,
                        seeded=pm0 is not None, packed=pack, window=window is not None,
                        steps=steps):
        if where == "cpu":
            plain_counts[name] += 1
            return _scan_plain(code, pm0, data, b0, b1, rb, window, pack)
        final_pm = torch.empty((B, S), dtype=torch.float32, device=data.device)
        rows = -(-T // PACK_BITS) if pack else T
        survivors = torch.empty((rows, B, S), dtype=torch.int32, device=data.device)
        if where == "meta":
            return final_pm, survivors
        table, maps = row_operands(b0, b1, rb)  # the distinct weight rows
        inputs = tuple(t for t in (pm0, data, table, maps, *(window or ())) if t is not None)
        ints = (B, T, F, S, table.shape[0])
        ptrs = [t.data_ptr() for t in inputs] + [final_pm.data_ptr(), survivors.data_ptr()]
        lib, fn = _launcher(f"{name}_launch", len(ptrs), len(ints))
        with launch_guard(data):
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
    steps: Optional[int] = None,
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
      steps: the sum of ``hi - lo`` over the lanes (clamped at 0), when the
        caller knows it on the host — the work the cost counter records;
        None counts every lane-step.
    Returns: final_pm (B, S) float32; packed (ceil(T/32), B, S) int32.
    """
    return _scan(WINDOW_NAME, code, pm0, data, b0, b1, rb, window=(lo, hi), steps=steps)


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
