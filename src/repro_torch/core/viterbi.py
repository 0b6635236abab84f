"""Viterbi decoders in plain PyTorch: the sequential scan (the oracle every
other path is held against), the block-parallel (min,+) associative scan over
chunk transfer matrices, and the general HMM max-sum Viterbi.

They consume *branch-metric tables* (see channel.py) so that hard and soft
decision decoding share one code path.  Python loops over time of plain
tensor ops: on any device they are chains of library ops, never a kernel of
this package (kernels/ops.viterbi_decode_parallel_op is the block-parallel
decode through the kernels).
"""
from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import torch

from repro_torch.core.acs import acs_step
from repro_torch.core.trellis import NEG_UNREACHABLE, ConvCode


def _initial_pm(code: ConvCode, batch_shape, device="cpu") -> torch.Tensor:
    """Paths start in state 0 (paper §IV-B)."""
    pm0 = torch.full(tuple(batch_shape) + (code.n_states,), NEG_UNREACHABLE,
                     dtype=torch.float32, device=device)
    pm0[..., 0] = 0.0
    return pm0


def _traceback(code: ConvCode, bps: torch.Tensor, final_state: torch.Tensor):
    """Trace back through backpointers.

    Args:
      bps: (T, B, S) int32 backpointer parity bits.
      final_state: (B,) int32.
    Returns:
      bits: (B, T) decoded input bits (u_t = MSB of s_t).
      states: (B, T) the surviving state sequence s_1..s_T.
    """
    K = code.constraint
    half = code.n_states // 2
    T = bps.shape[0]
    s = final_state.to(torch.int64)
    bits, states = [], []
    for t in range(T - 1, -1, -1):
        u = s >> (K - 2)  # input bit that produced s
        v = s & (half - 1)  # 0 when half == 1 (K=2)
        j = torch.gather(bps[t], 1, s[:, None])[:, 0].to(torch.int64)
        bits.append(u)
        states.append(s)
        s = 2 * v + j
    bits_bt = torch.stack(bits[::-1], dim=1).to(torch.int32)
    states_bt = torch.stack(states[::-1], dim=1).to(torch.int32)
    return bits_bt, states_bt


def viterbi_decode(
    code: ConvCode,
    bm_tables: torch.Tensor,
    terminated: bool = True,
    normalize: bool = False,
    unroll: int = 1,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sequential-scan Viterbi decoder (the faithful baseline).

    Args:
      bm_tables: (B, T, n_symbols) float32 branch-metric tables (minimize).
      terminated: trellis ends in state 0 (flush bits appended at encode).
      normalize: subtract each step's per-row minimum from the new path
        metrics (bounds metric growth on very long streams); the returned
        metric is then the normalized one, as the reference's.
      unroll: the reference's scan unroll factor, an int >= 1.  It changes
        nothing here: the loop below is Python, there is no scan to unroll.

    Returns:
      bits: (B, T) decoded input bits (including flush bits if terminated).
      metric: (B,) the winning path metric.
    """
    if isinstance(unroll, bool) or not isinstance(unroll, int) or unroll < 1:
        raise ValueError(f"unroll must be an int >= 1, got {unroll!r}")
    B, T, _ = bm_tables.shape
    bm_tables = bm_tables.to(torch.float32)
    pm = _initial_pm(code, (B,), bm_tables.device)
    bps = []
    for t in range(T):
        pm, bp = acs_step(code, pm, bm_tables[:, t])
        if normalize:
            pm = pm - pm.amin(dim=-1, keepdim=True)
        bps.append(bp)
    if terminated:
        final_state = torch.zeros((B,), dtype=torch.int32, device=pm.device)
        metric = pm[..., 0]
    else:
        final_state = torch.argmin(pm, dim=-1).to(torch.int32)
        metric = pm.min(dim=-1).values
    bits, _ = _traceback(code, torch.stack(bps), final_state)
    return bits, metric


# --------------------------------------------------------------------------- #
# Block-parallel decoder: (min,+) semiring associative scan.                   #
# --------------------------------------------------------------------------- #


def minplus_matmul(A: torch.Tensor, B_: torch.Tensor) -> torch.Tensor:
    """C[i,j] = min_k A[i,k] + B[k,j] over the last two axes (batched), no
    clamp: unreachable entries grow past 1e30 as in the reference."""
    return (A[..., :, :, None] + B_[..., None, :, :]).amin(dim=-2)


def _slice(x: torch.Tensor, axis: int, start, stop=None, step=None) -> torch.Tensor:
    idx = [slice(None)] * x.dim()
    idx[axis] = slice(start, stop, step)
    return x[tuple(idx)]


def _interleave(even: torch.Tensor, odd: torch.Tensor, axis: int) -> torch.Tensor:
    """even[0], odd[0], even[1], ... along ``axis`` (len(even) - len(odd) is
    0 or 1)."""
    shape = list(even.shape)
    shape[axis] += odd.shape[axis]
    out = even.new_empty(shape)
    _slice(out, axis, 0, None, 2).copy_(even)
    _slice(out, axis, 1, None, 2).copy_(odd)
    return out


def _associative_scan(fn: Callable, elems, axis: int = 0):
    """Inclusive scan of ``elems`` along ``axis`` with the associative
    ``fn(a, b)`` — jax.lax.associative_scan's recursion, so every prefix is
    combined in the reference's association order (float sums are not
    associative; the soft metrics depend on it): combine adjacent pairs,
    scan them recursively (the odd prefixes), combine each odd prefix with
    the next element (the even prefixes), interleave.  ``elems`` is one
    tensor, or a tuple of tensors scanned together (``fn`` then takes and
    returns tuples, as the reference's pytree form).  ``fn`` may be called
    on empty slices (two elements leave an empty even combine)."""
    if isinstance(elems, torch.Tensor):
        return _associative_scan(lambda a, b: (fn(a[0], b[0]),), (elems,), axis)[0]
    n = elems[0].shape[axis]
    if n < 2:
        return elems

    def cut(xs, *bounds):
        return tuple(_slice(x, axis, *bounds) for x in xs)

    reduced = fn(cut(elems, 0, -1, 2), cut(elems, 1, None, 2))
    odd = _associative_scan(fn, reduced, axis)
    even = fn(cut(odd, 0, -1) if n % 2 == 0 else odd, cut(elems, 2, None, 2))
    return tuple(_interleave(torch.cat([_slice(e, axis, 0, 1), ev], dim=axis), od, axis)
                 for e, ev, od in zip(elems, even, odd))


def _identity_rows(S: int, device) -> torch.Tensor:
    """(S, S): 0 on the diagonal, NEG_UNREACHABLE off it."""
    eye = torch.eye(S, dtype=torch.bool, device=device)
    return torch.where(eye, 0.0, NEG_UNREACHABLE).to(torch.float32)


def _chunk_transfer_matrices(code: ConvCode, bm_chunks: torch.Tensor) -> torch.Tensor:
    """Transfer matrix of each chunk.

    Args:
      bm_chunks: (B, nc, C, M).
    Returns:
      (B, nc, S, S): entry [i, s] = best metric from state i (chunk entry) to
      state s (chunk exit).
    """
    B, nc, C, M = bm_chunks.shape
    S = code.n_states
    pm = _identity_rows(S, bm_chunks.device).expand(B, nc, S, S)
    for t in range(C):
        # rows are independent initial states: ACS per row, with a broadcast
        # branch-metric table; clamp so BIG never exceeds float range
        bm_t = bm_chunks[:, :, t, None, :].expand(B, nc, S, M)
        new_pm, _ = acs_step(code, pm, bm_t)
        pm = torch.clamp(new_pm, max=NEG_UNREACHABLE)
    return pm


def viterbi_decode_parallel(
    code: ConvCode,
    bm_tables: torch.Tensor,
    chunk: int = 64,
    terminated: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Block-parallel Viterbi: chunk transfer matrices + associative (min,+)
    scan over chunks + per-chunk re-scan for backpointers.

    Matches :func:`viterbi_decode` exactly on the winning metric (hard), and
    on the decoded bits whenever the optimum is unique.

    Args:
      bm_tables: (B, T, n_symbols) float32 branch-metric tables (minimize).
      chunk: steps per chunk; T need not be a multiple (the last chunk's
        transfer matrix covers only its valid steps).
    Returns:
      bits: (B, T); metric: (B,).
    """
    B, T, M = bm_tables.shape
    S = code.n_states
    dev = bm_tables.device
    bm_tables = bm_tables.to(torch.float32)
    pad = (-T) % chunk
    if pad:
        bm_tables = torch.nn.functional.pad(bm_tables, (0, 0, 0, pad))
    Tp = T + pad
    nc = Tp // chunk
    bm_chunks = bm_tables.reshape(B, nc, chunk, M)

    mats = _chunk_transfer_matrices(code, bm_chunks)  # (B, nc, S, S)
    if pad:
        # the padded steps (bm = 0) are NOT identity steps: the last chunk's
        # matrix is recomputed over its valid prefix only
        valid = T - (nc - 1) * chunk
        pm = _identity_rows(S, dev).expand(B, S, S)
        for t in range(chunk):
            bm_t = bm_chunks[:, -1, t, None, :].expand(B, S, M)
            new_pm, _ = acs_step(code, pm, bm_t)
            new_pm = torch.clamp(new_pm, max=NEG_UNREACHABLE)
            pm = new_pm if t < valid else pm
        mats = torch.cat([mats[:, :-1], pm[:, None]], dim=1)

    # log-depth prefix products over chunks
    prefixes = _associative_scan(minplus_matmul, mats, axis=1)  # (B, nc, S, S)
    eye = _identity_rows(S, dev)
    excl = torch.cat([eye.expand(B, 1, S, S), prefixes[:, :-1]], dim=1)  # exclusive
    # boundary path metrics entering each chunk, starting from state 0
    boundary_pm = excl[:, :, 0, :]  # (B, nc, S)

    # re-scan each chunk (all chunks at once) to recover backpointers
    pm = boundary_pm
    bps = []
    for t in range(chunk):
        new_pm, bp = acs_step(code, pm, bm_chunks[:, :, t])
        pm = torch.clamp(new_pm, max=NEG_UNREACHABLE)
        bps.append(bp)
    bps = torch.stack(bps, dim=2)  # (B, nc, chunk, S)
    bps = bps.reshape(B, Tp, S).transpose(0, 1)[:T]  # (T, B, S)

    final_pm = prefixes[:, -1, 0, :]  # (B, S) metrics from state 0 over full T
    if terminated:
        final_state = torch.zeros((B,), dtype=torch.int32, device=dev)
        metric = final_pm[:, 0]
    else:
        final_state = torch.argmin(final_pm, dim=-1).to(torch.int32)
        metric = final_pm.min(dim=-1).values
    bits, _ = _traceback(code, bps, final_state)
    return bits, metric


# --------------------------------------------------------------------------- #
# General HMM max-sum Viterbi (the technique generalized beyond conv codes).   #
# --------------------------------------------------------------------------- #


def hmm_viterbi(
    log_trans: torch.Tensor,
    log_emit: torch.Tensor,
    log_init: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Most-likely state sequence of an HMM (max-sum Viterbi).

    Args:
      log_trans: (S, S) log transition matrix [from, to].
      log_emit: (B, T, S) log emission scores.
      log_init: (S,) log initial distribution (default: uniform).

    Returns:
      states: (B, T) int32 argmax state path; loglik: (B,).  Ties go to the
      lowest state (torch.argmax's first occurrence, as jnp.argmax's).
    """
    B, T, S = log_emit.shape
    if log_init is None:
        log_init = torch.zeros((S,), device=log_emit.device) - math.log(S)
    delta = log_init[None, :] + log_emit[:, 0, :]  # (B, S)
    bps = []
    for t in range(1, T):
        cand = delta[:, :, None] + log_trans[None]  # (B, S_from, S_to)
        bps.append(torch.argmax(cand, dim=1))
        delta = cand.max(dim=1).values + log_emit[:, t]

    s = torch.argmax(delta, dim=-1)
    loglik = delta.max(dim=-1).values
    states = [s]
    for bp in reversed(bps):
        s = torch.gather(bp, 1, s[:, None])[:, 0]
        states.append(s)
    return torch.stack(states[::-1], dim=1).to(torch.int32), loglik
