"""Mamba-1 selective SSM block (for jamba).

The selective scan runs in chunks, as the reference's: within a chunk the
linear recurrence h_t = a_t h_{t-1} + b_t is solved by an associative scan
over the pair (a, b) (``core.viterbi._associative_scan``, jax's recursion,
so every prefix is combined in the reference's association order); across
chunks a Python loop carries the (B, d_inner, d_state) state.  The chunk is
the largest divisor of S that is at most ``cfg.ssm.chunk``: it fixes both
the rounding and which (B, chunk, d_inner, d_state) intermediates exist.
While grad is enabled each chunk runs under a non-reentrant
``torch.utils.checkpoint`` (the reference's per-chunk ``jax.checkpoint``),
so the backward recomputes one chunk's intermediates at a time.

``softplus`` is ``jax.nn.softplus``'s ``logaddexp(x, 0)`` (``torch.logaddexp``:
the same formula and the same gradient); ``F.softplus`` would return ``x``
past its threshold of 20.

Decode is the exact single-step recurrence.  Prefill and decode write the
new state into the cache tensors they are given, in place: ``ssm`` the
float32 state, ``conv`` the last K-1 inputs of the conv (taken before it).
"""
from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.core.viterbi import _associative_scan
from repro_torch.models import common as cm
from repro_torch.models.attention import _divisor_chunk

f32 = torch.float32


def _dt_rank(cfg) -> int:
    return cfg.ssm.dt_rank or -(-cfg.d_model // 16)


def ssm_specs(cfg, stack: int):
    d = cfg.d_model
    s = cfg.ssm
    d_in = s.expand * d
    dtr = _dt_rank(cfg)
    N = s.d_state

    def P(shape, axes, init="normal", scale=1.0, fan_in=0):
        if stack:
            shape = (stack,) + shape
            axes = ("layers",) + axes
        return cm.ParamSpec(shape, axes, init, scale, fan_in)

    return {
        "in_proj": cm.dense_spec((d,), (2 * d_in,), ("embed",), ("dinner",), stack=stack),
        "conv_w": P((s.d_conv, d_in), ("conv", "dinner"), "normal", 1.0, s.d_conv),
        "conv_b": P((d_in,), ("dinner",), "zeros"),
        "x_proj": cm.dense_spec((d_in,), (dtr + 2 * N,), ("dinner",), (None,), stack=stack),
        "dt_proj": cm.dense_spec((dtr,), (d_in,), (None,), ("dinner",), stack=stack, bias=True),
        "A_log": P((d_in, N), ("dinner", "dstate"), "ones"),
        "D": P((d_in,), ("dinner",), "ones"),
        "out_proj": cm.dense_spec((d_in,), (d,), ("dinner",), ("embed",), stack=stack),
    }


def softplus(x):
    """``jax.nn.softplus``: ``logaddexp(x, 0)`` at every x."""
    return torch.logaddexp(x, x.new_zeros(()))


def conv1d(params, x, cd):
    """Depthwise causal conv over x: (B, S, f), zero-padded on the left;
    the taps added in the reference's order, then the bias."""
    w = params["conv_w"].to(cd)
    K, S = w.shape[0], x.shape[1]
    xpad = F.pad(x, (0, 0, K - 1, 0))
    return sum(xpad[:, i:i + S] * w[i] for i in range(K)) + params["conv_b"].to(cd)


def conv1d_step(params, conv_cache, x, cd):
    """One step of ``conv1d`` from the cached last K-1 inputs.  x: (B, f).
    Returns (conv output (B, f), the window (B, K, f))."""
    window = torch.cat([conv_cache.to(cd), x[:, None]], dim=1)
    conv = torch.einsum("bkf,kf->bf", window, params["conv_w"].to(cd))
    return conv + params["conv_b"].to(cd), window


def _combine(x, y):
    ax, bx = x
    ay, by = y
    return ax * ay, ay * bx + by


def _chunk_step(h, xc_c, dt_c, B_c, C_c, A):
    """One chunk: (final state (B, D, N), y (B, chunk, D))."""
    a_k = torch.exp(dt_c[..., None] * A)  # (B, chunk, D, N)
    b_k = (dt_c[..., None] * B_c[:, :, None, :]) * xc_c[..., None]
    # fold the carry into element 0
    b_k = torch.cat([b_k[:, :1] + a_k[:, :1] * h[:, None], b_k[:, 1:]], dim=1)
    _, hh = _associative_scan(_combine, (a_k, b_k), axis=1)
    y_c = torch.einsum("bsdn,bsn->bsd", hh, C_c)  # contract N immediately
    return hh[:, -1], y_c


def _ssm_scan_chunked(xc, dt, Bm, Cm, A, h0, chunk: int):
    """Selective scan with chunk-local intermediates: h_t = a_t h_{t-1} + b_t
    and y_t = <h_t, C_t>, a = exp(dt·A), b = dt·B·x.

    xc/dt: (B, S, D); Bm/Cm: (B, S, N); A: (D, N); h0: (B, D, N), all
    float32.  Returns y (B, S, D) float32 and the final state."""
    S = xc.shape[1]
    chunk = _divisor_chunk(S, chunk)
    step = _chunk_step
    if torch.is_grad_enabled():
        step = functools.partial(checkpoint, _chunk_step, use_reentrant=False,
                                 preserve_rng_state=False)
    h, ys = h0, []
    for c in range(S // chunk):
        sl = slice(c * chunk, (c + 1) * chunk)
        h, y_c = step(h, xc[:, sl], dt[:, sl], Bm[:, sl], Cm[:, sl], A)
        ys.append(y_c)
    return torch.cat(ys, dim=1), h


def _gate_inputs(params, cfg, xc, cd):
    """(dt float32, B, C) of the conv's output, and -exp(A_log)."""
    dtr, N = _dt_rank(cfg), cfg.ssm.d_state
    proj = cm.dense(params["x_proj"], xc, "...f,fp->...p", cd)
    dt_in, Bm, Cm = proj[..., :dtr], proj[..., dtr:dtr + N], proj[..., dtr + N:]
    dt = softplus(cm.dense(params["dt_proj"], dt_in, "...r,rf->...f", cd)).to(f32)
    return dt, Bm, Cm, -torch.exp(params["A_log"].to(f32))


def _output(params, y, xc, z, cd):
    y = (y + params["D"].to(f32) * xc.to(f32)).to(cd)
    return cm.dense(params["out_proj"], y * F.silu(z), "...f,fd->...d", cd)


def ssm_apply(
    params, cfg, x, *,
    cache: Optional[Dict[str, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """Full-sequence selective SSM.  x: (B, S, d).

    If ``cache`` is given (prefill), the scan starts from its state, and the
    final state and conv window are written into it in place."""
    cd = cm.dtype_of(cfg.compute_dtype)
    s = cfg.ssm
    B, S, d = x.shape
    d_in = s.expand * d

    xz = cm.dense(params["in_proj"], x, "...d,df->...f", cd)
    xi, z = xz[..., :d_in], xz[..., d_in:]
    xc = F.silu(conv1d(params, xi, cd))
    dt, Bm, Cm, A = _gate_inputs(params, cfg, xc, cd)
    h0 = (cache["ssm"].to(f32) if cache is not None
          else torch.zeros((B, d_in, s.d_state), dtype=f32, device=x.device))
    y, hT = _ssm_scan_chunked(xc.to(f32), dt, Bm.to(f32), Cm.to(f32), A, h0, s.chunk)
    out = _output(params, y, xc, z, cd)
    if cache is not None:
        K = params["conv_w"].shape[0]
        cache["ssm"].copy_(hT)
        cache["conv"].copy_(xi[:, -(K - 1):])
    return out, cache


def ssm_decode(
    params, cfg, x, *,
    cache: Dict[str, torch.Tensor],  # ssm: (B, d_in, N); conv: (B, K-1, d_in)
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Single-token recurrence.  x: (B, 1, d).  Writes the new state and
    window into ``cache`` in place."""
    cd = cm.dtype_of(cfg.compute_dtype)
    d_in = cfg.ssm.expand * cfg.d_model

    xz = cm.dense(params["in_proj"], x, "...d,df->...f", cd)[:, 0]
    xi, z = xz[..., :d_in], xz[..., d_in:]
    conv, window = conv1d_step(params, cache["conv"], xi, cd)
    xc = F.silu(conv)
    dt, Bm, Cm, A = _gate_inputs(params, cfg, xc, cd)
    a = torch.exp(dt[..., None] * A)  # (B, d_in, N)
    bx = (dt[..., None] * Bm[:, None, :].to(f32)) * xc[..., None].to(f32)
    h = a * cache["ssm"].to(f32) + bx
    y = torch.einsum("bdn,bn->bd", h, Cm.to(f32))
    out = _output(params, y[:, None], xc[:, None], z[:, None], cd)
    cache["ssm"].copy_(h)
    cache["conv"].copy_(window[:, 1:])
    return out, cache
