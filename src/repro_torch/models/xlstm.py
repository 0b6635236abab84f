"""xLSTM blocks: mLSTM (matrix memory, chunkwise-parallel) and sLSTM
(scalar memory, true recurrence), per arXiv:2405.04517.

mLSTM runs chunkwise, as the reference's: the gate stabilizer m follows a
(max,+) recurrence carried across chunks by a Python loop, everything within
a chunk is computed in parallel, and while grad is enabled each chunk runs
under a non-reentrant ``torch.utils.checkpoint`` (the reference's per-chunk
``jax.checkpoint``).  The chunk is the largest divisor of S that is at most
``cfg.xlstm.chunk``.

sLSTM is sequential (recurrent weights through a nonlinearity): a Python
loop over time in a head-major layout, (H, B, dh) for the state and (H, B,
4, dh) for a step's gates, so that a step is one batched product against
the per-head recurrent weights (cast to float32 and laid out (H, dh, 4·dh)
once a call) and ~20 element-wise ops, with no copy between them.  The
reference checkpoints every step; the port does not (at xlstm-350m's width
a layer's 4096 steps keep ~0.3 GB for the backward).

Rounding follows the reference: the chunk's and the sLSTM scan's ``h``
leave in bf16 whatever the compute dtype (decode keeps float32); both ``m``
start at -1e30; ``q`` is scaled by ``dh**-0.5`` rounded to its dtype
(``common.scalar``); ``gelu`` is the tanh form, as jax's; ``log_sigmoid``
is ``F.logsigmoid``, min(x, 0) - log1p(exp(-|x|)), jax's ``-softplus(-x)``
term for term (one float32 ulp apart in ~2 of 1e6 elements).

Prefill and decode write the new state into the cache tensors they are
given, in place (mLSTM: ``C``, ``n``, ``m`` and the conv window; sLSTM:
``state``'s ``c``, ``n``, ``h``, ``m``).
"""
from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.models import common as cm
from repro_torch.models.attention import _divisor_chunk
from repro_torch.models.ssm import conv1d as _conv1d
from repro_torch.models.ssm import conv1d_step

f32, bf16 = torch.float32, torch.bfloat16
M_INIT = -1e30


def _head_norm(h, gn, n_heads: int, eps: float, cd):
    """Per-head RMS norm of float32 ``h`` (..., d), times ``gn``, in ``cd``."""
    hg = h.reshape(*h.shape[:-1], n_heads, h.shape[-1] // n_heads)
    hg = hg * torch.rsqrt(torch.mean(hg * hg, dim=-1, keepdim=True) + eps)
    return (hg.reshape(h.shape) * gn.to(f32)).to(cd)


# --------------------------------------------------------------------------- #
# mLSTM                                                                        #
# --------------------------------------------------------------------------- #


def mlstm_specs(cfg, stack: int):
    d = cfg.d_model
    x = cfg.xlstm
    d_in = int(x.mlstm_proj_factor * d)
    H = cfg.n_heads
    K = x.conv_kernel

    def P(shape, axes, init="normal", scale=1.0, fan_in=0):
        if stack:
            shape, axes = (stack,) + shape, ("layers",) + axes
        return cm.ParamSpec(shape, axes, init, scale, fan_in)

    return {
        "up_proj": cm.dense_spec((d,), (2 * d_in,), ("embed",), ("dinner",), stack=stack),
        "conv_w": P((K, d_in), ("conv", "dinner"), "normal", 1.0, K),
        "conv_b": P((d_in,), ("dinner",), "zeros"),
        "wq": cm.dense_spec((d_in,), (d_in,), ("dinner",), (None,), stack=stack),
        "wk": cm.dense_spec((d_in,), (d_in,), ("dinner",), (None,), stack=stack),
        "wv": cm.dense_spec((d_in,), (d_in,), ("dinner",), (None,), stack=stack),
        "w_if": cm.dense_spec((d_in,), (2 * H,), ("dinner",), (None,), stack=stack, bias=True),
        "gn": P((d_in,), ("dinner",), "ones"),
        "down_proj": cm.dense_spec((d_in,), (d,), ("dinner",), ("embed",), stack=stack),
    }


def _mlstm_chunk_step(C, n, m, qc, kc, vc, li, lf):
    """One chunk (B, chunk, H, ...) from the carried (C, n, m).  Returns
    (C, n, m) at the chunk's end and h (B, chunk, H, dh) in bf16."""
    chunk = qc.shape[1]
    qc, kc, vc = qc.to(f32), kc.to(f32), vc.to(f32)
    Fc = torch.cumsum(lf, dim=1)  # inclusive decay-to-i (B, chunk, H)
    gmax = torch.cummax(li - Fc, dim=1).values
    m_new = torch.maximum(m[:, None] + Fc, Fc + gmax)  # (B, chunk, H)
    # intra-chunk weights: D_ij = exp(F_i - F_j + li_j - m_i), j <= i.  The
    # mask goes in before the exp (the reference's goes after): the same
    # values, but a masked logD past ~88 (a chunk of 256 at full width)
    # overflows, and the reference's gradient is then 0 * inf = NaN
    logD = Fc[:, :, None] - Fc[:, None, :] + li[:, None, :] - m_new[:, :, None]
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=qc.device))
    Dm = torch.exp(torch.where(tri[None, :, :, None], logD, -math.inf))  # (B, i, j, H)
    s = torch.einsum("bihd,bjhd->bijh", qc, kc)
    h_num = torch.einsum("bijh,bjhd->bihd", s * Dm, vc)
    n_num = torch.einsum("bijh,bjhd->bihd", Dm, kc)
    # inter-chunk (carried state) contribution
    inter_w = torch.exp(m[:, None] + Fc - m_new)  # (B, chunk, H)
    h_num = h_num + inter_w[..., None] * torch.einsum("bihd,bhde->bihe", qc, C)
    n_num = n_num + inter_w[..., None] * n[:, None]
    qn = torch.einsum("bihd,bihd->bih", qc, n_num)
    h = h_num / torch.maximum(torch.abs(qn), torch.exp(-m_new))[..., None]
    # state update to the chunk's end
    FL = Fc[:, -1]  # (B, H)
    m_next = torch.maximum(m + FL, FL + gmax[:, -1])
    wj = torch.exp(FL[:, None] - Fc + li - m_next[:, None])  # (B, chunk, H)
    decay = torch.exp(m + FL - m_next)
    C_next = decay[:, :, None, None] * C + torch.einsum("bjh,bjhd,bjhe->bhde", wj, kc, vc)
    n_next = decay[:, :, None] * n + torch.einsum("bjh,bjhd->bhd", wj, kc)
    return C_next, n_next, m_next, h.to(bf16)


def _mlstm_chunk(q, k, v, log_i, log_f, state, chunk: int):
    """Chunkwise stabilized mLSTM.

    q, k, v: (B, S, H, dh); log_i/log_f: (B, S, H) float32; state: (C (B, H,
    dh, dh), n (B, H, dh), m (B, H)) float32.  Returns h (B, S, H, dh) bf16
    and the final state."""
    S, dh = q.shape[1], q.shape[-1]
    chunk = _divisor_chunk(S, chunk)
    q = q * cm.scalar(dh ** -0.5, q.dtype)
    step = _mlstm_chunk_step
    if torch.is_grad_enabled():
        step = functools.partial(checkpoint, _mlstm_chunk_step, use_reentrant=False,
                                 preserve_rng_state=False)
    (C, n, m), hs = state, []
    for c in range(S // chunk):
        sl = slice(c * chunk, (c + 1) * chunk)
        C, n, m, h = step(C, n, m, q[:, sl], k[:, sl], v[:, sl], log_i[:, sl], log_f[:, sl])
        hs.append(h)
    return torch.cat(hs, dim=1), (C, n, m)


def mlstm_init_state(B, H, dh, device=None):
    return (torch.zeros((B, H, dh, dh), dtype=f32, device=device),
            torch.zeros((B, H, dh), dtype=f32, device=device),
            torch.full((B, H), M_INIT, dtype=f32, device=device))


def mlstm_apply(params, cfg, x, *, cache=None):
    """x: (B, S, d).  cache (prefill): {"C", "n", "m", "conv"}; the scan
    starts from its state, and the final state and conv window are written
    into it in place."""
    cd = cm.dtype_of(cfg.compute_dtype)
    B, S, d = x.shape
    d_in = int(cfg.xlstm.mlstm_proj_factor * d)
    H = cfg.n_heads
    dh = d_in // H
    up = cm.dense(params["up_proj"], x, "...d,df->...f", cd)
    xm, z = up[..., :d_in], up[..., d_in:]
    conv = F.silu(_conv1d(params, xm, cd))
    q = cm.dense(params["wq"], conv, "...f,fg->...g", cd).reshape(B, S, H, dh)
    k = cm.dense(params["wk"], conv, "...f,fg->...g", cd).reshape(B, S, H, dh)
    v = cm.dense(params["wv"], xm, "...f,fg->...g", cd).reshape(B, S, H, dh)
    if_raw = cm.dense(params["w_if"], xm, "...f,fg->...g", cd).to(f32)
    log_i = if_raw[..., :H]  # exp input gate -> log_i = raw
    log_f = F.logsigmoid(if_raw[..., H:])
    state = mlstm_init_state(B, H, dh, x.device) if cache is None else (
        cache["C"].to(f32), cache["n"].to(f32), cache["m"].to(f32))
    h, (C, n, m) = _mlstm_chunk(q, k, v, log_i, log_f, state, cfg.xlstm.chunk)
    h = _head_norm(h.reshape(B, S, d_in).to(cd).to(f32), params["gn"], H, cfg.norm_eps, cd)
    out = cm.dense(params["down_proj"], h * F.silu(z), "...f,fd->...d", cd)
    if cache is not None:
        K = params["conv_w"].shape[0]
        for name, new in (("C", C), ("n", n), ("m", m), ("conv", xm[:, -(K - 1):])):
            cache[name].copy_(new)
    return out, cache


def mlstm_decode(params, cfg, x, *, cache):
    """Single-step mLSTM recurrence.  x: (B, 1, d).  Writes the new state and
    window into ``cache`` in place."""
    cd = cm.dtype_of(cfg.compute_dtype)
    B, _, d = x.shape
    d_in = int(cfg.xlstm.mlstm_proj_factor * d)
    H = cfg.n_heads
    dh = d_in // H
    up = cm.dense(params["up_proj"], x, "...d,df->...f", cd)[:, 0]
    xm, z = up[..., :d_in], up[..., d_in:]
    conv, window = conv1d_step(params, cache["conv"], xm, cd)
    conv = F.silu(conv)
    q = cm.dense(params["wq"], conv, "...f,fg->...g", cd).reshape(B, H, dh)
    q = q * cm.scalar(dh ** -0.5, q.dtype)
    k = cm.dense(params["wk"], conv, "...f,fg->...g", cd).reshape(B, H, dh)
    v = cm.dense(params["wv"], xm, "...f,fg->...g", cd).reshape(B, H, dh)
    if_raw = cm.dense(params["w_if"], xm, "...f,fg->...g", cd).to(f32)
    log_i, log_f = if_raw[..., :H], F.logsigmoid(if_raw[..., H:])
    C, n, m = cache["C"].to(f32), cache["n"].to(f32), cache["m"].to(f32)
    m_new = torch.maximum(log_f + m, log_i)
    fw = torch.exp(log_f + m - m_new)[:, :, None]
    iw = torch.exp(log_i - m_new)[:, :, None]
    kf, vf, qf = k.to(f32), v.to(f32), q.to(f32)
    C = fw[..., None] * C + iw[..., None] * kf[:, :, :, None] * vf[:, :, None, :]
    n = fw * n + iw * kf
    h_num = torch.einsum("bhd,bhde->bhe", qf, C)
    qn = torch.einsum("bhd,bhd->bh", qf, n)
    h = h_num / torch.maximum(torch.abs(qn), torch.exp(-m_new))[..., None]
    h = _head_norm(h.reshape(B, d_in), params["gn"], H, cfg.norm_eps, cd)
    out = cm.dense(params["down_proj"], (h * F.silu(z))[:, None], "...f,fd->...d", cd)
    for name, new in (("C", C), ("n", n), ("m", m_new), ("conv", window[:, 1:])):
        cache[name].copy_(new)
    return out, cache


# --------------------------------------------------------------------------- #
# sLSTM                                                                        #
# --------------------------------------------------------------------------- #


def slstm_specs(cfg, stack: int):
    d = cfg.d_model
    x = cfg.xlstm
    H = cfg.n_heads
    dh = d // H
    d_ff = int(x.slstm_proj_factor * d)

    def P(shape, axes, init="normal", scale=1.0, fan_in=0):
        if stack:
            shape, axes = (stack,) + shape, ("layers",) + axes
        return cm.ParamSpec(shape, axes, init, scale, fan_in)

    return {
        "w_gates": cm.dense_spec((d,), (4, d), ("embed",), (None, "dinner"), stack=stack,
                                 bias=True),
        "r_gates": P((4, H, dh, dh), (None, "heads", "head_dim", None), "normal", 1.0, dh),
        "gn": P((d,), ("dinner",), "ones"),
        "up_gate": cm.dense_spec((d,), (d_ff,), ("embed",), ("ff",), stack=stack),
        "up": cm.dense_spec((d,), (d_ff,), ("embed",), ("ff",), stack=stack),
        "down": cm.dense_spec((d_ff,), (d,), ("ff",), ("embed",), stack=stack),
    }


def slstm_init_state(B, d, device=None):
    z = torch.zeros((B, d), dtype=f32, device=device)
    return {"c": z, "n": z, "h": z, "m": torch.full((B, d), M_INIT, dtype=f32, device=device)}


def _recurrent_weights(params):
    """r_gates (4, H, dh, dh) as float32 (H, dh, 4·dh): head h's product of
    ``h_prev`` with all four gates' blocks in one batched product."""
    r = params["r_gates"].to(f32)
    G, H, dh, _ = r.shape
    return r.permute(1, 2, 0, 3).reshape(H, dh, G * dh)


def _to_heads(t, H):
    """(B, ..., d) -> (H, B, ..., dh), a view."""
    return t.unflatten(-1, (H, t.shape[-1] // H)).movedim(-2, 0)


def _from_heads(t):
    """(H, B, ..., dh) -> (B, ..., H·dh)."""
    return t.movedim(0, -2).flatten(-2)


def _slstm_cell(r, x_t, state):
    """One sLSTM step, head-major.  r: ``_recurrent_weights``; x_t: (H, B, 4,
    dh) float32, the precomputed Wx part; state: c, n, h, m (H, B, dh)."""
    H, B, dh = state["h"].shape
    g = x_t + torch.bmm(state["h"], r).view(H, B, 4, dh)
    log_i = g[:, :, 0]
    log_f = F.logsigmoid(g[:, :, 1])
    z_in = torch.tanh(g[:, :, 2])
    o = torch.sigmoid(g[:, :, 3])
    m_new = torch.maximum(log_f + state["m"], log_i)
    i_s = torch.exp(log_i - m_new)
    f_s = torch.exp(log_f + state["m"] - m_new)
    c = f_s * state["c"] + i_s * z_in
    n = torch.maximum(f_s * state["n"] + i_s, torch.exp(-m_new))
    return {"c": c, "n": n, "h": o * (c / n), "m": m_new}


def _slstm_out(params, cfg, h, cd):
    """The block's tail from the cell's h (..., d): head norm, gated GeLU
    up-projection, down-projection."""
    h = _head_norm(h, params["gn"], cfg.n_heads, cfg.norm_eps, cd)
    up = cm._gelu_tanh(cm.dense(params["up_gate"], h, "...d,df->...f", cd))
    return cm.dense(params["down"], up * cm.dense(params["up"], h, "...d,df->...f", cd),
                    "...f,fd->...d", cd)


def _write_state(cache, state):
    for name, new in state.items():
        cache["state"][name].copy_(_from_heads(new))


def slstm_apply(params, cfg, x, *, cache=None):
    """x: (B, S, d); sequential over time.  cache (prefill): {"state": {c, n,
    h, m}}, the loop's start, overwritten in place with its end."""
    cd = cm.dtype_of(cfg.compute_dtype)
    B, S, d = x.shape
    H = cfg.n_heads
    wx = cm.dense(params["w_gates"], x, "...d,dgf->...gf", cd)  # (B, S, 4, d)
    wx = _to_heads(wx.to(f32), H).movedim(2, 0).contiguous()  # (S, H, B, 4, dh)
    state = cache["state"] if cache is not None else slstm_init_state(B, d, x.device)
    state = {k: _to_heads(v, H) for k, v in state.items()}
    r = _recurrent_weights(params)
    hs = []
    for t in range(S):
        state = _slstm_cell(r, wx[t], state)
        hs.append(state["h"].to(bf16))
    h = _from_heads(torch.stack(hs, dim=2))  # (B, S, d)
    y = _slstm_out(params, cfg, h.to(cd).to(f32), cd)
    if cache is not None:
        _write_state(cache, state)
    return y, cache


def slstm_decode(params, cfg, x, *, cache):
    """One sLSTM step.  x: (B, 1, d).  Writes the new state into ``cache``
    in place."""
    cd = cm.dtype_of(cfg.compute_dtype)
    H = cfg.n_heads
    wx = cm.dense(params["w_gates"], x, "...d,dgf->...gf", cd)[:, 0]  # (B, 4, d)
    state = {k: _to_heads(v, H) for k, v in cache["state"].items()}
    state = _slstm_cell(_recurrent_weights(params), _to_heads(wx.to(f32), H), state)
    y = _slstm_out(params, cfg, _from_heads(state["h"]).to(cd).to(f32), cd)
    _write_state(cache, state)
    return y[:, None], cache
