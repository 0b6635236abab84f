"""Attention: chunked (online-softmax) training/prefill attention, sliding
window, GQA, qk-norm, and the local full-cache decode path.

No S x S score matrix is ever materialized: training and prefill run in
O(chunk_q x chunk_kv) score blocks, a Python loop over query and key
blocks with the reference's chunk sizes (``_divisor_chunk``), because the
chunking changes the online softmax's sums.  While grad is enabled each
key block's step runs under a non-reentrant checkpoint (the reference's
``jax.checkpoint`` of ``kv_block_step``), so the backward recomputes score
blocks instead of saving them; inference runs no checkpoint.

Numerics are the reference's: ``q`` is scaled in its own dtype before the
score product; the score product comes out in the compute dtype and is
rounded there before the softcap and the cast to float32; the mask value is
``-1e30``; ``p`` is cast to ``v``'s dtype for the PV product; the result is
``acc / max(l, 1e-30)``.

Caches are written in place: prefill copies K (after RoPE) and V into the
cache in its dtype, a decode step writes each row's entry at its position.
The reference's seq-sharded ``flash_decode_sharded`` waits for a device
mesh (ROADMAP item 9b); ``cross_attention`` / ``cross_kv`` wait for the
encoder-decoder family (item 11).
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import common as cm

NEG_INF = -1e30


def _softcap(x, cap: float):
    if cap and cap > 0.0:
        c = cm.scalar(cap, x.dtype)
        return torch.tanh(x / c) * c
    return x


def _divisor_chunk(total: int, want: int) -> int:
    """The largest divisor of ``total`` that is <= ``want``."""
    c = min(want, total)
    while total % c:
        c -= 1
    return c


# ---------------------------------------------------------------------------- #
# Chunked attention core (train / prefill)                                      #
# ---------------------------------------------------------------------------- #


def _kv_block_step(acc, m, l, q_blk, qpos, k_blk, v_blk, kpos, *, causal, window, softcap):
    """One key block of the online softmax: returns (acc, m, l) updated."""
    s = torch.einsum("bqhd,bshd->bhqs", q_blk, k_blk)  # (B,H,cq,ck)
    s = _softcap(s, softcap).to(torch.float32)
    mask = torch.ones((q_blk.shape[1], k_blk.shape[1]), dtype=torch.bool, device=s.device)
    if causal:
        mask = mask & (kpos[None, :] <= qpos[:, None])
    if window > 0:
        mask = mask & (kpos[None, :] > qpos[:, None] - window)
    s = torch.where(mask[None, None], s, NEG_INF)
    m_new = torch.maximum(m, s.amax(dim=-1))
    p = torch.exp(s - m_new[..., None])
    alpha = torch.exp(m - m_new)
    l = l * alpha + p.sum(dim=-1)
    acc = acc * alpha[..., None] + torch.einsum(
        "bhqs,bshd->bhqd", p.to(v_blk.dtype), v_blk
    ).to(torch.float32)
    return acc, m_new, l


def chunked_attention(
    q: torch.Tensor,  # (B, Sq, H, D)
    k: torch.Tensor,  # (B, Sk, KV, D)
    v: torch.Tensor,  # (B, Sk, KV, Dv)
    *,
    causal: bool = True,
    window: int = 0,  # >0 with causal: keys restricted to (q-window, q]
    chunk_q: int = 2048,
    chunk_kv: int = 2048,
    q_offset: int = 0,
    softcap: float = 0.0,
    scale: Optional[float] = None,
) -> torch.Tensor:
    B, Sq, H, D = q.shape
    _, Sk, KV, _ = k.shape
    Dv = v.shape[-1]
    G = H // KV
    scale = scale if scale is not None else D ** -0.5
    dev = q.device

    cq = _divisor_chunk(Sq, chunk_q)
    ck = _divisor_chunk(Sk, chunk_kv)
    nq, nk = Sq // cq, Sk // ck
    # head-major: expand the KV heads to H up front (head h reads KV head h // G)
    if G > 1:
        k = torch.repeat_interleave(k, G, dim=2)
        v = torch.repeat_interleave(v, G, dim=2)
    q4 = q * cm.scalar(scale, q.dtype)

    banded = window > 0 and causal
    if banded:
        kw = cq + window  # keys possibly visible to one q chunk
        nk_inner = min(-(-kw // ck), nk)
    else:
        nk_inner = nk

    kv_step = functools.partial(_kv_block_step, causal=causal, window=window, softcap=softcap)
    if torch.is_grad_enabled():
        kv_step = functools.partial(checkpoint, kv_step, use_reentrant=False,
                                    preserve_rng_state=False)
    outs = []
    for qi in range(nq):
        q_blk = q4[:, qi * cq:(qi + 1) * cq]
        qpos = q_offset + qi * cq + torch.arange(cq, device=dev)
        acc = torch.zeros((B, H, cq, Dv), dtype=torch.float32, device=dev)
        m = torch.full((B, H, cq), NEG_INF, dtype=torch.float32, device=dev)
        l = torch.zeros((B, H, cq), dtype=torch.float32, device=dev)
        if banded:
            width = nk_inner * ck
            start = min(max(qi * cq + q_offset - window + 1, 0), Sk - width)
            k_loc, v_loc = k[:, start:start + width], v[:, start:start + width]
            kpos = start + torch.arange(width, device=dev)
        else:
            k_loc, v_loc, kpos = k, v, torch.arange(Sk, device=dev)
        for j in range(k_loc.shape[1] // ck):
            blk = slice(j * ck, (j + 1) * ck)
            acc, m, l = kv_step(acc, m, l, q_blk, qpos, k_loc[:, blk], v_loc[:, blk], kpos[blk])
        outs.append(acc / torch.clamp_min(l[..., None], 1e-30))  # (B, H, cq, Dv)
    # (nq, B, H, cq, Dv) -> (B, Sq, H, Dv)
    out = torch.stack(outs).permute(1, 0, 3, 2, 4).reshape(B, Sq, H, Dv)
    return out.to(q.dtype)


# ---------------------------------------------------------------------------- #
# Decode attention                                                              #
# ---------------------------------------------------------------------------- #


def _masked_decode(q1, k_cache, v_cache, lo, hi, softcap):
    """q1: (B,H,D); cache (B,S,KV,*); valid key positions p: lo <= p < hi.
    The softmax is float32 over every cache position."""
    B, H, D = q1.shape
    S, KV = k_cache.shape[1], k_cache.shape[2]
    G = H // KV
    if G > 1:
        k_cache = torch.repeat_interleave(k_cache, G, dim=2)
        v_cache = torch.repeat_interleave(v_cache, G, dim=2)
    dt = torch.promote_types(q1.dtype, k_cache.dtype)  # jnp.einsum promotes
    s = torch.einsum("bhd,bshd->bhs", (q1 * cm.scalar(D ** -0.5, q1.dtype)).to(dt),
                     k_cache.to(dt))
    s = _softcap(s, softcap).to(torch.float32)
    ar = torch.arange(S, device=q1.device)[None, :]
    valid = (ar < hi[:, None]) & (ar >= lo[:, None])
    s = torch.where(valid[:, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhs,bshd->bhd", p.to(v_cache.dtype), v_cache)
    return out.to(q1.dtype)


def flash_decode_sharded(q1, k_cache, v_cache, lo, hi, softcap, mesh, batch_axes):
    """Seq-sharded decode over a device mesh: waits for item 9b."""
    cm._needs_mesh("flash_decode_sharded")


# ---------------------------------------------------------------------------- #
# Attention module: specs + apply                                               #
# ---------------------------------------------------------------------------- #


def attention_specs(cfg, stack: int) -> Dict[str, Any]:
    d, H, KV = cfg.d_model, cfg.n_heads, cfg.n_kv_heads
    hd = cfg.resolved_head_dim
    p = {
        "wq": cm.dense_spec((d,), (H, hd), ("embed",), ("heads", "head_dim"),
                            stack=stack, bias=cfg.qkv_bias),
        "wk": cm.dense_spec((d,), (KV, hd), ("embed",), ("kv_heads", "head_dim"),
                            stack=stack, bias=cfg.qkv_bias),
        "wv": cm.dense_spec((d,), (KV, hd), ("embed",), ("kv_heads", "head_dim"),
                            stack=stack, bias=cfg.qkv_bias),
        "wo": cm.dense_spec((H, hd), (d,), ("heads", "head_dim"), ("embed",),
                            stack=stack),
    }
    if cfg.qk_norm:
        p["qknorm"] = cm.qknorm_spec(hd, stack)
    return p


def _rope_theta_for(cfg, kind: str) -> float:
    return cfg.rope_local_theta if kind == "attn_local" else cfg.rope_theta


def _qkv(params, cfg, x, cd):
    q = cm.dense(params["wq"], x, "...d,dhk->...hk", cd)
    k = cm.dense(params["wk"], x, "...d,dhk->...hk", cd)
    v = cm.dense(params["wv"], x, "...d,dhk->...hk", cd)
    if cfg.qk_norm:
        q = cm.headwise_rmsnorm(params["qknorm"]["q_scale"], q, cfg.norm_eps)
        k = cm.headwise_rmsnorm(params["qknorm"]["k_scale"], k, cfg.norm_eps)
    return q, k, v


def self_attention(
    params, cfg, part, x, *, kind: str,
    positions: Optional[torch.Tensor] = None,
    cache: Optional[Dict[str, torch.Tensor]] = None,
    mesh=None,
) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """Full-sequence self-attention (prefill).

    x: (B, S, d).  If ``cache`` is given, K/V are written into it in place
    and it is returned."""
    if mesh is not None:
        cm._needs_mesh("self_attention(mesh=...)")
    cd = cm.dtype_of(cfg.compute_dtype)
    hd = cfg.resolved_head_dim
    S = x.shape[1]
    q, k, v = _qkv(params, cfg, x, cd)
    pos = positions if positions is not None else torch.arange(S, device=x.device)[None, :]
    cos, sin = cm.rope_angles(pos, hd, _rope_theta_for(cfg, kind))
    q = cm.apply_rope(q, cos, sin)
    k = cm.apply_rope(k, cos, sin)
    out = chunked_attention(
        q, k, v,
        causal=(kind != "attn_bidir"),
        window=cfg.window if kind == "attn_local" else 0,
        chunk_q=part.attn_chunk_q, chunk_kv=part.attn_chunk_kv,
        softcap=cfg.logit_softcap,
    )
    y = cm.dense(params["wo"], out, "...hk,hkd->...d", cd)
    if cache is not None:
        if "pos" in cache:  # sliding-window ring cache
            for name, t in _ring_from_prefill(cache, k, v).items():
                cache[name].copy_(t)
        else:
            cache["k"][:, :S] = k.to(cache["k"].dtype)
            cache["v"][:, :S] = v.to(cache["v"].dtype)
    return y, cache


def _ring_from_prefill(cache, k, v):
    """The sliding-window ring cache after a prefill of S tokens starting at
    position 0 (new tensors; the caller writes them into the cache).  Ring
    slot i holds absolute position p = i (mod W), p in [S-W, S-1]; slots past
    S hold position -1 when S < W."""
    W = cache["k"].shape[1]
    B, S = k.shape[:2]
    dev = k.device
    if S >= W:
        base = S - W
        idx = base + (torch.arange(W, device=dev) - base) % W
        kc = k[:, idx].to(cache["k"].dtype)
        vc = v[:, idx].to(cache["v"].dtype)
        pos = idx.to(cache["pos"].dtype).expand(B, W)
    else:
        pad = (0, 0, 0, 0, 0, W - S)  # (hd, KV, seq) from the last dim
        kc = torch.nn.functional.pad(k, pad).to(cache["k"].dtype)
        vc = torch.nn.functional.pad(v, pad).to(cache["v"].dtype)
        pos1 = torch.cat([torch.arange(S, device=dev), torch.full((W - S,), -1, device=dev)])
        pos = pos1.to(cache["pos"].dtype).expand(B, W)
    return {"k": kc, "v": vc, "pos": pos}


def self_attention_decode(
    params, cfg, part, x, *, kind: str,
    positions: torch.Tensor,  # (B,) absolute position of the new token
    cache: Dict[str, torch.Tensor],
    mesh=None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Single-token decode: write the new K/V into ``cache`` at
    ``positions`` (in place), attend over it."""
    if mesh is not None:
        cm._needs_mesh("self_attention_decode(mesh=...)")
    cd = cm.dtype_of(cfg.compute_dtype)
    hd = cfg.resolved_head_dim
    q, k_new, v_new = _qkv(params, cfg, x, cd)  # (B,1,H,hd), (B,1,KV,hd)
    cos, sin = cm.rope_angles(positions[:, None], hd, _rope_theta_for(cfg, kind))
    q = cm.apply_rope(q, cos, sin)
    k_new = cm.apply_rope(k_new, cos, sin)
    k_cache = _scatter_cache(cache["k"], k_new, positions)
    v_cache = _scatter_cache(cache["v"], v_new, positions)
    hi = positions + 1
    if kind == "attn_local" and cfg.window > 0:
        lo = torch.clamp_min(hi - cfg.window, 0)
    else:
        lo = torch.zeros_like(hi)
    out = _masked_decode(q[:, 0], k_cache, v_cache, lo, hi, cfg.logit_softcap)
    y = cm.dense(params["wo"], out[:, None], "...hk,hkd->...d", cd)
    return y, cache


def _scatter_cache(cache, new, pos):
    """Write (B,1,KV,hd) entries at per-batch positions (B,) along axis 1 of
    ``cache``, in place; returns ``cache``.  Positions must lie inside the
    cache (the reference's masked select drops one that does not)."""
    B = cache.shape[0]
    cache[torch.arange(B, device=cache.device), pos.long()] = new[:, 0].to(cache.dtype)
    return cache


def cross_attention(params, cfg, part, x, *, enc_kv, decode=False, mesh=None):
    raise NotImplementedError(
        "cross_attention belongs to the encoder-decoder family, which repro_torch "
        "does not port yet (ROADMAP.md queue 1, item 11)")


def cross_kv(params, cfg, enc_out):
    raise NotImplementedError(
        "cross_kv belongs to the encoder-decoder family, which repro_torch "
        "does not port yet (ROADMAP.md queue 1, item 11)")
