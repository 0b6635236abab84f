"""Multi-head Latent Attention (DeepSeek-V2).

Prefill and training use the expanded form: per-head K and V are built from
the compressed ``c_kv`` (K = [k_nope, k_rope broadcast over the heads], V of
``v_head_dim``) and run through ``chunked_attention``.  Decode uses the
absorbed form: the cache holds only ``c_kv`` (kv_lora_rank wide) and
``k_rope`` (rope_head_dim) a token, ``W_uk`` is folded into the query, and
the scores and values are taken in the compressed space, with the
reference's einsum order.  RoPE touches the rope part only; ``kv_norm`` is
an RMSNorm over ``c_kv``.

The caches are written in place: prefill copies ``c_kv`` and ``k_rope``
(after RoPE) into them in their dtype, a decode step writes each row's
entry at its position (the reference selects a whole new cache).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.models import common as cm
from repro_torch.models.attention import NEG_INF, chunked_attention


def mla_specs(cfg, stack: int):
    d, H = cfg.d_model, cfg.n_heads
    m = cfg.mla
    dn, dr, dv, r = m.nope_head_dim, m.rope_head_dim, m.v_head_dim, m.kv_lora_rank
    return {
        "wq": cm.dense_spec((d,), (H, dn + dr), ("embed",), ("heads", "head_dim"), stack=stack),
        "kv_down": cm.dense_spec((d,), (r,), ("embed",), ("kv_lora",), stack=stack),
        "k_rope": cm.dense_spec((d,), (dr,), ("embed",), ("head_dim",), stack=stack),
        "kv_norm": {"scale": cm.ParamSpec((stack, r) if stack else (r,),
                                          ("layers", "kv_lora") if stack else ("kv_lora",),
                                          "ones")},
        "k_up": cm.dense_spec((r,), (H, dn), ("kv_lora",), ("heads", "head_dim"), stack=stack),
        "v_up": cm.dense_spec((r,), (H, dv), ("kv_lora",), ("heads", "head_dim"), stack=stack),
        "wo": cm.dense_spec((H, dv), (d,), ("heads", "head_dim"), ("embed",), stack=stack),
    }


def _q_proj(params, cfg, x, cd):
    dn = cfg.mla.nope_head_dim
    q = cm.dense(params["wq"], x, "...d,dhk->...hk", cd)
    return q[..., :dn], q[..., dn:]  # nope, rope parts


def _compressed_kv(params, cfg, x, cd):
    """(c_kv after kv_norm, k_rope before RoPE) of x: (B, S, d)."""
    c_kv = cm.dense(params["kv_down"], x, "...d,dr->...r", cd)
    c_kv = cm.rmsnorm(params["kv_norm"], c_kv, cfg.norm_eps, compute_dtype=cd)
    return c_kv, cm.dense(params["k_rope"], x, "...d,dr->...r", cd)


def mla_attention(
    params, cfg, part, x, *,
    positions: Optional[torch.Tensor] = None,
    cache: Optional[Dict[str, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """Full-sequence MLA (training / prefill).  x: (B, S, d).  If ``cache``
    is given, ``c_kv`` and ``k_rope`` are written into it in place and it is
    returned."""
    cd = cm.dtype_of(cfg.compute_dtype)
    m = cfg.mla
    B, S, _ = x.shape
    H = cfg.n_heads
    dn, dr = m.nope_head_dim, m.rope_head_dim
    q_nope, q_rope = _q_proj(params, cfg, x, cd)
    c_kv, k_rope = _compressed_kv(params, cfg, x, cd)
    k_rope = k_rope[:, :, None, :]  # (B, S, 1, dr)
    pos = positions if positions is not None else torch.arange(S, device=x.device)[None, :]
    cos, sin = cm.rope_angles(pos, dr, cfg.rope_theta)
    q_rope = cm.apply_rope(q_rope, cos, sin)
    k_rope = cm.apply_rope(k_rope, cos, sin)
    k_nope = cm.dense(params["k_up"], c_kv, "...r,rhk->...hk", cd)  # (B, S, H, dn)
    v = cm.dense(params["v_up"], c_kv, "...r,rhk->...hk", cd)  # (B, S, H, dv)
    k = torch.cat([k_nope, k_rope.expand(B, S, H, dr)], dim=-1)
    q = torch.cat([q_nope, q_rope], dim=-1)
    out = chunked_attention(q, k, v, causal=True, chunk_q=part.attn_chunk_q,
                            chunk_kv=part.attn_chunk_kv, scale=(dn + dr) ** -0.5)
    y = cm.dense(params["wo"], out, "...hk,hkd->...d", cd)
    if cache is not None:
        cache["c_kv"][:, :S] = c_kv.to(cache["c_kv"].dtype)
        cache["k_rope"][:, :S] = k_rope[:, :, 0].to(cache["k_rope"].dtype)
    return y, cache


def mla_attention_decode(
    params, cfg, part, x, *,
    positions: torch.Tensor,  # (B,)
    cache: Dict[str, torch.Tensor],  # c_kv: (B, S, r), k_rope: (B, S, dr)
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Absorbed-form decode: the new entries are written into ``cache`` at
    ``positions`` (in place), and attention runs in the compressed (r + dr)
    space."""
    cd = cm.dtype_of(cfg.compute_dtype)
    m = cfg.mla
    B = x.shape[0]
    dn, dr = m.nope_head_dim, m.rope_head_dim
    q_nope, q_rope = _q_proj(params, cfg, x, cd)  # (B, 1, H, dn), (B, 1, H, dr)
    c_new, kr_new = _compressed_kv(params, cfg, x, cd)  # (B, 1, r), (B, 1, dr)
    cos, sin = cm.rope_angles(positions[:, None], dr, cfg.rope_theta)
    q_rope = cm.apply_rope(q_rope, cos, sin)
    kr_new = cm.apply_rope(kr_new[:, :, None, :], cos, sin)[:, :, 0]

    rows, pos = torch.arange(B, device=x.device), positions.long()
    c_kv, k_rope = cache["c_kv"], cache["k_rope"]
    c_kv[rows, pos] = c_new[:, 0].to(c_kv.dtype)
    k_rope[rows, pos] = kr_new[:, 0].to(k_rope.dtype)

    # absorb W_uk into the query: q_eff (B, H, r)
    q_eff = torch.einsum("bhk,rhk->bhr", q_nope[:, 0], params["k_up"]["kernel"].to(cd))
    s = torch.einsum("bhr,bsr->bhs", q_eff, c_kv.to(cd))
    s = s + torch.einsum("bhk,bsk->bhs", q_rope[:, 0], k_rope.to(cd))
    s = (s * cm.scalar((dn + dr) ** -0.5, s.dtype)).to(torch.float32)
    valid = torch.arange(c_kv.shape[1], device=x.device)[None, :] < (positions + 1)[:, None]
    s = torch.where(valid[:, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o_c = torch.einsum("bhs,bsr->bhr", p.to(cd), c_kv.to(cd))  # (B, H, r)
    out = torch.einsum("bhr,rhk->bhk", o_c, params["v_up"]["kernel"].to(cd))  # (B, H, dv)
    y = cm.dense(params["wo"], out[:, None], "...hk,hkd->...d", cd)
    return y, cache
