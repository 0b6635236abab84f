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
``cross_attention`` / ``cross_kv`` serve the encoder-decoder family
(``models/encdec.py``).  ``flash_decode_sharded`` is the reference's
seq-sharded decode over a single-controller mesh (``parallel/mesh.py``):
each (batch, ``model``) shard's partial softmax on its device, merged
after ``collectives.all_gather``.  ``self_attention_tp`` and
``self_attention_decode_tp`` serve tensor parallel: each model shard's
query heads, its block of a cache split on sequence or KV heads.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Optional, Tuple

import numpy as np
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


def _on(t: torch.Tensor, dev) -> torch.Tensor:
    """``t`` on ``dev``: itself when it lies there (no op dispatched)."""
    return t if t.device == dev else t.to(dev)


def _flash_partial(q, k, v, lo, hi, softcap, offset: int):
    """One sequence shard's partial softmax: (m, l, o) float32 for the keys
    at positions ``offset + [0, S_loc)`` (q: (B, H, D); k, v: (B, S_loc,
    KV, *)), heads grouped (B, KV, G) as the reference's shard function."""
    B, H, D = q.shape
    S_loc, KV = k.shape[1], k.shape[2]
    G = H // KV
    kpos = offset + torch.arange(S_loc, device=q.device)
    valid = (kpos[None, :] < hi[:, None]) & (kpos[None, :] >= lo[:, None])
    dt = torch.promote_types(q.dtype, k.dtype)  # jnp.einsum promotes
    q4 = (q * cm.scalar(D ** -0.5, q.dtype)).reshape(B, KV, G, D)
    s = torch.einsum("bkgd,bskd->bkgs", q4.to(dt), k.to(dt))
    s = _softcap(s, softcap).to(torch.float32)
    s = torch.where(valid[:, None, None], s, NEG_INF)
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    o = torch.einsum("bkgs,bskd->bkgd", p.to(v.dtype), v).to(torch.float32)
    return m, l, o


def _lse_merge(om, ol, oo):
    """The shards' partials (m, l, o) stacked along a leading shard axis,
    merged by their log-sum-exp: the softmax-weighted output."""
    m_g = om.amax(dim=0)
    w = torch.exp(om - m_g[None])
    l_g = (ol * w).sum(dim=0)
    o_g = (oo * w[..., None]).sum(dim=0)
    return o_g / torch.clamp_min(l_g[..., None], 1e-30)


def flash_decode_sharded(q1, k_cache, v_cache, lo, hi, softcap, mesh, batch_axes):
    """Seq-sharded flash decode: the KV cache split on its seq dim over the
    ``model`` mesh axis (and the batch over ``batch_axes`` where it
    divides); each shard computes a partial softmax (o, m, l) on its device;
    the partials are LSE-merged after an all-gather over ``model``.

    Takes whole tensors (q1: (B, H, D); caches (B, S, KV, *); lo, hi: (B,))
    and returns (B, H, Dv) in q1's dtype on the mesh's first device.  A
    cache length that does not divide over ``model`` takes
    ``_masked_decode``, as the reference.  Each batch shard's merge runs
    once, on its first ``model`` shard's device (the reference computes it
    on every ``model`` shard, to the same values); a mesh of one cell
    merges one partial, whose weight is 1: ``o / l``, no gather.
    """
    from repro_torch.parallel import collectives

    S, KV = k_cache.shape[1], k_cache.shape[2]
    n_shard = mesh.shape["model"]
    if S % n_shard != 0:
        return _masked_decode(q1, k_cache, v_cache, lo, hi, softcap)
    S_loc = S // n_shard
    B, H = q1.shape[0], q1.shape[1]
    ba = tuple(a for a in batch_axes if a in mesh.shape)
    nb = 1
    for a in ba:
        nb *= mesh.shape[a]
    if B % nb != 0:  # e.g. global_batch=1 long-context decode
        ba, nb = (), 1
    Bl = B // nb
    if nb == 1 and n_shard == 1:
        # one partial: the merge's weight is exp(0) = 1, so its result is
        # o / l exactly, with no gather
        dev = mesh.devices.flat[0]
        m, l, o = _flash_partial(*(_on(t, dev) for t in (q1, k_cache, v_cache, lo, hi)),
                                 softcap, 0)
        return (o / torch.clamp_min(l[..., None], 1e-30)).reshape(B, H, v_cache.shape[-1]).to(
            q1.dtype)
    outs = []
    for i in range(nb):
        idx = np.unravel_index(i, [mesh.shape[a] for a in ba]) if ba else ()
        sub = mesh.sub({a: int(j) for a, j in zip(ba, idx)})
        rows = slice(i * Bl, (i + 1) * Bl)
        parts = []
        for j, dev in enumerate(sub.shard_devices("model")):
            seq = slice(j * S_loc, (j + 1) * S_loc)
            parts.append(_flash_partial(
                _on(q1[rows], dev), _on(k_cache[rows, seq], dev), _on(v_cache[rows, seq], dev),
                _on(lo[rows], dev), _on(hi[rows], dev), softcap, j * S_loc))
        # LSE merge across the model axis
        out = _lse_merge(*(collectives.all_gather(sub, "model", [p[k] for p in parts])[0]
                           for k in range(3)))
        outs.append(out.reshape(Bl, H, v_cache.shape[-1]).to(q1.dtype))
    if not ba:
        return outs[0]
    return collectives.gather(mesh, ba, outs).reshape((B,) + outs[0].shape[1:])


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


def _proj(params, cfg, x, cd, name: str):
    """One of the q, k, v projections (``name``), qk-normed where the
    config says so."""
    y = cm.dense(params["w" + name], x, "...d,dhk->...hk", cd)
    if cfg.qk_norm and name != "v":
        y = cm.headwise_rmsnorm(params["qknorm"][f"{name}_scale"], y, cfg.norm_eps)
    return y


def _qkv(params, cfg, x, cd):
    return tuple(_proj(params, cfg, x, cd, name) for name in "qkv")


def self_attention(
    params, cfg, part, x, *, kind: str,
    positions: Optional[torch.Tensor] = None,
    cache: Optional[Dict[str, torch.Tensor]] = None,
    mesh=None,
) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """Full-sequence self-attention (prefill).

    x: (B, S, d).  If ``cache`` is given, K/V are written into it in place
    and it is returned.  ``mesh`` changes nothing: the reference's GSPMD
    computes the same values."""
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
    ``positions`` (in place), attend over it: over a mesh with a ``model``
    axis through ``flash_decode_sharded`` when the partition asks for the
    flash decode (the reference's route), else ``_masked_decode``."""
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
    if part.flash_decode and mesh is not None and "model" in mesh.shape:
        out = flash_decode_sharded(q[:, 0], k_cache, v_cache, lo, hi, cfg.logit_softcap, mesh,
                                   ("pod", "data"))
    else:
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


def _scatter_cache_range(cache, new, pos, offset: int):
    """``_scatter_cache`` into a block of the cache's sequence that holds
    positions ``offset + [0, S_blk)``: a row whose position lies outside
    it keeps its entry (a masked write on every block, no host sync)."""
    B, S_blk = cache.shape[:2]
    local = pos.long() - offset
    inside = (local >= 0) & (local < S_blk)
    rows = torch.arange(B, device=cache.device)
    idx = torch.where(inside, local, torch.zeros_like(local))
    cache[rows, idx] = torch.where(inside[:, None, None], new[:, 0].to(cache.dtype),
                                   cache[rows, idx])
    return cache


# ---------------------------------------------------------------------------- #
# Tensor-parallel serving: heads over the model shards                          #
# ---------------------------------------------------------------------------- #
#
# The functions below take one value a model shard (``group``: a
# ``parallel.sharding.ModelShards``): parameter blocks, cache blocks, and
# replicated activations (shards that share a device share the tensor).
# Query heads are split when ``wq``'s block holds fewer than H heads; K/V
# heads when ``wk``'s holds fewer than KV (the maybe-shard rule keeps them
# whole where they do not divide: each shard then computes them whole, and
# query head h reads KV head h // (H / KV)).  ``wo`` contracts the heads:
# its partial products are summed by ``collectives.all_reduce`` only where
# the heads are split.  The cache's placement (``split``) is "seq" (its
# sequence over the shards), "kv" (its KV heads) or None (whole).


def _kv_for(k, j: int, Hl: int, H: int, KV: int):
    """The KV heads (dim -2 of ``k``) that query heads ``[j·Hl, (j+1)·Hl)``
    read, grouped as ``chunked_attention`` and the decodes group them
    (query head i of the shard reads KV head i // (Hl / heads returned)).
    ``k`` holds the shard's own KV heads when they are split with the
    query heads (returned as they are), else all KV."""
    if k.shape[-2] != KV or Hl == H:
        return k
    G = H // KV
    lo = j * Hl
    if Hl % G == 0:  # whole groups
        return k[..., lo // G:(lo + Hl) // G, :]
    if G % Hl == 0:  # inside one group
        return k[..., lo // G:lo // G + 1, :]
    return k.index_select(-2, torch.arange(lo, lo + Hl, device=k.device) // G)


def _head_split(ps, cfg):
    """(query heads a shard, query heads split, KV heads split)."""
    Hl = ps[0]["wq"]["kernel"].shape[-2]
    return Hl, Hl < cfg.n_heads, ps[0]["wk"]["kernel"].shape[-2] < cfg.n_kv_heads


def _qkv_tp(ps, cfg, hs, group, angles, cd):
    """Each shard's roped q (its heads) and (k roped, v) (its KV heads, or
    all KV once a device where they are whole)."""
    _, _, kv_split = _head_split(ps, cfg)
    qs = group.each(lambda p, h, a: cm.apply_rope(_proj(p, cfg, h, cd, "q"), *a), ps, hs, angles)
    kvs = (group.each if kv_split else group.once)(
        lambda p, h, a: (cm.apply_rope(_proj(p, cfg, h, cd, "k"), *a), _proj(p, cfg, h, cd, "v")),
        ps, hs, angles)
    return qs, kvs


def self_attention_tp(ps, cfg, part, hs, group, *, kind: str, caches=None, split=None):
    """``self_attention`` (prefill from position 0) over the model shards:
    each shard attends its query heads over the prompt, ``wo`` is row
    parallel.  The cache: split on sequence, each shard writes its rows of
    the prompt's K/V (gathered over the KV heads where they are split);
    on KV heads, its own heads; whole, once a device."""
    from repro_torch.parallel import collectives

    cd = cm.dtype_of(cfg.compute_dtype)
    hd, H, KV = cfg.resolved_head_dim, cfg.n_heads, cfg.n_kv_heads
    S = hs[0].shape[1]
    Hl, heads_split, kv_split = _head_split(ps, cfg)
    theta = _rope_theta_for(cfg, kind)
    angles = group.once(
        lambda h: cm.rope_angles(torch.arange(S, device=h.device)[None, :], hd, theta), hs)
    qs, kvs = _qkv_tp(ps, cfg, hs, group, angles, cd)

    def attend(j, q, kv):
        k, v = (_kv_for(t, j, Hl, H, KV) for t in kv)
        return chunked_attention(q, k, v, causal=(kind != "attn_bidir"),
                                 window=cfg.window if kind == "attn_local" else 0,
                                 chunk_q=part.attn_chunk_q, chunk_kv=part.attn_chunk_kv,
                                 softcap=cfg.logit_softcap)

    outs = (group.each if heads_split else group.once)(attend, range(group.n), qs, kvs)
    ys = cm.dense_row_parallel(group, [p["wo"] for p in ps], outs, "...hk,hkd->...d", cd,
                               heads_split)
    if caches is None:
        return ys
    if "pos" in caches[0]:  # a ring: its KV heads split or whole, never its sequence

        def ring(c, kv):
            for name, t in _ring_from_prefill(c, *kv).items():
                c[name].copy_(t)

        (group.each if split == "kv" else group.once)(ring, caches, kvs)
    elif split == "seq":
        full = kvs
        if kv_split:  # each shard's (2, B, S, KV/n, hd) joined along the heads
            full = collectives.all_gather(group.mesh, "model",
                                          [torch.stack(kv) for kv in kvs], dim=3)
        for j, (c, kv) in enumerate(zip(caches, full)):
            S_blk = c["k"].shape[1]
            lo = j * S_blk
            n = min(max(S - lo, 0), S_blk)
            if n:
                c["k"][:, :n] = kv[0][:, lo:lo + n].to(c["k"].dtype)
                c["v"][:, :n] = kv[1][:, lo:lo + n].to(c["v"].dtype)
    else:

        def write(c, kv):
            c["k"][:, :S] = kv[0].to(c["k"].dtype)
            c["v"][:, :S] = kv[1].to(c["v"].dtype)

        (group.each if split == "kv" else group.once)(write, caches, kvs)
    return ys


def self_attention_decode_tp(ps, cfg, part, hs, group, *, kind: str, positions, caches, split):
    """``self_attention_decode`` over the model shards.  A cache split on
    sequence takes the flash decode: q (and k, v where their heads are
    split) gathered over the heads, the new row written where each row's
    position falls (a masked write on every shard), each shard's partial
    softmax over its rows for every head, the partials LSE-merged on each
    device as ``flash_decode_sharded`` merges them, each shard's heads of
    the result into the row-parallel ``wo``.  A cache split on KV heads,
    or whole, takes ``_masked_decode`` of each shard's heads (the
    reference's route where the sequence does not divide)."""
    from repro_torch.parallel import collectives

    cd = cm.dtype_of(cfg.compute_dtype)
    hd, H, KV = cfg.resolved_head_dim, cfg.n_heads, cfg.n_kv_heads
    Hl, heads_split, kv_split = _head_split(ps, cfg)
    theta = _rope_theta_for(cfg, kind)
    angles = group.once(lambda pos: cm.rope_angles(pos[:, None], hd, theta), positions)
    qs, kvs = _qkv_tp(ps, cfg, hs, group, angles, cd)
    his = group.once(lambda pos: pos + 1, positions)
    los = group.once(lambda hi: torch.clamp_min(hi - cfg.window, 0)
                     if kind == "attn_local" and cfg.window > 0 else torch.zeros_like(hi), his)
    if split == "seq":
        if heads_split:
            KVl = kvs[0][0].shape[2] if kv_split else 0
            got = collectives.all_gather(group.mesh, "model", [
                torch.cat([q, *kv], dim=2) if kv_split else q for q, kv in zip(qs, kvs)])

            def heads(g, w0, w):  # (n, B, 1, ., hd) -> (B, 1, n·w, hd)
                part_ = g[:, :, :, w0:w0 + w]
                return part_.movedim(0, 2).reshape(part_.shape[1], 1, -1, hd)

            q_full = group.once(lambda g: heads(g, 0, Hl), got)
            if kv_split:
                kvs = group.once(lambda g: (heads(g, Hl, KVl), heads(g, Hl + KVl, KVl)), got)
        else:
            q_full = qs

        def partial(j, q, kv, c, pos, lo, hi):
            S_blk = c["k"].shape[1]
            _scatter_cache_range(c["k"], kv[0], pos, j * S_blk)
            _scatter_cache_range(c["v"], kv[1], pos, j * S_blk)
            m, l, o = _flash_partial(q[:, 0], c["k"], c["v"], lo, hi, cfg.logit_softcap,
                                     j * S_blk)
            return torch.cat([o, m[..., None], l[..., None]], dim=-1)

        parts = group.each(partial, range(group.n), q_full, kvs, caches, positions, los, his)
        got = collectives.all_gather(group.mesh, "model", parts)
        Dv = got[0].shape[-1] - 2

        def merge(g, q):
            out = _lse_merge(g[..., Dv], g[..., Dv + 1], g[..., :Dv])
            return out.reshape(out.shape[0], H, Dv).to(q.dtype)

        merged = group.once(merge, got, q_full)
        outs = [o[:, j * Hl:(j + 1) * Hl] for j, o in enumerate(merged)] if heads_split \
            else merged
    else:

        def write(c, kv, pos):
            _scatter_cache(c["k"], kv[0], pos)
            _scatter_cache(c["v"], kv[1], pos)

        (group.each if split == "kv" else group.once)(write, caches, kvs, positions)

        def attend(j, q, c, lo, hi):
            k, v = (_kv_for(c[name], j, Hl, H, KV) for name in ("k", "v"))
            return _masked_decode(q[:, 0], k, v, lo, hi, cfg.logit_softcap)

        outs = (group.each if heads_split else group.once)(attend, range(group.n), qs, caches,
                                                             los, his)
    return cm.dense_row_parallel(group, [p["wo"] for p in ps], [o[:, None] for o in outs],
                                 "...hk,hkd->...d", cd, heads_split)


def cross_attention(
    params, cfg, part, x, *,
    enc_kv: Dict[str, torch.Tensor],  # precomputed {"k","v"}: (B, S_enc, KV, hd)
    decode: bool = False,
    mesh=None,
) -> torch.Tensor:
    """Cross-attention against (precomputed) encoder K/V.  No RoPE.

    ``decode``: one query token (x: (B, 1, d)) attends over every row of
    ``enc_kv``, the zero rows of a cross cache longer than the encoder's
    frames included (the reference's ``hi = S_enc``).  ``mesh`` changes
    nothing, as in the reference."""
    cd = cm.dtype_of(cfg.compute_dtype)
    q = cm.dense(params["wq"], x, "...d,dhk->...hk", cd)
    if cfg.qk_norm:
        q = cm.headwise_rmsnorm(params["qknorm"]["q_scale"], q, cfg.norm_eps)
    k, v = enc_kv["k"].to(cd), enc_kv["v"].to(cd)
    if decode:
        B, S_enc = x.shape[0], k.shape[1]
        lo = torch.zeros((B,), dtype=torch.int32, device=x.device)
        hi = torch.full((B,), S_enc, dtype=torch.int32, device=x.device)
        out = _masked_decode(q[:, 0], k, v, lo, hi, cfg.logit_softcap)[:, None]
    else:
        out = chunked_attention(
            q, k, v, causal=False,
            chunk_q=part.attn_chunk_q, chunk_kv=part.attn_chunk_kv,
            softcap=cfg.logit_softcap,
        )
    return cm.dense(params["wo"], out, "...hk,hkd->...d", cd)


def cross_kv(params, cfg, enc_out: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Cross-attention K/V from encoder outputs, in the compute dtype."""
    cd = cm.dtype_of(cfg.compute_dtype)
    k = cm.dense(params["wk"], enc_out, "...d,dhk->...hk", cd)
    v = cm.dense(params["wv"], enc_out, "...d,dhk->...hk", cd)
    if cfg.qk_norm:
        k = cm.headwise_rmsnorm(params["qknorm"]["k_scale"], k, cfg.norm_eps)
    return {"k": k, "v": v}
