"""Decoder-only LM assembly for serving: block stacks over the repeating
layer group, the prefill and decode paths, cache management.

The layer stack is ``n_groups`` repetitions of the config's ``pattern`` (a
tuple of (mixer, ffn) block kinds).  As in the reference, every parameter
of block position ``p`` is stacked over groups (the group dimension leads),
and so is every cache; the forward pass is a Python loop over the groups
(the reference's ``lax.scan``), each group reading views of its slices.

Caches are updated in place: ``lm_prefill`` and ``lm_decode_step`` write
into the cache tensors they are given and return the same tree.

Served here: the attention mixers (``attn``, ``attn_bidir``,
``attn_local``) with the ``mlp`` or ``none`` ffn.  The ``mla``, ``mamba``,
``mlstm`` and ``slstm`` mixers, the ``moe`` ffn and training
(``_remat_policy``, ``remat_scan``, ``softmax_xent``, ``lm_train_loss``)
wait for ROADMAP item 11; ``model_zoo.build`` refuses them before any
allocation.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.models import common as cm
from repro_torch.models.attention import (
    _qkv,
    attention_specs,
    self_attention,
    self_attention_decode,
)
from repro_torch.models.mlp import mlp_apply, mlp_specs

ATTN_KINDS = ("attn", "attn_bidir", "attn_local")
SERVED_FFNS = ("mlp", "none")


def _not_ported(what: str):
    raise NotImplementedError(
        f"{what} is not ported to repro_torch yet (ROADMAP.md queue 1, item 11)")


# --------------------------------------------------------------------------- #
# Block specs                                                                  #
# --------------------------------------------------------------------------- #


def _mixer_specs(cfg, mixer: str, stack: int):
    if mixer in ATTN_KINDS:
        return attention_specs(cfg, stack)
    _not_ported(f"the {mixer!r} mixer")


def _ffn_specs(cfg, ffn: str, stack: int):
    if ffn == "mlp":
        return mlp_specs(cfg, stack)
    if ffn == "none":
        return None
    _not_ported(f"the {ffn!r} ffn")


def block_specs(cfg, mixer: str, ffn: str, stack: int):
    style = "rms"
    p: Dict[str, Any] = {
        "ln1": cm.norm_spec(cfg.d_model, stack=stack, style=style),
        "mixer": _mixer_specs(cfg, mixer, stack),
    }
    if cfg.norm_style == "sandwich":
        p["ln1_post"] = cm.norm_spec(cfg.d_model, stack=stack, style=style)
    f = _ffn_specs(cfg, ffn, stack)
    if f is not None:
        p["ln2"] = cm.norm_spec(cfg.d_model, stack=stack, style=style)
        p["ffn"] = f
        if cfg.norm_style == "sandwich":
            p["ln2_post"] = cm.norm_spec(cfg.d_model, stack=stack, style=style)
    return p


def lm_specs(cfg, part) -> Dict[str, Any]:
    """Full parameter spec tree for a decoder-only LM."""
    stack = cfg.n_groups
    p: Dict[str, Any] = {"embed": cm.embed_spec(cfg.vocab, cfg.d_model)}
    p["blocks"] = {
        f"p{i}": block_specs(cfg, mixer, ffn, stack)
        for i, (mixer, ffn) in enumerate(cfg.pattern)
    }
    p["final_norm"] = cm.norm_spec(cfg.d_model, stack=0)
    if not cfg.tie_embeddings:
        p["lm_head"] = cm.dense_spec(
            (cfg.d_model,), (cfg.vocab,), ("embed",), ("vocab",), scale=1.0
        )
    if cfg.modality == "vision":
        p["frontend_proj"] = cm.dense_spec(
            (cfg.frontend_dim,), (cfg.d_model,), ("frontend",), ("embed",)
        )
    return p


# --------------------------------------------------------------------------- #
# Cache specs                                                                  #
# --------------------------------------------------------------------------- #


def _mixer_cache_specs(cfg, part, mixer: str, B: int, S: int, stack: int):
    """ParamSpec tree for one mixer's decode cache (stacked over groups)."""
    bf16 = torch.bfloat16
    KV, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    seq_ax = "kv_seq" if part.flash_decode else None
    L = ("layers",)

    def PS(shape, axes, dtype=bf16):
        return cm.ParamSpec((stack,) + shape, L + axes, "zeros", dtype=dtype)

    if mixer in ("attn", "attn_bidir"):
        kv = PS((B, S, KV, hd), ("batch", seq_ax, "kv_heads", "head_dim"))
        return {"k": kv, "v": kv}
    if mixer == "attn_local":
        W = min(cfg.window, S)
        kv = PS((B, W, KV, hd), ("batch", None, "kv_heads", "head_dim"))
        pos = PS((B, W), ("batch", None), dtype=torch.int32)
        return {"k": kv, "v": kv, "pos": pos}
    _not_ported(f"the {mixer!r} mixer's cache")


def cache_specs(cfg, part, B: int, S: int) -> Dict[str, Any]:
    stack = cfg.n_groups
    return {
        f"p{i}": _mixer_cache_specs(cfg, part, mixer, B, S, stack)
        for i, (mixer, _) in enumerate(cfg.pattern)
    }


def init_cache(cfg, part, B: int, S: int, device):
    """Zero caches on ``device`` (an ``attn_local`` ring's pos at -1)."""
    specs = cache_specs(cfg, part, B, S)
    caches = cm.map_specs(
        lambda s: torch.zeros(s.shape, dtype=s.dtype, device=device), specs)
    for i, (mixer, _) in enumerate(cfg.pattern):
        if mixer == "attn_local":
            caches[f"p{i}"]["pos"].fill_(-1)
    return caches


# --------------------------------------------------------------------------- #
# Block application                                                            #
# --------------------------------------------------------------------------- #


def _norm(params, cfg, x):
    return cm.rmsnorm(params, x, cfg.norm_eps, compute_dtype=cm.dtype_of(cfg.compute_dtype))


def _ffn(bp, cfg, ffn: str, x):
    if ffn != "none":
        h = _norm(bp["ln2"], cfg, x)
        y = mlp_apply(bp["ffn"], cfg, h)
        if cfg.norm_style == "sandwich":
            y = _norm(bp["ln2_post"], cfg, y)
        x = x + y
    return x


def apply_block_full(bp, cfg, part, mixer: str, ffn: str, x, *, positions=None, cache=None,
                     mesh=None, rules=None):
    """Full-sequence block (prefill).  Returns (x, cache)."""
    h = _norm(bp["ln1"], cfg, x)
    y, new_cache = self_attention(
        bp["mixer"], cfg, part, h, kind=mixer, positions=positions, cache=cache, mesh=mesh)
    if cfg.norm_style == "sandwich":
        y = _norm(bp["ln1_post"], cfg, y)
    x = x + y
    return _ffn(bp, cfg, ffn, x), new_cache


def _local_ring_decode(params, cfg, part, x, *, positions, cache):
    """Sliding-window decode against a ring cache of width W, in place.

    cache: k/v (B, W, KV, hd) with RoPE pre-applied at write; pos (B, W)
    absolute positions (-1 = empty).  The new entry lands in slot pos % W —
    the ring keeps exactly the last W positions, so validity is
    ``pos >= 0``."""
    cd = cm.dtype_of(cfg.compute_dtype)
    hd = cfg.resolved_head_dim
    B = x.shape[0]
    W = cache["k"].shape[1]
    q, k_new, v_new = _qkv(params, cfg, x, cd)
    cos, sin = cm.rope_angles(positions[:, None], hd, cfg.rope_local_theta)
    q = cm.apply_rope(q, cos, sin)
    k_new = cm.apply_rope(k_new, cos, sin)
    rows = torch.arange(B, device=x.device)
    slot = (positions % W).long()
    cache["k"][rows, slot] = k_new[:, 0].to(cache["k"].dtype)
    cache["v"][rows, slot] = v_new[:, 0].to(cache["v"].dtype)
    cache["pos"][rows, slot] = positions.to(cache["pos"].dtype)
    # attend over valid ring slots
    KV, H = cfg.n_kv_heads, cfg.n_heads
    G = H // KV
    q4 = (q[:, 0] * cm.scalar(hd ** -0.5, q.dtype)).reshape(B, KV, G, hd)
    s = torch.einsum("bkgd,bskd->bkgs", q4, cache["k"].to(cd)).to(torch.float32)
    if cfg.logit_softcap:
        s = torch.tanh(s / cfg.logit_softcap) * cfg.logit_softcap
    valid = cache["pos"] >= 0
    s = torch.where(valid[:, None, None], s, -1e30)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", p.to(cd), cache["v"].to(cd))
    out = out.reshape(B, 1, H, hd)
    y = cm.dense(params["wo"], out, "...hk,hkd->...d", cd)
    return y, cache


def apply_block_decode(bp, cfg, part, mixer: str, ffn: str, x, *, positions, cache, mesh=None,
                       rules=None):
    """Single-token block.  x: (B, 1, d).  Returns (x, cache)."""
    h = _norm(bp["ln1"], cfg, x)
    if mixer == "attn_local":
        if mesh is not None:
            cm._needs_mesh("apply_block_decode(mesh=...)")
        y, new_cache = _local_ring_decode(
            bp["mixer"], cfg, part, h, positions=positions, cache=cache)
    else:
        y, new_cache = self_attention_decode(
            bp["mixer"], cfg, part, h, kind=mixer, positions=positions, cache=cache, mesh=mesh)
    if cfg.norm_style == "sandwich":
        y = _norm(bp["ln1_post"], cfg, y)
    x = x + y
    return _ffn(bp, cfg, ffn, x), new_cache


# --------------------------------------------------------------------------- #
# Group loop                                                                   #
# --------------------------------------------------------------------------- #


def _group(tree, g: int):
    """Views of group ``g`` of a stacked tree."""
    if isinstance(tree, dict):
        return {k: _group(v, g) for k, v in tree.items()}
    return tree[g]


def run_stack_full(params_blocks, cfg, part, x, *, positions=None, caches=None, mesh=None,
                   rules=None):
    """Run the stacked block groups over a full-sequence input (prefill),
    writing the caches in place when given.  Returns (x, caches) (the
    reference also returns the MoE aux losses, which the served ffns do not
    have)."""
    for g in range(cfg.n_groups):
        gp = _group(params_blocks, g)
        gc = None if caches is None else _group(caches, g)
        for i, (mixer, ffn) in enumerate(cfg.pattern):
            x, _ = apply_block_full(
                gp[f"p{i}"], cfg, part, mixer, ffn, x, positions=positions,
                cache=None if gc is None else gc[f"p{i}"], mesh=mesh, rules=rules)
    return x, caches


def run_stack_decode(params_blocks, cfg, part, x, *, positions, caches, mesh=None, rules=None):
    """Run the block groups for one decode step, updating the caches in
    place.  Returns (x, caches)."""
    for g in range(cfg.n_groups):
        gp, gc = _group(params_blocks, g), _group(caches, g)
        for i, (mixer, ffn) in enumerate(cfg.pattern):
            x, _ = apply_block_decode(
                gp[f"p{i}"], cfg, part, mixer, ffn, x,
                positions=positions, cache=gc[f"p{i}"], mesh=mesh, rules=rules)
    return x, caches


# --------------------------------------------------------------------------- #
# Embedding / head                                                             #
# --------------------------------------------------------------------------- #


def embed_tokens(params, cfg, tokens, patches=None):
    """tokens: (B, S_tok); patches: (B, n_prefix, frontend_dim) for VLMs.
    Returns (B, S, d) with patches projected and prefixed."""
    cd = cm.dtype_of(cfg.compute_dtype)
    x = cm.embed_lookup(params["embed"], tokens, cd)
    if cfg.embed_scale:
        x = x * cm.scalar(cfg.d_model ** 0.5, cd)
    if patches is not None:
        px = cm.dense(params["frontend_proj"], patches, "...f,fd->...d", cd)
        x = torch.cat([px, x], dim=1)
    return x


def lm_head(params, cfg, x):
    cd = cm.dtype_of(cfg.compute_dtype)
    if cfg.tie_embeddings:
        w = params["embed"]["embedding"].to(cd)  # (V, d)
        return torch.einsum("...d,vd->...v", x, w)
    return cm.dense(params["lm_head"], x, "...d,dv->...v", cd)


def softmax_xent(logits, labels, valid=None, z_weight: float = 0.0, mesh=None):
    _not_ported("training (softmax_xent)")


def lm_train_loss(params, cfg, part, batch, mesh=None, rules=None):
    _not_ported("training (lm_train_loss)")


# --------------------------------------------------------------------------- #
# Top-level LM functions                                                       #
# --------------------------------------------------------------------------- #


def lm_prefill(params, cfg, part, tokens, caches, *, patches=None, mesh=None, rules=None):
    """Prefill: run the full sequence, writing the decode caches in place.

    Returns (logits_last (B, V), caches)."""
    x = embed_tokens(params, cfg, tokens, patches)
    x = cm.constrain(x, mesh, rules, ("batch", None, None))
    x, caches = run_stack_full(
        params["blocks"], cfg, part, x, caches=caches, mesh=mesh, rules=rules)
    x = cm.rmsnorm(params["final_norm"], x, cfg.norm_eps,
                   compute_dtype=cm.dtype_of(cfg.compute_dtype))
    logits = lm_head(params, cfg, x[:, -1:])[:, 0]
    return logits, caches


def lm_decode_step(params, cfg, part, tokens, positions, caches, *, mesh=None, rules=None):
    """One decode step.  tokens: (B, 1); positions: (B,).  Updates the
    caches in place.  Returns (logits (B, V), caches)."""
    x = embed_tokens(params, cfg, tokens)
    x, caches = run_stack_decode(
        params["blocks"], cfg, part, x, positions=positions, caches=caches,
        mesh=mesh, rules=rules)
    x = cm.rmsnorm(params["final_norm"], x, cfg.norm_eps,
                   compute_dtype=cm.dtype_of(cfg.compute_dtype))
    logits = lm_head(params, cfg, x)[:, 0]
    return logits, caches
