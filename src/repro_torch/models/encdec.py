"""Encoder-decoder assembly (seamless-m4t family).

Encoder: bidirectional attention blocks over (stub) audio frame embeddings —
the modality frontend provides precomputed (B, S_enc, frontend_dim) frames;
a linear projector maps them into d_model.

Decoder: causal self-attention + cross-attention + MLP blocks over text
tokens, with a self KV cache and precomputed cross K/V for serving.

Shape conventions (the reference's):
  train:   S_enc = shape.seq_len frames, S_dec = seq_len // dec_ratio tokens
  prefill: encoder forward over the frames + cross-KV precompute + decoder
           prefill over the prompt tokens
  decode:  one decoder token against a self cache and a cross cache of the
           cache length (the decode step attends over every row of the cross
           cache, zero rows past the frames included, as the reference does).

As in the decoder-only stack, the layers are a Python loop over the stacked
parameters (the reference's ``lax.scan``), checkpointed by the partition's
``remat`` (``transformer._remat_policy``, ``remat_scan``) while grad is
enabled, and the caches are written in place: prefill writes the self
caches and the cross K/V (cast to bf16, then to the cache's dtype) into the
first ``S_enc`` rows of the cross cache; a decode step writes its self-cache
row and leaves the cross cache as it is.  On a mesh the functions compute
what they compute off it on the tensors they are given (the decode step's
self-attention takes the flash decode when the partition asks for it).
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.models import common as cm
from repro_torch.models.attention import (
    attention_specs,
    cross_attention,
    cross_kv,
    self_attention,
    self_attention_decode,
)
from repro_torch.models.mlp import mlp_apply, mlp_specs
from repro_torch.models.transformer import (
    _checkpointed,
    _group,
    _norm,
    _remat_policy,
    lm_head,
    remat_scan,
    softmax_xent,
)


# --------------------------------------------------------------------------- #
# Specs                                                                        #
# --------------------------------------------------------------------------- #


def encdec_specs(cfg, part) -> Dict[str, Any]:
    d = cfg.d_model
    enc_stack = cfg.enc_layers
    dec_stack = cfg.n_layers
    p: Dict[str, Any] = {
        "frontend_proj": cm.dense_spec((cfg.frontend_dim,), (d,), ("frontend",), ("embed",)),
        "embed": cm.embed_spec(cfg.vocab, d),
        "encoder": {
            "ln1": cm.norm_spec(d, stack=enc_stack),
            "attn": attention_specs(cfg, enc_stack),
            "ln2": cm.norm_spec(d, stack=enc_stack),
            "mlp": mlp_specs(cfg, enc_stack),
        },
        "enc_norm": cm.norm_spec(d, stack=0),
        "decoder": {
            "ln1": cm.norm_spec(d, stack=dec_stack),
            "self": attention_specs(cfg, dec_stack),
            "ln_cross": cm.norm_spec(d, stack=dec_stack),
            "cross": attention_specs(cfg, dec_stack),
            "ln2": cm.norm_spec(d, stack=dec_stack),
            "mlp": mlp_specs(cfg, dec_stack),
        },
        "final_norm": cm.norm_spec(d, stack=0),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = cm.dense_spec((d,), (cfg.vocab,), ("embed",), ("vocab",))
    return p


def encdec_cache_specs(cfg, part, B: int, S: int) -> Dict[str, Any]:
    """Self cache (dec_stack, B, S, KV, hd) + cross K/V of the same S_enc=S."""
    KV, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    seq_ax = "kv_seq" if part.flash_decode else None
    kv = cm.ParamSpec(
        (cfg.n_layers, B, S, KV, hd),
        ("layers", "batch", seq_ax, "kv_heads", "head_dim"),
        "zeros", dtype=torch.bfloat16)
    return {"self": {"k": kv, "v": kv}, "cross": {"k": kv, "v": kv}}


# --------------------------------------------------------------------------- #
# Encoder                                                                      #
# --------------------------------------------------------------------------- #


def encode_frames(params, cfg, part, frames, mesh=None, rules=None):
    """frames: (B, S_enc, frontend_dim) -> (B, S_enc, d)."""
    cd = cm.dtype_of(cfg.compute_dtype)
    x = cm.dense(params["frontend_proj"], frames, "...f,fd->...d", cd)
    x = cm.constrain(x, mesh, rules, ("batch", None, None))

    def layer_fn(x, lp):
        h = _norm(lp["ln1"], cfg, x)
        y, _ = self_attention(lp["attn"], cfg, part, h, kind="attn_bidir", mesh=mesh)
        x = x + y
        h = _norm(lp["ln2"], cfg, x)
        return x + mlp_apply(lp["mlp"], cfg, h)

    policy = _remat_policy(part)
    x = remat_scan(_checkpointed(layer_fn, policy), x, params["encoder"], cfg.enc_layers,
                   policy)
    return _norm(params["enc_norm"], cfg, x)


def encode_cross_kv(params, cfg, enc_out):
    """Per-decoder-layer cross K/V from encoder output, bf16: (L, B, S, KV, hd)."""
    ks, vs = [], []
    for layer in range(cfg.n_layers):
        kv = cross_kv(_group(params["decoder"]["cross"], layer), cfg, enc_out)
        ks.append(kv["k"].to(torch.bfloat16))
        vs.append(kv["v"].to(torch.bfloat16))
    return {"k": torch.stack(ks), "v": torch.stack(vs)}


# --------------------------------------------------------------------------- #
# Decoder                                                                      #
# --------------------------------------------------------------------------- #


def _dec_layer_full(lp, cfg, part, x, enc_out, self_cache, mesh=None):
    """One decoder layer.  Cross K/V are computed here from ``enc_out`` in
    the compute dtype (and recomputed in the backward under remat): all
    layers' cross K/V computed up front would keep L x 2 (B, S_enc, KV, hd)
    tensors alive."""
    h = _norm(lp["ln1"], cfg, x)
    y, _ = self_attention(lp["self"], cfg, part, h, kind="attn", cache=self_cache, mesh=mesh)
    x = x + y
    h = _norm(lp["ln_cross"], cfg, x)
    kv = cross_kv(lp["cross"], cfg, enc_out)
    x = x + cross_attention(lp["cross"], cfg, part, h, enc_kv=kv, mesh=mesh)
    h = _norm(lp["ln2"], cfg, x)
    return x + mlp_apply(lp["mlp"], cfg, h)


def decoder_forward(params, cfg, part, tokens, enc_out, *,
                    self_caches=None, mesh=None, rules=None):
    """Teacher-forced decoder.  tokens: (B, S_dec); enc_out: (B, S_enc, d).
    Writes the self caches in place when given.  Returns (hidden, the self
    caches or None)."""
    x = cm.embed_lookup(params["embed"], tokens, cm.dtype_of(cfg.compute_dtype))

    def layer_fn(x, xs):
        lp, sc = xs
        return _dec_layer_full(lp, cfg, part, x, enc_out, sc, mesh)

    policy = _remat_policy(part)
    x = remat_scan(_checkpointed(layer_fn, policy), x, (params["decoder"], self_caches),
                   cfg.n_layers, policy)
    return _norm(params["final_norm"], cfg, x), self_caches


# --------------------------------------------------------------------------- #
# Top-level steps                                                              #
# --------------------------------------------------------------------------- #


def encdec_train_loss(params, cfg, part, batch, mesh=None, rules=None):
    """batch: {"frames": (B,S_enc,F), "tokens": (B,S_dec), "labels": (B,S_dec)}
    (+ "valid").  Returns (loss, {"loss": loss})."""
    enc_out = encode_frames(params, cfg, part, batch["frames"], mesh, rules)
    x, _ = decoder_forward(params, cfg, part, batch["tokens"], enc_out, mesh=mesh, rules=rules)
    logits = lm_head(params, cfg, x)
    loss = softmax_xent(logits, batch["labels"], batch.get("valid"), mesh=mesh)
    return loss, {"loss": loss}


def encdec_prefill(params, cfg, part, batch, caches, *, mesh=None, rules=None):
    """Encoder forward + cross-KV precompute + decoder prefill.

    batch: {"frames": (B, S_enc, F), "tokens": (B, S_dec)}.
    caches: {"self": ..., "cross": ...} of length >= S_enc (cross) and
    >= S_dec (self), written in place.  Returns (last logits (B, V), caches)."""
    enc_out = encode_frames(params, cfg, part, batch["frames"], mesh, rules)
    cross = encode_cross_kv(params, cfg, enc_out)
    S_enc = enc_out.shape[1]
    for name in ("k", "v"):
        cache = caches["cross"][name]
        cache[:, :, :S_enc] = cross[name].to(cache.dtype)
    del cross
    x, _ = decoder_forward(params, cfg, part, batch["tokens"], enc_out,
                           self_caches=caches["self"], mesh=mesh, rules=rules)
    logits = lm_head(params, cfg, x[:, -1:])[:, 0]
    return logits, caches


def encdec_decode_step(params, cfg, part, tokens, positions, caches, *,
                       mesh=None, rules=None):
    """One decoder token.  tokens: (B, 1); positions: (B,); caches:
    {"self", "cross"} stacked over layers.  Writes the self caches in place;
    returns (logits (B, V), caches)."""
    x = cm.embed_lookup(params["embed"], tokens, cm.dtype_of(cfg.compute_dtype))
    for layer in range(cfg.n_layers):
        lp = _group(params["decoder"], layer)
        h = _norm(lp["ln1"], cfg, x)
        y, _ = self_attention_decode(lp["self"], cfg, part, h, kind="attn",
                                     positions=positions, cache=_group(caches["self"], layer),
                                     mesh=mesh)
        x = x + y
        h = _norm(lp["ln_cross"], cfg, x)
        x = x + cross_attention(lp["cross"], cfg, part, h,
                                enc_kv=_group(caches["cross"], layer), decode=True, mesh=mesh)
        h = _norm(lp["ln2"], cfg, x)
        x = x + mlp_apply(lp["mlp"], cfg, h)
    x = _norm(params["final_norm"], cfg, x)
    return lm_head(params, cfg, x)[:, 0], caches
