"""Decoder-only LM assembly: block stacks over the repeating layer group,
the training loss, the prefill and decode paths, cache management.

The layer stack is ``n_groups`` repetitions of the config's ``pattern`` (a
tuple of (mixer, ffn) block kinds).  As in the reference, every parameter
of block position ``p`` is stacked over groups (the group dimension leads),
and so is every cache; the forward pass is a Python loop over the groups
(the reference's ``lax.scan``), each group reading views of its slices.

Caches are updated in place: ``lm_prefill`` and ``lm_decode_step`` write
into the cache tensors they are given and return the same tree.

Training (``lm_train_loss``) differentiates the same full-sequence stack
with ``torch.autograd``.  Activation checkpointing follows the partition's
``remat``: ``"full"`` puts a non-reentrant ``torch.utils.checkpoint``
around each block (the reference's ``jax.checkpoint``), ``"dots"`` a
selective checkpoint that keeps the dense products' outputs, ``"none"``
none; with ``scan_layers`` and at least 4 groups the groups are also
checkpointed in ~sqrt(n) chunks (``remat_scan``).  Checkpoints run only
while grad is enabled, so inference runs none.

Served here: the attention mixers (``attn``, ``attn_bidir``,
``attn_local``) and ``mla``, with the ``mlp``, ``moe`` or ``none`` ffn.
The MoE aux losses travel with the activations: each block returns its
sums as outputs (of its checkpoint, when one runs), and the group loop
carries their running totals beside ``x``, so a recompute in the backward
never adds them twice.  The ``mamba``, ``mlstm`` and ``slstm`` mixers wait
for ROADMAP item 11; ``model_zoo.build`` refuses them before any
allocation.  A device mesh waits for item 9b.
"""
from __future__ import annotations

import functools
import math
from typing import Any, Dict

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
    noop_context_fn,
)

from repro_torch.models import common as cm
from repro_torch.models import mla as mla_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models.attention import (
    _qkv,
    attention_specs,
    self_attention,
    self_attention_decode,
)
from repro_torch.models.mlp import mlp_apply, mlp_specs

ATTN_KINDS = ("attn", "attn_bidir", "attn_local")
SERVED_MIXERS = ATTN_KINDS + ("mla",)
SERVED_FFNS = ("mlp", "moe", "none")


def _not_ported(what: str):
    raise NotImplementedError(
        f"{what} is not ported to repro_torch yet (ROADMAP.md queue 1, item 11)")


# --------------------------------------------------------------------------- #
# Block specs                                                                  #
# --------------------------------------------------------------------------- #


def _mixer_specs(cfg, mixer: str, stack: int):
    if mixer in ATTN_KINDS:
        return attention_specs(cfg, stack)
    if mixer == "mla":
        return mla_mod.mla_specs(cfg, stack)
    _not_ported(f"the {mixer!r} mixer")


def _ffn_specs(cfg, ffn: str, stack: int):
    if ffn == "mlp":
        return mlp_specs(cfg, stack)
    if ffn == "moe":
        return moe_mod.moe_specs(cfg, stack)
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
    if mixer == "mla":
        m = cfg.mla
        return {
            "c_kv": PS((B, S, m.kv_lora_rank), ("batch", seq_ax, "kv_lora")),
            "k_rope": PS((B, S, m.rope_head_dim), ("batch", seq_ax, "head_dim")),
        }
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


def _ffn(bp, cfg, ffn: str, x, mesh=None):
    """The block's ffn half.  Returns (x, aux): the MoE aux losses, {} for
    the other ffns."""
    aux = {}
    if ffn != "none":
        h = _norm(bp["ln2"], cfg, x)
        if ffn == "mlp":
            y = mlp_apply(bp["ffn"], cfg, h)
        else:
            y, aux = moe_mod.moe_apply(bp["ffn"], cfg, h, mesh=mesh)
        if cfg.norm_style == "sandwich":
            y = _norm(bp["ln2_post"], cfg, y)
        x = x + y
    return x, aux


def apply_block_full(bp, cfg, part, mixer: str, ffn: str, x, *, positions=None, cache=None,
                     mesh=None, rules=None):
    """Full-sequence block (training / prefill).  Returns (x, cache, aux)."""
    h = _norm(bp["ln1"], cfg, x)
    if mixer == "mla":
        if mesh is not None:
            cm._needs_mesh("apply_block_full(mesh=...)")
        y, new_cache = mla_mod.mla_attention(bp["mixer"], cfg, part, h, positions=positions,
                                             cache=cache)
    else:
        y, new_cache = self_attention(
            bp["mixer"], cfg, part, h, kind=mixer, positions=positions, cache=cache, mesh=mesh)
    if cfg.norm_style == "sandwich":
        y = _norm(bp["ln1_post"], cfg, y)
    x = x + y
    x, aux = _ffn(bp, cfg, ffn, x, mesh)
    return x, new_cache, aux


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
    if mixer in ("attn_local", "mla") and mesh is not None:
        cm._needs_mesh("apply_block_decode(mesh=...)")
    if mixer == "attn_local":
        y, new_cache = _local_ring_decode(
            bp["mixer"], cfg, part, h, positions=positions, cache=cache)
    elif mixer == "mla":
        y, new_cache = mla_mod.mla_attention_decode(
            bp["mixer"], cfg, part, h, positions=positions, cache=cache)
    else:
        y, new_cache = self_attention_decode(
            bp["mixer"], cfg, part, h, kind=mixer, positions=positions, cache=cache, mesh=mesh)
    if cfg.norm_style == "sandwich":
        y = _norm(bp["ln1_post"], cfg, y)
    x = x + y
    x, _ = _ffn(bp, cfg, ffn, x, mesh)
    return x, new_cache


# --------------------------------------------------------------------------- #
# Group loop and activation checkpointing                                      #
# --------------------------------------------------------------------------- #


def _group(tree, g: int):
    """Views of group ``g`` of a stacked tree."""
    if isinstance(tree, dict):
        return {k: _group(v, g) for k, v in tree.items()}
    return tree[g]


def _groups(tree, n: int):
    """The ``n`` group views of a stacked tree (None: ``n`` Nones).  One
    ``unbind`` a leaf: its backward stacks the groups' gradients once, where
    a view a group would add a zero-padded full-size gradient per group."""
    if tree is None:
        return [None] * n
    if isinstance(tree, tuple):
        per_item = [_groups(t, n) for t in tree]
        return [tuple(items[g] for items in per_item) for g in range(n)]
    if isinstance(tree, dict):
        per_key = {k: _groups(v, n) for k, v in tree.items()}
        return [{k: per_key[k][g] for k in tree} for g in range(n)]
    return list(torch.unbind(tree, 0))


_MM, _BMM = torch.ops.aten.mm.default, torch.ops.aten.bmm.default


def _save_dense_products(ctx, op, *args, **kwargs):
    """``jax.checkpoint_policies.dots_with_no_batch_dims_saveable``: keep the
    outputs of products without batch dimensions — ``aten.mm``, and
    ``aten.bmm`` over a batch of one, which is how ``torch.einsum`` lowers
    ``dense`` — and recompute the rest (attention's batched products)."""
    if op is _MM or (op is _BMM and args[0].shape[0] == 1):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat_policy(part):
    """The checkpoint's ``context_fn`` for ``part.remat`` (None: no
    checkpoint).  ``"full"`` saves nothing inside the checkpointed region."""
    if part.remat == "full":
        return noop_context_fn
    if part.remat == "dots":
        return functools.partial(create_selective_checkpoint_contexts, _save_dense_products)
    return None


def _checkpointed(fn, policy):
    """``fn`` under a non-reentrant activation checkpoint with ``policy`` (a
    ``context_fn``); ``fn`` itself without a policy or while grad is off."""
    if policy is None or not torch.is_grad_enabled():
        return fn
    return functools.partial(checkpoint, fn, use_reentrant=False, preserve_rng_state=False,
                             context_fn=policy)


def remat_scan(body, carry, xs, n: int, policy, scan: bool = True):
    """``body(carry, x_g) -> carry`` over the ``n`` groups of the stacked
    tree ``xs``; returns the last carry.  (The reference's scan also stacks
    per-group outputs: the prefill's caches, which the port writes in place.)

    With a policy, ``scan`` and ``n >= 4`` (and grad enabled), the groups
    run as ``no`` ~ sqrt(n) outer chunks of ``n // no``, each chunk under a
    checkpoint: the backward keeps only the chunk boundaries plus one chunk
    recomputed (O(sqrt(L)·carry + block) activations, as the reference's
    factored scan)."""
    groups = _groups(xs, n)

    def run(c, chunk):
        for xg in chunk:
            c = body(c, xg)
        return c

    if not scan or policy is None or n < 4 or not torch.is_grad_enabled():
        return run(carry, groups)
    no = int(math.ceil(math.sqrt(n)))
    while n % no:
        no += 1
    ni = n // no
    outer = _checkpointed(run, policy)
    for o in range(no):
        carry = outer(carry, groups[o * ni:(o + 1) * ni])
    return carry


def run_stack_full(params_blocks, cfg, part, x, *, positions=None, caches=None, mesh=None,
                   rules=None, collect_aux=True):
    """Run the stacked block groups over a full-sequence input (prefill and
    training), writing the caches in place when given.  Returns (x, caches,
    aux): the MoE aux-loss sums over the blocks (float32; zero without an
    MoE block or with ``collect_aux`` off).

    The sums ride in the group carry ``(x, lb, z)`` and leave each block as
    outputs of its checkpoint, so the backward's recompute of a block or a
    chunk of groups never adds them again."""
    policy = _remat_policy(part)

    def group_fn(carry, xs):
        x, lb, z = carry
        gp, gc = xs
        for i, (mixer, ffn) in enumerate(cfg.pattern):
            def block_fn(bp, x, cache, _mixer=mixer, _ffn=ffn):
                return apply_block_full(bp, cfg, part, _mixer, _ffn, x, positions=positions,
                                        cache=cache, mesh=mesh, rules=rules)

            # remat at block granularity: the backward recomputes one block's
            # internals at a time
            x, _, aux = _checkpointed(block_fn, policy)(
                gp[f"p{i}"], x, None if gc is None else gc[f"p{i}"])
            if aux and collect_aux:
                lb = lb + aux["load_balance_loss"]
                z = z + aux["router_z_loss"]
        return x, lb, z

    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    x, lb, z = remat_scan(group_fn, (x, zero, zero), (params_blocks, caches), cfg.n_groups,
                          policy, scan=part.scan_layers)
    return x, caches, {"load_balance_loss": lb, "router_z_loss": z}


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
    """Cross-entropy in float32.  logits: (B,S,V); labels: (B,S) int.

    The mean of ``logsumexp - gold`` over the ``valid`` positions (all when
    None), plus ``z_weight`` times the mean squared logsumexp.  The
    reference's vocab-sharded form on a mesh waits for item 9b."""
    if mesh is not None:
        cm._needs_mesh("softmax_xent(mesh=...)")
    lg = logits.to(torch.float32)
    lse = torch.logsumexp(lg, dim=-1)
    gold = torch.gather(lg, -1, labels[..., None].long())[..., 0]
    nll = lse - gold
    valid = torch.ones_like(nll) if valid is None else valid.to(torch.float32)
    denom = torch.clamp_min(valid.sum(), 1.0)
    loss = (nll * valid).sum() / denom
    if z_weight:
        loss = loss + z_weight * ((lse ** 2) * valid).sum() / denom
    return loss


def lm_train_loss(params, cfg, part, batch, mesh=None, rules=None):
    """batch: {"tokens": (B,S), "labels": (B,S)} (+ "patches" for a VLM,
    "valid" to mask positions).  Returns (loss, metrics): with MoE blocks the
    loss adds ``aux_loss_weight`` times the load-balance sum and 1e-3 times
    the z-loss sum; ``metrics["loss"]`` is the plain cross-entropy."""
    if mesh is not None:
        cm._needs_mesh("lm_train_loss(mesh=...)")
    x = embed_tokens(params, cfg, batch["tokens"], batch.get("patches"))
    x, _, aux = run_stack_full(params["blocks"], cfg, part, x, rules=rules)
    x = cm.rmsnorm(params["final_norm"], x, cfg.norm_eps,
                   compute_dtype=cm.dtype_of(cfg.compute_dtype))
    logits = lm_head(params, cfg, x)
    if cfg.modality == "vision" and cfg.n_prefix_tokens:
        # patch positions carry no next-token target
        logits = logits[:, cfg.n_prefix_tokens:]
    loss = softmax_xent(logits, batch["labels"], batch.get("valid"))
    total = loss
    if cfg.moe is not None:
        total = total + cfg.moe.aux_loss_weight * aux["load_balance_loss"] \
            + 1e-3 * aux["router_z_loss"]
    return total, {"loss": loss, **aux}


# --------------------------------------------------------------------------- #
# Top-level LM functions                                                       #
# --------------------------------------------------------------------------- #


def lm_prefill(params, cfg, part, tokens, caches, *, patches=None, mesh=None, rules=None):
    """Prefill: run the full sequence, writing the decode caches in place.

    Returns (logits_last (B, V), caches)."""
    x = embed_tokens(params, cfg, tokens, patches)
    x = cm.constrain(x, mesh, rules, ("batch", None, None))
    x, caches, _ = run_stack_full(
        params["blocks"], cfg, part, x, caches=caches, mesh=mesh, rules=rules,
        collect_aux=False)
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
