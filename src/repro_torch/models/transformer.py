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
``attn_local``), ``mla`` and the recurrent ``mamba``, ``mlstm`` and
``slstm``, with the ``mlp``, ``moe`` or ``none`` ffn.  A recurrent mixer's
cache is its state (``ssm``/``conv``; ``C``/``n``/``m``/``conv``;
``state``: ``c``/``n``/``h``/``m``, one level deeper), written in place as
the attention caches are.  The MoE aux losses travel with the activations:
each block returns its sums as outputs (of its checkpoint, when one runs),
and the group loop carries their running totals beside ``x``, so a
recompute in the backward never adds them twice.  On a mesh (``mesh=``)
the functions compute what they compute off it on the tensors they are
given (the serving engine and the train step hand each data-parallel shard
its rows); ``constrain`` checks the logical placements, the decode's
attention takes the flash decode (``attention.flash_decode_sharded``) when
the partition asks for it, as the reference's, and the vocab-sharded loss
waits for item 9b.3b.  Tensor-parallel serving (a ``model`` axis above 1)
is ``lm_prefill_tp``/``lm_decode_step_tp``, at the end of the module.
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
from repro_torch.models import ssm as ssm_mod
from repro_torch.models import xlstm as xlstm_mod
from repro_torch.models.attention import (
    _qkv,
    attention_specs,
    self_attention,
    self_attention_decode,
)
from repro_torch.models.mlp import mlp_apply, mlp_apply_tp, mlp_specs

ATTN_KINDS = ("attn", "attn_bidir", "attn_local")
#: the recurrent mixers' (specs, full-sequence, single-token) functions
RECURRENT = {
    "mamba": (ssm_mod.ssm_specs, ssm_mod.ssm_apply, ssm_mod.ssm_decode),
    "mlstm": (xlstm_mod.mlstm_specs, xlstm_mod.mlstm_apply, xlstm_mod.mlstm_decode),
    "slstm": (xlstm_mod.slstm_specs, xlstm_mod.slstm_apply, xlstm_mod.slstm_decode),
}


# --------------------------------------------------------------------------- #
# Block specs                                                                  #
# --------------------------------------------------------------------------- #


def _mixer_specs(cfg, mixer: str, stack: int):
    if mixer in ATTN_KINDS:
        return attention_specs(cfg, stack)
    if mixer == "mla":
        return mla_mod.mla_specs(cfg, stack)
    if mixer in RECURRENT:
        return RECURRENT[mixer][0](cfg, stack)
    raise ValueError(f"unknown mixer {mixer}")


def _ffn_specs(cfg, ffn: str, stack: int):
    if ffn == "mlp":
        return mlp_specs(cfg, stack)
    if ffn == "moe":
        return moe_mod.moe_specs(cfg, stack)
    if ffn == "none":
        return None
    raise ValueError(f"unknown ffn {ffn}")


def block_specs(cfg, mixer: str, ffn: str, stack: int, cross: bool = False):
    """One block position's specs; ``cross`` adds a cross-attention
    (``ln_cross``, ``cross``) after the mixer."""
    style = "rms"
    p: Dict[str, Any] = {
        "ln1": cm.norm_spec(cfg.d_model, stack=stack, style=style),
        "mixer": _mixer_specs(cfg, mixer, stack),
    }
    if cfg.norm_style == "sandwich":
        p["ln1_post"] = cm.norm_spec(cfg.d_model, stack=stack, style=style)
    if cross:
        p["ln_cross"] = cm.norm_spec(cfg.d_model, stack=stack, style=style)
        p["cross"] = attention_specs(cfg, stack)
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
    f32 = torch.float32
    if mixer == "mamba":
        s = cfg.ssm
        d_in = s.expand * cfg.d_model
        return {
            "ssm": PS((B, d_in, s.d_state), ("batch", "dinner", "dstate"), f32),
            "conv": PS((B, s.d_conv - 1, d_in), ("batch", None, "dinner")),
        }
    if mixer == "mlstm":
        x = cfg.xlstm
        d_in = int(x.mlstm_proj_factor * cfg.d_model)
        H = cfg.n_heads
        dh = d_in // H
        return {
            "C": PS((B, H, dh, dh), ("batch", "heads", None, None), f32),
            "n": PS((B, H, dh), ("batch", "heads", None), f32),
            "m": PS((B, H), ("batch", "heads"), f32),
            "conv": PS((B, x.conv_kernel - 1, d_in), ("batch", None, "dinner")),
        }
    if mixer == "slstm":
        st = {k: PS((B, cfg.d_model), ("batch", "dinner"), f32) for k in ("c", "n", "h", "m")}
        return {"state": st}
    raise ValueError(mixer)


def cache_specs(cfg, part, B: int, S: int) -> Dict[str, Any]:
    stack = cfg.n_groups
    return {
        f"p{i}": _mixer_cache_specs(cfg, part, mixer, B, S, stack)
        for i, (mixer, _) in enumerate(cfg.pattern)
    }


def cache_fills(cfg, part, B: int, S: int):
    """Each cache leaf's initial value, in a tree of the caches' keys: 0,
    an ``attn_local`` ring's pos -1, the mLSTM's ``m`` and the sLSTM's
    ``state.m`` -1e30."""
    fills = cm.map_specs(lambda s: 0, cache_specs(cfg, part, B, S))
    for i, (mixer, _) in enumerate(cfg.pattern):
        c = fills[f"p{i}"]
        if mixer == "attn_local":
            c["pos"] = -1
        elif mixer == "mlstm":
            c["m"] = xlstm_mod.M_INIT
        elif mixer == "slstm":
            c["state"]["m"] = xlstm_mod.M_INIT
    return fills


def init_cache(cfg, part, B: int, S: int, device):
    """Caches on ``device``, each leaf at its ``cache_fills`` value."""
    from repro_torch.train.tree import tree_map

    return tree_map(lambda s, f: torch.full(s.shape, f, dtype=s.dtype, device=device),
                    cache_specs(cfg, part, B, S), cache_fills(cfg, part, B, S))


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
        y, new_cache = mla_mod.mla_attention(bp["mixer"], cfg, part, h, positions=positions,
                                             cache=cache)
    elif mixer in RECURRENT:
        y, new_cache = RECURRENT[mixer][1](bp["mixer"], cfg, h, cache=cache)
    else:
        y, new_cache = self_attention(
            bp["mixer"], cfg, part, h, kind=mixer, positions=positions, cache=cache, mesh=mesh)
    if cfg.norm_style == "sandwich":
        y = _norm(bp["ln1_post"], cfg, y)
    x = x + y
    x, aux = _ffn(bp, cfg, ffn, x, mesh)
    if part.seq_shard_activations and mesh is not None:
        x = cm.constrain(x, mesh, rules, ("batch", "seq_shard", None))
    return x, new_cache, aux


def _local_ring_decode(params, cfg, part, x, *, positions, cache):
    """Sliding-window decode against a ring cache of width W, in place.

    cache: k/v (B, W, KV, hd) with RoPE pre-applied at write; pos (B, W)
    absolute positions (-1 = empty).  The new entry lands in slot pos % W —
    the ring keeps exactly the last W positions, so validity is
    ``pos >= 0``."""
    cd = cm.dtype_of(cfg.compute_dtype)
    hd = cfg.resolved_head_dim
    q, k_new, v_new = _qkv(params, cfg, x, cd)
    cos, sin = cm.rope_angles(positions[:, None], hd, cfg.rope_local_theta)
    q = cm.apply_rope(q, cos, sin)
    k_new = cm.apply_rope(k_new, cos, sin)
    _ring_write(cache, (k_new, v_new), positions, ("k", "v", "pos"))
    out = _ring_attend(q, cache["k"], cache["v"], cache["pos"], cfg, cd)
    y = cm.dense(params["wo"], out, "...hk,hkd->...d", cd)
    return y, cache


def _ring_write(cache, kv, positions, names):
    """The new entries of ``names`` (of k, v, pos) into slot pos % W of
    each row of a ring cache, in place."""
    W = cache["k"].shape[1]
    rows = torch.arange(positions.shape[0], device=positions.device)
    slot = (positions % W).long()
    new = dict(zip(("k", "v"), kv or ()))
    for name in names:
        val = positions if name == "pos" else new[name][:, 0]
        cache[name][rows, slot] = val.to(cache[name].dtype)


def _ring_attend(q, k, v, pos, cfg, cd):
    """q (B, 1, Hq, hd) over the valid slots (``pos >= 0``) of ring k/v
    (B, W, KVq, hd), query head i reading KV head i // (Hq / KVq)."""
    B, _, Hq, hd = q.shape
    KVq = k.shape[2]
    q4 = (q[:, 0] * cm.scalar(hd ** -0.5, q.dtype)).reshape(B, KVq, Hq // KVq, hd)
    s = torch.einsum("bkgd,bskd->bkgs", q4, k.to(cd)).to(torch.float32)
    if cfg.logit_softcap:
        s = torch.tanh(s / cfg.logit_softcap) * cfg.logit_softcap
    s = torch.where((pos >= 0)[:, None, None], s, -1e30)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", p.to(cd), v.to(cd))
    return out.reshape(B, 1, Hq, hd)


def apply_block_decode(bp, cfg, part, mixer: str, ffn: str, x, *, positions, cache, mesh=None,
                       rules=None):
    """Single-token block.  x: (B, 1, d).  Returns (x, cache)."""
    h = _norm(bp["ln1"], cfg, x)
    if mixer in RECURRENT:
        y, new_cache = RECURRENT[mixer][2](bp["mixer"], cfg, h, cache=cache)
    elif mixer == "attn_local":
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
    None), plus ``z_weight`` times the mean squared logsumexp.  On a mesh
    whose ``model`` axis has size 1 the loss is this plain one; a vocab
    split over a larger ``model`` axis (the reference's ``_xent_sharded``)
    waits for item 9b.3b."""
    if mesh is not None and cm._mesh_axis_size(mesh, "model") > 1 and \
            logits.shape[-1] % mesh.shape["model"] == 0:
        cm._needs_mesh("softmax_xent over a vocab split across the model axis (_xent_sharded)")
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
    x = embed_tokens(params, cfg, batch["tokens"], batch.get("patches"))
    x = cm.constrain(x, mesh, rules, ("batch", None, None))
    x, _, aux = run_stack_full(params["blocks"], cfg, part, x, mesh=mesh, rules=rules)
    x = cm.rmsnorm(params["final_norm"], x, cfg.norm_eps,
                   compute_dtype=cm.dtype_of(cfg.compute_dtype))
    logits = lm_head(params, cfg, x)
    if cfg.modality == "vision" and cfg.n_prefix_tokens:
        # patch positions carry no next-token target
        logits = logits[:, cfg.n_prefix_tokens:]
    loss = softmax_xent(logits, batch["labels"], batch.get("valid"), mesh=mesh)
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


# --------------------------------------------------------------------------- #
# Tensor-parallel serving                                                      #
# --------------------------------------------------------------------------- #
#
# One data shard's prefill and decode step over its model shards (``group``:
# a ``parallel.sharding.ModelShards``), from the parameters and caches placed
# on the mesh (``Placed`` trees: ``Model.param_shardings``/
# ``cache_shardings``).  A Python loop over the shards inside each layer,
# split at the layer's collectives: activations are replicated (one tensor
# a device), each split product runs on its shard's blocks, and a split
# that the maybe-shard rule left whole is computed whole once a device.


def _cache_split(placed) -> Any:
    """"seq", "kv" or None: how a block position's placed cache (k: (L, B,
    S, KV, hd)) is split over ``model``."""
    sh = placed["k"].sharding
    return "seq" if sh.pieces(2) > 1 else ("kv" if sh.pieces(3) > 1 else None)


def embed_tokens_tp(ps, cfg, toks, group, patches=None):
    """``embed_tokens`` over the model shards (``toks``/``patches`` one
    tensor a shard).  A vocab-split table: each shard looks up the tokens
    in its rows (zeros elsewhere), the lookups summed (one term a token is
    not zero: exact); the scale and the patches after."""
    from repro_torch.parallel import collectives

    cd = cm.dtype_of(cfg.compute_dtype)
    rows = ps[0]["embed"]["embedding"].shape[0]
    if rows == cfg.vocab:
        xs = group.once(lambda p, t: cm.embed_lookup(p["embed"], t, cd), ps, toks)
    else:
        xs = collectives.all_reduce(group.mesh, "model", group.each(
            lambda j, p, t: cm.embed_lookup_range(p["embed"], t, j * rows, cd),
            range(group.n), ps, toks))
    if cfg.embed_scale:
        xs = group.once(lambda x: x * cm.scalar(cfg.d_model ** 0.5, cd), xs)
    if patches is not None:
        xs = group.once(lambda p, pt, x: torch.cat(
            [cm.dense(p["frontend_proj"], pt, "...f,fd->...d", cd), x], dim=1), ps, patches, xs)
    return xs


def lm_head_tp(ps, cfg, xs, group):
    """``lm_head`` over the model shards: vocab-split logits gathered along
    the vocabulary on the group's first device (greedy ties then go to the
    lowest index, as off the mesh); a whole head runs there alone."""
    from repro_torch.parallel import collectives

    cd = cm.dtype_of(cfg.compute_dtype)
    if cfg.tie_embeddings:
        rows = ps[0]["embed"]["embedding"].shape[0]

        def head(p, x):
            return torch.einsum("...d,vd->...v", x, p["embed"]["embedding"].to(cd))
    else:
        rows = ps[0]["lm_head"]["kernel"].shape[-1]

        def head(p, x):
            return cm.dense(p["lm_head"], x, "...d,dv->...v", cd)

    if rows == cfg.vocab:
        return head(ps[0], xs[0])
    return collectives.gather(group.mesh, "model", group.each(head, ps, xs), dim=-1)


def _ffn_tp(bps, cfg, ffn: str, xs, group):
    if ffn == "none":
        return xs
    hs = group.once(lambda bp, x: _norm(bp["ln2"], cfg, x), bps, xs)
    fps = [bp["ffn"] for bp in bps]
    ys = mlp_apply_tp(fps, cfg, hs, group) if ffn == "mlp" else \
        moe_mod.moe_apply_tp(fps, cfg, hs, group)
    if cfg.norm_style == "sandwich":
        ys = group.once(lambda bp, y: _norm(bp["ln2_post"], cfg, y), bps, ys)
    return group.once(torch.add, xs, ys)


def _block_tp(bps, cfg, mixer: str, ffn: str, xs, group, attend):
    """A block over the model shards, its mixer ``attend(hs)``: norms,
    sandwich norms and residual adds on the replicated activations."""
    hs = group.once(lambda bp, x: _norm(bp["ln1"], cfg, x), bps, xs)
    ys = attend(hs)
    if cfg.norm_style == "sandwich":
        ys = group.once(lambda bp, y: _norm(bp["ln1_post"], cfg, y), bps, ys)
    return _ffn_tp(bps, cfg, ffn, group.once(torch.add, xs, ys), group)


def _local_ring_decode_tp(mps, cfg, hs, group, *, positions, caches, split):
    """``_local_ring_decode`` over the model shards: each shard's query
    heads over the ring (its KV heads split with them, or whole and written
    once a device), ``wo`` row parallel."""
    from repro_torch.models.attention import _head_split, _kv_for, _qkv_tp

    cd = cm.dtype_of(cfg.compute_dtype)
    hd, H, KV = cfg.resolved_head_dim, cfg.n_heads, cfg.n_kv_heads
    Hl, heads_split, _ = _head_split(mps, cfg)
    angles = group.once(lambda pos: cm.rope_angles(pos[:, None], hd, cfg.rope_local_theta),
                        positions)
    qs, kvs = _qkv_tp(mps, cfg, hs, group, angles, cd)
    (group.each if split == "kv" else group.once)(
        lambda c, kv, pos: _ring_write(c, kv, pos, ("k", "v")), caches, kvs, positions)
    group.once(lambda c, pos: _ring_write(c, None, pos, ("pos",)), caches, positions)
    outs = (group.each if heads_split else group.once)(
        lambda j, q, c: _ring_attend(q, _kv_for(c["k"], j, Hl, H, KV),
                                     _kv_for(c["v"], j, Hl, H, KV), c["pos"], cfg, cd),
        range(group.n), qs, caches)
    return cm.dense_row_parallel(group, [p["wo"] for p in mps], outs, "...hk,hkd->...d", cd,
                                 heads_split)


def _stack_tp(ps, cs, cfg, xs, group, mixer_fn):
    """The block groups over the model shards: ``mixer_fn(mixer, i, mixer
    blocks, cache blocks)`` gives block position i's mixer (a function of
    the normed activations); then the final norm."""
    for g in range(cfg.n_groups):
        gps = [_group(p["blocks"], g) for p in ps]
        gcs = [_group(c, g) for c in cs]
        for i, (mixer, ffn) in enumerate(cfg.pattern):
            bps, bcs = [gp[f"p{i}"] for gp in gps], [gc[f"p{i}"] for gc in gcs]
            xs = _block_tp(bps, cfg, mixer, ffn, xs, group,
                           mixer_fn(mixer, i, [bp["mixer"] for bp in bps], bcs))
    return group.once(lambda p, x: cm.rmsnorm(p["final_norm"], x, cfg.norm_eps,
                                              compute_dtype=cm.dtype_of(cfg.compute_dtype)),
                      ps, xs)


def lm_prefill_tp(params, cfg, part, tokens, caches, group, *, patches=None):
    """``lm_prefill`` of one data shard's rows ``tokens`` (on any device)
    over its model shards ``group``, from placed ``params`` and ``caches``
    (written in place).  Returns the last logits (B, V) on the group's
    first device."""
    from repro_torch.models.attention import self_attention_tp
    from repro_torch.parallel import collectives

    ps, cs = group.blocks(params), group.blocks(caches)
    toks = collectives.broadcast(group.mesh, "model", tokens)
    pts = None if patches is None else collectives.broadcast(group.mesh, "model", patches)
    xs = embed_tokens_tp(ps, cfg, toks, group, pts)

    def mixer_fn(mixer, i, mps, bcs):
        return lambda hs: self_attention_tp(mps, cfg, part, hs, group, kind=mixer, caches=bcs,
                                            split=_cache_split(caches[f"p{i}"]))

    xs = _stack_tp(ps, cs, cfg, xs, group, mixer_fn)
    return lm_head_tp(ps, cfg, [x[:, -1:] for x in xs], group)[:, 0]


def lm_decode_step_tp(params, cfg, part, tokens, positions, caches, group):
    """``lm_decode_step`` of one data shard's rows over its model shards
    ``group`` (tokens (B, 1) and positions (B,) on any device, handed to
    the shards in one broadcast), from placed ``params`` and ``caches``
    (updated in place).  Returns logits (B, V) on the group's first
    device."""
    from repro_torch.models.attention import self_attention_decode_tp
    from repro_torch.parallel import collectives

    ps, cs = group.blocks(params), group.blocks(caches)
    both = collectives.broadcast(group.mesh, "model", torch.stack(
        [tokens[:, 0].long(), positions.long()], dim=1))
    toks = group.once(lambda t: t[:, :1].to(tokens.dtype), both)
    pos = group.once(lambda t: t[:, 1].to(positions.dtype), both)
    xs = embed_tokens_tp(ps, cfg, toks, group)

    def mixer_fn(mixer, i, mps, bcs):
        split = _cache_split(caches[f"p{i}"])
        if mixer == "attn_local":
            return lambda hs: _local_ring_decode_tp(mps, cfg, hs, group, positions=pos,
                                                    caches=bcs, split=split)
        return lambda hs: self_attention_decode_tp(mps, cfg, part, hs, group, kind=mixer,
                                                   positions=pos, caches=bcs, split=split)

    return lm_head_tp(ps, cfg, _stack_tp(ps, cs, cfg, xs, group, mixer_fn), group)[:, 0]
