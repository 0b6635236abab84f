"""Mixture-of-Experts with top-k routing and per-row sort dispatch.

Dispatch (sort, capacity, scatter) runs independently per batch row, as the
reference's ``vmap``: capacity is per row, C = max(int(S·k/E ·
capacity_factor) + 1, 1), taken from static shapes.  Positions inside an
expert come from a stable sort of the picks' expert ids and a cummax of
the runs' starts; a pick past capacity goes to slot E·C, a drop bin that is
cut off before the experts run, and its combine reads an appended zero row.
No boolean-mask indexing, ``nonzero`` or ``.item()``: the path makes no
host sync.

Two points where torch needs more than a transcription:

* ``jax.lax.top_k`` breaks ties toward the lower expert index;
  ``torch.topk`` promises no order.  The router takes the first k of a
  stable descending sort, which keeps equal probabilities in index order.
* The combine sums each token's k contributions in ascending expert order,
  the order of the reference's scatter-add over the sorted picks, by
  gathering the token's k slots in that order and adding them one by one in
  the compute dtype.  A scatter-add (``index_add_``) on the card adds them
  in an order its atomics decide, which in bf16 changes the result from
  run to run; the gather makes two runs bit-equal.

The expert products are plain batched products (``torch.einsum`` on the
bf16 casts of the float32 expert kernels, cast per call as ``dense``
does).  Aux losses (float32): the switch load-balance loss ``E ·
sum(ce · me)`` with ``ce`` counted over all picks, kept and dropped, and
the router z-loss ``mean(logsumexp(logits)**2)``.  On a mesh the rows'
dispatch is what it is off it.  ``moe_apply`` takes whole experts: over a
``model`` axis that splits them it is tensor-parallel training's route
(item 9b.3b) and refuses.  Serving splits them: ``moe_apply_tp`` (expert
parallelism) gathers the router's expert columns, routes on every shard
alike, runs each shard's experts on their rows of the dispatch buffer and
gathers the experts' outputs for the ordered combine.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.models import common as cm
from repro_torch.models.mlp import mlp_apply, mlp_apply_tp, mlp_specs


def moe_specs(cfg, stack: int) -> Dict[str, Any]:
    d = cfg.d_model
    moe = cfg.moe
    ff = moe.d_expert or cfg.d_ff
    E = moe.n_experts

    def expert_dense(in_d, out_d, in_ax, out_ax):
        shape = (E, in_d, out_d)
        axes = ("expert", in_ax, out_ax)
        if stack:
            shape = (stack,) + shape
            axes = ("layers",) + axes
        return {"kernel": cm.ParamSpec(shape, axes, "normal", 1.0, in_d)}

    p = {
        "router": cm.dense_spec((d,), (E,), ("embed",), ("expert",), stack=stack),
        "gate": expert_dense(d, ff, "embed", "expert_ff"),
        "up": expert_dense(d, ff, "embed", "expert_ff"),
        "down": expert_dense(ff, d, "expert_ff", "embed"),
    }
    if moe.n_shared:
        p["shared"] = mlp_specs(cfg, stack, d_ff=ff * moe.n_shared)
    return p


def capacity(S: int, k: int, E: int, capacity_factor: float) -> int:
    """Per-row expert capacity; k distinct experts a token make C >= 1 cover
    S = 1."""
    return max(int(S * k / E * capacity_factor) + 1, 1)


def route(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k(probs, k)``: the k largest along the last dim and
    their indices, equal values in ascending index order."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def dispatch_slots(expert_idx: torch.Tensor, E: int, C: int):
    """Per-row dispatch plan.  expert_idx: (B, S, k).  Returns (slot (B,
    S·k), tok (B, S·k)) in sorted-pick order — pick i of a row goes to
    buffer slot ``slot[i]`` (E·C: dropped) and comes from token ``tok[i]``
    — and ``order`` (B, S·k), the sort's permutation of the flat picks."""
    B, S, k = expert_idx.shape
    flat_e = expert_idx.reshape(B, S * k)
    order = torch.argsort(flat_e, dim=-1, stable=True)  # ties keep token order
    e_sorted = torch.gather(flat_e, 1, order)
    idx = torch.arange(S * k, device=expert_idx.device).expand(B, -1)
    # position within each expert run: idx - index of the run's first element
    is_start = torch.ones_like(e_sorted, dtype=torch.bool)
    is_start[:, 1:] = e_sorted[:, 1:] != e_sorted[:, :-1]
    run_start = torch.cummax(torch.where(is_start, idx, 0), dim=1).values
    pos_in_e = idx - run_start
    slot = torch.where(pos_in_e < C, e_sorted * C + pos_in_e, E * C)
    return slot, torch.div(order, k, rounding_mode="floor"), order


def _dispatch(x, slot, tok, E: int, C: int, cd):
    """(B, E, C, d) expert buffers: slot ``slot[b, i]`` holds token
    ``tok[b, i]`` (a scatter with one writer a kept slot; the drop bin's
    row is cut off)."""
    B, _, d = x.shape
    src = torch.gather(x.to(cd), 1, tok[..., None].expand(-1, -1, d))
    buf = torch.zeros((B, E * C + 1, d), dtype=cd, device=x.device)
    buf = buf.scatter(1, slot[..., None].expand(-1, -1, d), src)
    return buf[:, :E * C].reshape(B, E, C, d)


def _combine(yb, slot, order, expert_idx, gate_vals, cd):
    """Inverse of ``_dispatch``: y (B, S, d), each token's k contributions
    ``yb[slot] * gate`` summed in ascending expert order (dropped picks read
    the appended zero row)."""
    B, S, k = expert_idx.shape
    d = yb.shape[-1]
    yb_flat = torch.cat([yb.reshape(B, -1, d), yb.new_zeros((B, 1, d))], dim=1)
    # each flat pick's slot, back in (token, pick) order: order is a
    # permutation, so this scatter has one writer a place
    slot_tp = torch.empty_like(slot).scatter_(1, order, slot).reshape(B, S, k)
    asc = torch.argsort(expert_idx, dim=-1)  # a token's k experts are distinct
    slot_asc = torch.gather(slot_tp, 2, asc).reshape(B, S * k)
    gate_asc = torch.gather(gate_vals, 2, asc).to(cd)
    picked = torch.gather(yb_flat, 1, slot_asc[..., None].expand(-1, -1, d)).reshape(B, S, k, d)
    y = picked[:, :, 0] * gate_asc[..., 0, None]
    for j in range(1, k):
        y = y + picked[:, :, j] * gate_asc[..., j, None]
    return y


def router(params, cfg, x: torch.Tensor):
    """The router of x: (B, S, d).  Returns (logits, probs) float32 (B, S, E)
    and (gates, expert ids) (B, S, k): the router product in the compute
    dtype, then float32, softmax, top-k, the gates renormalized when the
    config says so."""
    logits = cm.dense(params["router"], x, "bsd,de->bse",
                      cm.dtype_of(cfg.compute_dtype)).to(torch.float32)
    return (logits,) + _gates(logits, cfg.moe)


def _gates(logits, moe):
    """(probs, gates, expert ids) of float32 router logits."""
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_idx = route(probs, moe.top_k)
    if moe.renormalize:
        gate_vals = gate_vals / torch.clamp_min(gate_vals.sum(-1, keepdim=True), 1e-9)
    return probs, gate_vals, expert_idx


def _experts(params, buf, act, cd):
    """The experts of ``params`` on their rows ``buf`` (B, E, C, d) of the
    dispatch buffer."""
    g = torch.einsum("becd,edf->becf", buf, params["gate"]["kernel"].to(cd))
    u = torch.einsum("becd,edf->becf", buf, params["up"]["kernel"].to(cd))
    return torch.einsum("becf,efd->becd", act(g) * u, params["down"]["kernel"].to(cd))


def moe_apply(params, cfg, x: torch.Tensor,
              mesh=None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: (B, S, d) -> (y, aux) with aux = {load_balance_loss, router_z_loss}.

    On a mesh the dispatch is per row, as off it (the reference's
    shard_map over the batch axes computes the same); whole experts over a
    ``model`` axis that would split them refuse (tensor-parallel training,
    item 9b.3b; serving runs ``moe_apply_tp``)."""
    if mesh is not None:
        cm.require_data_parallel(mesh, cm.DEFAULT_RULES, (cfg.moe.n_experts,), ("expert",),
                                 "moe_apply")
    cd = cm.dtype_of(cfg.compute_dtype)
    moe = cfg.moe
    B, S, d = x.shape
    E, k = moe.n_experts, moe.top_k
    act = cm.activation(cfg.act)

    logits, probs, gate_vals, expert_idx = router(params, cfg, x)  # (B, S, E), (B, S, k)

    C = capacity(S, k, E, moe.capacity_factor)
    slot, tok, order = dispatch_slots(expert_idx, E, C)
    buf = _dispatch(x, slot, tok, E, C, cd)

    y = _combine(_experts(params, buf, act, cd), slot, order, expert_idx, gate_vals, cd)

    if moe.n_shared:
        y = y + mlp_apply(params["shared"], cfg, x)

    # switch load-balance: E * sum_e f_e * p_e  (f from kept and dropped picks)
    me = probs.mean(dim=(0, 1))  # (E,)
    counts = torch.zeros((E,), dtype=torch.float32, device=x.device).scatter_add_(
        0, expert_idx.reshape(-1), torch.ones(expert_idx.numel(), device=x.device))
    ce = counts / (B * S * k)
    lb = E * torch.sum(ce * me)
    z = torch.mean(torch.logsumexp(logits, dim=-1) ** 2)
    return y, {"load_balance_loss": lb, "router_z_loss": z}


def moe_apply_tp(ps, cfg, xs, group):
    """``moe_apply``'s output over the model shards of ``group`` (``ps`` each
    shard's block of the parameters, ``xs`` the replicated input; no aux
    losses: serving reads none).  Where the experts are split (the
    router's block narrower than E): the router's expert columns gathered
    before top-k, so every shard routes alike; the dispatch once a device;
    each shard's E/n experts on their rows of the buffer; the experts'
    outputs gathered, and the ordered combine (each token's k slots in
    ascending expert order) once a device.  Else the whole layer once a
    device.  Shared experts are an MLP over the shards."""
    from repro_torch.parallel import collectives

    cd = cm.dtype_of(cfg.compute_dtype)
    moe = cfg.moe
    E, k = moe.n_experts, moe.top_k
    act = cm.activation(cfg.act)
    El = ps[0]["router"]["kernel"].shape[-1]
    split = El < E

    def router_logits(p, x):
        return cm.dense(p["router"], x, "bsd,de->bse", cd).to(torch.float32)

    logits = (group.each if split else group.once)(router_logits, ps, xs)
    if split:
        logits = collectives.all_gather(group.mesh, "model", logits, dim=-1)

    def plan(lg, x):
        _, gate_vals, expert_idx = _gates(lg, moe)
        C = capacity(x.shape[1], k, E, moe.capacity_factor)
        slot, tok, order = dispatch_slots(expert_idx, E, C)
        return gate_vals, expert_idx, slot, order, _dispatch(x, slot, tok, E, C, cd)

    plans = group.once(plan, logits, xs)
    if split:
        ybs = group.each(lambda j, p, pl: _experts(p, pl[4][:, j * El:(j + 1) * El], act, cd),
                         range(group.n), ps, plans)
        yb = collectives.all_gather(group.mesh, "model", ybs, dim=1)
    else:
        yb = group.once(lambda p, pl: _experts(p, pl[4], act, cd), ps, plans)
    ys = group.once(lambda y, pl: _combine(y, pl[2], pl[3], pl[1], pl[0], cd), yb, plans)
    if moe.n_shared:
        shared = mlp_apply_tp([p["shared"] for p in ps], cfg, xs, group,
                              d_ff=(moe.d_expert or cfg.d_ff) * moe.n_shared)
        ys = group.once(torch.add, ys, shared)
    return ys
