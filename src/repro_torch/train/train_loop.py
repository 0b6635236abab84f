"""Train-step builder + fault-tolerant training loop.

``make_train_step`` builds one step: the loss and its gradients by
``torch.autograd`` (microbatch gradient accumulation when the partition
asks for it), then the optimizer's in-place update.  The step makes no host
sync: the loss, grad norm and lr stay tensors until the caller reads them
(``read_metrics``: one device-to-host copy).

``train`` wraps the step in the fault-tolerance harness: periodic async
checkpoints, crash -> restore -> resume, straggler detection.

On a mesh (``mesh=``) the step is data-parallel.  It places the parameters
and the optimizer state by their shardings (``Model.param_shardings``,
``_opt_shardings``: one replica a distinct device), splits the batch over
the batch axes (``parallel/sharding.data_shards``), runs each shard's
forward and backward on its device, sums the gradients of the shards that
share a device into one buffer and reduces them across devices leaf by
leaf (``collectives.all_reduce``), then runs the optimizer once a distinct
device: every replica gets the same gradient bits, so the replicas stay
equal.  The loss is a global mean, so each shard's loss is weighted by its
share of its microbatch's denominator (the reference reshapes the global
batch into ``microbatches`` chunks of contiguous rows, each a mean over its
own rows).  A placement that splits a parameter or optimizer-state leaf
(tensor parallelism, FSDP/ZeRO) and a family with MoE aux losses on more
than one data shard (the load-balance loss couples the batch's rows) raise
``NotImplementedError`` naming its sub-item of item 9b.3 (9b.3b, 9b.3c,
9b.3e) when the step is built.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.models import common as cm
from repro_torch.parallel.placement import Placed
from repro_torch.train.optimizer import Optimizer, cosine_warmup, get_optimizer
from repro_torch.train.tree import tree_leaves, tree_map, tree_unflatten


def _compute_copy(p: torch.Tensor) -> torch.Tensor:
    """The leaf the forward reads and the gradient is taken with respect to:
    a bf16 copy of a float32 master weight, any other parameter itself."""
    c = p.detach().to(torch.bfloat16) if p.dtype == torch.float32 else p.detach()
    return c.requires_grad_()


def build_step_fn(model, optimizer: Optimizer, lr_fn: Callable, mesh=None, rules=None):
    """The train step ``(params, opt_state, batch, step_idx) -> (params,
    opt_state, metrics)``; ``params`` and ``opt_state`` are updated in place
    and returned.  With ``part.microbatches > 1`` the batch's leading dim is
    split and the gradients (float32) are summed over the chunks, then
    divided by their number; with one, the gradients are the bf16 copy's.
    ``rules`` extend the logical-axis rules (off a mesh they place
    nothing); a ``mesh`` makes the step data-parallel (module docstring)."""
    if mesh is not None:
        return _data_parallel_step(model, optimizer, lr_fn, mesh, rules)
    mb = model.part.microbatches

    def step(params, opt_state, batch, step_idx):
        # mixed precision: the forward and backward read a bf16 copy of the
        # float32 master weights
        params_c = tree_map(_compute_copy, params)
        leaves = tree_leaves(params_c)
        if mb > 1:
            grads = [torch.zeros(c.shape, dtype=torch.float32, device=c.device) for c in leaves]
            loss = None
            for i in range(mb):
                chunk = tree_map(lambda x, i=i: x.reshape((mb, x.shape[0] // mb) + x.shape[1:])[i],
                                 batch)
                l, metrics = model.train_loss(params_c, chunk, rules=rules)
                for acc, g in zip(grads, torch.autograd.grad(l, leaves)):
                    acc.add_(g)
                loss = l.detach() if loss is None else loss + l.detach()
            for acc in grads:
                acc.div_(mb)
            loss = loss / mb
        else:
            loss, metrics = model.train_loss(params_c, batch, rules=rules)
            grads = list(torch.autograd.grad(loss, leaves))
        del params_c, leaves  # the copy is not needed by the update
        lr = lr_fn(step_idx)
        params, opt_state, gnorm = optimizer.update(
            tree_unflatten(params, grads), opt_state, params, step_idx, lr)
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics.update(loss=loss.detach(), grad_norm=gnorm, lr=lr)
        return params, opt_state, metrics

    return step


def _opt_shardings(model, optimizer, mesh, rules=None):
    specs = optimizer.state_specs(model.param_specs)
    return cm.shardings(specs, mesh, model._rules(rules, for_opt=True))


def _pieces(B: int, mb: int, rows: slice):
    """The parts of a shard's ``rows`` that fall in each of the global
    batch's ``mb`` chunks of contiguous rows: [(rows, chunk rows)]."""
    if B % mb:
        raise ValueError(f"a batch of {B} rows does not split into {mb} microbatches")
    Bc = B // mb
    out = []
    for c in range(rows.start // Bc, (rows.stop - 1) // Bc + 1):
        lo, hi = max(rows.start, c * Bc), min(rows.stop, (c + 1) * Bc)
        out.append((slice(lo, hi), slice(c * Bc, (c + 1) * Bc)))
    return out


def _weight(batch, piece: slice, chunk: slice):
    """A piece's share of its chunk's loss denominator (``softmax_xent``'s
    ``max(valid.sum(), 1)``): its rows over the chunk's, or with ``valid``
    its valid positions over the chunk's (a tensor on ``valid``'s device)."""
    valid = batch.get("valid")
    if valid is None:
        return (piece.stop - piece.start) / (chunk.stop - chunk.start)
    v = valid.to(torch.float32)
    return torch.clamp_min(v[piece].sum(), 1.0) / torch.clamp_min(v[chunk].sum(), 1.0)


def _data_parallel_step(model, optimizer: Optimizer, lr_fn: Callable, mesh, rules):
    from repro_torch.parallel import collectives, sharding
    from repro_torch.parallel.mesh import Mesh
    from repro_torch.parallel.placement import first_cell

    what = "make_train_step(mesh=...)"
    sharding.check_mesh(mesh, model.device.type, what)
    p_sh = model.param_shardings(mesh, rules)
    o_sh = _opt_shardings(model, optimizer, mesh, rules)
    sharding.require_data_parallel_tree(p_sh, model.param_specs, f"{what}: the parameters")
    sharding.require_data_parallel_tree(o_sh, optimizer.state_specs(model.param_specs),
                                        f"{what}: the optimizer state")
    if model.cfg.moe is not None and sharding.data_parallel_size(mesh) > 1:
        cm._needs_mesh(f"{what}: {model.cfg.name} on {sharding.data_parallel_size(mesh)} data "
                       "shards (its MoE load-balance loss couples the batch's rows)", "9b.3e")
    mb = model.part.microbatches
    devices = mesh.distinct_devices()
    home = devices[0]
    cells = {d: first_cell(mesh, d) for d in devices}
    # the gradient reduction runs over the distinct devices, one part each
    replicas = Mesh(np.array(devices, dtype=object), ("replica",))

    def step(params, opt_state, batch, step_idx):
        params = sharding.place_tree(params, p_sh)
        opt_state = sharding.place_tree(opt_state, o_sh)
        local = {d: sharding.block_tree(params, cells[d]) for d in devices}
        B = tree_leaves(batch)[0].shape[0]
        grads: Dict[torch.device, list] = {}
        losses: Dict[torch.device, torch.Tensor] = {}
        copies: Dict[torch.device, tuple] = {}
        metrics = None
        for s in sharding.data_shards(mesh, B):
            if s.device not in copies:
                # mixed precision: a bf16 copy of the master weights a device
                pc = tree_map(_compute_copy, local[s.device])
                copies[s.device] = (pc, tree_leaves(pc))
            params_c, leaves = copies[s.device]
            for piece, chunk in _pieces(B, mb, s.rows):
                part = tree_map(lambda x: x[piece].to(s.device), batch)
                l, m = model.train_loss(params_c, part, mesh=s.mesh, rules=rules)
                w = _weight(batch, piece, chunk)
                l = l * (w.to(s.device) if isinstance(w, torch.Tensor) else w)
                g = torch.autograd.grad(l, leaves)
                acc = grads.get(s.device)
                if acc is None:
                    grads[s.device] = [x.to(torch.float32) if mb > 1 else x for x in g]
                else:
                    for a, x in zip(acc, g):
                        a.add_(x)
                del g
                l = l.detach()
                losses[s.device] = l if s.device not in losses else losses[s.device] + l
                if s.index == 0:
                    metrics = m
            del params_c, leaves
        del copies  # the copies are not needed by the update
        # leaf by leaf across the distinct devices: one received leaf at a time
        reduced: Dict[torch.device, list] = {d: [] for d in devices}
        for k in range(len(tree_leaves(p_sh))):
            parts = [grads[d][k] if d in grads else None for d in devices]
            for d in grads:
                grads[d][k] = None
            for d, t in zip(devices, collectives.all_reduce(replicas, "replica", parts)):
                reduced[d].append(t.div_(mb) if mb > 1 else t)
            del parts
        loss = collectives.psum_scalar(replicas, "replica",
                                       [losses.get(d) for d in devices])[0]
        if mb > 1:
            loss = loss / mb
        lr = lr_fn(step_idx)
        gnorm = None
        for d in devices:  # the optimizer once a distinct device
            _, _, gn = optimizer.update(tree_unflatten(local[d], reduced.pop(d)),
                                        sharding.block_tree(opt_state, cells[d]), local[d],
                                        step_idx, lr)
            gnorm = gn if gnorm is None else gnorm
        metrics = {k: v.detach().to(home) for k, v in metrics.items()}
        metrics.update(loss=loss, grad_norm=gnorm, lr=lr)
        return params, opt_state, metrics

    return step


def make_train_step(model, optimizer: Optimizer, lr_fn: Callable, mesh=None, rules=None,
                    donate: bool = True):
    """The train step.  ``donate=True`` updates the caller's parameter and
    optimizer tensors in place (the reference donates their buffers);
    ``donate=False`` updates copies and leaves the caller's tensors as they
    were."""
    step = build_step_fn(model, optimizer, lr_fn, mesh, rules)
    if donate:
        return step

    def clone(x):
        return x.map(torch.clone) if isinstance(x, Placed) else torch.clone(x)

    def step_on_copies(params, opt_state, batch, step_idx):
        return step(tree_map(clone, params), tree_map(clone, opt_state), batch, step_idx)

    return step_on_copies


def read_metrics(metrics: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """The step's metrics as Python floats: the device's in one copy to the
    host (the step's one host sync), the host's (the lr) as they are."""
    on_device = [k for k, v in metrics.items() if v.device.type != "cpu"]
    values = dict(zip(on_device, torch.stack([metrics[k].to(torch.float32)
                                              for k in on_device]).tolist())) if on_device else {}
    return {k: values[k] if k in values else float(v) for k, v in metrics.items()}


def train(
    model,
    data_iter,
    *,
    steps: int,
    lr: float = 3e-4,
    warmup: int = 100,
    mesh=None,
    rules=None,
    seed: int = 0,
    checkpoint_dir: Optional[str] = None,
    checkpoint_every: int = 0,
    keep_checkpoints: int = 3,
    fail_hook: Optional[Callable[[int], None]] = None,
    log_every: int = 10,
    straggler_zscore: float = 4.0,
) -> Dict[str, Any]:
    """Fault-tolerant training loop on the model's device.

    Parameters are drawn from a generator of the model's device seeded with
    ``seed``.  ``fail_hook(step)`` may raise :class:`SimulatedFailure` to
    simulate a node failure (used by tests); the loop then restores the
    latest checkpoint and resumes.  Every step updates the parameters and
    optimizer state in place.  Returns the final params/opt_state plus a
    run report."""
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.fault_tolerance import StragglerDetector

    optimizer = get_optimizer(model.part.optimizer)
    lr_fn = cosine_warmup(lr, warmup, steps)
    step_fn = make_train_step(model, optimizer, lr_fn, mesh, rules)

    def fresh():
        params = model.init(torch.Generator(device=model.device).manual_seed(seed))
        return params, optimizer.init(params)

    params, opt_state = fresh()
    start_step = 0
    saver = ckpt.AsyncCheckpointer(checkpoint_dir, keep=keep_checkpoints) \
        if checkpoint_dir else None
    if saver is not None:
        restored = saver.restore_latest()
        if restored is not None:
            params, opt_state, start_step = ckpt.reshard_restored(restored, params, opt_state)

    detector = StragglerDetector(zscore=straggler_zscore)
    history = []
    restarts = 0
    step = start_step
    while step < steps:
        try:
            batch = data_iter(step)
            t0 = time.perf_counter()
            params, opt_state, metrics = step_fn(params, opt_state, batch, step)
            metrics = read_metrics(metrics)
            dt = time.perf_counter() - t0
            if detector.observe(step, dt):
                metrics["straggler_event"] = 1.0
            if log_every and step % log_every == 0:
                history.append({"step": step, "time_s": dt, **metrics})
            if saver is not None and checkpoint_every and \
                    step % checkpoint_every == checkpoint_every - 1:
                saver.save(step + 1, params, opt_state)
            if fail_hook is not None:
                fail_hook(step)
            step += 1
        except ckpt.SimulatedFailure:  # node failure -> restore
            restarts += 1
            if saver is None:
                raise
            restored = saver.restore_latest(block=True)
            if restored is None:  # no checkpoint yet: restart from scratch
                params, opt_state = fresh()
                step = 0
            else:
                params, opt_state, step = ckpt.reshard_restored(restored, params, opt_state)
    if saver is not None:
        saver.wait()
    return {
        "params": params,
        "opt_state": opt_state,
        "history": history,
        "restarts": restarts,
        "straggler_events": detector.events,
        "final_step": step,
    }
