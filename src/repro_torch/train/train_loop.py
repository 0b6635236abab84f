"""Train-step builder + fault-tolerant training loop.

``make_train_step`` builds one step: the loss and its gradients by
``torch.autograd`` (microbatch gradient accumulation when the partition
asks for it), then the optimizer's in-place update.  The step makes no host
sync: the loss, grad norm and lr stay tensors until the caller reads them
(``read_metrics``: one device-to-host copy).

``train`` wraps the step in the fault-tolerance harness: periodic async
checkpoints, crash -> restore -> resume, straggler detection.  A device
mesh (data-parallel replicas, FSDP) waits for ROADMAP item 9b.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.models import common as cm
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
    divided by their number; with one, the gradients are the bf16 copy's."""
    if mesh is not None or rules is not None:
        cm._needs_mesh("build_step_fn(mesh=..., rules=...)")
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
                l, metrics = model.train_loss(params_c, chunk)
                for acc, g in zip(grads, torch.autograd.grad(l, leaves)):
                    acc.add_(g)
                loss = l.detach() if loss is None else loss + l.detach()
            for acc in grads:
                acc.div_(mb)
            loss = loss / mb
        else:
            loss, metrics = model.train_loss(params_c, batch)
            grads = list(torch.autograd.grad(loss, leaves))
        del params_c, leaves  # the copy is not needed by the update
        lr = lr_fn(step_idx)
        params, opt_state, gnorm = optimizer.update(
            tree_unflatten(params, grads), opt_state, params, step_idx, lr)
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics.update(loss=loss.detach(), grad_norm=gnorm, lr=lr)
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

    def step_on_copies(params, opt_state, batch, step_idx):
        return step(tree_map(torch.clone, params), tree_map(torch.clone, opt_state), batch,
                    step_idx)

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
