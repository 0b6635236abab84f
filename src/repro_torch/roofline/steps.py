"""An LM's steps counted on ``meta`` tensors: the training step (the loss's
forward and backward with the partition's remat, the optimizer's update) and
one decode step, built from ``Model.abstract_params``, ``abstract_cache``
and ``input_specs`` — shapes and dtypes only, nothing allocated.

The same builders take a model on any device, so a step counted on the card
with real tensors can be held against its ``meta`` count.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

from repro_torch.roofline.op_cost import count_fn_costs


def train_step(model, lr: float = 1e-4, warmup: int = 2, total: int = 8) -> Callable:
    """The train step of ``make_train_step`` with the partition's optimizer
    and the cosine-warmup schedule."""
    from repro_torch.train.optimizer import cosine_warmup, get_optimizer
    from repro_torch.train.train_loop import make_train_step

    opt = get_optimizer(model.part.optimizer)
    step = make_train_step(model, opt, cosine_warmup(lr, warmup, total))
    return step


def abstract_train_args(model, shape) -> Tuple:
    """(params, optimizer state, batch, step index) of a train step at
    ``shape`` on ``meta`` tensors."""
    from repro_torch.train.optimizer import get_optimizer

    params = model.abstract_params()
    state = get_optimizer(model.part.optimizer).init(params)
    return params, state, model.input_specs(shape)["batch"], 0


def count_train_step(model, shape) -> Dict[str, float]:
    """``count_fn_costs`` of one train step at ``shape`` on ``meta``."""
    return count_fn_costs(train_step(model), *abstract_train_args(model, shape))


def decode_step(model) -> Callable:
    """``(params, tokens, positions, caches) -> logits`` of one decode step."""
    def step(params, tokens, positions, caches):
        return model.decode_step(params, tokens, positions, caches)[0]

    return step


def abstract_decode_args(model, shape) -> Tuple:
    """(params, tokens, positions, caches) of a decode step at ``shape``
    (B sequences against caches of S rows) on ``meta`` tensors."""
    spec = model.input_specs(shape)
    return model.abstract_params(), spec["tokens"], spec["positions"], spec["caches"]


def count_decode_step(model, shape) -> Dict[str, float]:
    """``count_fn_costs`` of one decode step at ``shape`` on ``meta``."""
    return count_fn_costs(decode_step(model), *abstract_decode_args(model, shape))
