"""Model zoo: one interface over the architectures the port serves.

``build(bundle, device=None)`` returns a :class:`Model` whose methods close
over the config and take and return plain nested dicts of tensors, in the
reference's layout (the group dimension leads every block parameter and
cache), so the reference's parameters carry over key for key
(``repro_torch.convert.lm_params_from_arrays``).  The model runs on the
card unless the caller asks for the CPU (``device="cpu"``).

Served: the attention, ``mla`` and recurrent (``mamba``, ``mlstm``,
``slstm``) mixers with the ``mlp``, ``moe`` or ``none`` ffn.  ``build``
refuses, before any allocation, the family the port does not serve yet
(the encoder-decoder family: ROADMAP item 11).  ``abstract_params`` and
``abstract_cache`` give shape-and-dtype trees on the ``meta`` device (no
allocation); the dry-run inputs (``input_specs``) wait for item 11, the
sharding methods and ``mesh=`` for item 9b.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from repro_torch.configs.base import ArchBundle, ModelConfig, PartitionConfig
from repro_torch.kernels.common import resolve_device
from repro_torch.models import common as cm
from repro_torch.models import transformer as tf


def _needs_item(what: str, item: str):
    raise NotImplementedError(
        f"{what} is not ported to repro_torch yet (ROADMAP.md queue 1, item {item})")


@dataclasses.dataclass
class Model:
    cfg: ModelConfig
    part: PartitionConfig
    param_specs: Dict[str, Any]
    device: torch.device

    # ---------------- params ---------------- #

    def init(self, generator: torch.Generator):
        """Random parameters on the model's device, drawn from ``generator``
        (a generator of that device)."""
        return cm.init_params(self.param_specs, generator, self.device)

    def abstract_params(self):
        """The parameters' shapes and dtypes as ``meta`` tensors."""
        return cm.abstract(self.param_specs)

    def param_shardings(self, mesh, rules=None):
        _needs_item("param_shardings", "9b")

    # ---------------- caches ---------------- #

    def cache_specs(self, B: int, S: int):
        return tf.cache_specs(self.cfg, self.part, B, S)

    def abstract_cache(self, B: int, S: int):
        """The caches' shapes and dtypes as ``meta`` tensors."""
        return cm.abstract(self.cache_specs(B, S))

    def cache_shardings(self, mesh, B: int, S: int, rules=None):
        _needs_item("cache_shardings", "9b")

    def init_cache(self, B: int, S: int):
        return tf.init_cache(self.cfg, self.part, B, S, self.device)

    # ---------------- steps ---------------- #

    def train_loss(self, params, batch, mesh=None, rules=None):
        """batch: {"tokens", "labels"} (+ "patches" for a VLM).  Returns
        (loss, metrics), differentiable with respect to ``params``."""
        return tf.lm_train_loss(params, self.cfg, self.part, batch, mesh=mesh, rules=rules)

    def prefill(self, params, batch, caches, mesh=None, rules=None):
        """batch: {"tokens": (B, S)} (+ "patches" for a VLM).  Writes the
        caches in place; returns (last logits (B, V), caches)."""
        return tf.lm_prefill(params, self.cfg, self.part, batch["tokens"], caches,
                             patches=batch.get("patches"), mesh=mesh, rules=rules)

    def decode_step(self, params, tokens, positions, caches, mesh=None, rules=None):
        """tokens: (B, 1); positions: (B,).  Updates the caches in place;
        returns (logits (B, V), caches)."""
        return tf.lm_decode_step(params, self.cfg, self.part, tokens, positions, caches,
                                 mesh=mesh, rules=rules)

    # ---------------- dry-run inputs ---------------- #

    def input_specs(self, shape):
        _needs_item("input_specs (the dry run)", "11")

    def batch_shardings(self, mesh, tree, rules=None):
        _needs_item("batch_shardings", "9b")


def build(bundle: ArchBundle, device=None) -> Model:
    """The served model of ``bundle`` on ``device`` (None: the card)."""
    cfg, part = bundle.model, bundle.partition
    if cfg.family == "encdec":
        _needs_item("the encoder-decoder family", "11")
    for mixer, ffn in cfg.pattern:
        if mixer not in tf.SERVED_MIXERS:
            _needs_item(f"the {mixer!r} mixer ({cfg.name})", "11")
        if ffn not in tf.SERVED_FFNS:
            _needs_item(f"the {ffn!r} ffn ({cfg.name})", "11")
    dev = resolve_device("cuda" if device is None else device)
    return Model(cfg=cfg, part=part, param_specs=tf.lm_specs(cfg, part), device=dev)
