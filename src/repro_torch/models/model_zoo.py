"""Model zoo: one interface over the architectures the port serves.

``build(bundle, device=None)`` returns a :class:`Model` whose methods close
over the config and take and return plain nested dicts of tensors, in the
reference's layout (the group dimension leads every block parameter and
cache), so the reference's parameters carry over key for key
(``repro_torch.convert.lm_params_from_arrays``).  The model runs on the
card unless the caller asks for the CPU (``device="cpu"``).

Served: every configuration of the repo — the decoder-only LMs (the
attention, ``mla`` and recurrent ``mamba``, ``mlstm``, ``slstm`` mixers
with the ``mlp``, ``moe`` or ``none`` ffn) and the encoder-decoder family
(``models/encdec.py``: seamless-m4t; its batches carry ``frames``).
``abstract_params``, ``abstract_cache`` and the dry-run inputs
(``input_specs``) give shape-and-dtype trees on the ``meta`` device (no
allocation).  The sharding methods (``param_shardings``,
``cache_shardings``, ``batch_shardings``) give the reference's placements
(``_rules``: ZeRO-1 and ``zero_stage``, ``flash_decode``'s ``kv_seq``); the
steps take a ``mesh=`` whose placement of the parameters splits nothing
(data parallelism, the serving engine and the train step run it) and
compute on the tensors they are given what they compute off the mesh;
any other placement raises naming item 9b.3.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from repro_torch.configs.base import ArchBundle, ModelConfig, PartitionConfig, ShapeConfig
from repro_torch.kernels.common import resolve_device
from repro_torch.models import common as cm
from repro_torch.models import encdec as ed
from repro_torch.models import transformer as tf
from repro_torch.parallel.placement import NamedSharding, PartitionSpec
from repro_torch.train.tree import tree_map


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
        return cm.shardings(self.param_specs, mesh, self._rules(rules))

    def _rules(self, rules=None, for_opt=False):
        r = dict(cm.DEFAULT_RULES)
        if self.part.fsdp and (for_opt or self.part.zero_stage >= 3):
            # ZeRO-1: optimizer state shards over data, params stay
            # replicated on data (sharded on model only)
            r.update(cm.FSDP_RULES_OVERRIDE)
        if self.part.flash_decode:
            r["kv_seq"] = "model"
        if rules:
            r.update(rules)
        return r

    def _check_mesh(self, mesh, rules, what: str):
        """The resolved rules; on a mesh, first the check that the
        parameters' placement is one this port executes (nothing split:
        item 9b.3 otherwise), made once per (mesh, rules)."""
        r = self._rules(rules)
        if mesh is not None:
            key = (mesh, tuple(sorted(r.items(), key=lambda kv: kv[0])))
            checked = self.__dict__.setdefault("_checked_meshes", set())
            if key not in checked:
                from repro_torch.parallel.sharding import require_data_parallel_tree

                require_data_parallel_tree(self.param_shardings(mesh, rules), self.param_specs,
                                           f"{what}: the {self.cfg.name} parameters")
                checked.add(key)
        return r

    # ---------------- caches ---------------- #

    def cache_specs(self, B: int, S: int):
        if self.cfg.family == "encdec":
            return ed.encdec_cache_specs(self.cfg, self.part, B, S)
        return tf.cache_specs(self.cfg, self.part, B, S)

    def abstract_cache(self, B: int, S: int):
        """The caches' shapes and dtypes as ``meta`` tensors."""
        return cm.abstract(self.cache_specs(B, S))

    def cache_shardings(self, mesh, B: int, S: int, rules=None):
        return cm.shardings(self.cache_specs(B, S), mesh, self._rules(rules))

    def init_cache(self, B: int, S: int, device=None):
        """Caches for B rows of S positions on ``device`` (default: the
        model's)."""
        device = self.device if device is None else torch.device(device)
        if self.cfg.family == "encdec":
            return cm.map_specs(
                lambda s: torch.zeros(s.shape, dtype=s.dtype, device=device),
                self.cache_specs(B, S))
        return tf.init_cache(self.cfg, self.part, B, S, device)

    # ---------------- steps ---------------- #

    def train_loss(self, params, batch, mesh=None, rules=None):
        """batch: {"tokens", "labels"} (+ "patches" for a VLM, "frames" for
        the encoder-decoder family).  Returns (loss, metrics),
        differentiable with respect to ``params``."""
        rules = self._check_mesh(mesh, rules, "train_loss")
        if self.cfg.family == "encdec":
            return ed.encdec_train_loss(params, self.cfg, self.part, batch, mesh, rules)
        return tf.lm_train_loss(params, self.cfg, self.part, batch, mesh=mesh, rules=rules)

    def prefill(self, params, batch, caches, mesh=None, rules=None):
        """batch: {"tokens": (B, S)} (+ "patches" for a VLM, "frames" for
        the encoder-decoder family).  Writes the caches in place; returns
        (last logits (B, V), caches)."""
        rules = self._check_mesh(mesh, rules, "prefill")
        if self.cfg.family == "encdec":
            return ed.encdec_prefill(params, self.cfg, self.part, batch, caches,
                                     mesh=mesh, rules=rules)
        return tf.lm_prefill(params, self.cfg, self.part, batch["tokens"], caches,
                             patches=batch.get("patches"), mesh=mesh, rules=rules)

    def decode_step(self, params, tokens, positions, caches, mesh=None, rules=None):
        """tokens: (B, 1); positions: (B,).  Updates the caches in place;
        returns (logits (B, V), caches)."""
        rules = self._check_mesh(mesh, rules, "decode_step")
        if self.cfg.family == "encdec":
            return ed.encdec_decode_step(params, self.cfg, self.part, tokens, positions,
                                         caches, mesh=mesh, rules=rules)
        return tf.lm_decode_step(params, self.cfg, self.part, tokens, positions, caches,
                                 mesh=mesh, rules=rules)

    # ---------------- dry-run inputs ---------------- #

    def input_specs(self, shape: ShapeConfig) -> Dict[str, Any]:
        """``meta``-tensor stand-ins for every model input of the step kind
        (the reference's ``ShapeDtypeStruct`` tree; the modality frontend is
        a stub: precomputed frame or patch embeddings are inputs)."""
        cfg = self.cfg
        B, S = shape.global_batch, shape.seq_len

        def spec(dims, dtype=torch.int32):
            return torch.empty(dims, dtype=dtype, device="meta")

        def stub(n):  # (B, n, frontend_dim) precomputed embeddings
            return spec((B, n, cfg.frontend_dim), torch.bfloat16)

        if shape.kind == "decode":  # one new token against a cache of S
            return {"tokens": spec((B, 1)), "positions": spec((B,)),
                    "caches": self.abstract_cache(B, S)}
        if cfg.family == "encdec":
            batch = {"frames": stub(S), "tokens": spec((B, S // cfg.dec_ratio))}
        elif cfg.modality == "vision":
            batch = {"tokens": spec((B, S - cfg.n_prefix_tokens)),
                     "patches": stub(cfg.n_prefix_tokens)}
        else:
            batch = {"tokens": spec((B, S))}
        if shape.kind == "train":
            batch["labels"] = spec(tuple(batch["tokens"].shape))
            return {"batch": batch}
        return {"batch": batch, "caches": self.abstract_cache(B, S)}

    def batch_shardings(self, mesh, tree, rules=None):
        """NamedShardings for an input_specs()-shaped tree: leading dim of
        every leaf is batch (replicated where it does not divide over the
        batch axes)."""
        batch_axes = tuple(a for a in ("pod", "data") if a in mesh.shape)

        def shard_leaf(leaf):
            if leaf.ndim == 0:
                return NamedSharding(mesh, PartitionSpec())
            spec = [None] * leaf.ndim
            if leaf.shape[0] % max(1, _prod(mesh.shape[a] for a in batch_axes)) == 0:
                spec[0] = batch_axes if len(batch_axes) > 1 else (
                    batch_axes[0] if batch_axes else None)
            return NamedSharding(mesh, PartitionSpec(*spec))

        return tree_map(shard_leaf, tree)


def _prod(it):
    out = 1
    for x in it:
        out *= x
    return out


def build(bundle: ArchBundle, device=None) -> Model:
    """The served model of ``bundle`` on ``device`` (None: the card)."""
    cfg, part = bundle.model, bundle.partition
    specs = ed.encdec_specs(cfg, part) if cfg.family == "encdec" else tf.lm_specs(cfg, part)
    dev = resolve_device("cuda" if device is None else device)
    return Model(cfg=cfg, part=part, param_specs=specs, device=dev)
