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
(``_rules``: ZeRO-1 and ``zero_stage``, ``flash_decode``'s ``kv_seq``).  The
steps take a ``mesh=``.  Where its ``model`` axis is 1 (data parallelism)
they compute on the tensors they are given what they compute off the
mesh.  Where it is above 1, ``prefill`` and ``decode_step`` serve tensor
parallel: they take the parameters placed by ``param_shardings`` (a plain
tree is placed per call) and caches from ``init_cache(mesh=)``, loop over
the data shards and, inside each layer, over each one's model shards
(``prefill_shard``/``decode_shard``), and return the logits on the mesh's
first device.  What they cannot run raises ``NotImplementedError`` naming
its sub-item of item 9b.3 before anything is allocated: training split
over ``model``, FSDP/ZeRO, and configurations with blocks other than
attention, MLP and MoE over ``model``.
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

    def init_on_mesh(self, mesh, seed: int, rules=None):
        """Random parameters placed by ``param_shardings(mesh, rules)``
        with no whole copy on any device: leaf by leaf in sorted key order,
        each distinct block drawn on the first device that holds it from a
        generator of that device seeded with ``seed``, then copied to the
        other devices that hold it.  The distributions are ``init``'s; the
        numbers are not."""
        gens: Dict[torch.device, torch.Generator] = {}

        def block(spec):
            def make(shape, coords, dev):
                if dev not in gens:
                    gens[dev] = torch.Generator(device=dev).manual_seed(seed)
                return cm.init_block(spec, shape, gens[dev], dev)
            return make

        from repro_torch.train.tree import tree_map

        return tree_map(lambda spec, sh: sh.build(spec.shape, spec.dtype, block(spec)),
                        self.param_specs, self.param_shardings(mesh, rules))

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

    def _check_mesh(self, mesh, rules, what: str, serving: bool = False):
        """The resolved rules; on a mesh, first the check that the
        parameters' placement is one this port executes (data parallel;
        with ``serving`` tensor parallel over ``model`` too; else the
        sub-item of 9b.3 that takes it), made once per (mesh, rules,
        serving)."""
        r = self._rules(rules)
        if mesh is not None:
            key = (mesh, tuple(sorted(r.items(), key=lambda kv: kv[0])), serving)
            checked = self.__dict__.setdefault("_checked_meshes", set())
            if key not in checked:
                from repro_torch.parallel.sharding import require_executable_tree

                if serving:
                    cm.require_servable(self.cfg, self.part, mesh, what)
                require_executable_tree(self.param_shardings(mesh, rules), self.param_specs,
                                        f"{what}: the {self.cfg.name} parameters", serving)
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

    def init_cache(self, B: int, S: int, device=None, mesh=None, rules=None):
        """Caches for B rows of S positions on ``device`` (default: the
        model's); with ``mesh``, placed by ``cache_shardings(mesh, B, S,
        rules)``, each distinct block made on its devices (no whole copy)."""
        if mesh is not None:
            from repro_torch.parallel.sharding import check_mesh, require_executable_tree
            from repro_torch.train.tree import tree_map

            check_mesh(mesh, self.device.type, "init_cache(mesh=...)")
            sh = self.cache_shardings(mesh, B, S, rules)
            specs = self.cache_specs(B, S)
            require_executable_tree(sh, specs, f"init_cache: the {self.cfg.name} caches", True)
            return tree_map(lambda spec, s, f: s.build(spec.shape, spec.dtype, lambda shape, _, d:
                            torch.full(shape, f, dtype=spec.dtype, device=d)),
                            specs, sh, self._cache_fills(B, S))
        device = self.device if device is None else torch.device(device)
        if self.cfg.family == "encdec":
            return cm.map_specs(
                lambda s: torch.zeros(s.shape, dtype=s.dtype, device=device),
                self.cache_specs(B, S))
        return tf.init_cache(self.cfg, self.part, B, S, device)

    def _cache_fills(self, B: int, S: int):
        if self.cfg.family == "encdec":
            return cm.map_specs(lambda s: 0, self.cache_specs(B, S))
        return tf.cache_fills(self.cfg, self.part, B, S)

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
        (last logits (B, V), caches).  Over a ``model`` axis above 1: the
        placed parameters and ``init_cache(mesh=)``'s caches, tensor
        parallel (the module docstring)."""
        rules = self._check_mesh(mesh, rules, "prefill", serving=True)
        if _model_size(mesh) > 1:
            params = self._placed(params, caches, mesh, rules, "prefill")
            tokens, patches = batch["tokens"], batch.get("patches")
            return self._rows_gathered(mesh, tokens.shape[0], lambda s, g: self.prefill_shard(
                params, tokens[s.rows], caches, g,
                patches=None if patches is None else patches[s.rows])), caches
        if self.cfg.family == "encdec":
            return ed.encdec_prefill(params, self.cfg, self.part, batch, caches,
                                     mesh=mesh, rules=rules)
        return tf.lm_prefill(params, self.cfg, self.part, batch["tokens"], caches,
                             patches=batch.get("patches"), mesh=mesh, rules=rules)

    def decode_step(self, params, tokens, positions, caches, mesh=None, rules=None):
        """tokens: (B, 1); positions: (B,).  Updates the caches in place;
        returns (logits (B, V), caches).  Over a ``model`` axis above 1 as
        ``prefill``."""
        rules = self._check_mesh(mesh, rules, "decode_step", serving=True)
        if _model_size(mesh) > 1:
            params = self._placed(params, caches, mesh, rules, "decode_step")
            return self._rows_gathered(mesh, tokens.shape[0], lambda s, g: self.decode_shard(
                params, tokens[s.rows], positions[s.rows], caches, g)), caches
        if self.cfg.family == "encdec":
            return ed.encdec_decode_step(params, self.cfg, self.part, tokens, positions,
                                         caches, mesh=mesh, rules=rules)
        return tf.lm_decode_step(params, self.cfg, self.part, tokens, positions, caches,
                                 mesh=mesh, rules=rules)

    def prefill_shard(self, params, tokens, caches, group, patches=None):
        """One data shard's prefill over its model shards ``group``
        (``parallel.sharding.ModelShards``) from placed ``params`` and
        ``caches``; its last logits on the group's first device."""
        if group.n == 1:
            cell = group.cells[0]
            batch = {"tokens": tokens.to(group.devices[0])}
            if patches is not None:
                batch["patches"] = patches.to(group.devices[0])
            return self.prefill(_blocks(params, cell), batch, _blocks(caches, cell),
                                mesh=group.mesh)[0]
        return tf.lm_prefill_tp(params, self.cfg, self.part, tokens, caches, group,
                                patches=patches)

    def decode_shard(self, params, tokens, positions, caches, group):
        """One data shard's decode step over its model shards ``group``;
        its logits on the group's first device."""
        if group.n == 1:
            cell, dev = group.cells[0], group.devices[0]
            return self.decode_step(_blocks(params, cell), tokens.to(dev), positions.to(dev),
                                    _blocks(caches, cell), mesh=group.mesh)[0]
        return tf.lm_decode_step_tp(params, self.cfg, self.part, tokens, positions, caches,
                                    group)

    def _placed(self, params, caches, mesh, rules, what: str):
        from repro_torch.parallel.placement import Placed
        from repro_torch.parallel.sharding import place_tree
        from repro_torch.train.tree import tree_leaves

        if not all(isinstance(c, Placed) for c in tree_leaves(caches)):
            raise TypeError(f"{what} over model={mesh.shape['model']} takes caches from "
                            "Model.init_cache(B, S, mesh=mesh)")
        return place_tree(params, self.param_shardings(mesh, rules))

    @staticmethod
    def _rows_gathered(mesh, B: int, run):
        """``run(data shard, its ModelShards)`` for each data shard of a
        batch of ``B`` rows, their results gathered along the rows on the
        mesh's first device."""
        from repro_torch.parallel import collectives
        from repro_torch.parallel.sharding import batch_axes, data_shards, model_shards

        shards = data_shards(mesh, B)
        outs = [run(s, model_shards(mesh, s.cell)) for s in shards]
        if len(outs) == 1:
            return outs[0].to(mesh.devices.flat[0])
        return collectives.gather(mesh, batch_axes(mesh), outs).reshape((B,) + outs[0].shape[1:])

    def decode_collective_calls(self, mesh, B: int, S: int, rules=None) -> Dict[str, int]:
        """The collective calls of one decode step of ``B`` rows against
        caches of ``S`` positions on ``mesh`` (a ``model`` axis above 1),
        by ``parallel.collectives`` name, from the placements alone: each
        data shard broadcasts its tokens and positions; a vocab-split
        table sums its lookups and gathers its logits; a layer all-reduces
        ``wo`` where its heads are split and the MLP where ff is; a cache
        split on sequence gathers q (with k and v where their heads are
        split) where the heads are split, and the partials; split experts
        gather the router's columns and the experts' outputs.  The rows'
        final gather across data shards (``decode_step``'s, not the
        engine's) is not counted."""
        from repro_torch.parallel.sharding import data_shards

        p_sh = self.param_shardings(mesh, rules)
        c_sh = self.cache_shardings(mesh, B, S, rules)
        calls = {"broadcast": 1, "all_reduce": 0, "all_gather": 0, "gather": 0}
        vocab = p_sh["embed"]["embedding"].pieces(0) > 1
        calls["all_reduce"] += vocab
        calls["gather"] += vocab
        for i, (mixer, ffn) in enumerate(self.cfg.pattern):
            bp = p_sh["blocks"][f"p{i}"]
            heads = bp["mixer"]["wq"]["kernel"].pieces(2) > 1
            per = {"all_reduce": int(heads), "all_gather": 0}
            if mixer != "attn_local" and c_sh[f"p{i}"]["k"].pieces(2) > 1:
                per["all_gather"] += 1 + heads
            if ffn == "mlp":
                per["all_reduce"] += bp["ffn"]["down"]["kernel"].pieces(1) > 1
            elif ffn == "moe":
                per["all_gather"] += 2 * (bp["ffn"]["router"]["kernel"].pieces(2) > 1)
                if "shared" in bp["ffn"]:
                    per["all_reduce"] += bp["ffn"]["shared"]["down"]["kernel"].pieces(1) > 1
            for k, v in per.items():
                calls[k] += self.cfg.n_groups * v
        return {k: v * len(data_shards(mesh, B)) for k, v in calls.items()}

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


def _model_size(mesh) -> int:
    return 1 if mesh is None else int(mesh.shape.get("model", 1))


def _blocks(tree, cell):
    from repro_torch.parallel.sharding import block_tree

    return block_tree(tree, cell)


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
