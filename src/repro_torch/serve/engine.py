"""Batched serving engine: prefill + decode loop with greedy / temperature
sampling and per-request stop handling.

The engine takes a model from ``repro_torch.models.build`` (which fixes the
device: the card unless the caller built it for the CPU) and its
parameters.  ``generate`` runs under ``torch.inference_mode()``; the decode
step is eager and updates the caches in place (the reference jits it and
donates the caches).  The loop keeps ``done`` and the tokens on the device,
so it makes no host sync a token.  Temperature sampling draws from a torch
generator on the model's device seeded from ``seed`` (Gumbel-max, as
``jax.random.categorical`` samples): the sampled tokens are not the
reference's for the same seed; greedy tokens are.

On a mesh (``mesh=``, a ``parallel.Mesh`` of the model's device type) the
engine is data and tensor parallel.  The parameters are placed once, at
construction, by ``Model.param_shardings`` (leaf by leaf; ``consume=True``
places the caller's own dicts in place, so no second copy of the model is
ever held; a tree already placed, as ``Model.init_on_mesh`` makes it, stays
as it is).  Each ``generate`` splits the batch over the batch axes
(``pod``, ``data``) and gives each data shard its model shards (the cells
at its batch index along ``model``: ``sharding.model_shards``) and their
blocks of the caches (``Model.init_cache(mesh=)``: split on sequence, on KV
heads or whole, as ``Model.cache_shardings`` places them).  The loop over
tokens is outside; inside it the loop over data shards, and inside each
layer the loop over model shards, split at the layer's collectives
(``Model.prefill_shard``/``decode_shard``), so distinct cards overlap.
Each data shard's logits come to its first model shard, which samples
(greedy ties to the lowest index).  The tokens are gathered once, at the
end, onto the mesh's first device (``collectives.gather``).  A batch that
does not divide over the batch axes is replicated and runs once, on the
first cell's model shards.  With temperature, each distinct device draws
the whole batch's noise a step from a generator seeded with ``seed`` and
each shard takes its rows, so a seed gives the tokens of the one-device
engine.  A placement this port does not run (tensor-parallel blocks other
than attention, MLP and MoE, FSDP) raises ``NotImplementedError`` naming
its sub-item of item 9b.3 before anything is allocated.

The engine prefills from tokens alone, so it refuses the encoder-decoder
family (whose prefill needs the encoder's ``frames``) with ``ValueError``
before any allocation; that family is served through ``Model.prefill``
and ``Model.decode_step``.  (The reference's engine fails there with
``KeyError: 'frames'``.)
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch


@dataclasses.dataclass
class ServeEngine:
    model: "object"
    params: "object"
    max_len: int
    mesh: Optional[object] = None
    temperature: float = 0.0
    eos: int = 0

    consume: bool = False

    def __post_init__(self):
        if self.model.cfg.family == "encdec":
            raise ValueError(
                f"ServeEngine prefills from tokens alone; {self.model.cfg.name} (encoder-"
                "decoder) needs the encoder's frames: serve it through Model.prefill and "
                "Model.decode_step")
        if self.mesh is not None:
            from repro_torch.parallel import sharding

            m = self.model
            sharding.check_mesh(self.mesh, m.device.type, "ServeEngine(mesh=...)")
            B = sharding.data_parallel_size(self.mesh)
            m._check_mesh(self.mesh, None, "ServeEngine", serving=True)
            sharding.require_executable_tree(
                m.cache_shardings(self.mesh, B, self.max_len), m.cache_specs(B, self.max_len),
                f"ServeEngine: the {m.cfg.name} caches", True)
            self.params = sharding.place_tree(self.params, m.param_shardings(self.mesh),
                                              consume=self.consume)

    def _sample(self, logits, gen: torch.Generator, noise=None):
        """Greedy, or Gumbel-max at the temperature: the noise of
        ``logits``' shape drawn from ``gen``, or ``noise`` where given."""
        if self.temperature <= 0.0:
            return torch.argmax(logits, dim=-1).to(torch.int32)
        z = logits.to(torch.float32) / self.temperature
        u = torch.rand(z.shape, generator=gen, device=z.device) if noise is None else noise
        return torch.argmax(z - torch.log(-torch.log(u)), dim=-1).to(torch.int32)

    @torch.inference_mode()
    def generate(
        self,
        prompts,  # (B, S_prompt) integer tokens
        max_new_tokens: int,
        seed: int = 0,
    ) -> Dict[str, torch.Tensor]:
        """Greedy/temperature generation for a batch of equal-length prompts.
        Returns {"tokens": (B, max_new_tokens) int32, "done": (B,) bool} on
        the model's device (on a mesh: its first device)."""
        if self.mesh is not None:
            return self._generate_on_mesh(prompts, max_new_tokens, seed)
        dev = self.model.device
        prompts = torch.as_tensor(prompts, device=dev)
        B, S_p = prompts.shape
        caches = self.model.init_cache(B, self.max_len)
        logits, caches = self.model.prefill(self.params, {"tokens": prompts}, caches)
        gen = torch.Generator(device=dev).manual_seed(seed)
        tok = self._sample(logits, gen)[:, None]
        out = [tok]
        positions = torch.full((B,), S_p, dtype=torch.int32, device=dev)
        done = torch.zeros((B,), dtype=torch.bool, device=dev)
        for _ in range(max_new_tokens - 1):
            logits, caches = self.model.decode_step(self.params, tok, positions, caches)
            nxt = self._sample(logits, gen)[:, None]
            done = done | (tok[:, 0] == self.eos)
            nxt = torch.where(done[:, None], self.eos, nxt)
            out.append(nxt)
            tok = nxt
            positions = positions + 1
        return {"tokens": torch.cat(out, dim=1), "done": done}

    def _generate_on_mesh(self, prompts, max_new_tokens: int, seed: int):
        from repro_torch.parallel import collectives, sharding

        m, mesh = self.model, self.mesh
        prompts = torch.as_tensor(prompts)
        B, S_p = prompts.shape
        shards = sharding.data_shards(mesh, B)
        groups = [sharding.model_shards(mesh, s.cell) for s in shards]
        Bl = shards[0].rows.stop - shards[0].rows.start
        caches = m.init_cache(B, self.max_len, mesh=mesh)
        gens = {s.device: torch.Generator(device=s.device).manual_seed(seed) for s in shards}
        V = m.cfg.vocab

        def noise():  # each distinct device draws the whole batch's noise once a step
            if self.temperature <= 0.0:
                return {}
            return {d: torch.rand((B, V), generator=g, device=d) for d, g in gens.items()}

        def sample(logits, s, u):
            return self._sample(logits, None, u[s.device][s.rows] if u else None)[:, None]

        u = noise()
        tok, out, done, positions = [], [], [], []
        for s, g in zip(shards, groups):
            logits = m.prefill_shard(self.params, prompts[s.rows].to(s.device), caches, g)
            tok.append(sample(logits, s, u))
            out.append([tok[-1]])
            positions.append(torch.full((Bl,), S_p, dtype=torch.int32, device=s.device))
            done.append(torch.zeros((Bl,), dtype=torch.bool, device=s.device))
        for _ in range(max_new_tokens - 1):
            u = noise()
            for i, (s, g) in enumerate(zip(shards, groups)):
                logits = m.decode_shard(self.params, tok[i], positions[i], caches, g)
                nxt = sample(logits, s, u)
                done[i] = done[i] | (tok[i][:, 0] == self.eos)
                nxt = torch.where(done[i][:, None], self.eos, nxt)
                out[i].append(nxt)
                tok[i] = nxt
                positions[i] = positions[i] + 1
        tokens = [torch.cat(o, dim=1) for o in out]
        if len(shards) == 1:
            return {"tokens": tokens[0].to(mesh.devices.flat[0]),
                    "done": done[0].to(mesh.devices.flat[0])}
        ba = sharding.batch_axes(mesh)
        return {"tokens": collectives.gather(mesh, ba, tokens).reshape(B, max_new_tokens),
                "done": collectives.gather(mesh, ba, done).reshape(B)}
