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
reference's for the same seed; greedy tokens are.  ``mesh=`` (a sharded
engine) waits for ROADMAP item 9b.

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

    def __post_init__(self):
        if self.mesh is not None:
            raise NotImplementedError(
                "ServeEngine(mesh=...) is not ported to repro_torch yet "
                "(ROADMAP.md queue 1, item 9b)")
        if self.model.cfg.family == "encdec":
            raise ValueError(
                f"ServeEngine prefills from tokens alone; {self.model.cfg.name} (encoder-"
                "decoder) needs the encoder's frames: serve it through Model.prefill and "
                "Model.decode_step")

    def _sample(self, logits, gen: torch.Generator):
        if self.temperature <= 0.0:
            return torch.argmax(logits, dim=-1).to(torch.int32)
        z = logits.to(torch.float32) / self.temperature
        u = torch.rand(z.shape, generator=gen, device=z.device)
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
        the model's device."""
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
