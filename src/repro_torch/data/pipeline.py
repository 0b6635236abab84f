"""Data pipeline: deterministic, restart-safe synthetic streams.

Every batch is a pure function of (seed, step): after a crash and restore
the loop replays exactly the batch it would have seen, with no iterator
state to checkpoint.  Per-process sharding: each process of a
``torch.distributed`` group makes only its slice of the global batch (by
rank; a single process owns everything).  Batches land on the card unless
the caller asks for the CPU (``device="cpu"``).

Two generators:
  SyntheticLM     — Zipf-distributed token documents packed to seq_len with
                    EOS boundaries; labels = next token.  numpy, so its
                    batches equal the reference's bit for bit.
  ViterbiStream   — random information bits -> convolutional encode -> a
                    binary symmetric channel -> branch-metric tables (the
                    paper's workload), drawn from a ``torch.Generator`` seeded
                    from (seed, step): its random stream is not the
                    reference's ``jax.random`` one.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from repro_torch.core.channel import bsc, hard_branch_metrics
from repro_torch.core.encoder import encode
from repro_torch.core.trellis import ConvCode
from repro_torch.kernels.common import resolve_device


def _process_grid():
    """(process count, this process's index): the ``torch.distributed``
    world when one is initialised, else (1, 0)."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


@dataclasses.dataclass
class SyntheticLM:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    eos: int = 0
    mean_doc_len: int = 512
    zipf_a: float = 1.2
    # modality stubs
    n_prefix_tokens: int = 0
    frontend_dim: int = 0
    family: str = "lm"
    dec_ratio: int = 4
    device: str = "cuda"

    def host_batch(self) -> int:
        n_proc, _ = _process_grid()
        if self.global_batch % n_proc:
            raise ValueError(f"global batch {self.global_batch} does not split over "
                             f"{n_proc} processes")
        return self.global_batch // n_proc

    def __call__(self, step: int) -> Dict[str, torch.Tensor]:
        dev = resolve_device(self.device)
        # fold (seed, step, process) into one deterministic stream id
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, _process_grid()[1]]))
        B = self.host_batch()

        def put(a, dtype=None):
            return torch.from_numpy(np.ascontiguousarray(a)).to(device=dev, dtype=dtype)

        if self.family == "encdec":
            S_dec = self.seq_len // self.dec_ratio
            frames = rng.standard_normal((B, self.seq_len, self.frontend_dim), dtype=np.float32)
            toks = self._pack_tokens(rng, B, S_dec + 1)
            return {"frames": put(frames, torch.bfloat16), "tokens": put(toks[:, :-1]),
                    "labels": put(toks[:, 1:])}
        S_tok = self.seq_len - self.n_prefix_tokens
        toks = self._pack_tokens(rng, B, S_tok + 1)
        out = {"tokens": put(toks[:, :-1]), "labels": put(toks[:, 1:])}
        if self.n_prefix_tokens:
            patches = rng.standard_normal((B, self.n_prefix_tokens, self.frontend_dim),
                                          dtype=np.float32)
            out["patches"] = put(patches, torch.bfloat16)
        return out

    def _pack_tokens(self, rng, B: int, S: int) -> np.ndarray:
        """Zipf tokens packed into documents separated by EOS."""
        toks = (rng.zipf(self.zipf_a, size=(B, S)) % (self.vocab - 1) + 1).astype(np.int32)
        # sprinkle EOS at ~1/mean_doc_len rate -> document boundaries
        eos_mask = rng.random((B, S)) < (1.0 / self.mean_doc_len)
        toks[eos_mask] = self.eos
        return toks


@dataclasses.dataclass
class ViterbiStream:
    """The paper's workload: coded bits over a noisy channel, batched."""

    code: ConvCode
    n_info_bits: int
    batch: int
    flip_prob: float = 0.02
    seed: int = 0
    device: str = "cuda"

    def __call__(self, step: int):
        dev = resolve_device(self.device)
        stream = np.random.SeedSequence([self.seed, step]).generate_state(1, np.uint64)[0]
        gen = torch.Generator(device=dev).manual_seed(int(stream))
        bits = torch.randint(0, 2, (self.batch, self.n_info_bits), generator=gen, device=dev,
                             dtype=torch.int32)
        coded = encode(self.code, bits, terminate=True)
        rx = bsc(gen, coded, self.flip_prob)
        bm = hard_branch_metrics(self.code, rx)
        return {"info_bits": bits, "coded": coded, "received": rx, "bm_tables": bm}


def make_data_iter(model, shape, seed: int = 0):
    """Data iterator factory keyed off a model config + shape cell; batches
    land on the model's device."""
    cfg = model.cfg
    return SyntheticLM(
        vocab=cfg.vocab,
        seq_len=shape.seq_len,
        global_batch=shape.global_batch,
        seed=seed,
        n_prefix_tokens=cfg.n_prefix_tokens if cfg.modality == "vision" else 0,
        frontend_dim=cfg.frontend_dim,
        family=cfg.family,
        dec_ratio=cfg.dec_ratio,
        device=str(model.device),
    )
