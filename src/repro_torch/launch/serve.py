"""Serving launcher: batched generation + the Viterbi decode path.

  python -m repro_torch.launch.serve --arch qwen2_5_3b --smoke --tokens 32
  python -m repro_torch.launch.serve --arch qwen3_moe_30b_a3b --smoke --device cpu
  python -m repro_torch.launch.serve --arch xlstm_350m --smoke --device cpu
  python -m repro_torch.launch.serve --viterbi --bits 256 --batch 64 --backend fused
  python -m repro_torch.launch.serve --viterbi --backend auto   # planner picks

``--arch`` takes the decoder-only configurations ``models.build`` serves:
the dense families, qwen3-moe-30b-a3b (MoE), deepseek-v2-lite-16b (MLA +
MoE), jamba-v0.1-52b (Mamba + attention + MoE) and xlstm-350m (mLSTM +
sLSTM).  seamless-m4t (encoder-decoder) builds, but ``ServeEngine``
refuses it with ``ValueError``: its prefill needs the encoder's frames, so
it is served through ``Model.prefill`` and ``Model.decode_step``.  Runs on
the card; ``--device cpu`` runs the CPU (every kernel's plain version).  Weights are random,
drawn from a seeded generator on the device.
Logs the result as one JSON object (and, with ``--viterbi``, the plan's
``explain(costs=True)`` before it).
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from repro_torch.obs.log import get_logger

log = get_logger("launch.serve")


def _finish(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2_5_3b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    # Viterbi decode path
    ap.add_argument("--viterbi", action="store_true")
    ap.add_argument("--bits", type=int, default=256)
    ap.add_argument("--backend", "--mode", dest="backend", default="auto",
                    help="registry backend name, or 'auto' for the planner")
    ap.add_argument("--flip-prob", type=float, default=0.02)
    args = ap.parse_args(argv)

    from repro_torch.kernels.common import resolve_device

    dev = resolve_device(args.device)

    if args.viterbi:
        from repro_torch.configs.paper_viterbi import DECODE_SPEC
        from repro_torch.decode import DecodeContext, DecodeRequest, decode

        spec = DECODE_SPEC
        backend = None if args.backend == "auto" else args.backend
        gen = torch.Generator(device=dev).manual_seed(0)
        bits = torch.randint(0, 2, (args.batch, args.bits), generator=gen, device=dev,
                             dtype=torch.int32)
        coded = spec.encode(bits)
        rx = spec.channel(torch.Generator(device=dev).manual_seed(1), coded,
                          flip_prob=args.flip_prob)
        t0 = time.perf_counter()
        res = decode(DecodeRequest(spec, received=rx), backend=backend,
                     ctx=DecodeContext(device=dev))
        _finish(dev)
        dt = time.perf_counter() - t0
        ber = float((res.info_bits != bits).float().mean())
        log.info(res.plan.explain(costs=True))
        log.info(json.dumps({
            "backend": res.plan.backend, "batch": args.batch, "bits": args.bits,
            "ber": ber, "exact": bool((res.info_bits == bits).all()),
            "throughput_bits_per_s": args.batch * args.bits / dt, "device": str(dev),
        }, indent=1))
        return

    from repro_torch.configs.base import get_arch, get_smoke_arch
    from repro_torch.models import build
    from repro_torch.serve.engine import ServeEngine

    bundle = get_smoke_arch(args.arch) if args.smoke else get_arch(args.arch)
    model = build(bundle, device=dev)
    params = model.init(torch.Generator(device=model.device).manual_seed(0))
    engine = ServeEngine(model, params,
                         max_len=args.prompt_len + args.tokens,
                         temperature=args.temperature)
    prompts = torch.randint(0, model.cfg.vocab, (args.batch, args.prompt_len),
                            generator=torch.Generator(device=model.device).manual_seed(1),
                            device=model.device)
    t0 = time.perf_counter()
    out = engine.generate(prompts, args.tokens)
    _finish(model.device)
    dt = time.perf_counter() - t0
    log.info(json.dumps({
        "arch": model.cfg.name, "batch": args.batch,
        "new_tokens": int(out["tokens"].shape[1]),
        "tokens_per_s": args.batch * out["tokens"].shape[1] / dt,
        "sample": out["tokens"][0, :8].tolist(), "device": str(model.device),
    }, indent=1))


if __name__ == "__main__":
    main()
