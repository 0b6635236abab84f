"""Training launcher.

  python -m repro_torch.launch.train --arch qwen2_5_3b --smoke --steps 20
  python -m repro_torch.launch.train --arch qwen2_5_3b --smoke --device cpu
  python -m repro_torch.launch.train --arch deepseek_v2_lite_16b --smoke --device cpu

``--arch`` takes every configuration ``models.build`` serves (the dense
families, the MoE qwen3-moe-30b-a3b and the MLA + MoE deepseek-v2-lite-16b,
whose losses add the router's aux terms); jamba, xlstm-350m and
seamless-m4t raise naming ROADMAP item 11.

Runs on the card; ``--device cpu`` runs the CPU.  One process on one
device: a ``--mesh`` other than ``none`` and ``--distributed`` wait for
ROADMAP item 9b.  Weights are random, drawn from a seeded generator on the
device; data is ``SyntheticLM`` at the ``train_4k`` shape (``--smoke``:
128 tokens x 4).  Logs the device, then the run's report as one JSON object,
the reference launcher's.
"""
from __future__ import annotations

import argparse
import dataclasses
import json

from repro_torch.obs.log import get_logger

log = get_logger("launch.train")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--seq-len", type=int, default=0)
    ap.add_argument("--global-batch", type=int, default=0)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=10)
    ap.add_argument("--checkpoint-dir", default="")
    ap.add_argument("--checkpoint-every", type=int, default=0)
    ap.add_argument("--mesh", default="none", choices=("none", "single", "multi", "host"))
    ap.add_argument("--distributed", action="store_true",
                    help="multi-process training (waits for ROADMAP item 9b)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from repro_torch.models import common as cm

    if args.distributed:
        cm._needs_mesh("--distributed")
    if args.mesh != "none":
        cm._needs_mesh(f"--mesh {args.mesh}")

    from repro_torch.configs.base import SHAPES, get_arch, get_smoke_arch
    from repro_torch.data.pipeline import make_data_iter
    from repro_torch.kernels.common import resolve_device
    from repro_torch.models.model_zoo import build
    from repro_torch.train.train_loop import train

    dev = resolve_device(args.device)
    bundle = get_smoke_arch(args.arch) if args.smoke else get_arch(args.arch)
    model = build(bundle, device=dev)

    shape = SHAPES["train_4k"]
    if args.seq_len:
        shape = dataclasses.replace(shape, seq_len=args.seq_len)
    if args.global_batch:
        shape = dataclasses.replace(shape, global_batch=args.global_batch)
    if args.smoke and not args.seq_len:
        shape = dataclasses.replace(shape, seq_len=128, global_batch=4)

    data = make_data_iter(model, shape)
    log.info(f"training {model.cfg.name} on {model.device}: {shape.global_batch} x "
             f"{shape.seq_len} tokens a step, {args.steps} steps")
    report = train(
        model, data, steps=args.steps, lr=args.lr, warmup=args.warmup,
        checkpoint_dir=args.checkpoint_dir or None,
        checkpoint_every=args.checkpoint_every,
    )
    last = report["history"][-1] if report["history"] else {}
    log.info(json.dumps({
        "arch": model.cfg.name, "steps": report["final_step"],
        "restarts": report["restarts"],
        "straggler_events": len(report["straggler_events"]),
        "final_metrics": {k: v for k, v in last.items() if k != "step"},
    }, indent=1))


if __name__ == "__main__":
    main()
