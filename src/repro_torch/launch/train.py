"""Training launcher.

  python -m repro_torch.launch.train --arch qwen2_5_3b --smoke --steps 20
  python -m repro_torch.launch.train --arch qwen2_5_3b --smoke --device cpu
  python -m repro_torch.launch.train --arch deepseek_v2_lite_16b --smoke --device cpu
  python -m repro_torch.launch.train --arch jamba_v0_1_52b --smoke --device cpu --steps 2
  python -m repro_torch.launch.train --arch seamless_m4t_large_v2 --smoke --device cpu --steps 3

``--arch`` takes every configuration of the repo (the dense families, the
MoE qwen3-moe-30b-a3b, the MLA + MoE deepseek-v2-lite-16b and the Mamba +
attention + MoE jamba-v0.1-52b, whose losses add the router's aux terms,
the mLSTM + sLSTM xlstm-350m, and the encoder-decoder seamless-m4t, whose
batches carry ``frames``: seq_len frames, seq_len // dec_ratio tokens).

Runs on the card; ``--device cpu`` runs the CPU.  One process: ``--mesh
host`` trains data-parallel over ``launch/mesh.smoke_mesh`` (every visible
card; with ``--device cpu`` the CPU), ``--mesh single`` and ``--mesh
multi`` over ``make_production_mesh`` (which raises ``ValueError`` naming
the device count when the cards are too few; a placement it cannot run
data-parallel raises naming its sub-item of item 9b.3); ``--distributed``
(one process a host) waits for ROADMAP item 9b.3f.  Weights are random, drawn from a seeded generator on the
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
                    help="multi-process training (waits for ROADMAP item 9b.3f)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from repro_torch.models import common as cm

    if args.distributed:
        cm._needs_mesh("--distributed (multi-process training)", "9b.3f")

    from repro_torch.configs.base import SHAPES, get_arch, get_smoke_arch
    from repro_torch.data.pipeline import make_data_iter
    from repro_torch.kernels.common import resolve_device
    from repro_torch.launch.mesh import make_production_mesh, smoke_mesh
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

    mesh = None
    if args.mesh == "single":
        mesh = make_production_mesh()
    elif args.mesh == "multi":
        mesh = make_production_mesh(multi_pod=True)
    elif args.mesh == "host":
        mesh = smoke_mesh(str(dev))

    data = make_data_iter(model, shape)
    where = model.device if mesh is None else mesh
    log.info(f"training {model.cfg.name} on {where}: {shape.global_batch} x "
             f"{shape.seq_len} tokens a step, {args.steps} steps")
    report = train(
        model, data, steps=args.steps, lr=args.lr, warmup=args.warmup, mesh=mesh,
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
