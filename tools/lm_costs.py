"""Count every configuration's train and decode step on ``meta`` tensors.

Each configuration's model is built on the meta device at full width and
its steps run under the op-and-kernel counter (``repro_torch.roofline``):
the train step at ``--train-shape`` (the repo's ``train_4k``: 256 x 4096,
the partition's microbatches) and one decode step at ``--decode-shape``
(``decode_32k``: 128 sequences against caches of 32768 rows); ``--batch``
and ``--rows`` cut them (``chip_smoke.py``'s qwen2.5-3b phases: ``--batch
2`` for its train step, ``--batch 4 --rows 48`` for its decode step).
Nothing is allocated, so this runs on the CPU, in seconds to many minutes
a configuration (host dispatch: a Python loop over steps dispatches every
step's ops).  For each it prints one JSON line: flops, bytes and input
bytes, ``model_flops``, the roofline report's ``useful_ratio`` and
``mfu_bound`` on one H100, or the error and the line that stopped the
count.

  python3 tools/lm_costs.py                      # every configuration
  python3 tools/lm_costs.py qwen2_5_3b --batch 2 --kinds train
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
import traceback
from pathlib import Path


def _stopped_at(exc: BaseException) -> str:
    """``file:line (function)`` of the innermost frame inside repro_torch."""
    frames = [f for f in traceback.extract_tb(exc.__traceback__)
              if "/repro_torch/" in f.filename and "/repro_torch/roofline/" not in f.filename]
    if not frames:
        return ""
    f = frames[-1]
    return f"{f.filename.rsplit('/repro_torch/', 1)[1]}:{f.lineno} ({f.name})"


def count_config(arch: str, shapes: dict, batch: int = 0, rows: int = 0) -> dict:
    """``shapes``: step kind -> a SHAPES name; ``batch``/``rows`` (0: the
    shape's own) cut its global batch and its sequence or cache rows."""
    import torch

    from repro_torch.configs import SHAPES, get_arch
    from repro_torch.models import build
    from repro_torch.roofline import model_flops, roofline_report, steps

    bundle = get_arch(arch)
    model = build(bundle, device="meta")
    out = {"arch": arch, "family": bundle.model.family}
    for kind, name in shapes.items():
        shape = SHAPES[name]
        shape = dataclasses.replace(shape, global_batch=batch or shape.global_batch,
                                    seq_len=rows or shape.seq_len)
        t0 = time.perf_counter()
        try:
            if kind == "train":
                c = steps.count_train_step(model, shape)
            else:
                with torch.inference_mode():
                    c = steps.count_decode_step(model, shape)
        except Exception as exc:  # a family whose step does not run on meta
            out[kind] = {"error": f"{type(exc).__name__}: {exc}"[:300],
                         "stopped_at": _stopped_at(exc)}
            continue
        mf = model_flops(bundle.model, shape)
        rep = roofline_report({"chips": 1, "jaxpr_cost": {"flops_per_device": c["flops"],
                                                          "bytes_per_device": c["bytes"]},
                               "collectives": {"total": 0.0}, "model_flops": mf})
        out[kind] = dict(c, shape=dataclasses.asdict(shape), model_flops=mf,
                         useful_ratio=rep["useful_ratio"], mfu_bound=rep["mfu_bound"],
                         bound_s=rep["bound_s"], dominant=rep["dominant"],
                         count_s=time.perf_counter() - t0)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("archs", nargs="*", help="configurations (default: every one)")
    ap.add_argument("--train-shape", default="train_4k")
    ap.add_argument("--decode-shape", default="decode_32k")
    ap.add_argument("--kinds", nargs="+", default=["train", "decode"])
    ap.add_argument("--batch", type=int, default=0, help="global batch (0: the shape's)")
    ap.add_argument("--rows", type=int, default=0, help="sequence or cache rows (0: the shape's)")
    ap.add_argument("--out", type=Path, default=None, help="also append the lines to this file")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
    import torch

    from repro_torch.configs import arch_ids

    torch.set_num_threads(1)
    for arch in args.archs or arch_ids():
        shapes = {"train": args.train_shape, "decode": args.decode_shape}
        line = json.dumps(count_config(arch, {k: shapes[k] for k in args.kinds}, args.batch,
                                       args.rows))
        print(line, flush=True)
        if args.out is not None:
            with args.out.open("a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
