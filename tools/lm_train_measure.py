#!/usr/bin/env python3
"""Where an LM training step's device time goes, at qwen2.5-3b's full
width on one NVIDIA card.

    python3 tools/lm_train_measure.py [--seed N] [--cells N ...] [--out FILE.jsonl]

The workload is ``chip_smoke.py``'s ``lm_train`` phase: qwen2.5-3b (remat
"full", AdamW, float32 master weights, bf16 compute) on one fixed
``SyntheticLM`` batch of 2 x 4096 tokens.  After two warm steps, one step
(its metrics read back, as the training loop reads them) runs under
``torch.profiler`` with CPU and CUDA activity.  Prints and records: the
step's wall time, the time some kernel was running (the union of the kernel
intervals) and the device's idle share (1 - that / wall), the kernel time
of the GEMMs (cuBLAS/CUTLASS kernels: names holding ``gemm``, ``xmma``,
``nvjet`` or ``cutlass``) and of everything else, the kernel count, and
the 15 kernels with the most time.  Without device events (no CUPTI on the
machine) it says so and records the wall time only.

``--cells N ...`` profiles the data-parallel step over an (N, 1) (data,
model) mesh of N cells on cuda:0 for each N given (0: the one-device step,
the default), one after another in the process, on the same batch.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
GEMM_MARKS = ("gemm", "xmma", "nvjet", "cutlass")


def _busy_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    busy, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


def _profile_step(torch, seed, cells, smi) -> dict:
    """One warm step (two before it) under the profiler: the one-device
    step (``cells`` 0) or the data-parallel one over ``cells`` cells."""
    import gc

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_arch
    from repro_torch.data import SyntheticLM
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import build
    from repro_torch.train.optimizer import adamw, cosine_warmup
    from repro_torch.train.train_loop import make_train_step, read_metrics

    mesh = make_mesh((cells, 1), ("data", "model"), devices=["cuda:0"] * cells) if cells else None
    model = build(get_arch("qwen2_5_3b"))
    params = model.init(torch.Generator(device="cuda").manual_seed(seed))
    opt = adamw()
    state = opt.init(params)
    step = make_train_step(model, opt, cosine_warmup(1e-4, 2, 8), mesh=mesh)
    batch = SyntheticLM(model.cfg.vocab, 4096, 2, seed=seed)(0)
    for i in range(2):
        params, state, met = step(params, state, batch, i)
        read_metrics(met)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        params, state, met = step(params, state, batch, 2)
        read_metrics(met)
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    row = {"arch": model.cfg.name, "batch": 2, "seq_len": 4096, "cells": cells,
           "wall_ms": wall_us / 1e3, "card": smi}
    if not kernels:
        row["device"] = "not measured: the profiler recorded no device events"
    else:
        by_name = defaultdict(float)
        for e in kernels:
            by_name[e.name] += e.time_range.elapsed_us()
        gemm = sum(t for n, t in by_name.items() if any(m in n.lower() for m in GEMM_MARKS))
        busy = _busy_us([(e.time_range.start, e.time_range.end) for e in kernels])
        row.update(kernels=len(kernels), busy_ms=busy / 1e3, idle_share=1 - busy / wall_us,
                   gemm_ms=gemm / 1e3, other_kernel_ms=(sum(by_name.values()) - gemm) / 1e3,
                   top=[{"name": n[:120], "ms": t / 1e3} for n, t in
                        sorted(by_name.items(), key=lambda kv: -kv[1])[:15]])
    del params, state, step, met, prof, kernels
    gc.collect()
    torch.cuda.empty_cache()
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="")
    ap.add_argument("--cells", type=int, nargs="+", default=[0],
                    help="0: one device; N: an (N, 1) mesh of N cells on cuda:0")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("lm_train_measure: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    for cells in args.cells:
        row = _profile_step(torch, args.seed, cells, smi)
        print(json.dumps(row, indent=1))
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(row) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
