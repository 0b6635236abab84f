#!/usr/bin/env python3
"""Host-side measurements of the stream scheduler (``repro_torch.stream.
StreamScheduler``) at the 64k deployment on one NVIDIA card.

    python3 tools/sched_measure.py [--runs K] [--profile] [--src DIR]
                                   [--out FILE.jsonl]

The workload is ``chip_smoke.py``'s scheduler phase: 128 streams of K=7
rate-1/2 hard symbols (BSC p=0.03, 65536 info bits, T=65542, made on the
card from ``--seed``), the ``STREAM`` deployment (64 slots, chunk 64, depth
64, 512 rows buffered a stream), ``fused_packed`` on raw symbols, each
stream fed by a producer of seeded random arrivals of 1 to 512 rows.

Each of ``--runs`` runs prints and records: the wall time of the whole run
(open, tick to the end, results on the host), the ticks, the scheduler's
``stream_tick_seconds`` histogram (bucket-bound p50/p99, exact mean and
max), and the share of the tick in each ``TICK_PHASES`` span, from a traced
run of its own.  ``--profile`` adds a cProfile of one more (untraced) run:
the 30 functions with the most time of their own, so a tick's host time
can be split by function (cProfile's overhead inflates Python-heavy code;
read the ranking, not the times).  ``--src DIR`` measures the
``repro_torch`` under DIR (default: this checkout's ``src``); unpack another
tree under ``_trees/`` with ``git archive`` and run the two in turns.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
STREAMS, N_INFO = 128, 65536


def _workload(seed):
    import torch

    from repro_torch.core import CODE_K7_NASA
    from repro_torch.decode import CodecSpec

    spec = CodecSpec(code=CODE_K7_NASA, metric="hard")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    bits = torch.randint(0, 2, (STREAMS, N_INFO), generator=gen, device="cuda",
                         dtype=torch.int32)
    rx = spec.channel(gen, spec.encode(bits), flip_prob=0.03)
    return spec, rx.to(torch.float32).cpu().numpy()


def _run(spec, rows, seed, telemetry=None):
    """One scheduler run over ``rows``; returns (scheduler, wall seconds)."""
    import torch

    from chip_smoke import _deployment_scheduler, _open_streams

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sched = _deployment_scheduler(spec, telemetry=telemetry)
    _open_streams(sched, rows, seed)
    sched.run()
    torch.cuda.synchronize()
    return sched, time.perf_counter() - t0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=2)
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("sched_measure: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(Path(args.src).resolve()))
    import repro_torch
    from repro_torch.kernels import _build
    from repro_torch.obs import Telemetry, Tracer
    from repro_torch.stream.scheduler import TICK_PHASES

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(f"[sched] card: {card}; repro_torch from {Path(repro_torch.__file__).parent}")
    _build.build_all()
    spec, rows = _workload(args.seed)
    _run(spec, rows[:, :2048], args.seed)  # warm: first launches, the pinned pool
    records = []
    for i in range(args.runs):
        sched, wall = _run(spec, rows, args.seed)
        hist = sched.telemetry.metrics.histogram("stream_tick_seconds")
        tracer = Tracer("sched_measure")
        traced, traced_wall = _run(spec, rows, args.seed, Telemetry(tracer=tracer))
        total = tracer.total_s("tick")
        rec = dict(run=i, src=args.src, card=card, wall_s=wall,
                   info_bits_per_s=STREAMS * N_INFO / wall,
                   ticks=sched.stats.ticks, tick_p50_s=hist.quantile(0.5),
                   tick_p99_s=hist.quantile(0.99), tick_mean_s=hist.mean, tick_max_s=hist.max,
                   traced_wall_s=traced_wall, traced_tick_s=total,
                   phase_shares={p: tracer.total_s(p) / total
                                 for p in (*TICK_PHASES, "flush", "compact")},
                   arena_compactions=sched.stats.arena_compactions)
        print(f"[sched] {json.dumps(rec)}")
        records.append(rec)
    if args.profile:
        import cProfile
        import io
        import pstats

        prof = cProfile.Profile()
        prof.enable()
        _run(spec, rows, args.seed)
        prof.disable()
        buf = io.StringIO()
        pstats.Stats(prof, stream=buf).sort_stats("tottime").print_stats(30)
        print(buf.getvalue())
    if args.out:
        with open(args.out, "a") as f:
            for rec in records:
                f.write(json.dumps(rec) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
