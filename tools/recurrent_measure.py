#!/usr/bin/env python3
"""Where the recurrent LM families' training time goes, at full width on
one NVIDIA card.

    python3 tools/recurrent_measure.py [--seed N] [--out FILE.jsonl]

The shapes are ``chip_smoke.py``'s ``lm_train_recurrent`` phase: B=2 x
S=4096 tokens, bf16 compute, one layer's parameters at full width drawn
from the seed.  Prints and records one JSON row per measurement:

* ``mamba`` (jamba-v0.1-52b's mixer): ``ssm_apply`` and, on the same
  inputs, its selective scan alone (``ssm._ssm_scan_chunked``), each
  forward without grad and forward plus backward with grad (the scan's
  per-chunk checkpoints recompute in the backward);
* ``mlstm`` and ``slstm`` (xlstm-350m's mixers): ``mlstm_apply`` and
  ``slstm_apply`` the same way, with the number of ops each dispatches;
* ``jamba_step``: one ``make_train_step`` step at 2 layers (the phase's)
  under ``torch.profiler``: wall, busy kernel time, idle share, GEMMs
  against other kernels and the 10 costliest kernels.

Times are CUDA events around work that ends in a synchronize (median of 3
after a warm-up); a forward without grad is also replayed as a CUDA graph
(device-only time).  Without device events from the profiler it says so.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
B, S = 2, 4096
GEMM_MARKS = ("gemm", "xmma", "nvjet", "cutlass")


def _ms(fn, rounds: int = 3) -> list:
    import torch

    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(rounds):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(end))
    return out


def _graph_ms(fn) -> float:
    """Device-only time of ``fn()`` as one CUDA-graph replay (median of 3)."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return statistics.median(_ms(graph.replay))


def _ops(fn) -> int:
    from repro_torch.analysis.op_lint import OpRecorder

    with OpRecorder() as rec:
        fn()
    return len(rec.ops)


def _mixer_rows(name, cfg, specs_fn, apply_fn, inner=None):
    """Rows for one mixer: ``apply_fn`` on x (B, S, d) of its parameters
    (bf16, as the train step reads them) and, when given, the parts
    ``inner(params, cfg, x)`` names: {label: (fn, its input)}.  The
    backward takes the gradients of the input and of every parameter the
    part reads."""
    import torch

    from repro_torch.models import common as cm
    from repro_torch.train.tree import tree_map

    gen = torch.Generator(device="cuda").manual_seed(0)
    params = tree_map(lambda t: t.to(torch.bfloat16).requires_grad_(),
                      cm.init_params(specs_fn(cfg, 0), gen))
    x = torch.randn((B, S, cfg.d_model), generator=gen, device="cuda").to(torch.bfloat16)
    parts = {name: (lambda v: apply_fn(params, cfg, v)[0], x)}
    if inner is not None:
        parts.update(inner(params, cfg, x))
    rows = []
    for label, (fn, arg) in parts.items():
        def fwd(fn=fn, arg=arg):
            with torch.no_grad():
                fn(arg)

        def fwd_bwd(fn=fn, arg=arg):
            fn(arg.detach().requires_grad_()).float().sum().backward()

        t0 = time.perf_counter()
        f = _ms(fwd)
        fb = _ms(fwd_bwd, 2)
        rows.append({"what": label, "batch": B, "seq_len": S, "forward_ms": statistics.median(f),
                     "forward_rounds": f, "forward_device_ms": _graph_ms(fwd),
                     "forward_ops": _ops(fwd), "forward_backward_ms": statistics.median(fb),
                     "forward_backward_rounds": fb,
                     "measured_in_s": time.perf_counter() - t0})
        print(json.dumps(rows[-1]), flush=True)
    return rows


def _scan_part(params, cfg, x):
    """``ssm._ssm_scan_chunked`` on the inputs ``ssm_apply`` gives it,
    differentiated with respect to its first (``xc``)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.models import common as cm
    from repro_torch.models import ssm

    d_in = cfg.ssm.expand * cfg.d_model
    with torch.no_grad():
        xi = cm.dense(params["in_proj"], x, "...d,df->...f", torch.bfloat16)[..., :d_in]
        xc = F.silu(ssm.conv1d(params, xi, torch.bfloat16))
        dt, Bm, Cm, A = ssm._gate_inputs(params, cfg, xc, torch.bfloat16)
        dt, Bm, Cm = (t.float() for t in (dt, Bm, Cm))
    h0 = torch.zeros((B, d_in, cfg.ssm.d_state), device="cuda")

    def scan(v):
        return ssm._ssm_scan_chunked(v, dt, Bm, Cm, A, h0, cfg.ssm.chunk)[0]

    return {"mamba_scan": (scan, xc.float())}


def _jamba_step(seed):
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_arch
    from repro_torch.data import SyntheticLM
    from repro_torch.models import build
    from repro_torch.train.optimizer import adamw, cosine_warmup
    from repro_torch.train.train_loop import make_train_step, read_metrics

    bundle = get_arch("jamba_v0_1_52b")
    cfg = dataclasses.replace(bundle.model, n_layers=2, pattern=bundle.model.pattern[:2])
    part = dataclasses.replace(bundle.partition, remat="full", microbatches=1)
    model = build(dataclasses.replace(bundle, model=cfg, partition=part))
    params = model.init(torch.Generator(device="cuda").manual_seed(seed))
    opt = adamw()
    state = opt.init(params)
    step = make_train_step(model, opt, cosine_warmup(1e-4, 2, 8))
    batch = SyntheticLM(model.cfg.vocab, S, B, seed=seed)(0)
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
    row = {"what": "jamba_step", "layers": 2, "batch": B, "seq_len": S, "wall_ms": wall_us / 1e3}
    if not kernels:
        row["device"] = "not measured: the profiler recorded no device events"
        return row
    by_name = defaultdict(float)
    for e in kernels:
        by_name[e.name] += e.time_range.elapsed_us()
    gemm = sum(t for n, t in by_name.items() if any(m in n.lower() for m in GEMM_MARKS))
    intervals = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy, end = 0.0, float("-inf")
    for a, b in intervals:
        if b > end:
            busy += b - max(a, end)
            end = b
    row.update(kernels=len(kernels), busy_ms=busy / 1e3, idle_share=1 - busy / wall_us,
               gemm_ms=gemm / 1e3, other_kernel_ms=(sum(by_name.values()) - gemm) / 1e3,
               top=[{"name": n[:100], "ms": t / 1e3} for n, t in
                    sorted(by_name.items(), key=lambda kv: -kv[1])[:10]])
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("recurrent_measure: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.configs import get_arch
    from repro_torch.models import ssm, xlstm

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    jamba, xl = get_arch("jamba_v0_1_52b").model, get_arch("xlstm_350m").model
    rows = _mixer_rows("mamba", jamba, ssm.ssm_specs, ssm.ssm_apply, _scan_part)
    rows += _mixer_rows("mlstm", xl, xlstm.mlstm_specs, xlstm.mlstm_apply)
    rows += _mixer_rows("slstm", xl, xlstm.slstm_specs, xlstm.slstm_apply)
    torch.cuda.empty_cache()
    rows.append(_jamba_step(args.seed))
    print(json.dumps(rows[-1]), flush=True)
    for row in rows:
        row["card"] = smi
    if args.out:
        with open(args.out, "a") as f:
            for row in rows:
                f.write(json.dumps(row) + "\n")
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
