#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--seed N]

Phases (any failure raises and exits non-zero):
  1. build   — compile every CUDA source of the port (one nvcc each, in
               parallel) and print the nvcc commands and ptxas reports;
  2. decode  — the port's main path at full width: ``decode(DecodeRequest(
               spec, received=rx))`` for the K=7 NASA (171,133) rate-1/2 code,
               B=8192 streams of 1000 info bits (T=1006 < 1024, the
               ``fused_packed`` route), hard/BSC and soft/BPSK-AWGN, plus a
               punctured-2/3 hard spec at B=1024.  Counters prove both kernels
               ran and no plain version did; a noiseless block must decode to
               its info bits and a slice must agree with the sequential oracle;
  3. parity  — each kernel against its plain PyTorch version on the card,
               exactly (words, metrics, bits), at K=3, 7, 11, 13 small shapes
               and at the main path's shape;
  4. timing  — CUDA-event times of each kernel, each plain version and the
               whole decode at the main shape (kernels and decode: median of
               5 rounds, every round printed), with each kernel's bound.

The line before the last is one JSON object with a row per kernel; the last
line is ``{"ok": true, "device": {...}}``.  Without a CUDA device, or without
the repository's ``src/`` beside this file, it exits non-zero and prints no
result.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

#: Published H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and float32
#: operations/s outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

B_MAIN, N_INFO = 8192, 1000
B_PUNCT = 1024


def _fail(msg: str):
    raise RuntimeError(f"chip_smoke: {msg}")


def _event_ms(fn, reps: int, rounds: int = 1, warmup: int = 2) -> list:
    """CUDA-event time of ``fn()`` after warm-up: for each of ``rounds``
    rounds, the mean over ``reps`` back-to-back runs."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(end) / reps)
    return out


def phase_build():
    from repro_torch.kernels import _build

    libs = _build.build_all()
    for lib in libs.values():
        print(f"[build] {' '.join(lib.command)}")
        for line in lib.compiler_output.splitlines():
            if "ptxas info" in line:
                print(f"[build] {lib.name}: {line.strip()}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"[build] card: {smi}")
    return smi


def _channel_inputs(spec, B, gen, **chan):
    import torch

    bits = torch.randint(0, 2, (B, N_INFO), generator=gen, device="cuda", dtype=torch.int32)
    coded = spec.encode(bits)
    return bits, coded, spec.channel(gen, coded, **chan)


def phase_decode(gen):
    """The main path, through the entry points a user calls."""
    import torch

    from repro_torch.core import CODE_K7_NASA, PUNCTURE_2_3
    from repro_torch.decode import CodecSpec, DecodeContext, DecodeRequest, decode
    from repro_torch.kernels import launch_counts, plain_counts, reset_counts

    hard = CodecSpec(code=CODE_K7_NASA, metric="hard")
    soft = CodecSpec(code=CODE_K7_NASA, metric="soft")
    punct = CodecSpec(code=CODE_K7_NASA, metric="hard", puncture=PUNCTURE_2_3)
    cases = [
        ("hard", hard, B_MAIN, dict(flip_prob=0.03)),
        ("soft", soft, B_MAIN, dict(snr_db=2.0)),
        ("punct23", punct, B_PUNCT, dict(flip_prob=0.01)),
    ]
    inputs = {name: _channel_inputs(spec, B, gen, **chan) for name, spec, B, chan in cases}
    torch.cuda.synchronize()

    reset_counts()
    results = {}
    for name, spec, _, _ in cases:
        results[name] = decode(DecodeRequest(spec, received=inputs[name][2]))
    clean = decode(DecodeRequest(hard, received=inputs["hard"][1]))
    torch.cuda.synchronize()
    launches = dict(launch_counts)
    plain = dict(plain_counts)
    print(f"[decode] launches {launches} plain calls {plain}")

    for name, res in results.items():
        if res.plan.backend != "fused_packed":
            _fail(f"{name}: planner chose {res.plan.backend!r}, not fused_packed")
    for kernel in ("viterbi_scan_packed", "traceback_packed"):
        if launches.get(kernel, 0) < 1:
            _fail(f"kernel {kernel} was not launched on the main path")
    if any(plain.values()):
        _fail(f"plain versions ran on the main path: {plain}")
    if not torch.equal(clean.info_bits, inputs["hard"][0]):
        _fail("noiseless K=7 block did not decode to its info bits")
    print(f"[decode] {results['hard'].plan.explain()}")

    for name, spec, B, _ in cases:
        res, bits = results[name], inputs[name][0]
        if res.bits.shape != (B, spec.n_steps(N_INFO)) or not torch.isfinite(res.path_metric).all():
            _fail(f"{name}: bad output shape {tuple(res.bits.shape)} or non-finite metrics")
        ber = (res.info_bits != bits).float().mean().item()
        print(f"[decode] {name}: B={B} T={spec.n_steps(N_INFO)} BER={ber!r}")
        if ber > 0.02:
            _fail(f"{name}: BER {ber} is far above what this code and channel give")
        # agreement with the sequential oracle (plain torch on the card) on a slice
        seq = decode(DecodeRequest(spec, received=inputs[name][2][:16]),
                     backend="sequential", ctx=DecodeContext())
        if not torch.equal(seq.bits, res.bits[:16]):
            _fail(f"{name}: fused_packed bits differ from the sequential oracle")
        if not torch.allclose(seq.path_metric, res.path_metric[:16], rtol=1e-5, atol=0):
            _fail(f"{name}: fused_packed metrics differ from the sequential oracle")
    return launches, inputs, hard


def _parity_case(code, data, weights):
    """Kernel vs plain on one input: returns (max |pm diff|, max |bits diff|)."""
    import torch

    from repro_torch.kernels import ops, survivors, viterbi_scan

    b0, b1, rb = weights
    pm_k, pk_k = viterbi_scan.viterbi_scan_packed(code, data, b0, b1, rb)
    pm_p, pk_p = viterbi_scan.viterbi_scan_packed_plain(code, data, b0, b1, rb)
    torch.cuda.synchronize()
    if not torch.equal(pk_k, pk_p):
        _fail(f"K={code.constraint}: packed words differ ({(pk_k != pk_p).sum().item()} words)")
    if not torch.equal(pm_k, pm_p):
        _fail(f"K={code.constraint}: final metrics differ")
    T = data.shape[1]
    worst_bits = 0
    for terminated in (True, False):
        fs, _ = ops._frontier(pm_k, terminated)
        bk = survivors.traceback_packed(code, pk_k, fs, T)
        bp = survivors.traceback_packed_plain(code, pk_k, fs, T)
        torch.cuda.synchronize()
        if not torch.equal(bk, bp):
            _fail(f"K={code.constraint}: traceback bits differ")
        worst_bits = max(worst_bits, (bk - bp).abs().max().item())
    return (pm_k - pm_p).abs().max().item(), worst_bits


def phase_parity(gen, main_inputs, hard_spec):
    import torch

    from repro_torch.core import CODE_K3_STD, CODE_K7_NASA, ConvCode
    from repro_torch.kernels import fused_metric_plan, table_weights

    codes = [
        (CODE_K3_STD, 37, 100),
        (CODE_K7_NASA, 37, 100),
        (ConvCode(11, (0o3345, 0o3613)), 9, 70),
        (ConvCode(13, (0o15621, 0o17363)), 3, 45),
    ]
    for code, B, T in codes:
        n = code.n_out
        hard = torch.randint(0, 2, (B, T, n), generator=gen, device="cuda", dtype=torch.int32)
        soft = torch.randn((B, T, n), generator=gen, device="cuda")
        tables = torch.randn((B, T, code.n_symbols), generator=gen, device="cuda")
        for label, plan_args, rx in (("hard", ("hard", None), hard), ("soft", ("soft", None), soft)):
            plan = fused_metric_plan(code, *plan_args)
            _parity_case(code, plan.features(rx).contiguous(), plan.folded("cuda"))
            print(f"[parity] K={code.constraint} B={B} T={T} {label} folded: exact")
        _parity_case(code, tables, table_weights(code, "cuda"))
        print(f"[parity] K={code.constraint} B={B} T={T} table weights: exact")

    # the main path's own shape and operands
    plan = fused_metric_plan(hard_spec.code, "hard")
    feats = plan.features(main_inputs[2]).contiguous()
    weights = plan.folded("cuda")
    errs = _parity_case(hard_spec.code, feats, weights)
    print(f"[parity] K=7 B={B_MAIN} T={feats.shape[1]} main shape: exact")
    return feats, weights, errs


def _touched_words(code, bits: "torch.Tensor") -> int:
    """Distinct survivor words the traceback reads: at step t it reads word
    (t // 32, b, s_t), s_t the decoded path's state at step t."""
    import torch

    K, S = code.constraint, code.n_states
    B, T = bits.shape
    states = torch.zeros((B, T), dtype=torch.int64, device=bits.device)
    for i in range(K - 1):  # s_t = sum_i u_{t-i} << (K-2-i)
        shifted = torch.zeros_like(states)
        shifted[:, i:] = bits[:, : T - i].to(torch.int64)
        states |= shifted << (K - 2 - i)
    W = -(-T // 32)
    t = torch.arange(T, device=bits.device)
    key = (torch.arange(B, device=bits.device)[:, None] * W + t // 32) * S + states
    return int(torch.unique(key).numel())


def phase_timing(hard_spec, rx, feats, weights):
    import torch

    from repro_torch.decode import DecodeRequest, decode
    from repro_torch.kernels import ops, survivors, viterbi_scan

    code = hard_spec.code
    B, T, F = feats.shape
    S = code.n_states
    W = -(-T // 32)
    b0, b1, rb = weights
    pm, packed = viterbi_scan.viterbi_scan_packed(code, feats, b0, b1, rb)
    fs, _ = ops._frontier(pm, True)
    bits = survivors.traceback_packed(code, packed, fs, T)

    # kernels and decode(): median of 5 rounds (all rounds printed, for the
    # spread); the plain versions, one step per op, once
    scan_rounds = _event_ms(
        lambda: viterbi_scan.viterbi_scan_packed(code, feats, b0, b1, rb), 20, rounds=5)
    scan_plain_ms = _event_ms(
        lambda: viterbi_scan.viterbi_scan_packed_plain(code, feats, b0, b1, rb), 2, warmup=1)[0]
    tb_rounds = _event_ms(lambda: survivors.traceback_packed(code, packed, fs, T), 20, rounds=5)
    tb_plain_ms = _event_ms(
        lambda: survivors.traceback_packed_plain(code, packed, fs, T), 2, warmup=1)[0]

    request = DecodeRequest(hard_spec, received=rx)
    decode_rounds = _event_ms(lambda: decode(request), 5, rounds=5)
    print(f"[timing] rounds (ms): scan {scan_rounds} traceback {tb_rounds} decode {decode_rounds}")
    scan_ms, tb_ms, decode_ms = (statistics.median(r) for r in (scan_rounds, tb_rounds,
                                                                  decode_rounds))
    torch.cuda.reset_peak_memory_stats()
    decode(request)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    print(f"[timing] decode() K=7 hard B={B} T={T}: {decode_ms!r} ms, "
          f"{B * N_INFO / (decode_ms / 1e3)!r} decoded bits/s, "
          f"peak device memory {peak} bytes")

    # bounds: each input read once, each output written once, over HBM; the
    # float operations over the float32 peak (larger of the two).  The folded
    # rows b_j[s] are the M rows of the metric weight re-indexed by each
    # transition's output symbol, so the function needs one F-term dot
    # product (F multiplies + F adds) per symbol and step; per state it needs
    # the 4 adds of (pm + m_j) + rb_j, the compare, the select and the clamp.
    scan_bytes = 4 * (B * T * F + W * B * S + B * S + 2 * S * F + 2 * S)
    scan_ops = B * T * (code.n_symbols * 2 * F + 7 * S)
    tb_bytes = 4 * (_touched_words(code, bits) + B + B * T)
    tb_ops = 6 * B * T
    rows = []
    for name, src, ref, ms, pms, nbytes, ops_n in (
        ("viterbi_scan_packed", "src/repro_torch/csrc/viterbi_scan.cu",
         "src/repro/kernels/viterbi_scan.py:232", scan_ms, scan_plain_ms, scan_bytes, scan_ops),
        ("traceback_packed", "src/repro_torch/csrc/survivors.cu",
         "src/repro/kernels/survivors.py:211", tb_ms, tb_plain_ms, tb_bytes, tb_ops),
    ):
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops_n / FP32_OPS_PER_S * 1e3
        rows.append(dict(
            name=name, route="cuda", source=src, replaces=ref, ms=ms, plain_ms=pms,
            bound_ms=max(t_bytes, t_ops), bound_by="bytes" if t_bytes >= t_ops else "operations",
            library_ms=None, bytes=nbytes, operations=ops_n,
        ))
        print(f"[timing] {name}: kernel {ms!r} ms, plain {pms!r} ms, "
              f"bound {max(t_bytes, t_ops)!r} ms ({rows[-1]['bound_by']})")
    return rows, dict(decode_ms=decode_ms, bits_per_s=B * N_INFO / (decode_ms / 1e3),
                      peak_bytes=peak)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    src = Path(__file__).resolve().parent / "src"
    if not (src / "repro_torch").is_dir():
        print(f"chip_smoke: {src / 'repro_torch'} not found", file=sys.stderr)
        return 1
    sys.path.insert(0, str(src))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = phase_build()
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    launches, inputs, hard_spec = phase_decode(gen)
    feats, weights, errs = phase_parity(gen, inputs["hard"], hard_spec)
    rows, e2e = phase_timing(hard_spec, inputs["hard"][2], feats, weights)
    for row, err in zip(rows, errs):
        row["launches"] = launches.get(row["name"], 0)
        row["max_abs_err"] = err
    kernels = [{k: row[k] for k in ("name", "route", "source", "replaces", "launches",
                                    "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                                    "library_ms")} for row in rows]
    print(json.dumps({"end_to_end": e2e, "bound_inputs": [
        {"name": r["name"], "bytes": r["bytes"], "operations": r["operations"]} for r in rows]}))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
