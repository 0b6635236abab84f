#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--seed N]

Phases (any failure raises and exits non-zero):
  1. build   — compile every CUDA source of the port (one nvcc each, in
               parallel) and print the nvcc commands and ptxas reports;
  2. decode  — the short-block path at full width: ``decode(DecodeRequest(
               spec, received=rx))`` for the K=7 NASA (171,133) rate-1/2 code,
               B=8192 streams of 1000 info bits (T=1006 < 1024, the
               ``fused_packed`` route), hard/BSC and soft/BPSK-AWGN, plus a
               punctured-2/3 hard spec at B=1024.  Counters prove both kernels
               ran and no plain version did; a noiseless block must decode to
               its info bits and a slice must agree with the sequential oracle;
  3. tiled   — long blocks at the full width of the NASA frame (B=1024
               streams of 1024 info bits, T=1030): (a) ``decode()`` as
               planned (route ``tiled``, the default tile count), (b) the same
               with 8 tiles pinned — the windowed scan kernel twice and the
               windowed traceback kernel once, no plain call, bits and hard
               metric equal to (a) — and (c) the truncated regime
               (tile_overlap=16), BERs side by side;
  4. stream  — streams at the 64k shape (128 streams x 65536 info bits,
               chunk 64, depth 5K): (a) a packed ``StreamSession`` on raw
               symbols (carried packed scan + packed traceback kernels),
               (b) ``decode()`` with ``DecodeContext(streaming=True)`` (the
               carried unpacked scan kernel); BERs beside the block decode of
               the same symbols, and a smaller case with depth >= T that must
               equal the block decode exactly;
  5. parity  — each kernel against its plain PyTorch version on the card,
               exactly (words, selects, metrics, bits, entry states), at
               K=3, 7, 11 (13 for the PR-11 kernels) small shapes with
               T % 32 != 0, partial windows and carried metrics holding 1e30;
  6. timing  — CUDA-event times of each kernel and each plain version at the
               shape its path gives it (kernels: median of 5 rounds, every
               round printed), each held against its plain output exactly,
               with each kernel's bound; end-to-end times of the three paths.

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
import time
from pathlib import Path

#: Published H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and float32
#: operations/s outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

B_MAIN, N_INFO = 8192, 1000
B_PUNCT = 1024
#: ``tpu_nasa_frame`` (src/repro/configs/paper_viterbi.py): 1024 frames of
#: 1024 info bits, K=7 — T = 1030 >= 1024 routes to ``tiled``
NASA_B, NASA_INFO = 1024, 1024
TILES, TRUNC_OVERLAP = 8, 16
#: ``tpu_stream_64k`` and the STREAM defaults: 128 streams x 65536 info bits,
#: chunk 64, depth 5K
STREAM_B, STREAM_INFO, STREAM_CHUNK = 128, 65536, 64

SCAN_SRC = "src/repro_torch/csrc/viterbi_scan.cu"
TB_SRC = "src/repro_torch/csrc/survivors.cu"


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


def _seed_metrics(gen, B, S):
    """Carried metrics as a stream or a tile sees them: small non-negative
    values with some states unreachable (exactly 1e30)."""
    import torch

    pm0 = torch.randint(0, 9, (B, S), generator=gen, device="cuda").float()
    return torch.where(torch.rand((B, S), generator=gen, device="cuda") < 0.3,
                       torch.full_like(pm0, 1e30), pm0)


def _same(label, kernel_out, plain_out) -> float:
    """Fail unless every output of a kernel equals its plain version's;
    returns the largest absolute difference (0.0)."""
    import torch

    torch.cuda.synchronize()
    for k, p in zip(kernel_out, plain_out):
        if k.shape != p.shape or not torch.equal(k, p):
            _fail(f"{label}: kernel and plain version differ")
    return max(float((k.double() - p.double()).abs().max()) for k, p in
               zip(kernel_out, plain_out))


def phase_parity_seeded(gen):
    """The carried, windowed and unpacked scans and the windowed traceback
    against their plain versions at small shapes."""
    import torch

    from repro_torch.core import CODE_K3_STD, CODE_K7_NASA, ConvCode
    from repro_torch.kernels import fused_metric_plan, survivors, viterbi_scan

    for code, B, T in ((CODE_K3_STD, 37, 100), (CODE_K7_NASA, 300, 70),
                       (ConvCode(11, (0o3345, 0o3613)), 9, 45)):
        S, K = code.n_states, code.constraint
        pm0 = _seed_metrics(gen, B, S)
        lo = torch.randint(0, T // 2, (B,), generator=gen, device="cuda").int()
        hi = torch.randint(T // 2, T + 3, (B,), generator=gen, device="cuda").int()
        soft = torch.randn((B, T, code.n_out), generator=gen, device="cuda")
        hard = torch.randint(0, 2, (B, T, code.n_out), generator=gen, device="cuda")
        tables = torch.randint(0, 3, (B, T, code.n_symbols), generator=gen, device="cuda").float()
        for label, data, w in (
            ("soft", soft, fused_metric_plan(code, "soft").folded("cuda")),
            ("hard", fused_metric_plan(code, "hard").features(hard).contiguous(),
             fused_metric_plan(code, "hard").folded("cuda")),
            ("table", tables, viterbi_scan.table_weights(code, "cuda")),
        ):
            args = (code, pm0, data, *w)
            _same(f"carry K={K} {label}", viterbi_scan.viterbi_scan_packed_carry(*args),
                  viterbi_scan.viterbi_scan_packed_carry_plain(*args))
            _same(f"window K={K} {label}", viterbi_scan.viterbi_scan_packed_window(*args, lo, hi),
                  viterbi_scan.viterbi_scan_packed_window_plain(*args, lo, hi))
        _same(f"unpacked carry K={K}", viterbi_scan.viterbi_scan_carry(code, pm0, tables),
              viterbi_scan.viterbi_scan_carry_plain(code, pm0, tables))
        W = -(-T // 32)
        words = torch.randint(-2 ** 31, 2 ** 31 - 1, (W, B, S), generator=gen, device="cuda",
                              dtype=torch.int32)
        fs = torch.randint(0, S, (B,), generator=gen, device="cuda", dtype=torch.int32)
        whi = torch.randint(T // 2, 32 * W + 1, (B,), generator=gen, device="cuda").int()
        _same(f"window traceback K={K}",
              survivors.traceback_packed_window(code, words, fs, lo, whi),
              survivors.traceback_packed_window_plain(code, words, fs, lo, whi))
        print(f"[parity] K={K} B={B} T={T} carry/window/unpacked scans (soft, hard, table), "
              "window traceback: exact")


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


def _row(name, src, ref, ms, plain_ms, nbytes, n_ops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / FP32_OPS_PER_S * 1e3
    row = dict(name=name, route="cuda", source=src, replaces=ref, ms=ms, plain_ms=plain_ms,
               bound_ms=max(t_bytes, t_ops), bound_by="bytes" if t_bytes >= t_ops else "operations",
               library_ms=None, bytes=nbytes, operations=n_ops)
    print(f"[timing] {name}: kernel {ms!r} ms, plain {plain_ms!r} ms, "
          f"bound {row['bound_ms']!r} ms ({row['bound_by']})")
    return row


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
    peak = _peak_bytes(lambda: decode(request))
    print(f"[timing] decode() K=7 hard B={B} T={T}: {decode_ms!r} ms, "
          f"{B * N_INFO / (decode_ms / 1e3)!r} decoded bits/s, "
          f"peak device memory {peak} bytes above the live tensors")

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
    rows = [
        _row("viterbi_scan_packed", SCAN_SRC, "src/repro/kernels/viterbi_scan.py:232", scan_ms,
             scan_plain_ms, scan_bytes, scan_ops),
        _row("traceback_packed", TB_SRC, "src/repro/kernels/survivors.py:211", tb_ms,
             tb_plain_ms, tb_bytes, tb_ops),
    ]
    return rows, dict(decode_ms=decode_ms, bits_per_s=B * N_INFO / (decode_ms / 1e3),
                      peak_bytes=peak)


def _peak_bytes(fn) -> int:
    """Device memory ``fn()`` allocates at its high-water mark, above what
    was already live when it started."""
    import torch

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - base


def _counts():
    from repro_torch.kernels import launch_counts, plain_counts

    return dict(launch_counts), dict(plain_counts)


def _ber(decoded, sent) -> float:
    return (decoded != sent).float().mean().item()


def phase_tiled(gen):
    """Long blocks: the NASA frame through ``decode()``, planned and pinned."""
    import torch

    from repro_torch.core import CODE_K7_NASA
    from repro_torch.decode import CodecSpec, DecodeContext, DecodeRequest, decode
    from repro_torch.kernels import reset_counts

    pinned = DecodeContext(tiles=TILES)
    out = {}
    for name, metric, chan in (("hard", "hard", dict(flip_prob=0.03)),
                               ("soft", "soft", dict(snr_db=2.0))):
        spec = CodecSpec(code=CODE_K7_NASA, metric=metric)
        bits = torch.randint(0, 2, (NASA_B, NASA_INFO), generator=gen, device="cuda",
                             dtype=torch.int32)
        coded = spec.encode(bits)
        rx = spec.channel(gen, coded, **chan)
        torch.cuda.synchronize()

        reset_counts()
        planned = decode(DecodeRequest(spec, received=rx))
        torch.cuda.synchronize()
        la, pa = _counts()
        if planned.plan.backend != "tiled":
            _fail(f"NASA frame {name}: planner chose {planned.plan.backend!r}, not tiled")
        P = planned.plan.ctx.tiles
        want = (("viterbi_scan_packed", 1), ("traceback_packed", 1)) if P == 1 else (
            ("viterbi_scan_packed_window", 2), ("traceback_packed_window", 1))
        if any(la.get(k, 0) != n for k, n in want) or any(pa.values()):
            _fail(f"NASA frame {name} (planned, P={P}): launches {la}, plain calls {pa}")
        print(f"[tiled] {name} planned: P={P} launches {la} | {planned.plan.explain()}")

        reset_counts()
        tiled = decode(DecodeRequest(spec, received=rx), ctx=pinned)
        torch.cuda.synchronize()
        lb, pb = _counts()
        print(f"[tiled] {name} P={TILES} pinned: launches {lb} plain calls {pb}")
        if (lb.get("viterbi_scan_packed_window", 0) != 2
                or lb.get("traceback_packed_window", 0) != 1 or any(pb.values())):
            _fail(f"NASA frame {name} P={TILES}: launches {lb}, plain calls {pb}")
        if tiled.diagnostics.get("tiles") != TILES:
            _fail(f"NASA frame {name}: pinned tiles not honoured: {tiled.diagnostics}")
        n_diff = int((tiled.bits != planned.bits).sum())
        d_metric = float((tiled.path_metric - planned.path_metric).abs().max())
        print(f"[tiled] {name} P={TILES} vs planned: {n_diff} bits differ, "
              f"max |metric diff| {d_metric!r}")
        if name == "hard" and (n_diff or d_metric):
            _fail("NASA frame hard: the tiled decode differs from the un-tiled one")

        truncated = decode(DecodeRequest(spec, received=rx),
                           ctx=DecodeContext(tiles=TILES, tile_overlap=TRUNC_OVERLAP))
        bers = [_ber(r.info_bits, bits) for r in (planned, tiled, truncated)]
        print(f"[tiled] {name} BER: planned P={P} {bers[0]!r}, P={TILES} exact {bers[1]!r}, "
              f"P={TILES} overlap={TRUNC_OVERLAP} (truncated) {bers[2]!r}")
        for r in (planned, tiled, truncated):
            if (r.bits.shape != (NASA_B, spec.n_steps(NASA_INFO))
                    or not torch.isfinite(r.path_metric).all()):
                _fail(f"NASA frame {name}: bad output shape or non-finite metrics")
        if max(bers) > 0.02:
            _fail(f"NASA frame {name}: BER {bers} is far above what this code and channel give")
        out[name] = dict(spec=spec, bits=bits, coded=coded, rx=rx, planned_tiles=P,
                         launches_pinned=lb, ber=bers, pinned=tiled)

    hard = out["hard"]
    clean = decode(DecodeRequest(hard["spec"], received=hard["coded"]), ctx=pinned)
    if not torch.equal(clean.info_bits, hard["bits"]):
        _fail("noiseless NASA frame did not decode to its info bits through P=8 tiles")
    print("[tiled] noiseless frame through P=8 tiles: exact")
    return out


def phase_stream(gen):
    """Streams: a packed session and the streaming backend at the 64k shape."""
    import torch

    from repro_torch.core import CODE_K7_NASA
    from repro_torch.decode import CodecSpec, DecodeContext, DecodeRequest, decode
    from repro_torch.kernels import reset_counts
    from repro_torch.stream import StreamSession

    spec = CodecSpec(code=CODE_K7_NASA, metric="hard")
    bits = torch.randint(0, 2, (STREAM_B, STREAM_INFO), generator=gen, device="cuda",
                         dtype=torch.int32)
    rx = spec.channel(gen, spec.encode(bits), flip_prob=0.03)
    torch.cuda.synchronize()

    reset_counts()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    session = StreamSession(spec, batch=STREAM_B, chunk=STREAM_CHUNK, backend="fused_packed",
                            inputs="received")
    s_bits, s_metric = session.decode_all(rx)
    torch.cuda.synchronize()
    session_s = time.perf_counter() - t0
    session_peak = torch.cuda.max_memory_allocated() - base
    la, pa = _counts()
    print(f"[stream] session fused_packed/received: launches {la} plain calls {pa}, "
          f"{session_s!r} s, peak device memory {session_peak} bytes above the live tensors")
    for k in ("viterbi_scan_packed_carry", "traceback_packed"):
        if la.get(k, 0) < 1:
            _fail(f"stream session: kernel {k} was not launched")
    if any(pa.values()):
        _fail(f"stream session: plain versions ran: {pa}")

    reset_counts()
    t0 = time.perf_counter()
    windowed = decode(DecodeRequest(spec, received=rx), ctx=DecodeContext(streaming=True))
    torch.cuda.synchronize()
    windowed_s = time.perf_counter() - t0
    lb, pb = _counts()
    print(f"[stream] decode(streaming=True): backend {windowed.plan.backend!r} "
          f"{windowed.diagnostics} launches {lb} plain calls {pb}, {windowed_s!r} s")
    if windowed.plan.backend != "streaming" or lb.get("viterbi_scan_carry", 0) < 1:
        _fail(f"streaming decode: backend {windowed.plan.backend!r}, launches {lb}")
    if any(pb.values()):
        _fail(f"streaming decode: plain versions ran: {pb}")

    block = decode(DecodeRequest(spec, received=rx))
    torch.cuda.synchronize()
    T = spec.n_steps(STREAM_INFO)
    bers = [_ber(spec.strip_flush(b), bits) for b in (s_bits, windowed.bits, block.bits)]
    print(f"[stream] BER at depth 5K: session {bers[0]!r}, streaming decode {bers[1]!r}, "
          f"block decode ({block.plan.backend}, P={block.plan.ctx.tiles}) {bers[2]!r}")
    for b in (s_bits, windowed.bits):
        if b.shape != (STREAM_B, T):
            _fail(f"stream decode: bad output shape {tuple(b.shape)}")
    if max(bers) > 0.02 or not torch.isfinite(s_metric).all():
        _fail(f"stream decode: BER {bers} far off or non-finite metrics")

    # depth >= T: the window holds the whole stream, so both stream routes
    # must equal the block decode exactly
    small_bits = torch.randint(0, 2, (16, 500), generator=gen, device="cuda", dtype=torch.int32)
    small = spec.channel(gen, spec.encode(small_bits), flip_prob=0.03)
    want = decode(DecodeRequest(spec, received=small))
    full = DecodeContext(streaming=True, stream_depth=small.shape[1])
    via_decode = decode(DecodeRequest(spec, received=small), ctx=full)
    got = [StreamSession(spec, batch=16, chunk=STREAM_CHUNK, depth=small.shape[1],
                         backend="fused_packed", inputs="received").decode_all(small),
           (via_decode.bits, via_decode.path_metric)]
    for label, (b, m) in zip(("session", "streaming decode"), got):
        if not (torch.equal(b, want.bits) and torch.equal(m, want.path_metric)):
            _fail(f"{label} at depth >= T differs from the block decode")
    print("[stream] depth >= T (B=16, T=506): session and streaming decode equal the block "
          "decode exactly")
    n_bits = STREAM_B * STREAM_INFO
    return dict(spec=spec, rx=rx, launches_session=la, launches_windowed=lb, ber=bers,
                e2e=dict(session_s=session_s, session_bits_per_s=n_bits / session_s,
                         session_peak_bytes=session_peak, streaming_decode_s=windowed_s,
                         streaming_decode_bits_per_s=n_bits / windowed_s))


def _timed(kernel_fn, plain_fn, reps):
    """(kernel rounds (ms), plain ms, kernel output, plain output): the
    kernel median-of-5 material after warm-up, the plain version once after
    one warm-up call."""
    outs = {}
    rounds = _event_ms(lambda: outs.__setitem__("k", kernel_fn()), reps, rounds=5)
    plain_ms = _event_ms(lambda: outs.__setitem__("p", plain_fn()), 1, warmup=1)[0]
    return rounds, plain_ms, outs["k"], outs["p"]


def _window_touched_words(code, packed, fs, lo, hi) -> int:
    """Distinct survivor words the windowed traceback reads: one per valid
    step, (t // 32, lane, s_t) along each lane's walk."""
    import torch

    W, L, S = packed.shape
    rows = torch.arange(L, device=packed.device)
    s = fs.long()
    keys = []
    for t in range(W * 32 - 1, -1, -1):
        valid = (t >= lo) & (t < hi)
        keys.append(((t // 32 * L + rows) * S + s)[valid])
        bit = (packed[t // 32, rows, s] >> (t % 32)) & 1
        s = torch.where(valid, 2 * (s & (S // 2 - 1)) + bit.long(), s)
    return int(torch.unique(torch.cat(keys)).numel())


def phase_timing_seeded(tiled, stream):
    """The carried, windowed and unpacked scans and the windowed traceback at
    the shapes their paths give them, each against its plain version."""
    import torch

    from repro_torch.kernels import (
        fused_metric_plan, minplus, ops, plan_tiles, survivors, viterbi_scan)

    rows = []
    # --- the stream step: (B=128, C=64), the first chunk of the 64k stream
    spec = stream["spec"]
    code = spec.code
    S, M = code.n_states, code.n_symbols
    plan = fused_metric_plan(code, "hard")
    feats = plan.features(stream["rx"][:, :STREAM_CHUNK]).contiguous()
    b0, b1, rb = plan.folded("cuda")
    pm0 = torch.full((STREAM_B, S), 1e30, device="cuda")
    pm0[:, 0] = 0.0
    B, C, F = feats.shape
    W = -(-C // 32)
    r, pms, k, p = _timed(lambda: viterbi_scan.viterbi_scan_packed_carry(code, pm0, feats, b0, b1, rb),
                          lambda: viterbi_scan.viterbi_scan_packed_carry_plain(
                              code, pm0, feats, b0, b1, rb), 50)
    err = _same("carry at the session shape", k, p)
    print(f"[timing] rounds (ms): viterbi_scan_packed_carry {r}")
    rows.append(_row("viterbi_scan_packed_carry", SCAN_SRC, "src/repro/kernels/viterbi_scan.py:260",
                     statistics.median(r), pms,
                     4 * (B * C * F + 2 * B * S + W * B * S + 2 * S * F + 2 * S),
                     B * C * (M * 2 * F + 7 * S)))
    rows[-1].update(max_abs_err=err, shape=f"{B} streams x {C} steps")
    bm = spec.branch_metrics(stream["rx"][:, :STREAM_CHUNK]).contiguous()
    r, pms, k, p = _timed(lambda: viterbi_scan.viterbi_scan_carry(code, pm0, bm),
                          lambda: viterbi_scan.viterbi_scan_carry_plain(code, pm0, bm), 50)
    err = _same("unpacked carry at the stream shape", k, p)
    print(f"[timing] rounds (ms): viterbi_scan_carry {r}")
    rows.append(_row("viterbi_scan_carry", SCAN_SRC, "src/repro/kernels/viterbi_scan.py:208",
                     statistics.median(r), pms,
                     4 * (B * C * M + 2 * B * S + C * B * S + 2 * S * M + 2 * S),
                     B * C * (M * 2 * M + 7 * S)))
    rows[-1].update(max_abs_err=err, shape=f"{B} streams x {C} steps")

    # --- the tiled passes of the pinned NASA-frame decode (P=8, exact), on
    # the operands the tiled op itself hands its kernels
    hard = tiled["hard"]
    code = hard["spec"].code
    launched = {}
    bits, metric = ops.viterbi_decode_tiled_fused(
        fused_metric_plan(code, "hard"), hard["rx"], TILES, capture=launched)
    if not (torch.equal(bits, hard["pinned"].bits)
            and torch.equal(metric, hard["pinned"].path_metric)):
        _fail("the captured tiled op differs from the pinned decode() it times")
    pass1, pass2, tb = launched["pass1"], launched["pass2"], launched["traceback"]
    Bn = hard["rx"].shape[0]
    lanes2, V, F = pass2[2].shape  # lanes (b, p) x span x features
    valid = int((pass2[7] - pass2[6]).sum())  # valid (frame, step) pairs over all tiles
    W = -(-V // 32)
    passes = []
    for label, args, lanes, reps in (("pass 1", pass1, lanes2 * S, 3), ("pass 2", pass2, lanes2, 20)):
        r, pms, k, p = _timed(lambda a=args: viterbi_scan.viterbi_scan_packed_window(*a),
                              lambda a=args: viterbi_scan.viterbi_scan_packed_window_plain(*a),
                              reps)
        err = _same(f"windowed scan, tiled {label}", k, p)
        print(f"[timing] rounds (ms): viterbi_scan_packed_window {label} "
              f"({lanes} lanes x {V} steps) {r}")
        nbytes = 4 * (lanes * V * F + 2 * lanes * S + 2 * lanes + W * lanes * S + 2 * S * F + 2 * S)
        n_ops = valid * (lanes // lanes2) * (M * 2 * F + 7 * S)
        passes.append((statistics.median(r), pms, err, _row(
            f"viterbi_scan_packed_window ({label})", SCAN_SRC, "", statistics.median(r), pms,
            nbytes, n_ops)))
    # one row for the kernel: both launches of one tiled decode, each pass's
    # bound added (the passes run one after the other)
    row = dict(passes[0][3], name="viterbi_scan_packed_window",
               replaces="src/repro/kernels/viterbi_scan.py:276",
               ms=sum(x[0] for x in passes), plain_ms=sum(x[1] for x in passes),
               bound_ms=sum(x[3]["bound_ms"] for x in passes),
               bytes=sum(x[3]["bytes"] for x in passes),
               operations=sum(x[3]["operations"] for x in passes),
               max_abs_err=max(x[2] for x in passes),
               shape="pass 1 + pass 2: " + ", ".join(
                   f"{x[3]['bound_ms']!r} ms bound ({x[3]['bound_by']})" for x in passes))
    print(f"[timing] viterbi_scan_packed_window (both passes): kernel {row['ms']!r} ms, plain "
          f"{row['plain_ms']!r} ms, bound {row['bound_ms']!r} ms")
    rows.append(row)
    lanes = lanes2 * S
    r, pms, k, p = _timed(lambda: survivors.traceback_packed_window(*tb),
                          lambda: survivors.traceback_packed_window_plain(*tb), 5)
    err = _same("windowed traceback, tiled", k, p)
    print(f"[timing] rounds (ms): traceback_packed_window {r}")
    touched = _window_touched_words(code, *tb[1:])
    row = _row("traceback_packed_window", TB_SRC, "src/repro/kernels/survivors.py:163",
               statistics.median(r), pms, 4 * (touched + lanes * 32 * W + 4 * lanes),
               6 * valid * S)
    row.update(max_abs_err=err, shape=f"{lanes} lanes x {32 * W} steps")
    rows.append(row)

    # --- the pinned decode's torch work between its kernels, one part each
    feats = fused_metric_plan(code, "hard").features(hard["rx"])
    tp = plan_tiles(feats.shape[1], TILES)
    parts = {
        "gather tiles + repeat for pass 1": lambda: ops._tile_data(feats, tp).repeat_interleave(
            S, dim=0),
        "prefix_maps (P compositions)": lambda: minplus.prefix_maps(launched["maps"]),
        "repeat packed words for the traceback": lambda: launched["packed"].repeat_interleave(
            S, dim=1),
    }
    breakdown = {}
    for label, fn in parts.items():
        breakdown[label] = statistics.median(_event_ms(fn, 1, rounds=3, warmup=1))
    print(f"[timing] tiled P={TILES} torch parts (ms, median of 3): {breakdown}")
    # the session's second kernel at its shape: the traceback over the
    # 128-step packed ring of 128 streams
    ring = torch.zeros((4, STREAM_B, S), dtype=torch.int32, device="cuda")
    best = torch.zeros((STREAM_B,), dtype=torch.int32, device="cuda")
    tb_ms = statistics.median(_event_ms(
        lambda: survivors.traceback_packed(code, ring, best, 128), 50, rounds=5))
    print(f"[timing] traceback_packed at the session shape (128 streams x 128 steps): "
          f"{tb_ms!r} ms")

    # --- end to end: the tiled decode, pinned and planned
    from repro_torch.decode import DecodeContext, DecodeRequest, decode

    request = DecodeRequest(hard["spec"], received=hard["rx"])
    e2e = {}
    for label, ctx in (("pinned", DecodeContext(tiles=TILES)), ("planned", DecodeContext())):
        rounds = _event_ms(lambda c=ctx: decode(request, ctx=c), 3, rounds=5)
        ms = statistics.median(rounds)
        e2e[label] = dict(ms=ms, rounds=rounds, bits_per_s=NASA_B * NASA_INFO / (ms / 1e3),
                          peak_bytes=_peak_bytes(lambda c=ctx: decode(request, ctx=c)))
        print(f"[timing] tiled decode() NASA frame {label} (P="
              f"{TILES if label == 'pinned' else tiled['hard']['planned_tiles']}): rounds {rounds} "
              f"median {ms!r} ms, {e2e[label]['bits_per_s']!r} decoded bits/s, peak device "
              f"memory {e2e[label]['peak_bytes']} bytes above the live tensors")
    e2e["pinned_torch_parts_ms"] = breakdown
    e2e["session_traceback_ms"] = tb_ms
    return rows, e2e


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
    tiled = phase_tiled(gen)
    stream = phase_stream(gen)
    feats, weights, errs = phase_parity(gen, inputs["hard"], hard_spec)
    phase_parity_seeded(gen)
    rows, e2e = phase_timing(hard_spec, inputs["hard"][2], feats, weights)
    for row, err in zip(rows, errs):
        row["launches"] = launches.get(row["name"], 0)
        row["max_abs_err"] = err
    seeded_rows, tiled_e2e = phase_timing_seeded(tiled, stream)
    # launches: each kernel's count from the run of the path that drives it
    path_launches = {
        "viterbi_scan_packed_carry": stream["launches_session"],
        "viterbi_scan_carry": stream["launches_windowed"],
        "viterbi_scan_packed_window": tiled["hard"]["launches_pinned"],
        "traceback_packed_window": tiled["hard"]["launches_pinned"],
    }
    for row in seeded_rows:
        row["launches"] = path_launches[row["name"]].get(row["name"], 0)
    rows += seeded_rows
    e2e = {"decode_short": e2e, "tiled_nasa_frame": tiled_e2e, "stream_64k": stream["e2e"],
           "ber": {"tiled_hard": tiled["hard"]["ber"], "tiled_soft": tiled["soft"]["ber"],
                   "stream": stream["ber"]}}
    kernels = [{k: row[k] for k in ("name", "route", "source", "replaces", "launches",
                                    "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                                    "library_ms")} for row in rows]
    print(json.dumps({"end_to_end": e2e, "bound_inputs": [
        {k: r[k] for k in ("name", "bytes", "operations", "shape") if k in r} for r in rows]}))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
