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
 4b. scheduler — the same 128 streams through a ``StreamScheduler`` at the
               ``STREAM`` deployment (64 slots: two waves, chunk 64, depth
               5K, 512 rows buffered a stream; ``fused_packed`` on raw
               symbols), each stream fed by a producer of seeded random
               arrivals of 1-512 rows: every stream's bits and metric equal
               the packed session's, the BER the stream phase's, #3 and #2
               launched once a tick and no plain call; wall time, tick time,
               arrival-to-commit latency and peak memory, and from a traced
               run over each stream's first 16384 rows (open) the tick's
               phase shares, that run snapshotted at tick 300 and restored
               on the card, its bits equal a packed session's;
  5. fused   — the unpacked route at phase 2's shape and symbols:
               ``decode(..., backend="fused")`` (the unpacked scan kernel +
               the plain traceback), hard and soft, bits (and the hard
               metric) equal to the ``fused_packed`` decode exactly;
  6. texpand — the paper's one-step instruction driven over all T=1006 steps
               of the same bm tables, one launch a step: final metrics and
               stacked selects equal the unpacked scan's exactly;
  7. siso    — ``decode()`` through the planner's family rule: the K=4 LTE
               RSC code through ``bcjr`` (B=8192 x 1000 bits, terminated),
               the repo's turbo configuration (QPP N=512, B=8192, 6
               iterations, early exit) and LTE's largest block (QPP N=6144,
               B=1024) at Eb/N0 1 dB; the turbo BER must be below the rate-1/3
               K=7 soft Viterbi baseline's on the same info bits;
  8. parallel — the block-parallel route, ``decode(..., backend="parallel")``:
               (a) the NASA frame of phase 3 (hard and soft symbols, chunk
               64: 17 chunks, the last of 6 steps), bits (and the hard
               metric) equal to phase 3's planned decode, the soft metric
               within rtol 1e-5; (b) the repo's long-stream example
               (examples/long_context.py: K=3, one stream of 65536 info bits,
               BSC p=0.01, chunk 512: 129 chunks), bits and metric equal to
               the planned decode (``tiled``, P=128, its launches counted
               on their own).  Counters prove the windowed scan, the
               (min,+) product, the carried unpacked scan and the packed
               traceback ran and no plain version did;
  9. parity  — each kernel against its plain PyTorch version on the card,
               exactly (words, selects, metrics, bits, entry states, alphas,
               LLRs, (min,+) products), at K=3, 7, 11 (13 for the short-block
               kernels) small shapes with T % 32 != 0, partial windows and
               carried metrics holding 1e30, the state-0, windowed and
               unpacked scans at every S of their launch tables (2 to 4096),
               the windowed walk at every S of its table (2 to 128) and at
               256 and 512, the full walk at every S (staged to 128, direct
               past it; odd, 2 mod 4 and 0 mod 4 row lengths; words off
               16-byte alignment), the RSC codes
               of every S, terminated and open, and (min,+) products at both
               inits with 1e30, 2e30 and NaN entries, K = 1, strided batches
               and an empty batch, the square kernel at every S from 2 to 128
               (contiguous, strided, stride-0 and misaligned batches, each
               printed with the kernel that takes it);
 10. timing  — CUDA-event times of each kernel and each plain version at the
               shape its path gives it (kernels: median of 5 rounds, every
               round printed), each held against its plain output exactly,
               with each kernel's bound; for the scans and #8 also the
               device-only time (a CUDA graph of the same launches,
               replayed), #4 at the ``parallel`` transfer matrices' shape
               beside the pinned tiled passes, #5 at the long stream's
               planned ``tiled`` walk beside the pinned one, #7 at both
               ``parallel`` re-scan shapes, #2 at its five path shapes (the
               short blocks, the planned and the ``parallel`` NASA decodes'
               walks, a session push's ring, a scheduler tick's ring), #3 at
               the session's and a scheduler tick's shapes, and #11 at each
               of the seven
               combines of the ``parallel`` NASA decode, all on the operands
               their decodes hand them; end-to-end times of every path;
 11. analysis — the port's repo rules (RPR001-RPR005) over src/repro_torch
               must be clean, and every registered backend's hot path
               (``repro_torch.analysis.check_hot_paths``) runs once warm and
               once under ``sanitized()`` with its op trace: per entry the
               dispatched ops, host syncs against the contract's bound and
               their lines, uploads, rebuilds (0), launches per kernel (each
               named kernel > 0), plain calls (0) and contract violations
               (0);
 12. paper   — the paper's comparison on the card, at its 4-state code and
               at K=7 NASA, B as in the timing phase: the device-only time a
               trellis step (CUDA graphs) of ACS without the custom
               instruction (``acs_step_unfused``, torch ops a transition),
               ``acs_step`` (torch ops), one ``texpand`` (#8) launch and the
               fused unpacked scan (#6) over T=1006 divided by T, beside the
               torch ops or launches a step; all four give equal metrics
               and selects, and ``paper_expansion_calls(12) == 19``;
 13. lm_serve — the LM serving path at qwen2.5-3b's full width (36 layers,
               d=2048, GQA 16/2, d_ff 11008, vocab 151936, QKV bias, tied
               embeddings; random weights from the seed): ``build`` on the
               card, greedy ``ServeEngine.generate`` of 32 tokens after 4
               prompts of 16 (no host sync a token: counted at 32 and 16
               tokens), parameter count beside ``param_count()``, bytes held,
               ``cache_bytes``, peak memory, prefill and decode-step times
               (CUDA events, median of 5 rounds) and tokens/s beside the
               step's byte bound; teacher forcing — prefill(16) + decode(token
               16) against a full forward over 17 tokens — in bf16 (logits
               within its stated tolerance, the decode's argmax a maximum of
               the full forward up to it) and in float32 compute (the same
               argmax in every row);
 14. serve_scenario — the paper's pipeline (examples/serve_viterbi.py): the
               LM's tokens at 18 bits a token -> the K=3 code -> a BSC at flip
               0, 0.01, 0.03 -> the planned decode (``fused_packed``: #1 and
               #2, no plain call); bits and tokens exact at flip 0.
 15. lm_train — LM training at qwen2.5-3b's full width (remat "full", AdamW,
               float32 master weights, bf16 compute; random weights from the
               seed), after the serving phases' tensors are freed, on
               ``SyntheticLM`` batches of 2 x 4096 tokens (``train_4k``'s
               sequence, its global batch 256 cut to 2 for one card):
               ``remat="full"`` against ``"none"`` at full width but 2 layers
               (the loss equal, each gradient leaf within LM_REMAT_GRAD_TOL);
               8 ``make_train_step`` steps on one fixed batch (lr 1e-4, warmup
               2) — the step-0 loss equal to ``softmax_xent`` of a no-grad
               forward of the same bf16 weights, every loss and grad norm
               finite, the last loss below the first, one host sync a step
               (``sanitized()``); step time (median of steps 2-7), tokens/s,
               the model-FLOP share of the bf16 peak, peak memory against the
               prediction, the optimizer update's own time; then ``train()``
               for 3 steps on ``make_data_iter``.
 16. lm_serve_moe — the MoE family (qwen3-moe-30b-a3b: d=2048, GQA 32/4,
               qk-norm, 128 experts top 8 of width 768, vocab 151936) at 16
               of its 48 layers (the float32 weights of 48 do not fit the
               card) and the MLA + MoE family (deepseek-v2-lite-16b: d=2048,
               16 heads, MLA rank 512 with rope 64 / nope 128 / v 128, 64
               experts top 6 of width 1408 + 2 shared, vocab 102400) at all
               27 layers, random float32 weights from the seed, bf16
               compute: greedy ``ServeEngine.generate`` of 32 tokens after
               4 prompts of 16 with no host sync in it and two calls
               bit-equal (the combine adds in expert order), prefill and
               decode-step times (CUDA events; the step also as a CUDA-graph
               replay), tokens/s, peak memory; teacher forcing at capacity
               factor 64 in bf16 and float32 compute at phase 13's
               tolerances; each family's tokens through phase 14's scenario
               (17 or 18 bits a token; exact at flip 0);
 17. lm_train_moe — both families at full width and 2 layers, remat "full",
               AdamW, on ``SyntheticLM`` batches of 2 x 4096: 5
               ``make_train_step`` steps of a fixed batch (the step-0 loss,
               aux terms included, equal to a no-grad forward's; one host
               sync a step; finite losses and positive aux losses), step
               time (median of steps 1-4), tokens/s, the model-FLOP share of
               the active parameters, peak memory; then ``train()`` for 2
               steps on ``make_data_iter``.

The line before the last is one JSON object with a row per kernel; the last
line is ``{"ok": true, "device": {...}}``.  Without a CUDA device, or without
the repository's ``src/`` beside this file, it exits non-zero and prints no
result.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
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


@contextlib.contextmanager
def _recording(module, name: str):
    """Inside, ``module.name`` appends (arguments, result, counts) of every
    call to the list it yields, ``counts`` being the kernel launches and
    plain-version calls that call made (two Counters); the call itself goes
    on as before."""
    from collections import Counter

    from repro_torch.kernels import launch_counts, plain_counts

    calls = []
    orig = getattr(module, name)

    def record(*args):
        launched, plain = Counter(launch_counts), Counter(plain_counts)
        out = orig(*args)
        calls.append((args, out, (launch_counts - launched, plain_counts - plain)))
        return out
    setattr(module, name, record)
    try:
        yield calls
    finally:
        setattr(module, name, orig)


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


#: untimed replays of a graph before its timed ones last at least this long:
#: for tens of ms after large fresh allocations (a phase's plain versions, a
#: graph's own pool) a store-bound kernel such as #6 runs slower, and the
#: graph would time that instead of the kernel
SETTLE_MS = 200.0


def _graph_ms(fn, n: int, rounds: int = 5) -> tuple:
    """Device-only time of ``fn()``: ``n`` calls captured into one CUDA
    graph after a warm-up, replayed untimed for ``SETTLE_MS``, then for each
    of ``rounds`` replays its CUDA-event time over ``n``.  Back-to-back
    eager calls (``_event_ms``) stop at the host's time to enqueue a call; a
    replay does not.  Returns (timed rounds, settling replays)."""
    import torch

    fn()
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()

    def replay():
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / n

    settle, t0 = [], time.perf_counter()
    while (time.perf_counter() - t0) * 1e3 < SETTLE_MS:
        settle.append(replay())
    return [replay() for _ in range(rounds)], settle


def _device_only(row, fn, n):
    """Add the device-only time of ``fn`` (median of 5 graph replays of
    ``n`` calls, after the settling replays) to ``row`` beside its
    back-to-back ``ms``."""
    r, settle = _graph_ms(fn, n)
    row.update(device_ms=statistics.median(r), device_rounds=r)
    print(f"[timing] {row['name']}: device-only {row['device_ms']!r} ms (graph replays {r}; "
          f"settling replays before them {settle[:12]}{' ...' if len(settle) > 12 else ''}, "
          f"{len(settle)} in all), back-to-back {row['ms']!r} ms")


def phase_build():
    from repro_torch.kernels import _build

    libs = _build.build_all()
    for lib in libs.values():
        print(f"[build] {' '.join(lib.command)}")
        for line in lib.compiler_output.splitlines():
            if "ptxas info" in line or "spill" in line:
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
    return launches, inputs, hard, results


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


#: a rate-1/2 code of every trellis size in the chain kernel's launch tables
#: (csrc/viterbi_scan.cu: VITERBI_CHOICES, VITERBI_WIDE_CHOICES)
TABLE_CODES = ((2, (0b11, 0b10)), (3, (0b111, 0b101)), (4, (0o15, 0o17)), (5, (0o23, 0o35)),
               (6, (0o53, 0o75)), (7, (0o171, 0o133)), (8, (0o247, 0o371)),
               (9, (0o561, 0o753)), (10, (0o1167, 0o1545)), (11, (0o3345, 0o3613)),
               (12, (0o5723, 0o6265)), (13, (0o15621, 0o17363)))


def phase_parity_wide(gen):
    """The wide kernel's entries (#1, #4 packed, #6 unpacked) against their
    plain versions at every S of the wide launch tables: folded hard and
    soft weights (soft features holding NaN, +-inf and +-1e30) and table
    weights, per-lane windows with empty ones and edges beside word
    boundaries, seeds holding 1e30; survivors exact, metrics NaN-aware, one
    launch a call.  And the windowed walk (#5) at every S of its table and
    two past it (staged to 128, direct beyond): random words, windows beside
    word edges and empty ones, final states out of the row, one launch a
    call; the full walk (#2) at every S the same way.  No call runs a plain
    version."""
    import torch

    from repro_torch.core import ConvCode
    from repro_torch.kernels import fused_metric_plan, survivors, viterbi_scan

    for K, polys in TABLE_CODES:
        code = ConvCode(K, polys)
        S = code.n_states
        B, T = (333, 70) if S <= 256 else (9, 45)
        pm0 = _seed_metrics(gen, B, S)
        lo = torch.randint(0, T // 2, (B,), generator=gen, device="cuda").int()
        hi = torch.randint(T // 2, T + 3, (B,), generator=gen, device="cuda").int()
        lo[:4] = torch.tensor([31, 0, 33, 20], device="cuda", dtype=torch.int32)[:B]
        hi[:4] = torch.tensor([33, 32, 65, 20], device="cuda", dtype=torch.int32)[:B]
        soft = torch.randn((B, T, code.n_out), generator=gen, device="cuda")
        pick = torch.rand(soft.shape, generator=gen, device="cuda")
        for i, v in enumerate((float("nan"), math.inf, -math.inf, 1e30, -1e30)):
            soft[(pick >= 0.004 * i) & (pick < 0.004 * (i + 1))] = v
        hard = torch.randint(0, 2, (B, T, code.n_out), generator=gen, device="cuda")
        tables = torch.randint(0, 3, (B, T, code.n_symbols), generator=gen, device="cuda").float()
        hplan = fused_metric_plan(code, "hard")
        for label, data, w in (("soft", soft, fused_metric_plan(code, "soft").folded("cuda")),
                               ("hard", hplan.features(hard).contiguous(), hplan.folded("cuda")),
                               ("table", tables, viterbi_scan.table_weights(code, "cuda"))):
            for name, args in (("viterbi_scan_packed", (code, data, *w)),
                               ("viterbi_scan_packed_window", (code, pm0, data, *w, lo, hi))):
                pm, words = _one_launch(f"{name} S={S} {label}", name,
                                        lambda: getattr(viterbi_scan, name)(*args))
                pm_p, words_p = getattr(viterbi_scan, f"{name}_plain")(*args)
                _same(f"{name} S={S} {label} (words)", (words,), (words_p,))
                _same_nan(f"{name} S={S} {label} (metrics)", pm, pm_p)
        soft_tables = torch.randn(tables.shape, generator=gen, device="cuda")
        soft_tables[pick[..., :1].expand_as(soft_tables) < 0.01] = float("nan")
        for label, bm in (("hard", tables), ("soft", soft_tables)):
            pm, bps = _one_launch(f"viterbi_scan S={S} {label}", "viterbi_scan",
                                  lambda: viterbi_scan.viterbi_scan(code, bm))
            pm_p, bps_p = viterbi_scan.viterbi_scan_plain(code, bm)
            _same(f"viterbi_scan S={S} {label} (selects)", (bps,), (bps_p,))
            _same_nan(f"viterbi_scan S={S} {label} (metrics)", pm, pm_p)
        if S <= 512:
            W = -(-T // 32)
            words = torch.randint(-2 ** 31, 2 ** 31 - 1, (W, B, S), generator=gen,
                                  device="cuda", dtype=torch.int32)
            fs = torch.randint(-2 ** 31, 2 ** 31 - 1, (B,), generator=gen, device="cuda",
                               dtype=torch.int32)
            whi = hi.clamp(max=32 * W)
            walk = _one_launch(f"traceback_packed_window S={S}", "traceback_packed_window",
                               lambda: survivors.traceback_packed_window(code, words, fs, lo,
                                                                         whi))
            _same(f"traceback_packed_window S={S}", walk,
                  survivors.traceback_packed_window_plain(code, words, fs, lo, whi))
        # the full walk (#2): staged to S = 128, direct past it; rows of T
        # ints with T 2 mod 4 (or odd past S = 256), odd and 0 mod 4
        for Tw in (T, 33, 64):
            words = torch.randint(-2 ** 31, 2 ** 31 - 1, (-(-Tw // 32), B, S), generator=gen,
                                  device="cuda", dtype=torch.int32)
            fs = torch.randint(-2 ** 31, 2 ** 31 - 1, (B,), generator=gen, device="cuda",
                               dtype=torch.int32)
            bits = _one_launch(f"traceback_packed S={S} T={Tw}", "traceback_packed",
                               lambda: survivors.traceback_packed(code, words, fs, Tw))
            _same(f"traceback_packed S={S} T={Tw}", (bits,),
                  (survivors.traceback_packed_plain(code, words, fs, Tw),))
        # words one int off 16-byte alignment: the direct walk at every S
        buf = torch.randint(-2 ** 31, 2 ** 31 - 1, (words.numel() + 1,), generator=gen,
                            device="cuda", dtype=torch.int32)
        words = buf[1:].view(words.shape)
        bits = _one_launch(f"traceback_packed S={S} misaligned", "traceback_packed",
                           lambda: survivors.traceback_packed(code, words, fs, 64))
        _same(f"traceback_packed S={S} misaligned", (bits,),
              (survivors.traceback_packed_plain(code, words, fs, 64),))
        print(f"[parity] S={S} B={B} T={T}: viterbi_scan_packed, viterbi_scan_packed_window "
              "(soft with NaN/inf/1e30, hard, table; windows beside word edges), viterbi_scan "
              "(hard and soft tables)" + (", traceback_packed_window" if S <= 512 else "")
              + f", traceback_packed (T = {T}, 33, 64; words one int off 16 bytes): exact")


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


def _row(name, src, ref, ms, plain_ms, nbytes, n_ops, ops_per_s=FP32_OPS_PER_S):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / ops_per_s * 1e3
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
    _device_only(rows[0], lambda: viterbi_scan.viterbi_scan_packed(code, feats, b0, b1, rb), 20)
    _device_only(rows[1], lambda: survivors.traceback_packed(code, packed, fs, T), 20)
    rows[1].update(shape=f"{B} lanes x {T} steps")
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


def _one_launch(label, name, fn):
    """``fn()``'s output; fails unless it launched kernel ``name`` once and
    ran no plain version."""
    import torch

    launches, plains = _counts()
    out = fn()
    torch.cuda.synchronize()
    after, plains_after = _counts()
    if after.get(name, 0) - launches.get(name, 0) != 1 or plains_after != plains:
        _fail(f"{label}: not one launch of {name} and no plain call")
    return out


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
                         launches_pinned=lb, ber=bers, pinned=tiled, planned=planned)

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
    return dict(spec=spec, rx=rx, bits=bits, session_bits=s_bits, session_metric=s_metric,
                launches_session=la, launches_windowed=lb, ber=bers,
                e2e=dict(session_s=session_s, session_bits_per_s=n_bits / session_s,
                         session_peak_bytes=session_peak, streaming_decode_s=windowed_s,
                         streaming_decode_bits_per_s=n_bits / windowed_s))


#: ``STREAM`` (src/repro_torch/configs/paper_viterbi.py): 64 slots, chunk 64,
#: depth 5K, 512 rows buffered a stream; arrivals of 1 to 512 rows.  The
#: traced run (phase shares, snapshot/restore) takes the first 16384 rows of
#: each stream, open-ended: a cut of length only, the widths and counts stay.
SCHED_MAX_ARRIVAL = 512
SCHED_TRACE_ROWS = 16384
SCHED_SNAP_TICK = 300


def _arrivals(table, rng):
    """A stream's rows in seeded random arrival sizes of 1 to 512 rows."""
    i = 0
    while i < len(table):
        n = int(rng.integers(1, SCHED_MAX_ARRIVAL + 1))
        yield table[i:i + n]
        i += n


def _deployment_scheduler(spec, **kw):
    """A ``StreamScheduler`` at the ``STREAM`` deployment, ``fused_packed``
    on raw symbols, on the card."""
    from repro_torch.configs import STREAM
    from repro_torch.stream import StreamScheduler

    return StreamScheduler(spec, n_slots=STREAM.n_slots, chunk=STREAM.chunk,
                           depth=STREAM.depth(spec.code), backend="fused_packed",
                           inputs="received", max_buffered=STREAM.max_buffered, **kw)


def _open_streams(sched, rows, seed, **kw):
    """Open one stream a row of ``rows`` on a ``GeneratorProducer`` of its
    arrivals; returns the producers by stream id."""
    import numpy as np

    from repro_torch.stream import GeneratorProducer

    prods = {}
    for i, table in enumerate(rows):
        prods[f"s{i}"] = GeneratorProducer(_arrivals(table, np.random.default_rng([seed, i])))
        sched.open_stream(f"s{i}", producer=prods[f"s{i}"], **kw)
    return prods


def phase_scheduler(stream, seed):
    """The continuous-batching scheduler at the 64k deployment: the stream
    phase's 128 streams through ``STREAM``'s 64 slots (two waves, every slot
    reused), fed by producers of random arrival sizes; each stream's bits and
    metric equal the packed session's exactly.  A second, traced run over
    the first 16384 rows of each stream gives the tick's phase shares, and
    is snapshotted at a mid-run tick and restored (producers re-attached):
    its bits equal a packed session's on the same cut symbols."""
    import numpy as np
    import torch

    from repro_torch.configs import STREAM
    from repro_torch.kernels import reset_counts, survivors, viterbi_scan
    from repro_torch.obs import Telemetry, Tracer
    from repro_torch.stream import StreamScheduler, StreamSession
    from repro_torch.stream.scheduler import TICK_PHASES

    spec = stream["spec"]
    rows = stream["rx"].to(torch.float32).cpu().numpy()  # the caller's host symbols
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    sched = _deployment_scheduler(spec)
    _open_streams(sched, rows, seed)
    results = sched.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    la, pa = _counts()
    peak = torch.cuda.max_memory_allocated() - base
    ticks = sched.stats.ticks
    print(f"[scheduler] {STREAM_B} streams x {STREAM_INFO} info bits, {STREAM.n_slots} slots, "
          f"chunk {STREAM.chunk}, depth {sched.depth}, max_buffered {STREAM.max_buffered}, "
          f"arrivals of 1-{SCHED_MAX_ARRIVAL} rows: launches {la} plain calls {pa}, {ticks} ticks")
    for k in ("viterbi_scan_packed_carry", "traceback_packed"):
        if la.get(k, 0) != ticks:
            _fail(f"scheduler: {k} launched {la.get(k, 0)} times in {ticks} ticks")
    if any(pa.values()):
        _fail(f"scheduler: plain versions ran: {pa}")
    if sched.stats.slot_claims != STREAM_B or sched.stats.streams_finished != STREAM_B:
        _fail(f"scheduler: stats {sched.stats.asdict()}")
    s_bits = stream["session_bits"].cpu().numpy()
    s_metric = stream["session_metric"].cpu().numpy()
    for i in range(STREAM_B):
        bits, metric = results[f"s{i}"]
        if not (np.array_equal(bits, s_bits[i]) and metric == float(s_metric[i])):
            _fail(f"scheduler: stream s{i} differs from the packed session")
    sched_bits = torch.from_numpy(np.stack([results[f"s{i}"][0] for i in range(STREAM_B)]))
    ber = _ber(spec.strip_flush(sched_bits.cuda()), stream["bits"])
    if ber != stream["ber"][0]:
        _fail(f"scheduler BER {ber!r} != the stream phase's {stream['ber'][0]!r}")
    n_bits = STREAM_B * STREAM_INFO
    hist = sched.telemetry.metrics.histogram("stream_tick_seconds")
    report = sched.load_report()
    e2e = dict(wall_s=wall, bits_per_s=n_bits / wall, ticks=ticks,
               starved_slot_ticks=sched.stats.starved_slot_ticks,
               tick_s=dict(p50=hist.quantile(0.5), p99=hist.quantile(0.99), mean=hist.mean,
                           max=hist.max),
               arrival_to_commit_s=report["latency_s"], peak_bytes=peak,
               session_s=stream["e2e"]["session_s"],
               session_bits_per_s=stream["e2e"]["session_bits_per_s"], ber=ber,
               stats=sched.stats.asdict())
    print(f"[scheduler] every stream's bits and metric equal the packed session's; BER {ber!r} "
          f"(stream phase {stream['ber'][0]!r})")
    print(f"[scheduler] wall {wall!r} s = {e2e['bits_per_s']!r} info bits/s (packed session on "
          f"the same symbols {stream['e2e']['session_s']!r} s = "
          f"{stream['e2e']['session_bits_per_s']!r}); starved slot-ticks "
          f"{e2e['starved_slot_ticks']}; tick time (stream_tick_seconds, bucket bounds) p50 "
          f"{e2e['tick_s']['p50']!r} s p99 {e2e['tick_s']['p99']!r} s, mean {hist.mean!r} s, "
          f"max {hist.max!r} s; arrival-to-commit {report['latency_s']}; peak device memory "
          f"{peak} bytes above the live tensors")

    # --- the traced run: phase shares, one tick's kernel operands, and a
    # snapshot/restore round trip at a mid-run tick
    cut = rows[:, :SCHED_TRACE_ROWS]
    tracer = Tracer("chip_smoke")
    traced = _deployment_scheduler(spec, telemetry=Telemetry(tracer=tracer))
    prods = _open_streams(traced, cut, seed, terminated=False)
    while traced.stats.ticks < SCHED_SNAP_TICK and traced.pending_work():
        if traced.stats.ticks == SCHED_SNAP_TICK // 2:
            with _recording(viterbi_scan, "viterbi_scan_packed_carry") as scans, \
                    _recording(survivors, "traceback_packed") as walks:
                traced.step()
        else:
            traced.step()
    snap = traced.snapshot()
    restored = StreamScheduler.restore(snap, telemetry=Telemetry(tracer=tracer))
    for im in snap.active + snap.pending:
        if not im.closed:
            restored.attach_producer(im.stream_id, prods[im.stream_id])
    cut_results = restored.run()
    want_bits, want_metric = StreamSession(
        spec, batch=STREAM_B, chunk=STREAM.chunk, backend="fused_packed",
        inputs="received").decode_all(stream["rx"][:, :SCHED_TRACE_ROWS], terminated=False)
    want_bits, want_metric = want_bits.cpu().numpy(), want_metric.cpu().numpy()
    for i in range(STREAM_B):
        bits, metric = cut_results[f"s{i}"]
        if not (np.array_equal(bits, want_bits[i]) and metric == float(want_metric[i])):
            _fail(f"scheduler: stream s{i} after snapshot/restore at tick {SCHED_SNAP_TICK} "
                  "differs from the packed session")
    if len(scans) != 1 or len(walks) != 1:
        _fail(f"scheduler: a tick launched {len(scans)} scans and {len(walks)} walks")
    total = tracer.total_s("tick")
    shares = {p: tracer.total_s(p) / total for p in (*TICK_PHASES, "flush", "compact")}
    e2e.update(traced_ticks=restored.stats.ticks, traced_tick_s=total, phase_shares=shares,
               traced_coverage=tracer.coverage("tick", TICK_PHASES))
    print(f"[scheduler] traced run ({STREAM_B} streams x {SCHED_TRACE_ROWS} rows, open; "
          f"snapshot at tick {SCHED_SNAP_TICK} of {restored.stats.ticks}, restored on the card, "
          f"producers re-attached): bits and metrics equal the packed session's; tick time "
          f"{total!r} s in all, share by phase {shares} (flush inside admit)")
    return dict(e2e=e2e, launches=la, scan_args=scans[0][0], walk_args=walks[0][0])


def phase_timing_scheduler(sched):
    """Rows #3 and #2 at the scheduler's tick shape (64 slots x 64 steps, a
    4-word ring), on the operands one tick handed them."""
    from repro_torch.kernels import viterbi_scan

    code, pm0, feats, b0, b1, rb = args = sched["scan_args"]
    S, M = code.n_states, code.n_symbols
    B, C, F = feats.shape
    W = -(-C // 32)
    r, pms, k, p = _timed(lambda: viterbi_scan.viterbi_scan_packed_carry(*args),
                          lambda: viterbi_scan.viterbi_scan_packed_carry_plain(*args), 50)
    err = _same("carry at the scheduler shape", k, p)
    print(f"[timing] rounds (ms): viterbi_scan_packed_carry scheduler {r}")
    scan = _row("viterbi_scan_packed_carry (scheduler)", SCAN_SRC, "", statistics.median(r), pms,
                4 * (B * C * F + 2 * B * S + W * B * S + 2 * S * F + 2 * S),
                B * C * (M * 2 * F + 7 * S))
    scan.update(max_abs_err=err, shape=f"{B} slots x {C} steps",
                launches=sched["launches"].get("viterbi_scan_packed_carry", 0))
    _device_only(scan, lambda: viterbi_scan.viterbi_scan_packed_carry(*args), 50)
    walk = _walk_shape("scheduler tick", sched["walk_args"],
                       sched["launches"].get("traceback_packed", 0), 50)
    return {"viterbi_scan_packed_carry": scan, "traceback_packed": walk}


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
        fused_metric_plan, launch_counts, minplus, ops, plan_tiles, reset_counts, survivors,
        viterbi_scan)

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
    _device_only(rows[-1], lambda: viterbi_scan.viterbi_scan_packed_carry(code, pm0, feats, b0, b1,
                                                                          rb), 50)
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
    _device_only(rows[-1], lambda: viterbi_scan.viterbi_scan_carry(code, pm0, bm), 50)

    # --- the tiled passes of the pinned NASA-frame decode (P=8, exact), on
    # the operands the tiled op itself hands its kernels
    hard = tiled["hard"]
    code = hard["spec"].code

    class Launched(dict):
        """A capture that also reads the window scan's launch count as each
        pass's operands come in (the op hands them over after the launch)."""

        def update(self, **kw):
            for key in kw:
                self[f"{key} count"] = launch_counts["viterbi_scan_packed_window"]
            super().update(**kw)

    reset_counts()
    launched = Launched()
    bits, metric = ops.viterbi_decode_tiled_fused(
        fused_metric_plan(code, "hard"), hard["rx"], TILES, capture=launched)
    if not (torch.equal(bits, hard["pinned"].bits)
            and torch.equal(metric, hard["pinned"].path_metric)):
        _fail("the captured tiled op differs from the pinned decode() it times")
    pass1, pass2, tb = launched["pass1"], launched["pass2"], launched["traceback"]
    pass_launches = (launched["pass1 count"], launched["pass2 count"] - launched["pass1 count"])
    if sum(pass_launches) != hard["launches_pinned"].get("viterbi_scan_packed_window", 0):
        _fail(f"the captured tiled op launched the window scan {pass_launches} times a pass, "
              f"the pinned decode() {hard['launches_pinned']}")
    Bn = hard["rx"].shape[0]
    lanes2, V, F = pass2[2].shape  # lanes (b, p) x span x features
    valid = int((pass2[7] - pass2[6]).sum())  # valid (frame, step) pairs over all tiles
    W = -(-V // 32)
    passes = []
    for label, args, lanes, reps, n_launch in (("pass 1", pass1, lanes2 * S, 3, pass_launches[0]),
                                               ("pass 2", pass2, lanes2, 20, pass_launches[1])):
        r, pms, k, p = _timed(lambda a=args: viterbi_scan.viterbi_scan_packed_window(*a),
                              lambda a=args: viterbi_scan.viterbi_scan_packed_window_plain(*a),
                              reps)
        err = _same(f"windowed scan, tiled {label}", k, p)
        print(f"[timing] rounds (ms): viterbi_scan_packed_window {label} "
              f"({lanes} lanes x {V} steps) {r}")
        nbytes = 4 * (lanes * V * F + 2 * lanes * S + 2 * lanes + W * lanes * S + 2 * S * F + 2 * S)
        n_ops = valid * (lanes // lanes2) * (M * 2 * F + 7 * S)
        prow = _row(f"viterbi_scan_packed_window ({label})", SCAN_SRC, "", statistics.median(r),
                    pms, nbytes, n_ops)
        prow.update(launches=n_launch, max_abs_err=err)
        _device_only(prow, lambda a=args: viterbi_scan.viterbi_scan_packed_window(*a), reps)
        passes.append((statistics.median(r), pms, err, prow))
    # one row for the kernel: both launches of one tiled decode, each pass's
    # bound added (the passes run one after the other)
    row = dict(passes[0][3], name="viterbi_scan_packed_window",
               replaces="src/repro/kernels/viterbi_scan.py:276",
               ms=sum(x[0] for x in passes), plain_ms=sum(x[1] for x in passes),
               bound_ms=sum(x[3]["bound_ms"] for x in passes),
               device_ms=sum(x[3]["device_ms"] for x in passes),
               bytes=sum(x[3]["bytes"] for x in passes),
               operations=sum(x[3]["operations"] for x in passes),
               max_abs_err=max(x[2] for x in passes),
               shape="pass 1 + pass 2: " + ", ".join(
                   f"{x[3]['bound_ms']!r} ms bound ({x[3]['bound_by']})" for x in passes))
    row["shapes"] = {"tiled_p8_pass1": passes[0][3], "tiled_p8_pass2": passes[1][3]}
    print(f"[timing] viterbi_scan_packed_window (both passes): kernel {row['ms']!r} ms, "
          f"device-only {row['device_ms']!r} ms, plain {row['plain_ms']!r} ms, bound "
          f"{row['bound_ms']!r} ms")
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
    _device_only(row, lambda: survivors.traceback_packed_window(*tb), 5)
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
    return rows, e2e


# --------------------------------------------------------------------------- #
# the unpacked route, the paper's one-step instruction, the SISO family       #
# --------------------------------------------------------------------------- #

#: ``TURBO_SPEC`` of tests/test_golden_ber.py and benchmarks/siso_throughput.py:
#: the K=4 LTE constituent with a QPP interleaver of N=512, at B=8192 blocks;
#: LTE's largest code block (3GPP TS 36.212 Table 5.1.3-3) at B=1024
TURBO_B, TURBO_N, TURBO_QPP = 8192, 512, (512, 31, 64)
LTE_B, LTE_QPP = 1024, (6144, 263, 480)
EBN0_DB = 1.0
TEXPAND_SRC = "src/repro_torch/csrc/texpand.cu"
BCJR_SRC = "src/repro_torch/csrc/bcjr.cu"


def phase_fused(inputs, results):
    """The unpacked route through ``decode(..., backend="fused")`` on phase
    2's symbols, against phase 2's ``fused_packed`` decodes."""
    import torch

    from repro_torch.decode import DecodeRequest, decode
    from repro_torch.kernels import reset_counts

    reset_counts()
    for name in ("hard", "soft"):
        rx = inputs[name][2]
        spec = results[name].spec
        before = _counts()[0].get("viterbi_scan", 0)
        res = decode(DecodeRequest(spec, received=rx), backend="fused")
        torch.cuda.synchronize()
        la, pa = _counts()
        if la.get("viterbi_scan", 0) - before != 1 or any(pa.values()):
            _fail(f"fused {name}: launches {la}, plain calls {pa}")
        packed = results[name]
        if res.plan.backend != "fused" or not torch.equal(res.bits, packed.bits):
            _fail(f"fused {name}: bits differ from the fused_packed decode of the same symbols")
        d_metric = float((res.path_metric - packed.path_metric).abs().max())
        if name == "hard" and d_metric:
            _fail(f"fused hard: metric differs from fused_packed by {d_metric}")
        # soft: the table route and the in-kernel route round the metric's
        # sums differently; the reference's float32 contract
        if not torch.allclose(res.path_metric, packed.path_metric, rtol=1e-5, atol=0):
            _fail(f"fused {name}: metric beyond float32 rounding of fused_packed's")
        ber = _ber(res.info_bits, inputs[name][0])
        print(f"[fused] {name}: B={rx.shape[0]} T={rx.shape[1]} bits equal fused_packed's, "
              f"max |metric diff| {d_metric!r}, BER={ber!r}")
    launches = _counts()[0]
    print(f"[fused] launches {launches}")
    return launches


def _texpand_steps(code, bm_t):
    """Drive ``texpand_op`` over every step of (T, B, M) tables from the
    state-0 start: (final pm (B, S), selects (T, B, S) int32)."""
    import torch

    from repro_torch.kernels import ops

    T, B, _ = bm_t.shape
    pm = torch.full((B, code.n_states), 1e30, dtype=torch.float32, device=bm_t.device)
    pm[:, 0] = 0.0
    bps = []
    for t in range(T):
        pm, bp = ops.texpand_op(code, pm, bm_t[t])
        bps.append(bp)
    return pm, torch.stack(bps)


def _texpand_decode(code, bm_t):
    """A terminated decode driven one ``texpand`` launch per step, traced
    back by the plain traceback of core/viterbi.py: (bits, metric)."""
    import torch

    from repro_torch.core.viterbi import _traceback

    pm, bps = _texpand_steps(code, bm_t)
    final_state = torch.zeros((pm.shape[0],), dtype=torch.int32, device=pm.device)
    return _traceback(code, bps, final_state)[0], pm[:, 0]


def phase_texpand(inputs, results):
    """The paper's instruction driven step by step over phase 2's bm tables,
    against one launch of the unpacked scan."""
    import torch

    from repro_torch.kernels import launch_counts, reset_counts, viterbi_scan

    tables = {}
    reset_counts()
    for name in ("hard", "soft"):
        spec = results[name].spec
        bm = spec.branch_metrics(inputs[name][2]).contiguous()
        bm_t = bm.transpose(0, 1).contiguous()  # (T, B, M): one contiguous row a step
        torch.cuda.synchronize()
        before = launch_counts["texpand"]
        pm, bps = _texpand_steps(spec.code, bm_t)
        torch.cuda.synchronize()
        steps = launch_counts["texpand"] - before
        if steps != bm.shape[1]:
            _fail(f"texpand {name}: {steps} launches for T={bm.shape[1]}")
        want_pm, want_bps = viterbi_scan.viterbi_scan(spec.code, bm)
        torch.cuda.synchronize()
        if not (torch.equal(pm, want_pm) and torch.equal(bps, want_bps)):
            _fail(f"texpand {name}: the stepped metrics or selects differ from the scan's")
        print(f"[texpand] {name}: {steps} launches, final metrics and (T, B, S) selects equal "
              "the unpacked scan's exactly")
        del bps, want_bps
        tables[name] = (spec, inputs[name][2], bm, bm_t)
    launches, plain = _counts()
    if any(plain.values()):
        _fail(f"texpand: plain versions ran: {plain}")
    print(f"[texpand] launches {launches}")
    return launches, tables


def _ebn0_channel(rate: float) -> float:
    """Es/N0 (dB) of Eb/N0 = EBN0_DB at code rate ``rate``."""
    return EBN0_DB + 10 * math.log10(rate)


def phase_siso(gen):
    """The SISO family through ``decode()``: bcjr and turbo at full width."""
    import torch

    from repro_torch.core import ConvCode
    from repro_torch.decode import CodecSpec, DecodeContext, DecodeRequest, decode
    from repro_torch.kernels import reset_counts
    from repro_torch.siso import RSC_K4_LTE, QPPInterleaver, TurboSpec

    reset_counts()
    out = {}
    # --- the LTE constituent alone through the bcjr backend, rate 1/2
    spec = CodecSpec(code=RSC_K4_LTE, metric="soft", terminated=True)
    bits = torch.randint(0, 2, (B_MAIN, N_INFO), generator=gen, device="cuda", dtype=torch.int32)
    coded = spec.encode(bits)
    snr = _ebn0_channel(1 / RSC_K4_LTE.n_out)
    rx = spec.channel(gen, coded, snr_db=snr)
    torch.cuda.synchronize()
    before = _counts()[0]
    res = decode(DecodeRequest(spec, received=rx))
    torch.cuda.synchronize()
    after = _counts()[0]
    for k in ("bcjr_alpha_scan", "bcjr_beta_llr_scan"):
        if after.get(k, 0) - before.get(k, 0) != 1:
            _fail(f"bcjr decode: {k} launched {after.get(k, 0) - before.get(k, 0)} times")
    if res.plan.backend != "bcjr" or res.bits.shape != (B_MAIN, spec.n_steps(N_INFO)):
        _fail(f"bcjr decode: backend {res.plan.backend!r}, bits {tuple(res.bits.shape)}")
    if not torch.isfinite(res.path_metric).all():
        _fail("bcjr decode: non-finite metrics")
    clean = decode(DecodeRequest(spec, received=1.0 - 2.0 * coded.float()))
    if not torch.equal(clean.info_bits, bits):
        _fail("noiseless RSC block did not decode to its info bits")
    ber = _ber(res.info_bits, bits)
    print(f"[siso] bcjr {spec.describe()}: B={B_MAIN} T={spec.n_steps(N_INFO)} Es/N0={snr!r} dB "
          f"BER={ber!r} | {res.plan.explain()}")
    uncoded = 0.5 * math.erfc(math.sqrt(10 ** (EBN0_DB / 10)))  # BPSK at the same Eb/N0
    if not ber < uncoded:
        _fail(f"bcjr decode: BER {ber} is not below uncoded BPSK's {uncoded} at this Eb/N0")
    out["bcjr"] = dict(spec=spec, rx=rx, bits=bits, ber=ber, snr_db=snr)

    # --- turbo: the repo's configuration and LTE's largest block
    snr = _ebn0_channel(1 / 3)
    for label, B, qpp in (("turbo", TURBO_B, TURBO_QPP), ("lte6144", LTE_B, LTE_QPP)):
        tspec = TurboSpec(code=RSC_K4_LTE, interleaver=QPPInterleaver(*qpp))
        tbits = torch.randint(0, 2, (B, tspec.block_len), generator=gen, device="cuda",
                              dtype=torch.int32)
        trx = tspec.channel(gen, tspec.encode(tbits), snr_db=snr)
        torch.cuda.synchronize()
        before = _counts()[0]
        t0 = time.perf_counter()
        tres = decode(DecodeRequest(tspec, received=trx))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        after = _counts()[0]
        n_it = tres.diagnostics["iterations"]
        for k in ("bcjr_alpha_scan", "bcjr_beta_llr_scan"):
            if after.get(k, 0) - before.get(k, 0) != 2 * n_it:
                _fail(f"{label}: {k} launched {after.get(k, 0) - before.get(k, 0)} times "
                      f"for {n_it} iterations")
        if tres.plan.backend != "turbo" or tres.bits.shape != (B, tspec.block_len):
            _fail(f"{label}: backend {tres.plan.backend!r}, bits {tuple(tres.bits.shape)}")
        if not torch.isfinite(tres.diagnostics["llr"]).all():
            _fail(f"{label}: non-finite LLRs")
        tber = _ber(tres.bits, tbits)
        print(f"[siso] {label} {tspec.describe()}: B={B} Es/N0={snr!r} dB iterations_run={n_it} "
              f"agreement={list(tres.diagnostics['agreement'])} converged "
              f"{int(tres.diagnostics['converged'].sum())}/{B} BER={tber!r} ({wall!r} s)")
        out[label] = dict(spec=tspec, rx=trx, bits=tbits, ber=tber, iterations=n_it,
                          agreement=list(tres.diagnostics["agreement"]))

    # the repo's gate (tests/test_golden_ber.py): turbo strictly below the
    # rate-1/3 K=7 soft Viterbi baseline on the same info bits, open trellis
    base = CodecSpec(code=ConvCode(7, (0o133, 0o171, 0o165)), metric="soft", terminated=False)
    tbits = out["turbo"]["bits"]
    brx = base.channel(gen, base.encode(tbits), snr_db=snr)
    bres = decode(DecodeRequest(base, received=brx))
    bber = _ber(bres.info_bits, tbits)
    print(f"[siso] baseline {base.describe()} via {bres.plan.backend}: BER={bber!r}; turbo "
          f"N={TURBO_N} BER={out['turbo']['ber']!r} at Eb/N0 {EBN0_DB} dB")
    if not out["turbo"]["ber"] < bber:
        _fail(f"turbo BER {out['turbo']['ber']} is not below the K=7 Viterbi baseline's {bber}")
    launches, plain = _counts()
    if any(plain.values()):
        _fail(f"siso: plain versions ran: {plain}")
    out["baseline_ber"] = bber
    print(f"[siso] launches {launches}")
    # a slice of the bcjr decode against the plain versions on the CPU
    # (after the counters are read: these are not the path's launches)
    on_cpu = decode(DecodeRequest(spec, received=rx[:16].cpu()), ctx=DecodeContext(device="cpu"))
    if not (torch.equal(on_cpu.bits, res.bits[:16].cpu())
            and torch.equal(on_cpu.path_metric, res.path_metric[:16].cpu())):
        _fail("bcjr decode on the card differs from the plain decode on the CPU")
    print("[siso] bcjr decode of 16 blocks on the card equals the plain decode on the CPU")
    return launches, out


def phase_parity_siso(gen):
    """The unpacked scan, texpand and both BCJR scans against their plain
    versions at small shapes."""
    import torch

    from repro_torch.core import CODE_K3_STD, CODE_K7_NASA, ConvCode
    from repro_torch.kernels import bcjr, texpand, viterbi_scan
    from repro_torch.siso import RSC_K3_75, RSC_K4_LTE, RSCCode

    for code, B, T in ((CODE_K3_STD, 37, 100), (CODE_K7_NASA, 300, 70),
                       (ConvCode(11, (0o3345, 0o3613)), 9, 45)):
        S, M, K = code.n_states, code.n_symbols, code.constraint
        for tables in (torch.randint(0, 3, (B, T, M), generator=gen, device="cuda").float(),
                       torch.randn((B, T, M), generator=gen, device="cuda")):
            _same(f"unpacked scan K={K}", viterbi_scan.viterbi_scan(code, tables),
                  viterbi_scan.viterbi_scan_plain(code, tables))
        for pm, bm in ((_seed_metrics(gen, B, S),
                        torch.randint(0, 2, (B, M), generator=gen, device="cuda").float()),
                       (torch.randn((B, S), generator=gen, device="cuda") * 10,
                        torch.randn((B, M), generator=gen, device="cuda"))):
            _same(f"texpand K={K}", texpand.texpand(code, pm, bm),
                  texpand.texpand_plain(code, pm, bm))
        print(f"[parity] K={K} B={B} T={T} unpacked scan (int, soft tables), texpand "
              "(1e30 seeds, ties, soft): exact")
    # every S the BCJR kernels take, one- and two-parity codes, B off the
    # group and block sizes, T = 1 and T off the chunk sizes, soft, tie-heavy
    # and +-1e30 / NaN features; NaN-aware, one launch a call
    for code in (RSCCode(2, 0b11, (0b10,)), RSC_K3_75, RSC_K4_LTE, RSCCode(4, 0o13, (0o15, 0o17)),
                 RSCCode(5, 0o23, (0o35, 0o27)), RSCCode(6, 0o43, (0o75,)),
                 RSCCode(7, 0o133, (0o171,)), RSCCode(7, 0o133, (0o171, 0o165))):
        K, P = code.constraint, code.n_parity
        for B, T, kind in ((333, 90, "soft"), (1, 1, "soft"), (33, 45, "ties"),
                           (1000, 70, "extremes"), (64, 96, "soft")):
            shape = (T, code.n_features, B)
            if kind == "ties":
                feat = torch.randint(-2, 3, shape, generator=gen, device="cuda").float()
            else:
                feat = torch.randn(shape, generator=gen, device="cuda") * 2
            if kind == "extremes":
                pick = torch.rand(shape, generator=gen, device="cuda")
                feat[pick < 0.02] = 1e30
                feat[(pick >= 0.02) & (pick < 0.04)] = -1e30
                feat[:, :, ::7][pick[:, :, ::7] > 0.995] = float("nan")
            before = _counts()[0]
            alphas, final_pm = bcjr.bcjr_alpha_scan(code, feat)
            want = bcjr.bcjr_alpha_scan_plain(code, feat)
            _same_nan(f"alpha scan K={K} parities={P} B={B} T={T} {kind}", alphas, want[0])
            _same_nan(f"alpha scan K={K} parities={P} B={B} T={T} {kind}", final_pm, want[1])
            for terminated in (True, False):
                _same_nan(f"beta/LLR scan K={K} parities={P} B={B} T={T} {kind} "
                          f"terminated={terminated}",
                          bcjr.bcjr_beta_llr_scan(code, alphas, feat, terminated),
                          bcjr.bcjr_beta_llr_scan_plain(code, alphas, feat, terminated))
            after = _counts()[0]
            if [after.get(k, 0) - before.get(k, 0)
                    for k in ("bcjr_alpha_scan", "bcjr_beta_llr_scan")] != [1, 2]:
                _fail(f"BCJR parity K={K}: launches {after} after {before}")
        print(f"[parity] RSC K={K} (S={code.n_states}) parities={P}: alpha scan, beta/LLR scan "
              "(terminated, open) at B=333 T=90, B=1 T=1, B=33 T=45 ties, B=1000 T=70 "
              "+-1e30/NaN, B=64 T=96: exact (NaN where the plain version has NaN)")


def _unique_rows(*weights) -> int:
    """Distinct weight rows among (S, F) tables: the branch costs the
    function needs per step (every other row repeats one of them)."""
    import numpy as np

    return len({tuple(r) for w in weights for r in np.asarray(w)})


def _siso_features(run):
    """(T, F, B) features of the first SISO pass of a ``phase_siso`` run, as
    ops.bcjr_llr_op builds them: the channel LLRs of the systematic and
    first-parity bits (turbo) or of every coded bit (bcjr), then a zero
    a-priori column."""
    import torch

    spec, rx = run["spec"], run["rx"]
    if hasattr(spec, "interleaver"):  # turbo: the first constituent's pass
        llrs = spec.channel_llrs(rx)
        coded = torch.cat([llrs[..., :1], llrs[..., 1:1 + spec.code.n_parity]], dim=-1)
    else:
        coded = spec.branch_metrics(rx).to(torch.float32)
    B, N, _ = coded.shape
    feat = torch.cat([coded, torch.zeros((B, N, 1), device=coded.device)], dim=-1)
    return feat.permute(1, 2, 0).contiguous()


def _timing_bcjr(siso, e2e):
    """Rows 9 and 10 where their paths run them: the first SISO pass of the
    N=512 turbo decode (the rows' own numbers, as in earlier runs), of the
    N=6144 one and of the bcjr decode, each shape with its bound, its time a
    step and its plain version's time (``shapes``); records one SISO pass
    (alpha + beta) per shape in ``e2e``."""
    from repro_torch.kernels import bcjr

    rcode = siso["turbo"]["spec"].code
    F, Sr = rcode.n_features, rcode.n_states
    R = _unique_rows(*rcode.alpha_weights, *rcode.beta_weights, *rcode.llr_weights)
    bcjr_rows = {}
    for label, run, terminated, reps in (("turbo512", "turbo", False, 10),
                                         ("lte6144", "lte6144", False, 2),
                                         ("bcjr", "bcjr", True, 5)):
        feat = _siso_features(siso[run])
        N, _, Bt = feat.shape
        r, pms, k, p = _timed(lambda: bcjr.bcjr_alpha_scan(rcode, feat),
                              lambda: bcjr.bcjr_alpha_scan_plain(rcode, feat), reps)
        a_err = _same(f"alpha scan at the {label} shape", k, p)
        alphas = k[0]
        del k, p
        print(f"[timing] rounds (ms): bcjr_alpha_scan at {label} {r}")
        # per (lane, step): R distinct F-term branch costs, then per state two
        # adds, a min, the renorm min, subtract and clamp
        a_row = _row("bcjr_alpha_scan", BCJR_SRC, "src/repro/kernels/bcjr.py:117",
                     statistics.median(r), pms,
                     4 * (N * F * Bt + N * Sr * Bt + Sr * Bt + 2 * Sr * F),
                     Bt * N * (R * 2 * F + 6 * Sr))
        a_row.update(max_abs_err=a_err, shape=f"{Bt} blocks x {N} steps, S={Sr}", rounds=r)
        r, pms, k, p = _timed(lambda: bcjr.bcjr_beta_llr_scan(rcode, alphas, feat, terminated),
                              lambda: bcjr.bcjr_beta_llr_scan_plain(rcode, alphas, feat,
                                                                    terminated), reps)
        b_err = _same(f"beta/LLR scan at the {label} shape", (k,), (p,))
        del k, p, alphas, feat
        print(f"[timing] rounds (ms): bcjr_beta_llr_scan at {label} {r}")
        # per (lane, step): R branch costs; the LLR's two costs, two mins per
        # state and one subtract; the beta retire's two adds, min and renorm
        b_row = _row("bcjr_beta_llr_scan", BCJR_SRC, "src/repro/kernels/bcjr.py:165",
                     statistics.median(r), pms,
                     4 * (N * Sr * Bt + N * F * Bt + N * Bt + 4 * Sr * F + 2 * Sr),
                     Bt * N * (R * 2 * F + 12 * Sr + 1))
        b_row.update(max_abs_err=b_err, shape=f"{Bt} blocks x {N} steps, S={Sr}", rounds=r)
        for row in (a_row, b_row):
            us = row["ms"] * 1e3 / N
            print(f"[timing] {row['name']} at {label} (B={Bt}, T={N}): {row['ms']!r} ms = "
                  f"{us!r} us a step, bound {row['bound_ms']!r} ms ({row['bound_by']}), "
                  f"{row['ms'] / row['bound_ms']!r}x the bound")
            first = bcjr_rows.setdefault(row["name"], dict(row, shapes={}))
            first["shapes"][label] = {k: row[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                                          "max_abs_err", "rounds", "bytes",
                                                          "operations")}
            first["shapes"][label].update(B=Bt, T=N, us_per_step=us)
            first["max_abs_err"] = max(first["max_abs_err"], row["max_abs_err"])
    pass_ms = {label: sum(bcjr_rows[n]["shapes"][label]["ms"] for n in bcjr_rows)
               for label in ("turbo512", "lte6144", "bcjr")}
    print(f"[timing] one SISO pass (alpha + beta/LLR): {pass_ms}")
    e2e["siso_pass_ms"] = pass_ms
    return list(bcjr_rows.values())


def phase_timing_siso(texpand_tables, siso):
    """The unpacked scan, texpand and both BCJR scans at the shapes their
    paths give them, each against its plain version; end-to-end times of the
    fused, texpand-driven, bcjr and turbo decodes."""
    import torch

    from repro_torch.decode import DecodeRequest, decode
    from repro_torch.kernels import bcjr, texpand, viterbi_scan

    rows = []
    e2e = {}
    spec, rx, bm, bm_t = texpand_tables["hard"]
    code = spec.code
    B, T, M = bm.shape
    S = code.n_states
    # --- row 6: one unpacked scan over the K=7 B=8192 T=1006 hard tables
    r, pms, k, p = _timed(lambda: viterbi_scan.viterbi_scan(code, bm),
                          lambda: viterbi_scan.viterbi_scan_plain(code, bm), 5)
    err = _same("unpacked scan at the fused shape", k, p)
    del k, p
    print(f"[timing] rounds (ms): viterbi_scan {r}")
    row = _row("viterbi_scan", SCAN_SRC, "src/repro/kernels/viterbi_scan.py:190",
               statistics.median(r), pms, 4 * (B * T * M + T * B * S + B * S + 2 * S * M + 2 * S),
               B * T * (M * 2 * M + 7 * S))
    row.update(max_abs_err=err, shape=f"{B} streams x {T} steps, K=7")
    _device_only(row, lambda: viterbi_scan.viterbi_scan(code, bm), 4)
    rows.append(row)
    scan_ms = row["ms"]
    # --- row 8: one texpand step at the same shape, and all T of them
    pm_mid, _ = _texpand_steps(code, bm_t[:40])  # a frontier with every state reachable
    r, pms, k, p = _timed(lambda: texpand.texpand(code, pm_mid, bm_t[40]),
                          lambda: texpand.texpand_plain(code, pm_mid, bm_t[40]), 200)
    err = _same("texpand at the fused shape", k, p)
    print(f"[timing] rounds (ms): texpand (one step) {r}")
    row = _row("texpand", TEXPAND_SRC, "src/repro/kernels/texpand.py:46", statistics.median(r),
               pms, 4 * (3 * B * S + B * M + 2 * S), 4 * B * S)
    row.update(max_abs_err=err, shape=f"{B} streams x 1 step, K=7")
    _device_only(row, lambda: texpand.texpand(code, pm_mid, bm_t[40]), 200)
    rows.append(row)
    loop_rounds = _event_ms(lambda: _texpand_steps(code, bm_t), 1, rounds=5, warmup=1)
    loop_ms = statistics.median(loop_rounds)
    print(f"[timing] texpand over all {T} steps (one launch a step): rounds {loop_rounds} median "
          f"{loop_ms!r} ms = {loop_ms / T!r} ms a step, against one viterbi_scan launch "
          f"{scan_ms!r} ms ({loop_ms / scan_ms!r}x)")
    e2e["texpand_steps_ms"] = loop_ms
    e2e["texpand_per_step_ms"] = loop_ms / T
    e2e["viterbi_scan_ms"] = scan_ms

    # --- end to end: the fused decode (raw symbols in, as phase 5) and the
    # texpand-driven decode (bm tables in)
    request = DecodeRequest(spec, received=rx)
    for label, fn in (("fused decode()", lambda: decode(request, backend="fused")),
                      ("texpand-driven decode", lambda: _texpand_decode(code, bm_t))):
        rounds = _event_ms(fn, 1, rounds=5, warmup=1)
        ms = statistics.median(rounds)
        peak = _peak_bytes(fn)
        key = "fused" if label.startswith("fused") else "texpand_decode"
        e2e[key] = dict(ms=ms, rounds=rounds, bits_per_s=B * N_INFO / (ms / 1e3),
                        peak_bytes=peak)
        print(f"[timing] {label} K=7 hard B={B} T={T}: rounds {rounds} median {ms!r} ms, "
              f"{B * N_INFO / (ms / 1e3)!r} decoded bits/s, peak device memory {peak} bytes "
              "above the live tensors")

    rows += _timing_bcjr(siso, e2e)

    # --- end to end: the bcjr decode and both turbo decodes
    for label in ("bcjr", "turbo", "lte6144"):
        cspec, crx = siso[label]["spec"], siso[label]["rx"]
        request = DecodeRequest(cspec, received=crx)
        rounds = _event_ms(lambda rq=request: decode(rq), 1, rounds=5, warmup=1)
        ms = statistics.median(rounds)
        n_bits = crx.shape[0] * (cspec.block_len if label != "bcjr" else N_INFO)
        peak = _peak_bytes(lambda rq=request: decode(rq))
        e2e[label] = dict(ms=ms, rounds=rounds, bits_per_s=n_bits / (ms / 1e3), peak_bytes=peak)
        print(f"[timing] {label} decode() B={crx.shape[0]} T={crx.shape[1]}: rounds {rounds} "
              f"median {ms!r} ms, {n_bits / (ms / 1e3)!r} decoded bits/s, peak device memory "
              f"{peak} bytes above the live tensors")
    return rows, e2e


# --------------------------------------------------------------------------- #
# the block-parallel route and the (min,+) product                            #
# --------------------------------------------------------------------------- #

PARALLEL_CHUNK = 64
#: examples/long_context.py: CODE_K3_STD, one stream of 65536 info bits,
#: BSC p=0.01, chunk 512
LONG_INFO, LONG_FLIP, LONG_CHUNK = 65536, 0.01, 512
MINPLUS_SRC = "src/repro_torch/csrc/minplus.cu"
PARALLEL_KERNELS = ("viterbi_scan_packed_window", "minplus_matmul", "viterbi_scan_carry",
                    "traceback_packed")


def phase_parallel(gen, tiled):
    """The block-parallel decode through ``decode(..., backend="parallel")``
    on the NASA frame and on the long-stream example."""
    import torch

    from repro_torch.core import CODE_K3_STD
    from repro_torch.decode import CodecSpec, DecodeContext, DecodeRequest, decode
    from repro_torch.kernels import reset_counts

    spec_b = CodecSpec(code=CODE_K3_STD, metric="hard")
    bits_b = torch.randint(0, 2, (1, LONG_INFO), generator=gen, device="cuda", dtype=torch.int32)
    rx_b = spec_b.channel(gen, spec_b.encode(bits_b), flip_prob=LONG_FLIP)
    torch.cuda.synchronize()

    reset_counts()
    results = {name: decode(DecodeRequest(tiled[name]["spec"], received=tiled[name]["rx"]),
                            backend="parallel", ctx=DecodeContext(chunk=PARALLEL_CHUNK))
               for name in ("hard", "soft")}
    results["long"] = decode(DecodeRequest(spec_b, received=rx_b), backend="parallel",
                             ctx=DecodeContext(chunk=LONG_CHUNK))
    torch.cuda.synchronize()
    launches, plain = _counts()
    print(f"[parallel] launches {launches} plain calls {plain}")
    if any(launches.get(k, 0) < 1 for k in PARALLEL_KERNELS) or any(plain.values()):
        _fail(f"parallel: launches {launches}, plain calls {plain}")

    out = {}
    for name in ("hard", "soft"):
        res, ref = results[name], tiled[name]["planned"]
        spec = tiled[name]["spec"]
        T = spec.n_steps(NASA_INFO)
        if res.plan.backend != "parallel" or res.diagnostics != {"backend": "parallel",
                                                                   "chunk": PARALLEL_CHUNK}:
            _fail(f"parallel {name}: backend {res.plan.backend!r} {res.diagnostics}")
        if res.bits.shape != (NASA_B, T) or not torch.isfinite(res.path_metric).all():
            _fail(f"parallel {name}: bad output shape or non-finite metrics")
        if not torch.equal(res.bits, ref.bits):
            _fail(f"parallel {name}: {int((res.bits != ref.bits).sum())} bits differ from the "
                  "planned decode")
        d_metric = float((res.path_metric - ref.path_metric).abs().max())
        if name == "hard" and d_metric:
            _fail(f"parallel hard: metric differs from the planned decode by {d_metric}")
        # soft: bm tables vs in-kernel metrics round the sums differently;
        # the reference's grid tolerance
        if not torch.allclose(res.path_metric, ref.path_metric, rtol=1e-5, atol=0):
            _fail(f"parallel {name}: metric beyond float32 rounding of the planned decode's")
        ber = _ber(res.info_bits, tiled[name]["bits"])
        out[name] = dict(ber=ber, planned_ber=tiled[name]["ber"][0])
        print(f"[parallel] NASA frame {name}: B={NASA_B} T={T} chunk={PARALLEL_CHUNK} "
              f"(nc={-(-T // PARALLEL_CHUNK)}) bits equal the planned "
              f"({ref.plan.backend}) decode's, max |metric diff| {d_metric!r}, BER={ber!r} "
              f"(planned {out[name]['planned_ber']!r})")

    res = results["long"]
    reset_counts()
    planned = decode(DecodeRequest(spec_b, received=rx_b))
    torch.cuda.synchronize()
    long_launches, long_plain = _counts()
    P = planned.plan.ctx.tiles
    if (planned.plan.backend != "tiled" or P < 2
            or long_launches.get("traceback_packed_window", 0) != 1 or any(long_plain.values())):
        _fail(f"long stream planned: {planned.plan.backend} P={P}, launches {long_launches}, "
              f"plain calls {long_plain}")
    print(f"[parallel] long stream planned: tiled P={P} launches {long_launches}")
    T = spec_b.n_steps(LONG_INFO)
    if res.bits.shape != (1, T) or not (torch.equal(res.bits, planned.bits)
                                        and torch.equal(res.path_metric, planned.path_metric)):
        _fail("parallel long stream: bits or metric differ from the planned decode")
    ber = _ber(res.info_bits, bits_b)
    planned_ber = _ber(planned.info_bits, bits_b)
    if ber > 0.01:
        _fail(f"parallel long stream: BER {ber} far above what K=3 at p=0.01 gives")
    out["long"] = dict(ber=ber, planned_ber=planned_ber)
    out["long_planned"] = dict(tiles=P, launches=long_launches, bits=planned.bits,
                               metric=planned.path_metric)
    print(f"[parallel] long stream K=3 B=1 T={T} chunk={LONG_CHUNK} (nc={-(-T // LONG_CHUNK)}): "
          f"bits and metric equal the planned ({planned.plan.backend}, P="
          f"{planned.plan.ctx.tiles}) decode's, BER={ber!r} (planned {planned_ber!r})")
    return launches, dict(out, spec_b=spec_b, rx_b=rx_b)


def phase_timing_walk_long(parallel):
    """Row 5 at the long stream's planned shape: the walk of the planned
    ``tiled`` decode (P tiles x S exit states = 512 lanes over its words), on
    the operands the tiled op hands the kernel, against its plain version."""
    import torch

    from repro_torch.kernels import fused_metric_plan, ops, survivors

    spec_b, planned = parallel["spec_b"], parallel["long_planned"]
    cap = {}
    bits, metric = ops.viterbi_decode_tiled_fused(
        fused_metric_plan(spec_b.code, spec_b.metric), parallel["rx_b"], planned["tiles"],
        terminated=spec_b.terminated, capture=cap)
    if not (torch.equal(bits, planned["bits"]) and torch.equal(metric, planned["metric"])):
        _fail("the captured long-stream tiled op differs from the planned decode() it times")
    tb = cap["traceback"]
    code, packed = tb[0], tb[1]
    W, lanes, S = packed.shape
    r, pms, k, p = _timed(lambda: survivors.traceback_packed_window(*tb),
                          lambda: survivors.traceback_packed_window_plain(*tb), 20)
    err = _same("windowed traceback, long stream planned", k, p)
    print(f"[timing] rounds (ms): traceback_packed_window long stream ({lanes} lanes x "
          f"{32 * W} steps) {r}")
    valid = int((tb[4] - tb[3]).clamp(min=0).sum())
    row = _row("traceback_packed_window (long stream planned)", TB_SRC, "",
               statistics.median(r), pms,
               4 * (_window_touched_words(code, *tb[1:]) + lanes * 32 * W + 4 * lanes),
               6 * valid)
    row.update(max_abs_err=err, launches=planned["launches"].get("traceback_packed_window", 0),
               shape=f"{lanes} lanes x {32 * W} steps")
    _device_only(row, lambda: survivors.traceback_packed_window(*tb), 20)
    return row


def _same_nan(label, got, want) -> float:
    """Fail unless ``got`` equals ``want`` with NaN exactly where it has
    NaN; returns the largest absolute difference elsewhere (0.0)."""
    import torch

    torch.cuda.synchronize()
    nan = torch.isnan(want)
    if (got.shape != want.shape or not torch.equal(torch.isnan(got), nan)
            or not torch.equal(got[~nan], want[~nan])):
        _fail(f"{label}: kernel and plain version differ")
    if not got[~nan].numel():
        return 0.0
    return float((got[~nan].double() - want[~nan].double()).abs().max())


#: the square (min,+) kernel's S (csrc/minplus.cu: I = K = J = S)
SQUARE_STATES = (2, 4, 8, 16, 32, 64, 128)


def phase_parity_minplus(gen):
    """The (min,+) product against its plain version at both inits, with
    unreachable (1e30, 2e30) and NaN entries, K = 1, strided batch views and
    an empty batch; the square kernel at every S it takes.  Every call one
    launch and no plain call."""
    import torch

    from repro_torch.kernels import launch_counts, minplus

    big = 1e30
    for N, I, K, J in ((1, 4, 4, 4), (2, 8, 16, 8), (3, 130, 64, 70), (2, 5, 1, 3),
                       (5, 64, 64, 64)):
        a = torch.randn((N, I, K), generator=gen, device="cuda") * 5
        b = torch.randn((N, K, J), generator=gen, device="cuda") * 5
        for x in (a, b):
            x[torch.rand(x.shape, generator=gen, device="cuda") < 0.2] = big
            x[torch.rand(x.shape, generator=gen, device="cuda") < 0.1] = 2 * big
        a[-1, 0, 0] = float("nan")
        b[0, -1, -1] = float("nan")
        for init in (big, math.inf):
            _same_nan(f"minplus {N}x{I}x{K}x{J} init={init}", minplus.minplus_matmul(a, b, init),
                      minplus.minplus_matmul_plain(a, b, init))
            # the associative scan's strided slices of a (B, nc, S, S) stack
            a4 = a.reshape(1, N, I, K)
            b4 = b.reshape(1, N, K, J)
            _same_nan(f"minplus strided {N}x{I}x{K}x{J} init={init}",
                      minplus.minplus_matmul(a4[:, 0:-1:2], b4[:, 1::2], init),
                      minplus.minplus_matmul_plain(a4[:, 0:-1:2].contiguous(),
                                                   b4[:, 1::2].contiguous(), init))
        print(f"[parity] minplus N={N} I={I} K={K} J={J} (1e30, 2e30, NaN; init 1e30 and inf; "
              f"strided batch; {minplus.kernel_variant(a, b)}): exact")
    # the square kernel at every S it takes: N off the products a block takes
    # at once; contiguous, the associative scan's strided slices and a
    # stride-0 batch (square), operands one element off 16 bytes (general)
    for S in SQUARE_STATES:
        per_block = 256 // (min(S, 64) // min(S, 4)) ** 2
        N = 2 * per_block + 3
        a = torch.randn((2 * N + 1, S, S), generator=gen, device="cuda") * 5
        b = torch.randn((2 * N + 1, S, S), generator=gen, device="cuda") * 5
        for x in (a, b):
            pick = torch.rand(x.shape, generator=gen, device="cuda")
            for i, v in enumerate((big, 2 * big, math.inf, -math.inf, float("nan"))):
                x[(pick >= 0.05 * i) & (pick < 0.05 * (i + 1))] = v
        flat = torch.empty((N * S * S + 1,), device="cuda")
        flat[1:] = a[:N].reshape(-1)
        a4, b4 = a.reshape(1, 2 * N + 1, S, S), b.reshape(1, 2 * N + 1, S, S)
        cases = (("contiguous", a[:N], b[:N], f"square S={S}"),
                 ("strided", a4[:, 0:-1:2], b4[:, 1::2], f"square S={S}"),
                 ("stride 0", a[:1].expand(N, S, S), b[N:2 * N], f"square S={S}"),
                 ("misaligned", flat[1:].view(N, S, S), b[:N], "general"))
        for label, x, y, want in cases:
            if minplus.kernel_variant(x, y) != want:
                _fail(f"minplus S={S} {label}: {minplus.kernel_variant(x, y)}, not {want}")
            for init in (big, math.inf):
                got = _one_launch(f"minplus S={S} {label} init={init}", "minplus_matmul",
                                  lambda: minplus.minplus_matmul(x, y, init))
                _same_nan(f"minplus S={S} {label} init={init}", got,
                          minplus.minplus_matmul_plain(x.contiguous(), y.contiguous(), init))
        print(f"[parity] minplus square S={S} N={N} (1e30, 2e30, +-inf, NaN; init 1e30 and inf): "
              + ", ".join(f"{label} ({want})" for label, _, _, want in cases) + ": exact")
    before = launch_counts["minplus_matmul"]
    empty = minplus.minplus_matmul(torch.zeros((0, 4, 4), device="cuda"),
                                   torch.zeros((0, 4, 4), device="cuda"), math.inf)
    if empty.shape != (0, 4, 4) or launch_counts["minplus_matmul"] != before:
        _fail("minplus: an empty batch must return an empty product without a launch")
    print("[parity] minplus N=0: empty product, no launch")


def _replayer(calls):
    """A combine that hands back, in order, the results ``calls`` recorded
    (so an associative scan runs its slices, cats and interleaves alone)."""
    outs = iter([out for _, out, _ in calls])
    return lambda a, b: next(outs)


def _sm_instructions_per_s() -> tuple:
    """(fp32 instructions a second the card can issue: 128 a clock on each
    SM at the SM clock's maximum, that clock in MHz, the SMs)."""
    import torch

    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return 128 * sms * mhz * 1e6, mhz, sms


def phase_timing_parallel(tiled, parallel):
    """Row 11 at each of the seven combine launches of the NASA-frame
    parallel decode (the widest is the row's own numbers), row 7 at both
    re-scan shapes (returned as its ``shapes``), and the parallel decode's
    end-to-end times and steps.  Also returns the walk's operands and its
    launches in the captured decode."""
    import torch

    from repro_torch.decode import DecodeContext, DecodeRequest, decode
    from repro_torch.kernels import launch_counts, minplus, ops, plain_counts, reset_counts

    hard = tiled["hard"]
    spec = hard["spec"]
    bm = spec.branch_metrics(hard["rx"])
    cap = {}
    torch.cuda.synchronize()
    reset_counts()
    with _recording(ops, "_minplus_unclamped") as combines:
        bits, metric = ops.viterbi_decode_parallel_op(spec.code, bm, PARALLEL_CHUNK, True,
                                                      capture=cap)
    torch.cuda.synchronize()
    decode_launches, decode_plain = dict(launch_counts), dict(plain_counts)
    del bits, metric
    # each combine's own launches: together, every (min,+) launch of the
    # decode, and no plain version anywhere in it
    per_combine = [counts[0]["minplus_matmul"] for _, _, counts in combines]
    if any(decode_plain.values()) or any(counts[1] for _, _, counts in combines):
        _fail(f"the captured parallel decode ran plain versions: {decode_plain}")
    if sum(per_combine) != decode_launches.get("minplus_matmul", 0):
        _fail(f"the combines' minplus_matmul launches {per_combine} do not sum to the "
              f"decode's {decode_launches.get('minplus_matmul', 0)}")
    walk_launches = decode_launches.get("traceback_packed", 0)
    mats = cap["mats"]  # (B, nc, S, S)
    # the combines that launch (an empty one returns without a launch), in
    # the order of the associative scan, each with its launches in the
    # decode; the widest is chunk 2m with 2m+1
    launched = [(args, n) for (args, _, _), n in zip(combines, per_combine)
                if args[0].shape[0] * args[0].shape[1]]
    if any(n < 1 for _, n in launched):
        _fail(f"a non-empty combine launched no minplus_matmul: {per_combine}")
    ins_per_s, mhz, sms = _sm_instructions_per_s()
    print(f"[timing] minplus_matmul bound: bytes over {HBM_BYTES_PER_S!r} B/s, two fp32 "
          f"instructions a candidate over 128 x {sms} SMs x {mhz!r} MHz = {ins_per_s!r}/s")
    shapes = {}
    for i, ((a, b), n_launch) in enumerate(launched):
        Bm, n1, I, K = a.shape
        J = b.shape[-1]
        N = Bm * n1
        r, pms, k, p = _timed(lambda: minplus.minplus_matmul(a, b, math.inf),
                              lambda: minplus.minplus_matmul_plain(a, b, math.inf), 20)
        err = _same_nan(f"minplus at combine {i}", k, p)
        del k, p
        variant = minplus.kernel_variant(a, b)
        print(f"[timing] rounds (ms): minplus_matmul combine {i} ({N} products, {variant}) {r}")
        # bytes: each operand matrix read once, each product written once;
        # operations: one add and one min per (n, i, j, k), each an issued
        # fp32 instruction
        srow = _row(f"minplus_matmul (combine {i})", MINPLUS_SRC, "", statistics.median(r), pms,
                    4 * N * (I * K + K * J + I * J), 2 * N * I * J * K, ops_per_s=ins_per_s)
        srow.update(max_abs_err=err, launches=n_launch, variant=variant,
                    shape=f"{N} products of {I}x{K} by {K}x{J}")
        _device_only(srow, lambda: minplus.minplus_matmul(a, b, math.inf), 20)
        shapes[f"combine_{i}"] = srow
    total = {k: sum(s[k] for s in shapes.values())
             for k in ("ms", "device_ms", "plain_ms", "bound_ms", "bytes", "operations")}
    total.update(launches=decode_launches.get("minplus_matmul", 0),
                 max_abs_err=max(s["max_abs_err"] for s in shapes.values()),
                 shape=f"the {len(shapes)} combines of one decode")
    print(f"[timing] minplus_matmul, the {len(shapes)} combines of one NASA parallel decode: "
          f"back to back {total['ms']!r} ms, device-only {total['device_ms']!r} ms, bound "
          f"{total['bound_ms']!r} ms")
    row = dict(shapes["combine_0"], name="minplus_matmul",
               replaces="src/repro/kernels/minplus.py:59", clock_mhz=mhz, sms=sms)
    row["shapes"] = dict(shapes, nasa_decode=total)
    # the decode's steps one by one, on the operands it gave each of them
    from repro_torch.core.viterbi import _associative_scan
    from repro_torch.kernels import survivors, viterbi_scan

    steps = {
        "transfer matrices (viterbi_scan_packed_window)":
            lambda: viterbi_scan.viterbi_scan_packed_window(*cap["pass1"]),
        "associative scan (minplus_matmul)":
            lambda: _associative_scan(ops._minplus_unclamped, mats, axis=1),
        "associative scan: its minplus_matmul launches":
            lambda: [minplus.minplus_matmul(a, b, math.inf) for (a, b), _ in launched],
        "associative scan: its torch slices, cat and interleave":
            lambda: _associative_scan(_replayer(combines), mats, axis=1),
        "re-scan (viterbi_scan_carry)": lambda: viterbi_scan.viterbi_scan_carry(*cap["rescan"]),
        "pack selects (torch)": lambda: survivors.pack_survivors(cap["bps"]),
        "walk (traceback_packed)": lambda: survivors.traceback_packed(*cap["walk"]),
    }
    breakdown = {label: statistics.median(_event_ms(fn, 1, rounds=3, warmup=1))
                 for label, fn in steps.items()}
    print(f"[timing] parallel decode NASA frame hard, steps (ms, median of 3): {breakdown}")
    # row 4 at the transfer matrices' shape: back to back and device-only,
    # against its plain version; bound with the tiled passes' rule
    pass1 = cap["pass1"]
    wcode, _, wdata, *_, wlo, whi = pass1
    lanes, Tw, Fw = wdata.shape
    Sw, Mw = wcode.n_states, wcode.n_symbols
    r, pms, k, p = _timed(lambda: viterbi_scan.viterbi_scan_packed_window(*pass1),
                          lambda: viterbi_scan.viterbi_scan_packed_window_plain(*pass1), 3)
    err = _same("windowed scan at the parallel shape", k, p)
    del k, p
    print(f"[timing] rounds (ms): viterbi_scan_packed_window parallel ({lanes} lanes x {Tw} "
          f"steps) {r}")
    Ww = -(-Tw // 32)
    valid = int((whi - wlo).clamp(min=0).sum())
    wrow = _row("viterbi_scan_packed_window (parallel)", SCAN_SRC, "", statistics.median(r), pms,
                4 * (lanes * Tw * Fw + 2 * lanes * Sw + 2 * lanes + Ww * lanes * Sw + 2 * Sw * Fw
                     + 2 * Sw), valid * (Mw * 2 * Fw + 7 * Sw))
    wrow.update(rounds=r, max_abs_err=err, B=lanes, T=Tw, S=Sw)
    _device_only(wrow, lambda: viterbi_scan.viterbi_scan_packed_window(*pass1), 3)
    del pass1
    # row 7 at both re-scan shapes, on the operands each decode gave it:
    # back-to-back and device-only, against its plain version
    spec_b = parallel["spec_b"]
    cap_long = {}
    ops.viterbi_decode_parallel_op(spec_b.code, spec_b.branch_metrics(parallel["rx_b"]),
                                   LONG_CHUNK, True, capture=cap_long)
    rescan = {}
    for label, args in (("rescan_nasa", cap["rescan"]), ("rescan_long", cap_long["rescan"])):
        rcode, _, chunks = args
        Br, C, Mr = chunks.shape
        Sr = rcode.n_states
        r, pms, k, p = _timed(lambda a=args: viterbi_scan.viterbi_scan_carry(*a),
                              lambda a=args: viterbi_scan.viterbi_scan_carry_plain(*a), 10)
        err = _same(f"unpacked carry at the {label} shape", k, p)
        del k, p
        row7 = _row(f"viterbi_scan_carry ({label})", SCAN_SRC, "", statistics.median(r), pms,
                    4 * (Br * C * Mr + 2 * Br * Sr + C * Br * Sr + 2 * Sr * Mr + 2 * Sr),
                    Br * C * (Mr * 2 * Mr + 7 * Sr))
        row7.update(rounds=r, max_abs_err=err, B=Br, T=C, S=Sr)
        _device_only(row7, lambda a=args: viterbi_scan.viterbi_scan_carry(*a), 10)
        rescan[label] = {k: row7[k] for k in ("ms", "rounds", "device_ms", "device_rounds",
                                              "plain_ms", "bound_ms", "bound_by", "max_abs_err",
                                              "bytes", "operations", "B", "T", "S")}
    walk = cap["walk"], walk_launches
    del cap, cap_long, mats, steps, combines, launched

    e2e = {"nasa_hard_steps_ms": breakdown}
    for label, rq, chunk, n_bits in (
            ("nasa_hard", DecodeRequest(spec, received=hard["rx"]), PARALLEL_CHUNK,
             NASA_B * NASA_INFO),
            ("nasa_soft", DecodeRequest(tiled["soft"]["spec"], received=tiled["soft"]["rx"]),
             PARALLEL_CHUNK, NASA_B * NASA_INFO),
            ("long_stream", DecodeRequest(parallel["spec_b"], received=parallel["rx_b"]),
             LONG_CHUNK, LONG_INFO)):
        ctx = DecodeContext(chunk=chunk)
        rounds = _event_ms(lambda rq=rq, c=ctx: decode(rq, backend="parallel", ctx=c), 1,
                           rounds=5, warmup=1)
        ms = statistics.median(rounds)
        peak = _peak_bytes(lambda rq=rq, c=ctx: decode(rq, backend="parallel", ctx=c))
        e2e[label] = dict(ms=ms, rounds=rounds, bits_per_s=n_bits / (ms / 1e3), peak_bytes=peak)
        print(f"[timing] parallel decode() {label} chunk={chunk}: rounds {rounds} median "
              f"{ms!r} ms, {n_bits / (ms / 1e3)!r} decoded bits/s, peak device memory {peak} "
              "bytes above the live tensors")
    return [row], e2e, rescan, wrow, walk


def _walk_shape(label, args, launches, reps):
    """Row 2 at one path shape, on the operands its decode handed the
    wrapper: back to back and device-only, against its plain version, with
    its bound (the touched words, the start states and the bits)."""
    from repro_torch.kernels import survivors

    code, packed, fs, T = args
    W, B, S = packed.shape
    if launches < 1:
        _fail(f"traceback_packed was not launched by the {label} decode")
    r, pms, k, p = _timed(lambda: survivors.traceback_packed(*args),
                          lambda: survivors.traceback_packed_plain(*args), reps)
    err = _same(f"traceback_packed, {label}", (k,), (p,))
    print(f"[timing] rounds (ms): traceback_packed {label} ({B} lanes x {T} steps) {r}")
    row = _row(f"traceback_packed ({label})", TB_SRC, "", statistics.median(r), pms,
               4 * (_touched_words(code, k) + B + B * T), 6 * B * T)
    row.update(max_abs_err=err, launches=launches, shape=f"{B} lanes x {T} steps")
    _device_only(row, lambda: survivors.traceback_packed(*args), reps)
    return row


def phase_timing_walks(tiled, stream, parallel_walk):
    """Row 2 at its path shapes besides the short blocks': the walk of the
    planned NASA decode, of the ``parallel`` NASA decode (``parallel_walk``:
    its operands and its launches in that decode) and of a packed session's
    push (its 128 x 128 ring, from a session of 128 streams over the 64k
    stream's first 2048 steps), each captured from the decode."""
    import torch

    from repro_torch.decode import DecodeRequest, decode
    from repro_torch.kernels import launch_counts, plain_counts, reset_counts, survivors
    from repro_torch.stream import StreamSession

    hard = tiled["hard"]
    torch.cuda.synchronize()
    reset_counts()
    with _recording(survivors, "traceback_packed") as calls:
        decode(DecodeRequest(hard["spec"], received=hard["rx"]))
    torch.cuda.synchronize()
    planned_launches = launch_counts["traceback_packed"]
    if len(calls) != 1 or any(plain_counts.values()):
        _fail(f"the planned NASA decode walked {len(calls)} times, not once, or ran plain "
              f"versions {dict(plain_counts)}")
    with _recording(survivors, "traceback_packed") as pushes:
        StreamSession(stream["spec"], batch=STREAM_B, chunk=STREAM_CHUNK, backend="fused_packed",
                      inputs="received").decode_all(stream["rx"][:, :2048])
    ring = [args for args, _, _ in pushes if args[1].shape[0] == 4]
    if not ring:
        _fail("no session push walked a 4-word ring")
    walk_args, walk_launches = parallel_walk
    return {"nasa_planned": _walk_shape("NASA planned", calls[0][0], planned_launches, 20),
            "parallel_nasa": _walk_shape("parallel NASA", walk_args, walk_launches, 20),
            "session": _walk_shape("session push", ring[-1],
                                   stream["launches_session"].get("traceback_packed", 0), 50)}


#: what a kernel row keeps of each of its further shapes
def phase_analysis(smi):
    """Phase 11: the repo rules over the port's tree, then every registered
    backend's hot path under its contract and the sanitizer (after every
    other phase: the catalog zeroes the launch counters per entry)."""
    from repro_torch.analysis import check_hot_paths, lint_paths, problems

    violations, n_files = lint_paths([Path(__file__).resolve().parent / "src" / "repro_torch"])
    if violations:
        _fail("repo rules: " + "; ".join(map(str, violations)))
    print(f"[analysis] repo rules RPR001-RPR005: {n_files} files of src/repro_torch clean")
    report = check_hot_paths(device="cuda")
    table = {}
    for name, e in report.items():
        found = problems(e)
        if e["host_syncs"] > e["max_host_syncs"]:
            found.append(f"{e['host_syncs']} host syncs over the bound {e['max_host_syncs']}")
        print(f"[analysis] {name} ({e['backend']}): {e['ops']} dispatched ops, host syncs "
              f"{e['host_syncs']} / bound {e['max_host_syncs']} at {e['sync_sites']}, uploads "
              f"{e['uploads']}, rebuilds {e['rebuilds']}, launches {e['launches']}, plain "
              f"calls {e['plain']}, contract violations {len(e['violations'])} ({smi})")
        if found:
            _fail(f"analysis {name}: " + "; ".join(found))
        table[name] = {k: e[k] for k in ("backend", "ops", "host_syncs", "max_host_syncs",
                                         "sync_sites", "uploads", "rebuilds", "launches")}
    return table


#: the paper's comparison: its own 4-state encoder (Fig. 1(b)) and K=7 NASA
PAPER_CODES = (("k3_paper", 3, (0b110, 0b010)), ("k7_nasa", 7, (0o171, 0o133)))
#: steps driven one call a step for the equality check (the unfused K=7
#: step is ~10^3 torch ops)
PAPER_CHECK_T = 64
#: calls captured in one CUDA graph per variant: (unfused, acs_step, texpand)
PAPER_GRAPH_N = {"k3_paper": (50, 500, 500), "k7_nasa": (4, 200, 500)}


def _stepped(step, code, bm_t):
    """Drive ``step(code, pm, bm)`` over (T, B, M) tables from the state-0
    start: (final pm (B, S), selects (T, B, S))."""
    import torch

    T, B, _ = bm_t.shape
    pm = torch.full((B, code.n_states), 1e30, dtype=torch.float32, device=bm_t.device)
    pm[:, 0] = 0.0
    sel = []
    for t in range(T):
        pm, bp = step(code, pm, bm_t[t])
        sel.append(bp)
    return pm, torch.stack(sel)


def _ops_per_call(fn) -> int:
    """Ops one call of ``fn`` dispatches (the analogue of the paper's
    instruction count for a step of torch ops)."""
    from repro_torch.analysis.op_lint import OpRecorder

    with OpRecorder() as rec:
        fn()
    return len(rec.ops)


def _paper_model():
    """``tools/paper_model.py`` of this checkout, as a module."""
    import importlib.util

    path = Path(__file__).resolve().parent / "tools" / "paper_model.py"
    spec = importlib.util.spec_from_file_location("paper_model_tool", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


def phase_paper(smi):
    """Phase 12: the paper's cycle model (Tables III-V), then ACS without and
    with the custom instruction on the card."""
    import torch

    from repro_torch.core import ConvCode, acs_step, acs_step_unfused, paper_expansion_calls
    from repro_torch.kernels import launch_counts, ops, reset_counts, viterbi_scan

    calls = paper_expansion_calls(12)
    if calls != 19:
        _fail(f"paper_expansion_calls(12) = {calls}, the paper counts 19")
    print(f"[paper] paper_expansion_calls(12) = {calls} (the paper's count, 4-state K=3)")
    tables = _paper_model().run()
    print(f"[paper] the paper's cycle model (tools/paper_model.py): Table III {tables['table3']}; "
          f"Table IV {tables['table4']}; Table V {tables['table5']}; Fig. 4 improvement % "
          f"{tables['fig4_improvement_pct']}; equal to the published tables: "
          f"{tables['matches_paper']}")
    if not all(tables["matches_paper"].values()):
        _fail(f"paper: the cycle model disagrees with the published tables {tables}")
    gen = torch.Generator(device="cuda").manual_seed(12)
    out = {}
    for label, K, polys in PAPER_CODES:
        code = ConvCode(K, polys)
        S, M = code.n_states, code.n_symbols
        bm = torch.randn((B_MAIN, N_INFO + K - 1, M), generator=gen, device="cuda")
        bm_t = bm.transpose(0, 1).contiguous()  # (T, B, M): one contiguous row a step
        T = bm.shape[1]
        # equality over the first PAPER_CHECK_T steps: metrics, and selects
        # (the unfused step's survivor parity p & 1 is the select bit)
        head, head_t = bm[:, :PAPER_CHECK_T].contiguous(), bm_t[:PAPER_CHECK_T]
        reset_counts()
        want_pm, want_sel = viterbi_scan.viterbi_scan(code, head)
        for name, step in (("acs_step_unfused", acs_step_unfused), ("acs_step", acs_step),
                           ("texpand", ops.texpand_op)):
            pm, sel = _stepped(step, code, head_t)
            torch.cuda.synchronize()
            if not (torch.equal(pm, want_pm) and torch.equal(sel, want_sel)):
                _fail(f"paper {label}: {name} disagrees with the fused scan over "
                      f"{PAPER_CHECK_T} steps")
        if launch_counts["texpand"] != PAPER_CHECK_T or launch_counts["viterbi_scan"] != 1:
            _fail(f"paper {label}: launches {dict(launch_counts)}")
        # per-step device-only times: one step's inputs mid-trellis
        pm_mid = want_pm
        step_bm = bm_t[PAPER_CHECK_T]
        n_unfused, n_acs, n_tex = PAPER_GRAPH_N[label]
        row = {"states": S, "batch": B_MAIN, "card": smi}
        for name, fn, n in (
            ("acs_step_unfused", lambda: acs_step_unfused(code, pm_mid, step_bm), n_unfused),
            ("acs_step", lambda: acs_step(code, pm_mid, step_bm), n_acs),
            ("texpand", lambda: ops.texpand_op(code, pm_mid, step_bm), n_tex),
        ):
            r, _ = _graph_ms(fn, n)
            reset_counts()
            n_ops = _ops_per_call(fn)
            row[name] = {"ms_per_step": statistics.median(r), "rounds": r,
                         "torch_ops_per_step": n_ops,
                         "launches_per_step": launch_counts.get(name, 0)}
        r, _ = _graph_ms(lambda: viterbi_scan.viterbi_scan(code, bm), 5)
        row["fused_scan"] = {"ms_per_step": statistics.median(r) / T, "rounds_ms": r,
                             "steps": T, "launches_per_step": 1 / T}
        for name in ("acs_step_unfused", "acs_step", "texpand", "fused_scan"):
            x = row[name]
            print(f"[paper] {label} (S={S}, B={B_MAIN}): {name} {x['ms_per_step']!r} ms a step "
                  f"(device-only), {x.get('torch_ops_per_step', 0)} torch ops and "
                  f"{x['launches_per_step']!r} kernel launches a step ({smi})")
        print(f"[paper] {label}: all four give equal metrics and selects over "
              f"{PAPER_CHECK_T} steps; unfused / texpand step time "
              f"{row['acs_step_unfused']['ms_per_step'] / row['texpand']['ms_per_step']!r}")
        out[label] = row
    out["cycle_model"] = {k: tables[k] for k in ("table3", "table4", "table5",
                                                  "fig4_improvement_pct")}
    return out


#: the LM serving path: qwen2.5-3b at full width (src/repro/configs/qwen2_5_3b.py),
#: B prompts of LM_PROMPT tokens, LM_NEW new tokens, greedy
LM_ARCH, LM_B, LM_PROMPT, LM_NEW = "qwen2_5_3b", 4, 16, 32
#: timed rounds (CUDA events) of a prefill, of LM_DECODE_REPS decode steps, of a generate
LM_ROUNDS, LM_DECODE_REPS = 5, 8
#: teacher-forcing tolerances at full width, |decode - full forward| <= atol +
#: rtol * |full forward|.  bf16: a few bf16 ulps at the logits' scale (ulp
#: 0.03125 at |logit| in [4, 8)) — the prefill's chunked softmax and the
#: decode's masked softmax round p at different points, and GEMMs of 1, 16
#: and 17 rows sum in different orders, at every one of 36 layers.  float32
#: compute: the bf16 caches alone (the full forward never reads them)
LM_TF_TOL = {"bfloat16": (0.25, 0.05), "float32": (0.05, 0.02)}
#: the serving scenario's channel: BSC flip probabilities
SCENARIO_FLIPS = (0.0, 0.01, 0.03)
#: LM training: qwen2.5-3b at full width on ``train_4k``'s 4096-token
#: sequences, the global batch of 256 cut to LM_TRAIN_B (what one card holds
#: beside the float32 weights and AdamW's two moments); LM_TRAIN_STEPS steps
#: of the fixed batch at lr 1e-4 with 2 warm-up steps, then train() for
#: LM_TRAIN_LOOP_STEPS
LM_TRAIN_B, LM_TRAIN_S, LM_TRAIN_STEPS, LM_TRAIN_LOOP_STEPS = 2, 4096, 8, 3
LM_TRAIN_LR, LM_TRAIN_WARMUP = 1e-4, 2
#: NVIDIA's published H100 SXM dense bf16 peak (FLOP/s)
BF16_FLOPS_PER_S = 989.4e12
#: remat "full" against "none" (2 layers): the loss equal; each bf16 gradient
#: leaf within this relative L2 error (stated before the first run: the tied
#: embedding's gradient sums the gather's scatter-add, whose accumulation
#: order on the card is not fixed, and the head's product)
LM_REMAT_GRAD_TOL = 1e-2
#: the step-0 loss against softmax_xent of a no-grad forward: rtol
LM_LOSS_RTOL = 1e-6
#: predicted peak of the training run, bytes above the phase's start
#: (PERF.md §6, PR 24): the float32 weights and AdamW's moments (37.03e9),
#: the bf16 copy (6.17e9) and, at the loss's forward, the bf16 logits
#: (2.49e9), their float32 copy (4.98e9) and logsumexp's two temporaries
LM_TRAIN_PEAK_PREDICTED = (58e9, 64e9)


def _lm_forward_check(model, params, toks, dtype, cache_dtype=None):
    """Teacher forcing at full width in ``dtype`` compute: prefill(S) then
    decode(token S) against a full forward over S+1 tokens, position S (the
    caches in ``cache_dtype``, None: the served bf16).  Returns (max |diff|,
    logits beyond the tolerance in all and by row, argmax rows equal, rows
    whose argmax differs with the full forward's logit at the decode's
    argmax below its max, top-2 margins of the full forward)."""
    import dataclasses

    import torch

    from repro_torch.models import common as cm
    from repro_torch.models import transformer as tf
    from repro_torch.models.model_zoo import Model

    cfg = dataclasses.replace(model.cfg, compute_dtype=dtype)
    m = Model(cfg=cfg, part=model.part, param_specs=model.param_specs, device=model.device)
    B, S1 = toks.shape
    S = S1 - 1
    x = tf.embed_tokens(params, cfg, toks)
    x, _, _ = tf.run_stack_full(params["blocks"], cfg, m.part, x)
    x = cm.rmsnorm(params["final_norm"], x, cfg.norm_eps, compute_dtype=cm.dtype_of(dtype))
    full = tf.lm_head(params, cfg, x)[:, S].float()
    caches = m.init_cache(B, S1)
    if cache_dtype is not None:
        from repro_torch.train.tree import tree_map

        cdt = getattr(torch, cache_dtype)
        caches = tree_map(lambda t: t.to(cdt) if t.is_floating_point() else t, caches)
    _, caches = m.prefill(params, {"tokens": toks[:, :S]}, caches)
    dec, _ = m.decode_step(params, toks[:, S:], torch.full((B,), S, dtype=torch.int32,
                                                         device=toks.device), caches)
    dec = dec.float()
    if dec.shape != full.shape or not (torch.isfinite(dec).all() and torch.isfinite(full).all()):
        _fail(f"lm_serve {dtype}: bad logits {tuple(dec.shape)} or non-finite values")
    atol, rtol = LM_TF_TOL[dtype]
    diff = (dec - full).abs()
    over_by_row = (diff > atol + rtol * full.abs()).sum(-1).tolist()
    arg_d, arg_f = dec.argmax(-1), full.argmax(-1)
    top2 = full.topk(2, dim=-1).values
    below = (full.max(-1).values - full.gather(1, arg_d[:, None])[:, 0]).tolist()
    return {"max_abs_diff": diff.max().item(), "over_tolerance": sum(over_by_row),
            "over_by_row": over_by_row,
            "argmax_equal": (arg_d == arg_f).tolist(), "decode_argmax_below_max": below,
            "top2_margin": (top2[:, 0] - top2[:, 1]).tolist(), "atol": atol, "rtol": rtol}


def _host_syncs(fn) -> tuple:
    """``fn()``'s result and the synchronizing CUDA calls it made, with
    their caller lines (the analysis layer's counter)."""
    from repro_torch.analysis import sanitized

    with sanitized(transfer_guard=None, debug_nans=False) as rep:
        out = fn()
    return out, rep.host_syncs, dict(rep.sync_sites)


def phase_lm_serve(smi, seed):
    """Phase 13: the LM serving path at qwen2.5-3b's full width on the card:
    ``build`` + ``init`` from a seeded generator, greedy ``ServeEngine``
    generation, its host syncs, prefill and decode-step times, peak memory,
    and the teacher-forcing check in bf16 (the served dtype) and float32
    compute."""
    import torch

    from repro_torch.analysis.op_lint import OpRecorder
    from repro_torch.configs import get_arch
    from repro_torch.models import build
    from repro_torch.serve import ServeEngine, cache_bytes

    torch.cuda.synchronize()
    live0 = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    model = build(get_arch(LM_ARCH))
    cfg = model.cfg
    if model.device.type != "cuda":
        _fail(f"lm_serve: model built on {model.device}")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    t0 = time.perf_counter()
    params = model.init(gen)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    leaves = []
    stack = [params]
    while stack:
        node = stack.pop()
        if isinstance(node, dict):
            stack.extend(node.values())
        else:
            leaves.append(node)
    n_params = sum(t.numel() for t in leaves)
    held = sum(t.numel() * t.element_size() for t in leaves)
    counted = cfg.param_count()["total"]
    # param_count() leaves out the norms' scales and the QKV biases
    hd = cfg.resolved_head_dim
    extra = (2 * cfg.n_layers + 1) * cfg.d_model + (
        cfg.n_layers * (cfg.n_heads + 2 * cfg.n_kv_heads) * hd if cfg.qkv_bias else 0)
    if n_params != counted + extra or not all(t.device.type == "cuda" for t in leaves):
        _fail(f"lm_serve: {n_params} parameters on the card, param_count() {counted} + "
              f"norms and biases {extra}")
    kv_bytes = cache_bytes(model, LM_B, LM_PROMPT + LM_NEW)
    print(f"[lm_serve] {cfg.name}: {cfg.n_layers} layers, d={cfg.d_model}, {cfg.n_heads} heads "
          f"({cfg.n_kv_heads} KV), head_dim {hd}, d_ff {cfg.d_ff}, vocab {cfg.vocab}; "
          f"{n_params} parameters in tensors, param_count()['total'] {counted!r} (+ {extra} norm "
          f"scales and QKV biases), {held} bytes held (float32), init {init_s!r} s; "
          f"cache_bytes(model, {LM_B}, {LM_PROMPT + LM_NEW}) = {kv_bytes} ({smi})")

    prompts = torch.randint(0, cfg.vocab, (LM_B, LM_PROMPT), generator=gen, device="cuda")
    engine = ServeEngine(model, params, max_len=LM_PROMPT + LM_NEW)
    engine.generate(prompts, LM_NEW)  # warm-up: cuBLAS handles, allocator
    torch.cuda.synchronize()
    out, syncs, sites = _host_syncs(lambda: engine.generate(prompts, LM_NEW))
    _, syncs_half, _ = _host_syncs(lambda: engine.generate(prompts, LM_NEW // 2))
    tokens = out["tokens"]
    host_tokens = tokens.cpu()  # the final read
    print(f"[lm_serve] host syncs inside generate: {syncs} for {LM_NEW} tokens, {syncs_half} for "
          f"{LM_NEW // 2} (sites {sites}); then one read of the tokens ({smi})")
    if syncs != syncs_half:
        _fail(f"lm_serve: generate syncs per token ({syncs} for {LM_NEW}, {syncs_half} for "
              f"{LM_NEW // 2})")
    if tuple(host_tokens.shape) != (LM_B, LM_NEW) or host_tokens.dtype != torch.int32 or not (
            (host_tokens >= 0) & (host_tokens < cfg.vocab)).all():
        _fail(f"lm_serve: bad tokens {tuple(host_tokens.shape)} {host_tokens.dtype}")
    again = engine.generate(prompts, LM_NEW)["tokens"]
    if not torch.equal(again, tokens):
        _fail("lm_serve: greedy generation is not deterministic")

    with torch.inference_mode():
        caches = model.init_cache(LM_B, LM_PROMPT + LM_NEW)
        batch = {"tokens": prompts}
        prefill = _event_ms(lambda: model.prefill(params, batch, caches), 1, LM_ROUNDS)
        tok = tokens[:, :1]
        pos = torch.full((LM_B,), LM_PROMPT, dtype=torch.int32, device="cuda")
        step = _event_ms(lambda: model.decode_step(params, tok, pos, caches), LM_DECODE_REPS,
                         LM_ROUNDS)
        with OpRecorder() as rec:
            model.decode_step(params, tok, pos, caches)
        step_ops = len(rec.ops)
        with OpRecorder() as rec:
            model.prefill(params, batch, caches)
        prefill_ops = len(rec.ops)
    gen_ms = _event_ms(lambda: engine.generate(prompts, LM_NEW), 1, 3, warmup=0)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    with torch.inference_mode():
        # device-only: the same calls replayed from a CUDA graph (a
        # measurement; the served path is eager), after the peak's reading
        step_dev, _ = _graph_ms(lambda: model.decode_step(params, tok, pos, caches), 4)
        prefill_dev, _ = _graph_ms(lambda: model.prefill(params, batch, caches), 1)
    # the step's bytes as written: each layer parameter and the tied table
    # read as float32 (4 B), its bf16 copy written (2 B) and read by the
    # product (2 B); the floor reads each float32 parameter once
    step_bytes = 8 * counted
    row = {
        "arch": cfg.name, "batch": LM_B, "prompt": LM_PROMPT, "new_tokens": LM_NEW,
        "params_in_tensors": n_params, "param_count_total": counted, "bytes_held": held,
        "cache_bytes": kv_bytes, "peak_bytes": peak, "peak_bytes_above_phase_start": peak - live0,
        "prefill_ms": statistics.median(prefill), "prefill_rounds": prefill,
        "decode_ms_per_token": statistics.median(step), "decode_rounds": step,
        "prefill_device_ms": statistics.median(prefill_dev), "prefill_device_rounds": prefill_dev,
        "decode_device_ms": statistics.median(step_dev), "decode_device_rounds": step_dev,
        "generate_ms": statistics.median(gen_ms), "generate_rounds": gen_ms,
        "tokens_per_s": LM_B * LM_NEW / (statistics.median(gen_ms) / 1e3),
        "decode_ops": step_ops, "prefill_ops": prefill_ops,
        "step_bytes_as_written": step_bytes, "step_bound_ms": step_bytes / HBM_BYTES_PER_S * 1e3,
        "fp32_read_once_bound_ms": 4 * counted / HBM_BYTES_PER_S * 1e3,
        "host_syncs_generate": syncs, "card": smi,
    }
    print(f"[lm_serve] prefill ({LM_B} x {LM_PROMPT}) {row['prefill_ms']!r} ms (rounds {prefill}, "
          f"{prefill_ops} dispatched ops); decode {row['decode_ms_per_token']!r} ms a token "
          f"(rounds {step}, {step_ops} dispatched ops a step); generate {LM_NEW} tokens "
          f"{row['generate_ms']!r} ms = {row['tokens_per_s']!r} tokens/s; step bound as written "
          f"{row['step_bound_ms']!r} ms ({step_bytes} bytes), float32 read once "
          f"{row['fp32_read_once_bound_ms']!r} ms; device-only (CUDA graph replays) prefill "
          f"{row['prefill_device_ms']!r} ms {prefill_dev}, decode step "
          f"{row['decode_device_ms']!r} ms {step_dev}; peak {peak} bytes ({peak - live0} above "
          f"the phase's start) ({smi})")

    toks = torch.randint(0, cfg.vocab, (LM_B, LM_PROMPT + 1), generator=gen, device="cuda")
    with torch.inference_mode():
        for dtype in ("bfloat16", "float32"):
            tf = _lm_forward_check(model, params, toks, dtype)
            print(f"[lm_serve] teacher forcing, {dtype} compute: {tf} ({smi})")
            if tf["over_tolerance"]:
                _fail(f"lm_serve {dtype}: {tf['over_tolerance']} logits beyond atol {tf['atol']} "
                      f"+ rtol {tf['rtol']}")
            # float32: the same argmax in every row; bf16: the decode's
            # argmax is a maximum of the full forward up to the tolerance
            # (bf16 logits tie at their maximum: ulp 0.03125 at 4-8)
            if dtype == "float32" and not all(tf["argmax_equal"]):
                _fail(f"lm_serve float32: argmax differs: {tf}")
            if max(tf["decode_argmax_below_max"]) > tf["atol"]:
                _fail(f"lm_serve {dtype}: the decode's argmax is no maximum of the full forward")
            row[f"teacher_forcing_{dtype}"] = tf
    return row, tokens


def phase_serve_scenario(tokens, smi, bits_per_token=18, label="serve_scenario"):
    """Phase 14: the paper's serving scenario on the card: the LM's tokens
    (vocab 151936: 18 bits a token) -> bits -> the K=3 code -> a BSC ->
    the planned decode (#1 and #2)."""
    import torch

    from repro_torch.configs import DECODE_SPEC
    from repro_torch.decode import DecodeRequest, decode
    from repro_torch.kernels import reset_counts
    from repro_torch.serve import bits_to_tokens, tokens_to_bits

    bits = tokens_to_bits(tokens, bits_per_token)
    coded = DECODE_SPEC.encode(bits)
    gen = torch.Generator(device="cuda").manual_seed(2)
    rxs = [DECODE_SPEC.channel(gen, coded, flip_prob=p) for p in SCENARIO_FLIPS]
    torch.cuda.synchronize()
    reset_counts()
    results = [decode(DecodeRequest(DECODE_SPEC, received=rx)) for rx in rxs]
    torch.cuda.synchronize()
    launches, plain = _counts()
    out = {"bits": tuple(bits.shape), "backend": results[0].plan.backend, "ber": {},
           "launches": launches, "plain": plain, "card": smi}
    for p, res in zip(SCENARIO_FLIPS, results):
        out["ber"][p] = _ber(res.info_bits, bits)
    print(f"[{label}] {tuple(tokens.shape)} tokens -> {tuple(bits.shape)} bits "
          f"({bits_per_token} a token) -> K=3 -> BSC; backend {out['backend']!r}; BER at flip "
          f"{out['ber']}; launches {launches}, plain calls {plain} ({smi})")
    print(f"[{label}] {results[0].plan.explain(costs=True)}")
    if any(r.plan.backend != "fused_packed" for r in results):
        _fail(f"{label}: planned {[r.plan.backend for r in results]}")
    if launches.get("viterbi_scan_packed", 0) != len(rxs) or launches.get(
            "traceback_packed", 0) != len(rxs) or any(plain.values()):
        _fail(f"{label}: launches {launches}, plain calls {plain}")
    if not torch.equal(results[0].info_bits, bits) or not torch.equal(
            bits_to_tokens(results[0].info_bits, bits_per_token), tokens):
        _fail(f"{label}: flip 0 did not recover the bits and tokens exactly")
    if max(out["ber"].values()) > 0.05:
        _fail(f"{label}: BERs {out['ber']} far above what this code and channel give")
    return out


def _lm_grads(model, params, batch):
    """(loss, bf16 gradients) of ``model.train_loss`` with respect to a bf16
    copy of ``params``, as the train step takes them."""
    import torch

    from repro_torch.train.tree import tree_leaves, tree_map

    copies = [p.detach().to(torch.bfloat16).requires_grad_() for p in tree_leaves(params)]
    it = iter(copies)
    loss, _ = model.train_loss(tree_map(lambda _: next(it), params), batch)
    return loss.detach(), torch.autograd.grad(loss, copies)


def _lm_remat_check(bundle, batch, seed):
    """``remat="full"`` against ``"none"`` at full width, 2 layers, on the
    same weights and batch."""
    import dataclasses

    import torch

    from repro_torch.models import build

    cfg = dataclasses.replace(bundle.model, n_layers=2)
    out, params = {}, None
    for remat in ("full", "none"):
        model = build(dataclasses.replace(bundle, model=cfg, partition=dataclasses.replace(
            bundle.partition, remat=remat)))
        if params is None:
            params = model.init(torch.Generator(device="cuda").manual_seed(seed))
        out[remat] = _lm_grads(model, params, batch)
    (loss_f, g_f), (loss_n, g_n) = out["full"], out["none"]
    errs = [((a.float() - b.float()).norm() / b.float().norm().clamp_min(1e-30)).item()
            for a, b in zip(g_f, g_n)]
    equal = sum(torch.equal(a, b) for a, b in zip(g_f, g_n))
    return {"loss_full": loss_f.item(), "loss_none": loss_n.item(),
            "loss_equal": bool(torch.equal(loss_f, loss_n)), "grad_leaves": len(errs),
            "grad_leaves_equal": int(equal), "max_grad_rel_err": max(errs),
            "tol": LM_REMAT_GRAD_TOL}


def phase_lm_train(smi, seed):
    """Phase 15: LM training at qwen2.5-3b's full width on the card."""
    import dataclasses
    import gc

    import torch

    from repro_torch.configs import SHAPES, get_arch
    from repro_torch.data import SyntheticLM, make_data_iter
    from repro_torch.models import build
    from repro_torch.models import common as cm
    from repro_torch.models import transformer as tf
    from repro_torch.train.optimizer import adamw, cosine_warmup
    from repro_torch.train.train_loop import make_train_step, read_metrics, train
    from repro_torch.train.tree import tree_leaves, tree_map

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    live0 = torch.cuda.memory_allocated()
    bundle = get_arch(LM_ARCH)
    cfg, part = bundle.model, bundle.partition
    if (part.remat, part.microbatches, part.optimizer) != ("full", 1, "adamw"):
        _fail(f"lm_train: {LM_ARCH} trains with {part}")
    batch = SyntheticLM(cfg.vocab, LM_TRAIN_S, LM_TRAIN_B, seed=seed)(0)
    tokens = LM_TRAIN_B * LM_TRAIN_S
    t0 = time.perf_counter()
    remat = _lm_remat_check(bundle, batch, seed)
    remat_s = time.perf_counter() - t0
    print(f"[lm_train] remat full vs none, 2 layers at full width: {remat} ({remat_s!r} s) "
          f"({smi})")
    if not remat["loss_equal"] or remat["max_grad_rel_err"] > LM_REMAT_GRAD_TOL:
        _fail(f"lm_train: remat changes the loss or the gradients: {remat}")
    gc.collect()
    torch.cuda.empty_cache()

    model = build(bundle)
    params = model.init(torch.Generator(device="cuda").manual_seed(seed))
    n_params = sum(t.numel() for t in tree_leaves(params))
    opt = adamw()
    state = opt.init(params)
    with torch.no_grad():  # the step-0 loss's reference: a no-grad forward
        params_c = tree_map(lambda p: p.to(torch.bfloat16), params)
        x = tf.embed_tokens(params_c, cfg, batch["tokens"])
        x, _, _ = tf.run_stack_full(params_c["blocks"], cfg, part, x)
        x = cm.rmsnorm(params_c["final_norm"], x, cfg.norm_eps,
                       compute_dtype=cm.dtype_of(cfg.compute_dtype))
        ref_loss = tf.softmax_xent(tf.lm_head(params_c, cfg, x), batch["labels"]).item()
        del params_c, x
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_fn = make_train_step(model, opt, cosine_warmup(LM_TRAIN_LR, LM_TRAIN_WARMUP,
                                                        LM_TRAIN_STEPS))

    def one(i):
        nonlocal params, state
        params, state, met = step_fn(params, state, batch, i)
        return read_metrics(met)

    history, times, syncs, sites = [], [], None, None
    for i in range(LM_TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if i == 1:  # the one sync a steady step makes: the metrics' read-back
            met, syncs, sites = _host_syncs(lambda: one(1))
        else:
            met = one(i)
        times.append((time.perf_counter() - t0) * 1e3)
        history.append(met)
    peak = torch.cuda.max_memory_allocated() - live0
    losses = [h["loss"] for h in history]
    norms = [h["grad_norm"] for h in history]
    step_ms = statistics.median(times[2:])
    # model FLOPs a token: 6 N (forward and backward of every parameter's
    # product, the tied head's included) + 12 L H hd S (attention's scores
    # and PV over the whole sequence, forward and backward)
    flops_token = 6 * n_params + 12 * cfg.n_layers * cfg.n_heads * cfg.resolved_head_dim * LM_TRAIN_S
    mfu = flops_token * tokens / (step_ms / 1e3) / BF16_FLOPS_PER_S
    print(f"[lm_train] {cfg.name}: {n_params} parameters, B={LM_TRAIN_B} x S={LM_TRAIN_S}, "
          f"remat {part.remat!r}, AdamW; losses {losses}; grad norms {norms}; lr "
          f"{[h['lr'] for h in history]}; step-0 loss {losses[0]!r} against the no-grad "
          f"forward's {ref_loss!r}; host syncs in step 1 {syncs} (sites {sites}) ({smi})")
    print(f"[lm_train] step times (ms, host clock to the metrics' read-back) {times}; median "
          f"of steps 2-{LM_TRAIN_STEPS - 1} {step_ms!r} ms = {tokens / (step_ms / 1e3)!r} "
          f"tokens/s; model FLOPs {flops_token * tokens!r} a step = {mfu!r} of the "
          f"{BF16_FLOPS_PER_S!r} FLOP/s bf16 peak; peak {peak} bytes above the phase's start "
          f"(predicted {LM_TRAIN_PEAK_PREDICTED}) ({smi})")
    if abs(losses[0] - ref_loss) > LM_LOSS_RTOL * abs(ref_loss):
        _fail(f"lm_train: step-0 loss {losses[0]!r} against the no-grad forward's {ref_loss!r}")
    if not all(math.isfinite(v) for v in losses + norms):
        _fail(f"lm_train: non-finite losses {losses} or grad norms {norms}")
    if not losses[-1] < losses[0]:
        _fail(f"lm_train: the fixed batch's loss did not fall: {losses}")
    if syncs != 1:
        _fail(f"lm_train: {syncs} host syncs in a step (sites {sites}), expected 1")

    # the optimizer's own time: one AdamW update of the full model (CUDA
    # events, median of 3 after 1 warm-up) on bf16 gradients like the step's
    with torch.no_grad():
        grads = tree_map(lambda p: torch.full(p.shape, 1e-4, dtype=torch.bfloat16,
                                              device=p.device), params)
    lr = torch.tensor(LM_TRAIN_LR)
    opt_ms = _event_ms(lambda: opt.update(grads, state, params, LM_TRAIN_STEPS, lr), 1, 3,
                       warmup=1)
    print(f"[lm_train] AdamW update alone {statistics.median(opt_ms)!r} ms (rounds {opt_ms}) "
          f"({smi})")
    del grads, params, state, step_fn
    gc.collect()
    torch.cuda.empty_cache()

    shape = dataclasses.replace(SHAPES["train_4k"], seq_len=LM_TRAIN_S, global_batch=LM_TRAIN_B)
    t0 = time.perf_counter()
    report = train(model, make_data_iter(model, shape, seed=seed), steps=LM_TRAIN_LOOP_STEPS,
                   lr=LM_TRAIN_LR, warmup=LM_TRAIN_WARMUP, seed=seed, log_every=1)
    loop_s = time.perf_counter() - t0
    loop = [{k: h[k] for k in ("step", "time_s", "loss", "grad_norm", "lr")}
            for h in report["history"]]
    print(f"[lm_train] train() {LM_TRAIN_LOOP_STEPS} steps on make_data_iter in {loop_s!r} s "
          f"(init included): {loop}; final step {report['final_step']}, restarts "
          f"{report['restarts']} ({smi})")
    if report["final_step"] != LM_TRAIN_LOOP_STEPS or report["restarts"] or not all(
            math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"]) for h in loop):
        _fail(f"lm_train: train() report {loop}, final step {report['final_step']}")
    del report
    gc.collect()
    torch.cuda.empty_cache()
    return {
        "arch": cfg.name, "batch": LM_TRAIN_B, "seq_len": LM_TRAIN_S, "params": n_params,
        "remat_check": remat, "losses": losses, "grad_norms": norms,
        "step0_no_grad_loss": ref_loss, "step_ms": step_ms, "step_rounds_ms": times,
        "tokens_per_s": tokens / (step_ms / 1e3), "model_flops_per_step": flops_token * tokens,
        "mfu_bf16": mfu, "peak_bytes_above_phase_start": peak,
        "peak_predicted": LM_TRAIN_PEAK_PREDICTED, "host_syncs_step": syncs,
        "optimizer_ms": statistics.median(opt_ms), "optimizer_rounds_ms": opt_ms,
        "train_loop": loop, "card": smi,
    }


#: the MoE and MLA families at full width (src/repro/configs/qwen3_moe_30b_a3b.py,
#: deepseek_v2_lite_16b.py): serving depth (float32 weights: qwen3-moe's 48
#: layers, ~120e9 bytes, do not fit the card's 85.0e9, so 16 of them; all 27
#: of deepseek-v2-lite's, ~64.8e9) and the training depth (2 layers each)
LM_MOE_ARCHS = (("qwen3_moe_30b_a3b", 16), ("deepseek_v2_lite_16b", 27))
LM_MOE_TRAIN_LAYERS = 2
#: train steps on one fixed batch (the first warms, the second is counted by
#: the sync counter, the median of all after the first is the step time),
#: then train() steps on make_data_iter
LM_MOE_TRAIN_STEPS, LM_MOE_LOOP_STEPS = 5, 2
#: the teacher-forcing check's capacity factor (the reference's own check
#: raises it: a full pass and a single-token decode drop different tokens at
#: the published 1.25)
LM_MOE_TF_CAPACITY = 64.0
#: the teacher-forcing readings, (compute dtype, cache dtype): phase 13's two
#: with the served bf16 caches, and float32 compute over float32 caches.
#: With bf16 caches the decode's activations differ from the full forward's
#: by a bf16 rounding, enough to flip a router near-tie: one expert for
#: another moves a logit by O(1) (CPU rehearsal, deepseek's smoke model: row
#: 0 swaps expert 1 for 7 in layer 1, 1.09 apart; over float32 caches the
#: same rows are 2.5e-6 apart with equal routes).  So the routes of the
#: decoded token are recorded in both passes, a row whose route differs in
#: some layer is reported, and the rows whose routes agree are held to phase
#: 13's tolerances; over float32 caches no route may differ
LM_MOE_TF_RUNS = (("bfloat16", None), ("float32", None), ("float32", "float32"))
#: the readings held, by mixer.  MLA decodes in the absorbed form (W_uk
#: folded into the query, scores in the compressed space) and prefills in
#: the expanded form: in bf16 the two round at different points, and the
#: reference's own gap between them is 1.4375 at smoke size (256 of 2048
#: logits beyond the bf16 tolerance; float32: 0.0131, none), so MLA's bf16
#: reading is printed, not held, as the reference's own check holds float32
LM_MOE_TF_GATED = {"attn": ("bfloat16", "float32"), "mla": ("float32",)}


@contextlib.contextmanager
def _routes_recorded():
    """Inside, every MoE routing appends the expert ids of its last position,
    sorted (B, k), to the list it yields."""
    from repro_torch.models import moe as moe_mod

    calls, orig = [], moe_mod.route

    def record(probs, k):
        vals, idx = orig(probs, k)
        calls.append(idx[:, -1].sort(-1).values)
        return vals, idx
    moe_mod.route = record
    try:
        yield calls
    finally:
        moe_mod.route = orig


def _bits_per_token(vocab: int) -> int:
    return max(1, (vocab - 1).bit_length())


def _free_card():
    import gc

    import torch

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def _lm_param_count(cfg, params) -> tuple:
    """(parameters in tensors, param_count()'s total, the leaves param_count()
    leaves out: the norms' scales, qk-norm's and MLA's kv_norm scales)."""
    from repro_torch.train.tree import tree_leaves

    n = sum(t.numel() for t in tree_leaves(params))
    extra = (2 * cfg.n_layers + 1) * cfg.d_model
    if cfg.qk_norm:
        extra += 2 * cfg.n_layers * cfg.resolved_head_dim
    if cfg.mla is not None:
        extra += cfg.n_layers * cfg.mla.kv_lora_rank
    return n, cfg.param_count()["total"], extra


def phase_lm_serve_moe(smi, seed):
    """Phase 16: the MoE (qwen3-moe-30b-a3b) and MLA + MoE (deepseek-v2-lite-
    16b) families served at full width: ``ServeEngine`` greedy generation,
    no host sync in ``generate``, two ``generate`` calls bit-equal, prefill
    and decode times (eager and CUDA-graph replay), teacher forcing at
    capacity factor 64, and the tokens through the serving scenario."""
    import dataclasses

    import torch

    from repro_torch.analysis.op_lint import OpRecorder
    from repro_torch.configs import get_arch
    from repro_torch.models import build
    from repro_torch.models.model_zoo import Model
    from repro_torch.serve import ServeEngine, cache_bytes

    out = {}
    for arch, n_layers in LM_MOE_ARCHS:
        _free_card()
        live0 = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        bundle = get_arch(arch)
        published = bundle.model.n_layers
        bundle = dataclasses.replace(bundle, model=dataclasses.replace(bundle.model,
                                                                       n_layers=n_layers))
        model = build(bundle)
        cfg = model.cfg
        if model.device.type != "cuda":
            _fail(f"lm_serve_moe {arch}: model built on {model.device}")
        gen = torch.Generator(device="cuda").manual_seed(seed)
        t0 = time.perf_counter()
        params = model.init(gen)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        n_params, counted, extra = _lm_param_count(cfg, params)
        if n_params != counted + extra:
            _fail(f"lm_serve_moe {arch}: {n_params} parameters, param_count() {counted} + "
                  f"scales {extra}")
        held = torch.cuda.memory_allocated() - live0
        kv_bytes = cache_bytes(model, LM_B, LM_PROMPT + LM_NEW)
        print(f"[lm_serve_moe] {cfg.name}: {n_layers} of {published} layers, d={cfg.d_model}, "
              f"{cfg.n_heads} heads ({cfg.n_kv_heads} KV), {cfg.moe.n_experts} experts top "
              f"{cfg.moe.top_k} (+{cfg.moe.n_shared} shared) of width {cfg.moe.d_expert}, "
              f"MLA {cfg.mla}, vocab {cfg.vocab}; {n_params} parameters (param_count() "
              f"{counted!r} + {extra} scales), {held} bytes held (float32), init {init_s!r} s; "
              f"cache_bytes(model, {LM_B}, {LM_PROMPT + LM_NEW}) = {kv_bytes} ({smi})")

        prompts = torch.randint(0, cfg.vocab, (LM_B, LM_PROMPT), generator=gen, device="cuda")
        engine = ServeEngine(model, params, max_len=LM_PROMPT + LM_NEW)
        engine.generate(prompts, LM_NEW)  # warm-up
        torch.cuda.synchronize()
        first, syncs, sites = _host_syncs(lambda: engine.generate(prompts, LM_NEW))
        tokens = first["tokens"]
        again = engine.generate(prompts, LM_NEW)["tokens"]
        host_tokens = tokens.cpu()
        print(f"[lm_serve_moe] {cfg.name}: host syncs inside generate {syncs} for {LM_NEW} "
              f"tokens (sites {sites}); two generate calls bit-equal: "
              f"{bool(torch.equal(again, tokens))} ({smi})")
        if syncs != 0:
            _fail(f"lm_serve_moe {arch}: {syncs} host syncs in generate (sites {sites})")
        if not torch.equal(again, tokens):
            _fail(f"lm_serve_moe {arch}: two generate calls differ")
        if tuple(host_tokens.shape) != (LM_B, LM_NEW) or not (
                (host_tokens >= 0) & (host_tokens < cfg.vocab)).all():
            _fail(f"lm_serve_moe {arch}: bad tokens {tuple(host_tokens.shape)}")

        with torch.inference_mode():
            caches = model.init_cache(LM_B, LM_PROMPT + LM_NEW)
            batch = {"tokens": prompts}
            prefill = _event_ms(lambda: model.prefill(params, batch, caches), 1, LM_ROUNDS)
            tok = tokens[:, :1]
            pos = torch.full((LM_B,), LM_PROMPT, dtype=torch.int32, device="cuda")
            step = _event_ms(lambda: model.decode_step(params, tok, pos, caches), 4, LM_ROUNDS)
            with OpRecorder() as rec:
                model.decode_step(params, tok, pos, caches)
            step_ops = len(rec.ops)
        gen_ms = _event_ms(lambda: engine.generate(prompts, LM_NEW), 1, 3, warmup=0)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - live0
        with torch.inference_mode():
            step_dev, _ = _graph_ms(lambda: model.decode_step(params, tok, pos, caches), 2)
        row = {
            "arch": cfg.name, "layers": n_layers, "published_layers": published,
            "batch": LM_B, "prompt": LM_PROMPT, "new_tokens": LM_NEW,
            "params_in_tensors": n_params, "param_count_total": counted,
            "param_count_active": cfg.param_count()["active"], "bytes_held": held,
            "cache_bytes": kv_bytes, "peak_bytes_above_phase_start": peak,
            "prefill_ms": statistics.median(prefill), "prefill_rounds": prefill,
            "decode_ms_per_token": statistics.median(step), "decode_rounds": step,
            "decode_device_ms": statistics.median(step_dev), "decode_device_rounds": step_dev,
            "decode_ops": step_ops,
            "generate_ms": statistics.median(gen_ms), "generate_rounds": gen_ms,
            "tokens_per_s": LM_B * LM_NEW / (statistics.median(gen_ms) / 1e3),
            "host_syncs_generate": syncs, "generate_bit_equal": True, "card": smi,
        }
        print(f"[lm_serve_moe] {cfg.name}: prefill ({LM_B} x {LM_PROMPT}) {row['prefill_ms']!r} "
              f"ms (rounds {prefill}); decode {row['decode_ms_per_token']!r} ms a token eager "
              f"(rounds {step}, {step_ops} dispatched ops a step), "
              f"{row['decode_device_ms']!r} device-only (CUDA graph replays "
              f"{step_dev}); generate {LM_NEW} tokens {row['generate_ms']!r} ms = "
              f"{row['tokens_per_s']!r} tokens/s; peak {peak} bytes above the phase's start "
              f"({smi})")

        # teacher forcing at capacity factor 64, both compute dtypes
        tf_cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=LM_MOE_TF_CAPACITY))
        tf_model = Model(cfg=tf_cfg, part=model.part, param_specs=model.param_specs,
                         device=model.device)
        toks = torch.randint(0, cfg.vocab, (LM_B, LM_PROMPT + 1), generator=gen, device="cuda")
        gated = LM_MOE_TF_GATED[cfg.pattern[0][0]]
        L = cfg.n_layers
        with torch.inference_mode():
            for dtype, cache_dtype in LM_MOE_TF_RUNS:
                with _routes_recorded() as routes:  # full forward, prefill, decode
                    tf = _lm_forward_check(tf_model, params, toks, dtype, cache_dtype)
                if len(routes) != 3 * L:
                    _fail(f"lm_serve_moe {arch}: {len(routes)} routings for {L} layers")
                flips = [(layer, r) for layer in range(L) for r in range(LM_B)
                         if not torch.equal(routes[layer][r], routes[2 * L + layer][r])]
                rows = sorted({r for _, r in flips})
                tf.update(held=dtype in gated, cache_dtype=str(cache_dtype or "bfloat16"),
                          route_flips=flips,
                          over_in_rows_with_equal_routes=sum(
                              n for r, n in enumerate(tf["over_by_row"]) if r not in rows))
                name = f"teacher_forcing_{dtype}" + ("_fp32_caches" if cache_dtype else "")
                row[name] = tf
                print(f"[lm_serve_moe] {cfg.name}: teacher forcing at capacity factor "
                      f"{LM_MOE_TF_CAPACITY}, {dtype} compute, {tf['cache_dtype']} caches"
                      f"{'' if tf['held'] else ' (printed, not held: LM_MOE_TF_GATED)'}: "
                      f"decoded token's routes differ from the full forward's at (layer, row) "
                      f"{flips}; {tf} ({smi})")
                if cache_dtype is not None and flips:
                    _fail(f"lm_serve_moe {arch}: routes differ over float32 caches: {flips}")
                if not tf["held"]:
                    continue
                if tf["over_in_rows_with_equal_routes"]:
                    _fail(f"lm_serve_moe {arch} {dtype}: {tf['over_in_rows_with_equal_routes']} "
                          f"logits beyond atol {tf['atol']} + rtol {tf['rtol']} in rows whose "
                          "routes agree")
                kept = [r for r in range(LM_B) if r not in rows]
                if dtype == "float32" and not all(tf["argmax_equal"][r] for r in kept):
                    _fail(f"lm_serve_moe {arch} float32: argmax differs: {tf}")
                if max([tf["decode_argmax_below_max"][r] for r in kept], default=0.0) > tf["atol"]:
                    _fail(f"lm_serve_moe {arch} {dtype}: the decode's argmax is no maximum of "
                          "the full forward")
        del engine, caches, params, tf_model, model
        _free_card()
        row["scenario"] = phase_serve_scenario(tokens, smi, _bits_per_token(cfg.vocab),
                                               f"serve_scenario_{arch}")
        out[arch] = row
    return out


def phase_lm_train_moe(smi, seed):
    """Phase 17: training of the MoE and MLA + MoE families at full width, 2
    layers each: ``make_train_step`` on one fixed batch of 2 x 4096 tokens
    (remat "full", AdamW) and ``train()`` on ``make_data_iter``."""
    import dataclasses

    import torch

    from repro_torch.configs import SHAPES, get_arch
    from repro_torch.data import SyntheticLM, make_data_iter
    from repro_torch.models import build
    from repro_torch.train.optimizer import adamw, cosine_warmup
    from repro_torch.train.train_loop import make_train_step, read_metrics, train
    from repro_torch.train.tree import tree_map

    out = {}
    for arch, _ in LM_MOE_ARCHS:
        _free_card()
        live0 = torch.cuda.memory_allocated()
        bundle = get_arch(arch)
        published = bundle.model.n_layers
        cfg = dataclasses.replace(bundle.model, n_layers=LM_MOE_TRAIN_LAYERS)
        part = dataclasses.replace(bundle.partition, remat="full", microbatches=1,
                                   optimizer="adamw")
        bundle = dataclasses.replace(bundle, model=cfg, partition=part)
        model = build(bundle)
        params = model.init(torch.Generator(device="cuda").manual_seed(seed))
        counts = cfg.param_count()
        n_params, counted, extra = _lm_param_count(cfg, params)
        # the parameters a token's products read: the active count (top-k
        # plus shared experts, the router) and the scales
        n_active = counts["active"] + extra
        batch = SyntheticLM(cfg.vocab, LM_TRAIN_S, LM_TRAIN_B, seed=seed)(0)
        tokens = LM_TRAIN_B * LM_TRAIN_S
        opt = adamw()
        state = opt.init(params)
        with torch.no_grad():  # the step-0 loss's reference: a no-grad forward
            params_c = tree_map(lambda p: p.to(torch.bfloat16), params)
            ref_loss = model.train_loss(params_c, batch)[0].item()
            del params_c
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        step_fn = make_train_step(model, opt, cosine_warmup(LM_TRAIN_LR, LM_TRAIN_WARMUP,
                                                            LM_MOE_TRAIN_STEPS))

        def one(i):
            nonlocal params, state
            params, state, met = step_fn(params, state, batch, i)
            return read_metrics(met)

        history, times, syncs, sites = [], [], None, None
        for i in range(LM_MOE_TRAIN_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if i == 1:
                met, syncs, sites = _host_syncs(lambda: one(1))
            else:
                met = one(i)
            times.append((time.perf_counter() - t0) * 1e3)
            history.append(met)
        peak = torch.cuda.max_memory_allocated() - live0
        losses = [h["loss"] for h in history]
        lbs = [h["load_balance_loss"] for h in history]
        zs = [h["router_z_loss"] for h in history]
        norms = [h["grad_norm"] for h in history]
        step_ms = statistics.median(times[1:])
        m = cfg.mla
        qk, v = ((m.nope_head_dim + m.rope_head_dim, m.v_head_dim) if m is not None
                 else (cfg.resolved_head_dim, cfg.resolved_head_dim))
        # model FLOPs a token: 6 N_active (forward and backward of the
        # products a token runs: top-k and shared experts, not all E) +
        # 6 L H (qk + v) S (attention's scores and PV over the sequence)
        flops_token = 6 * n_active + 6 * cfg.n_layers * cfg.n_heads * (qk + v) * LM_TRAIN_S
        mfu = flops_token * tokens / (step_ms / 1e3) / BF16_FLOPS_PER_S
        print(f"[lm_train_moe] {cfg.name}: {LM_MOE_TRAIN_LAYERS} of {published} layers at full "
              f"width, {n_params} parameters ({n_active} active a token), B={LM_TRAIN_B} x "
              f"S={LM_TRAIN_S}, remat 'full', AdamW; losses {losses}; load-balance {lbs}; "
              f"z {zs}; grad norms {norms}; step-0 loss {losses[0]!r} against the no-grad "
              f"forward's {ref_loss!r}; host syncs in step 1 {syncs} (sites {sites}) ({smi})")
        print(f"[lm_train_moe] {cfg.name}: step times (ms) {times}; median of steps 1-"
              f"{LM_MOE_TRAIN_STEPS - 1} {step_ms!r} ms = {tokens / (step_ms / 1e3)!r} tokens/s; "
              f"model FLOPs (6 N_active + attention) {flops_token * tokens!r} a step = {mfu!r} "
              f"of the {BF16_FLOPS_PER_S!r} FLOP/s bf16 peak; peak {peak} bytes above the "
              f"phase's start ({smi})")
        if abs(losses[0] - ref_loss) > LM_LOSS_RTOL * abs(ref_loss):
            _fail(f"lm_train_moe {arch}: step-0 loss {losses[0]!r} against the no-grad "
                  f"forward's {ref_loss!r}")
        if not all(math.isfinite(x) for x in losses + norms + lbs + zs):
            _fail(f"lm_train_moe {arch}: non-finite losses {losses}, {lbs}, {zs} or norms")
        if not (min(lbs) > 0 and min(zs) > 0):
            _fail(f"lm_train_moe {arch}: aux losses {lbs}, {zs}")
        if syncs != 1:
            _fail(f"lm_train_moe {arch}: {syncs} host syncs in a step (sites {sites}), "
                  "expected 1")
        del params, state, step_fn
        _free_card()
        shape = dataclasses.replace(SHAPES["train_4k"], seq_len=LM_TRAIN_S,
                                    global_batch=LM_TRAIN_B)
        t0 = time.perf_counter()
        report = train(model, make_data_iter(model, shape, seed=seed),
                       steps=LM_MOE_LOOP_STEPS, lr=LM_TRAIN_LR, warmup=LM_TRAIN_WARMUP,
                       seed=seed, log_every=1)
        loop_s = time.perf_counter() - t0
        loop = [{k: h[k] for k in ("step", "time_s", "loss", "grad_norm", "load_balance_loss",
                                   "router_z_loss")} for h in report["history"]]
        print(f"[lm_train_moe] {cfg.name}: train() {LM_MOE_LOOP_STEPS} steps on make_data_iter "
              f"in {loop_s!r} s (init included): {loop}; restarts {report['restarts']} ({smi})")
        if report["final_step"] != LM_MOE_LOOP_STEPS or report["restarts"] or not all(
                math.isfinite(h["loss"]) for h in loop):
            _fail(f"lm_train_moe {arch}: train() report {loop}")
        del report
        _free_card()
        out[arch] = {
            "arch": cfg.name, "layers": LM_MOE_TRAIN_LAYERS, "published_layers": published,
            "batch": LM_TRAIN_B, "seq_len": LM_TRAIN_S, "params": n_params,
            "active_params": n_active, "losses": losses, "load_balance_losses": lbs,
            "router_z_losses": zs, "grad_norms": norms, "step0_no_grad_loss": ref_loss,
            "step_ms": step_ms, "step_rounds_ms": times,
            "tokens_per_s": tokens / (step_ms / 1e3), "model_flops_per_step": flops_token * tokens,
            "mfu_bf16_active": mfu, "peak_bytes_above_phase_start": peak,
            "host_syncs_step": syncs, "train_loop": loop, "card": smi,
        }
    return out


SHAPE_KEYS = ("ms", "device_ms", "launches", "plain_ms", "bound_ms", "bound_by", "max_abs_err",
              "bytes", "operations", "shape", "variant")


def _summary(x) -> dict:
    return {k: x[k] for k in SHAPE_KEYS if k in x}


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

    wall0 = time.perf_counter()

    def mark(label):  # the wall time each phase ends at, to see where a run's time goes
        print(f"[wall] {label}: {time.perf_counter() - wall0!r} s")

    smi = phase_build()
    mark("build")
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    launches, inputs, hard_spec, results = phase_decode(gen)
    tiled = phase_tiled(gen)
    stream = phase_stream(gen)
    mark("decode, tiled, stream")
    sched = phase_scheduler(stream, args.seed)
    mark("scheduler")
    fused_launches = phase_fused(inputs, results)
    texpand_launches, texpand_tables = phase_texpand(inputs, results)
    siso_launches, siso = phase_siso(gen)
    parallel_launches, parallel = phase_parallel(gen, tiled)
    mark("fused, texpand, siso, parallel")
    feats, weights, errs = phase_parity(gen, inputs["hard"], hard_spec)
    phase_parity_seeded(gen)
    phase_parity_wide(gen)
    phase_parity_siso(gen)
    phase_parity_minplus(gen)
    mark("parity")
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
    siso_rows, siso_e2e = phase_timing_siso(texpand_tables, siso)
    parallel_rows, parallel_e2e, rescan, window_parallel, walk = phase_timing_parallel(tiled,
                                                                                        parallel)
    walk_long = phase_timing_walk_long(parallel)
    walks = phase_timing_walks(tiled, stream, walk)
    sched_rows = phase_timing_scheduler(sched)
    walks["scheduler"] = sched_rows["traceback_packed"]
    mark("timing")
    # row 2: the short blocks' walk is the row's own numbers; the other
    # paths' walks its further shapes
    rows[1]["shapes"] = {label: _summary(x) for label, x in (("short_blocks", rows[1]),
                                                             *walks.items())}
    path_launches.update(viterbi_scan=fused_launches, texpand=texpand_launches,
                         bcjr_alpha_scan=siso_launches, bcjr_beta_llr_scan=siso_launches,
                         minplus_matmul=parallel_launches)
    for row in seeded_rows + siso_rows + parallel_rows:
        row["launches"] = path_launches[row["name"]].get(row["name"], 0)
        if row["name"] == "minplus_matmul":
            row["shapes"] = {label: _summary(x) for label, x in row["shapes"].items()}
        if row["name"] == "viterbi_scan_carry":
            row["shapes"] = rescan
        if row["name"] == "viterbi_scan_packed_carry":
            # the session push is the row's own numbers; the scheduler's
            # tick its second shape
            row["shapes"] = {label: _summary(x) for label, x in (
                ("session", row), ("scheduler", sched_rows["viterbi_scan_packed_carry"]))}
        if row["name"] == "traceback_packed_window":
            # the pinned NASA walk is the row's own numbers; the long stream's
            # planned walk its second shape, with its own bound
            row["shapes"] = {label: _summary(x) for label, x in (
                ("tiled_p8", row), ("long_stream_planned", walk_long))}
        if row["name"] == "viterbi_scan_packed_window":
            # the pinned tiled passes are the row's own numbers; the parallel
            # decode's transfer matrices are its second shape
            window_parallel["launches"] = parallel_launches.get(row["name"], 0)
            row["shapes"]["parallel_nasa"] = window_parallel
            row["shapes"] = {label: _summary(x) for label, x in row["shapes"].items()}
    rows += seeded_rows + siso_rows + parallel_rows
    e2e = {"decode_short": e2e, "tiled_nasa_frame": tiled_e2e, "stream_64k": stream["e2e"],
           "scheduler_64k": sched["e2e"],
           "fused_texpand_siso": siso_e2e, "parallel": parallel_e2e,
           "parallel_launches": parallel_launches,
           "ber": {"tiled_hard": tiled["hard"]["ber"], "tiled_soft": tiled["soft"]["ber"],
                   "stream": stream["ber"],
                   "siso": {k: siso[k]["ber"] for k in ("bcjr", "turbo", "lte6144")},
                   "turbo_baseline_k7": siso["baseline_ber"],
                   "parallel": {k: parallel[k] for k in ("hard", "soft", "long")}},
           "turbo_iterations": {k: siso[k]["iterations"] for k in ("turbo", "lte6144")}}
    # the kernels' table in the order of the TPU kernels' rows (PERF.md)
    order = ["viterbi_scan_packed", "traceback_packed", "viterbi_scan_packed_carry",
             "viterbi_scan_packed_window", "traceback_packed_window", "viterbi_scan",
             "viterbi_scan_carry", "texpand", "bcjr_alpha_scan", "bcjr_beta_llr_scan",
             "minplus_matmul"]
    rows.sort(key=lambda row: order.index(row["name"]))
    if [row["name"] for row in rows] != order or not all(row["launches"] > 0 for row in rows):
        _fail(f"kernel rows incomplete: {[(row['name'], row['launches']) for row in rows]}")
    kernels = [{k: row[k] for k in ("name", "route", "source", "replaces", "launches",
                                    "max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms",
                                    "bound_by", "library_ms", "shapes") if k in row}
               for row in rows]
    mark("kernels table")
    analysis = phase_analysis(smi)
    mark("analysis")
    paper = phase_paper(smi)
    mark("paper")
    lm, lm_tokens = phase_lm_serve(smi, args.seed)
    scenario = phase_serve_scenario(lm_tokens, smi)
    mark("lm_serve, serve_scenario")
    lm_train = phase_lm_train(smi, args.seed)
    mark("lm_train")
    lm_moe = phase_lm_serve_moe(smi, args.seed)
    mark("lm_serve_moe")
    lm_train_moe = phase_lm_train_moe(smi, args.seed)
    mark("lm_train_moe")
    print(json.dumps({"analysis": analysis, "paper": paper, "lm_serve": lm,
                      "serve_scenario": scenario, "lm_train": lm_train,
                      "lm_serve_moe": lm_moe, "lm_train_moe": lm_train_moe}))
    print(json.dumps({"end_to_end": e2e, "bound_inputs": [
        {k: r[k] for k in ("name", "bytes", "operations", "shape") if k in r} for r in rows]}))
    print(f"[done] wall time {time.perf_counter() - wall0!r} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
