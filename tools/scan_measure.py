#!/usr/bin/env python3
"""Measurements of the ACS scan kernels (``src/repro_torch/csrc/viterbi_scan.cu``),
the survivor walks (``csrc/survivors.cu``) and ``texpand`` at the shapes their
paths give them, on one NVIDIA card.

    python3 tools/scan_measure.py device split paths peak sass [--src DIR] [--out FILE.jsonl]
    python3 tools/scan_measure.py sweep wide square [--out FILE.jsonl]

``device``  device-only time of #3 (the packed session's chunk), #7 (the
            ``streaming`` chunk and both ``parallel`` re-scans), #8 (one
            texpand step), #1 (the main path), #4 (both passes of the pinned
            P=8 tiled NASA frame, the ``parallel`` NASA frame's transfer
            matrices, pass 1 of a planned one-frame tiled decode, B·P·S = 512
            lanes, and the K=3 long stream's ``parallel`` transfer matrices)
            #6 (the ``fused`` decode's scan), #2 (the walks of the main
            path, 8192 x 1006, of the planned NASA decode, 1024 x 1030, of
            the ``parallel`` NASA decode, 1024 x 1030, and of a packed
            session's push, its 128 x 128 ring), #5 (the pinned P=8 NASA
            frame's walk, 524288 lanes, and the K=3 long stream's planned
            ``tiled`` walk, P=128, 512 lanes) and #11 (the seven combines of
            the ``parallel`` NASA decode's associative scan, 1024 to 8192
            products of 64 x 64, and the first of the K=3 long stream's, 4 x
            4), each on the operands its decode hands the wrapper: a CUDA
            graph of N captured wrapper calls,
            replayed, its CUDA-event time over N (N a power of two set by the
            kernel's device time, so that the graph's own launch cost weighs
            the same on every checkout).  Beside it the back-to-back
            time of N eager calls (CUDA events around them), whose floor is
            the wrapper's host time, and that host time (the host clock over
            the N calls, before the synchronize).  Each row carries a digest
            of its outputs, so the rows of two checkouts can be held equal.
``split``   device-only times of #3 and #7 at the stream chunk's shape, of #1
            at the main path's and of #6 at the ``fused`` decode's, on builds
            with part of a step cut out (their outputs are wrong): the
            features' load, the branch-metric dots, the survivor stores and,
            for the block kernel, the step's barrier.  A kernel of
            the chain design is cut through ``VITERBI_CUT``; the block
            kernel's body, which ran #1, #3, #4, #6 and #7 in earlier
            checkouts, by exact text substitutions on a copy of the source.
            #5 at both of its ``device`` shapes with its slab copies (loads)
            cut, its stores cut, or both: the staged walk through
            ``TRACEBACK_CUT``, the direct walk of earlier checkouts by text
            substitutions.  #2 at the main path's shape the same way (the
            staged full walk only), and #11's square kernel at the widest
            NASA combine with its copies cut, its candidates cut, or both
            (``MINPLUS_CUT``).
``paths``   the paths that launch #1-#7, end to end as ``chip_smoke.py``
            drives them: the ``fused_packed`` decode (8192 x 1000 info bits,
            K=7 hard), the NASA frame (1024 x 1024 info bits) as planned,
            with 8 tiles pinned and through ``parallel`` (chunk 64), the K=3
            long stream (65536 info bits) as planned (``tiled``, P=128) and
            through ``parallel`` (chunk 512), the ``fused`` decode and the texpand-driven decode of
            ``chip_smoke.py`` on the ``fused_packed`` symbols (CUDA events,
            median of 5 after a warm-up); the packed
            64k session (128 streams x 65536 info bits, K=7 hard, chunk 64) and
            the ``streaming`` decode of the same symbols (host clock around
            each, after a synchronize).  Host-bound paths vary between runs:
            run two checkouts in turns in one call.
``peak``    the peak device memory of the ``parallel`` decodes above the
            tensors live before each (``max_memory_allocated`` after a
            reset, as ``chip_smoke.py`` reads it): the K=3 long stream's
            (chunk 512) three times in a fresh process, then the NASA
            frame's (chunk 64) once, then the long stream's twice more, so
            that what the allocator's cache left behind shows apart from
            what the tree allocates.  Run it as a process of its own.
``sweep``   every launch choice of the chain kernel's carried entries (#3,
            #7: G threads a lane, L lanes a block, Tc steps a tile) at every S
            of VITERBI_CHOICES, each a build of the source with its own table
            (a translation unit that defines it and includes
            ``viterbi_scan.cu``).  Shapes: the session's (128 lanes x 64 steps,
            folded hard weights, F=2, packed) and the ``streaming`` chunk's
            (bm tables, F=M, unpacked) at every S; both ``parallel`` re-scans
            (17408 x 64 at S=64, 129 x 512 at S=4).
``wide``    the same for the state-0 and windowed entries (#1, #4, #6) and
            VITERBI_WIDE_CHOICES.  Shapes at S=64: #1 at 8192 x 1006 (folded
            hard, F=2), #4 at the four shapes of ``device``, #6 at 8192 x
            1006 (bm tables, F=M=4); at every other S, #1 and #6 at
            524288/S lanes x 1006 steps and #4 at 4 x 524288/S lanes x 129
            steps (folded hard, carried seeds, windows of 128 or 129 steps).
            The pick is by #1 and #4; #6's times are printed beside it.
            Both sweeps hold each choice's outputs exactly against the
            package's build, and that against the plain version, and print
            for each S the choice with the least sum over the shapes of its
            time over that shape's best (``sweep``) or of its time
            (``wide``), each shape's best, and the time of the choice the
            source builds.

``square``  the square (min,+) kernel's launch choices (MINPLUS_SQUARE_CHOICE:
            rows of a thread's tile, threads a block, stages of the copy
            ring), each a build of ``minplus.cu`` with its own choice, at the
            seven combines of the ``parallel`` NASA decode and the long
            stream's first, and at 4096 contiguous products (1024 at S=128)
            of every other S; each output held exactly against the
            package's build; per choice the NASA combines' summed time.

``sass``    the SASS of the built scan, survivors and (min,+) libraries
            (cuobjdump): for every chain, wide (packed and unpacked), block,
            walk and (min,+) kernel a digest of its instructions
            (constant-bank offsets masked), so two checkouts' kernels can be
            held equal; for the S=64 chain kernels the step loop's
            instructions a state-step (its body over half its shuffles) and
            their mix, for the S=64 walks the step loop's instructions a step
            (over its shared-memory loads) and for the square (min,+) kernels
            the k loop's instructions a candidate (over its FMNMX).

``--src DIR`` measures the ``repro_torch`` under DIR (default: this
checkout's ``src``), for ``device``, ``split``, ``paths``, ``peak`` and
``sass``; run them on two checkouts in one call to compare them.
Device-only times are the median of 5 replays, back-to-back times of 5
rounds, after a warm-up call.  Builds go to
``<DIR>/repro_torch/_build/measure/``.
"""
from __future__ import annotations

import argparse
import contextlib
import ctypes
import hashlib
import json
import os
import re
import statistics
import subprocess
import sys
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
#: a rate-1/2 code of every trellis size in the chain kernel's table
CODES = {2: (2, (0b11, 0b10)), 4: (3, (0b111, 0b101)), 8: (4, (0o15, 0o17)),
         16: (5, (0o23, 0o35)), 32: (6, (0o53, 0o75)), 64: (7, (0o171, 0o133)),
         128: (8, (0o247, 0o371)), 256: (9, (0o561, 0o753)), 512: (10, (0o1167, 0o1545)),
         1024: (11, (0o3345, 0o3613)), 2048: (12, (0o5723, 0o6265)),
         4096: (13, (0o15621, 0o17363))}
STATES = tuple(CODES)
#: the 64k streams' chunk: 128 streams x 64 steps
STREAM_B, STREAM_T = 128, 64
#: the `parallel` re-scans: the NASA frame at chunk 64 (1024 frames x 17
#: chunks), the K=3 long stream at chunk 512 (129 chunks)
RESCAN = {"rescan_nasa": (64, 17408, 64), "rescan_long": (4, 129, 512)}
MAIN_B, MAIN_T = 8192, 1006
#: the NASA frame: 1024 frames x 1030 steps (1024 info bits, K=7)
NASA_B, NASA_T = 1024, 1030
#: the K=3 long stream: 65536 info bits, one stream
LONG_INFO = 65536
#: lanes x states of #1's shape, the wide sweep's budget at S != 64
WIDE_LANE_STATES = MAIN_B * 64
CUTS = {"features": 1, "dots": 2, "stores": 4, "all": 7}
#: the staged walk's cuts (TRACEBACK_CUT)
WALK_CUTS = {"loads": 1, "stores": 2, "all": 3}
#: the square (min,+) kernel's cuts (MINPLUS_CUT)
MINPLUS_CUTS = {"copies": 1, "candidates": 2, "all": 3}
#: the direct windowed walk's step, cut on a copy: bit -> [(text, replacement)]
DIRECT_WALK_CUTS = {
    1: [("\n      const uint32_t word = static_cast<uint32_t>(\n"
         "          __ldg(packed + (static_cast<size_t>(t >> 5) * B + b) * S + s));\n",
         "\n      const uint32_t word = static_cast<uint32_t>(s) * 0x9E3779B9u + t;\n")],
    2: [("\n      out[t] = s >> (K - 2);\n", "\n"), ("\n      out[t] = 0;\n", "\n")],
}
#: the block kernel's step, cut on a copy: bit -> (text, replacement); a
#: bit's texts that a checkout lacks are skipped (#6's block kernel stored
#: only selects), but every bit must change the text
BLOCK_CUTS = {
    1: [("x_next[f] = live ? row[static_cast<size_t>(t + 1) * F + f] : 0.0f;",
         "x_next[f] = 0.0f;")],
    2: [("        m0 = __fadd_rn(m0, __fmul_rn(__ldg(b0 + s * F + f), xf));\n"
         "        m1 = __fadd_rn(m1, __fmul_rn(__ldg(b1 + s * F + f), xf));\n",
         "        (void)xf;\n")],
    4: [("          if (live)\n"
         "            out[(static_cast<size_t>(t >> 5) * B + b) * S + s] = "
         "static_cast<int32_t>(word[k]);\n", ""),
        ("        if (live) out[(static_cast<size_t>(t) * B + b) * S + s] = "
         "static_cast<int32_t>(take1);\n", ""),
        ("      if (live) out[(static_cast<size_t>(t) * B + b) * S + s] = "
         "static_cast<int32_t>(take1);\n", "")],
    8: [("    __syncthreads();\n    float* tmp = pm_cur;", "    float* tmp = pm_cur;")],
}
BLOCK_VARIANTS = {"features": 1, "dots": 2, "stores": 4, "barrier": 8, "all": 15}


def _smi() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()


def _graph_ms(fn, n: int, rounds: int = 5):
    """(median, rounds) of the device-only time of ``fn()``: ``n`` calls
    captured into one CUDA graph, each replay's event time over ``n``."""
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
    out = []
    for _ in range(rounds):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        graph.replay()
        e1.record()
        torch.cuda.synchronize()
        out.append(e0.elapsed_time(e1) / n)
    del graph
    return statistics.median(out), out


def _eager_ms(fn, n: int, rounds: int = 5):
    """(median back-to-back ms, median host ms) a call: CUDA events around
    ``n`` eager calls, and the host clock over them before the synchronize."""
    import torch

    fn()
    torch.cuda.synchronize()
    dev, host = [], []
    for _ in range(rounds):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        h0 = time.perf_counter()
        for _ in range(n):
            fn()
        h1 = time.perf_counter()
        e1.record()
        torch.cuda.synchronize()
        dev.append(e0.elapsed_time(e1) / n)
        host.append((h1 - h0) * 1e3 / n)
    return statistics.median(dev), statistics.median(host)


def _reps(fn) -> int:
    """Calls a timing takes: the largest power of two from 4 to 256 whose
    calls take at most ~4 ms of device time, from a graph of 4 calls.  A
    graph's own launch cost is spread over its calls, so the count must not
    follow the host's noise: equal kernels get equal counts on every
    checkout."""
    ms = _graph_ms(fn, 4, rounds=3)[0]
    n = 4
    while n < 256 and 2 * n * ms <= 4.0:
        n *= 2
    return n


def _digest(outs) -> list:
    """Shape and int64 sum of the 32-bit words of every output (a tensor or
    a tuple of them)."""
    import torch

    if isinstance(outs, torch.Tensor):
        outs = (outs,)
    return [[list(t.shape), int(t.contiguous().view(torch.int32).to(torch.int64).sum())]
            for t in outs]


def _seeds(gen, B, S):
    """Carried metrics as a stream sees them: small integers, some 1e30."""
    import torch

    pm0 = torch.randint(0, 9, (B, S), generator=gen, device="cuda").float()
    return torch.where(torch.rand((B, S), generator=gen, device="cuda") < 0.3,
                       torch.full_like(pm0, 1e30), pm0)


def _hard(gen, code, B, T):
    """Folded hard weights and features of random bits."""
    import torch

    from repro_torch.kernels import fused_metric_plan

    plan = fused_metric_plan(code, "hard")
    bits = torch.randint(0, 2, (B, T, code.n_out), generator=gen, device="cuda")
    return plan.features(bits).contiguous(), plan.folded("cuda")


def _tables(gen, code, B, T):
    import torch

    return torch.randint(0, 3, (B, T, code.n_symbols), generator=gen, device="cuda").float()


def _device_cases(gen):
    """{label: (kernel name, fn)}: the wrapper calls at their path shapes,
    inputs drawn in a fixed order (the same on every checkout)."""
    from repro_torch.core import ConvCode
    from repro_torch.kernels import texpand, viterbi_scan

    k7, k3 = ConvCode(*CODES[64]), ConvCode(*CODES[4])
    cases = {}
    feats, w = _hard(gen, k7, STREAM_B, STREAM_T)
    pm0 = _seeds(gen, STREAM_B, 64)
    cases["session"] = ("viterbi_scan_packed_carry",
                        lambda: viterbi_scan.viterbi_scan_packed_carry(k7, pm0, feats, *w))
    bm = _tables(gen, k7, STREAM_B, STREAM_T)
    cases["streaming"] = ("viterbi_scan_carry", lambda: viterbi_scan.viterbi_scan_carry(k7, pm0, bm))
    for label, (S, B, T) in RESCAN.items():
        code = k7 if S == 64 else k3
        args = (code, _seeds(gen, B, S), _tables(gen, code, B, T))
        cases[label] = ("viterbi_scan_carry", lambda a=args: viterbi_scan.viterbi_scan_carry(*a))
    pm = _seeds(gen, MAIN_B, 64)
    bm1 = _tables(gen, k7, MAIN_B, 1)[:, 0].contiguous()
    cases["texpand"] = ("texpand", lambda: texpand.texpand(k7, pm, bm1))
    mfeats, mw = _hard(gen, k7, MAIN_B, MAIN_T)
    cases["main"] = ("viterbi_scan_packed",
                     lambda: viterbi_scan.viterbi_scan_packed(k7, mfeats, *mw))
    return cases


def _path_only_cases(gen) -> dict:
    """#6 at the ``fused`` decode's shape (8192 x 1006 bm tables, K=7) and #4
    at the K=3 long stream's ``parallel`` transfer matrices (129 chunks of
    512 steps x 4 unit entries), the rows ``device`` adds to the others."""
    import torch

    from repro_torch.core import ConvCode
    from repro_torch.kernels import fused_metric_plan, ops, viterbi_scan

    k7, k3 = ConvCode(*CODES[64]), ConvCode(*CODES[4])
    bm = _tables(gen, k7, MAIN_B, MAIN_T)
    cases = {"fused": ("viterbi_scan", lambda: viterbi_scan.viterbi_scan(k7, bm))}
    rx = torch.randint(0, 2, (1, 65538, 2), generator=gen, device="cuda", dtype=torch.int32)
    cap = {}
    ops.viterbi_decode_parallel_op(k3, fused_metric_plan(k3, "hard").bm_tables(rx), 512, True,
                                   capture=cap)
    cases["parallel_long_pass1"] = (
        "viterbi_scan_packed_window",
        lambda a=cap["pass1"]: viterbi_scan.viterbi_scan_packed_window(*a))
    return cases


def _window_cases(gen) -> dict:
    """{label: arguments of viterbi_scan_packed_window} as the paths give
    them, captured from the ops on one NASA frame of random bits: both passes
    of the pinned P=8 tiled decode, the ``parallel`` decode's transfer
    matrices (chunk 64, bm tables) and pass 1 of the planned tiled decode of
    its first frame alone (P = default_tiles(1, T, 64), B·P·S = 512 lanes)."""
    import torch

    from repro_torch.core import ConvCode
    from repro_torch.kernels import fused_metric_plan, ops, tiling

    k7 = ConvCode(*CODES[64])
    plan = fused_metric_plan(k7, "hard")
    rx = torch.randint(0, 2, (NASA_B, NASA_T, 2), generator=gen, device="cuda", dtype=torch.int32)
    cases = {}
    cap = {}
    ops.viterbi_decode_tiled_fused(plan, rx, 8, capture=cap)
    cases["pinned_pass1"], cases["pinned_pass2"] = cap["pass1"], cap["pass2"]
    cap = {}
    ops.viterbi_decode_tiled_fused(plan, rx[:1], tiling.default_tiles(1, NASA_T, 64), capture=cap)
    cases["planned_small_pass1"] = cap["pass1"]
    cap = {}
    ops.viterbi_decode_parallel_op(k7, plan.bm_tables(rx), 64, True, capture=cap)
    cases["parallel_pass1"] = cap["pass1"]
    return cases


@contextlib.contextmanager
def _recording(module, name: str, calls: list):
    """``module.name`` appends its arguments to ``calls`` inside (the call
    itself goes on as before)."""
    orig = getattr(module, name)

    def record(*args):
        calls.append(args)
        return orig(*args)
    setattr(module, name, record)
    try:
        yield
    finally:
        setattr(module, name, orig)


def _nasa_rx(gen, code, B, n_info, flip):
    import torch

    from repro_torch.decode import CodecSpec

    spec = CodecSpec(code=code, metric="hard")
    return spec, spec.channel(gen, spec.encode(torch.randint(0, 2, (B, n_info), generator=gen,
                                                             device="cuda", dtype=torch.int32)),
                              flip_prob=flip)


def _captured_cases(gen) -> dict:
    """#2 and #11 on what the decodes hand their wrappers: the planned NASA
    decode's walk (1024 frames, P=1), the ``parallel`` NASA decode's walk and
    its seven combines (chunk 64), the first combine of the K=3 long
    stream's ``parallel`` decode (chunk 512) and the walk of a packed
    session's last push (128 streams, chunk 64, its 128 x 128 ring)."""
    import math

    from repro_torch.core import CODE_K3_STD, CODE_K7_NASA
    from repro_torch.decode import DecodeContext, DecodeRequest, decode
    from repro_torch.kernels import minplus, ops, survivors
    from repro_torch.stream import StreamSession

    def walk(args):
        return "traceback_packed", lambda: survivors.traceback_packed(*args)

    def combine(a, b):
        return "minplus_matmul", lambda: minplus.minplus_matmul(a, b, math.inf)

    cases = {}
    spec, rx = _nasa_rx(gen, CODE_K7_NASA, NASA_B, 1024, 0.03)
    walks = []
    with _recording(survivors, "traceback_packed", walks):
        decode(DecodeRequest(spec, received=rx), ctx=DecodeContext())
    cases["nasa_planned_walk"] = walk(walks[-1])
    for label, code, rx_p, chunk in (("nasa", CODE_K7_NASA, rx, 64),
                                     ("long", CODE_K3_STD, None, 512)):
        if rx_p is None:
            spec_p, rx_p = _nasa_rx(gen, code, 1, LONG_INFO, 0.01)
        else:
            spec_p = spec
        walks, combines = [], []
        with _recording(survivors, "traceback_packed", walks), \
                _recording(ops, "_minplus_unclamped", combines):
            ops.viterbi_decode_parallel_op(code, spec_p.branch_metrics(rx_p), chunk, True)
        combines = [(a, b) for a, b in combines if a.shape[0] * a.shape[1]]
        if label == "nasa":
            cases["parallel_walk"] = walk(walks[-1])
        else:
            combines = combines[:1]
        for i, (a, b) in enumerate(combines):
            cases[f"combine_{label}_{i}"] = combine(a, b)
    walks = []
    srx = _nasa_rx(gen, CODE_K7_NASA, STREAM_B, 2048, 0.03)[1]
    with _recording(survivors, "traceback_packed", walks):
        StreamSession(spec, batch=STREAM_B, chunk=STREAM_T, backend="fused_packed",
                      inputs="received").decode_all(srx)
    cases["session_walk"] = walk(next(a for a in reversed(walks) if a[1].shape[0] == 4))
    return cases


def _walk_cases(gen) -> dict:
    """#2 at the main path's shape (the walk of #1's words from the
    terminated frontier) and #5 at the two tiled walks the paths give it, on
    channel symbols: the NASA frame's with 8 tiles pinned (1024 frames, p =
    0.03: 524288 lanes x 160 steps, S=64) and the K=3 long stream's as
    planned (65536 info bits, p = 0.01, P = default_tiles: 512 lanes x 544
    steps, S=4), each captured from the tiled op the decode runs."""
    import torch

    from repro_torch.core import CODE_K3_STD, CODE_K7_NASA
    from repro_torch.decode import CodecSpec
    from repro_torch.kernels import fused_metric_plan, ops, survivors, tiling, viterbi_scan

    k7 = CODE_K7_NASA
    cases = {}
    mfeats, mw = _hard(gen, k7, MAIN_B, MAIN_T)
    pm, packed = viterbi_scan.viterbi_scan_packed(k7, mfeats, *mw)
    fs = ops._frontier(pm, True)[0]
    cases["main_walk"] = ("traceback_packed",
                          lambda: survivors.traceback_packed(k7, packed, fs, MAIN_T))
    for label, code, B, n_info, flip, tiles in (
            ("pinned_walk", k7, NASA_B, 1024, 0.03, 8),
            ("long_planned_walk", CODE_K3_STD, 1, LONG_INFO, 0.01, None)):
        spec = CodecSpec(code=code, metric="hard")
        rx = spec.channel(gen, spec.encode(torch.randint(0, 2, (B, n_info), generator=gen,
                                                         device="cuda", dtype=torch.int32)),
                          flip_prob=flip)
        P = tiles or tiling.default_tiles(B, rx.shape[1], code.n_states)
        cap = {}
        ops.viterbi_decode_tiled_fused(fused_metric_plan(code, "hard"), rx, P, capture=cap)
        cases[label] = ("traceback_packed_window",
                        lambda a=cap["traceback"]: survivors.traceback_packed_window(*a))
    return cases


def device(gen, fh, src):
    import torch

    from repro_torch.kernels import viterbi_scan

    cases = _device_cases(gen)
    for label, args in _window_cases(gen).items():
        cases[label] = ("viterbi_scan_packed_window",
                        lambda a=args: viterbi_scan.viterbi_scan_packed_window(*a))
    cases.update(_path_only_cases(gen))
    cases.update(_walk_cases(gen))
    cases.update(_captured_cases(gen))
    for label, (name, fn) in cases.items():
        outs = fn()
        torch.cuda.synchronize()
        n = _reps(fn)
        ms, rounds = _graph_ms(fn, n)
        b2b, host = _eager_ms(fn, n)
        row = dict(mode="device", src=str(src), shape=label, kernel=name, device_ms=ms,
                   device_rounds=rounds, back_to_back_ms=b2b, host_ms=host, calls=n,
                   digest=_digest(outs), operands=_operand_shapes(fn))
        if name == "minplus_matmul":
            row.update(_variant(fn))
        fh.write(json.dumps(row) + "\n")
        print(f"[device] {src} {label} {name}: device-only {ms!r} ms, back-to-back {b2b!r} ms, "
              f"host {host!r} ms a call (n={n}); digest {row['digest']}; operands "
              f"{row['operands']}" + (f"; {row['variant']}" if "variant" in row else ""))
        del outs


def _closure_tensors(fn) -> list:
    """The tensors a case's closure holds (its defaults and free variables,
    one level into tuples)."""
    import torch

    vals = list(fn.__defaults__ or ()) + [c.cell_contents for c in fn.__closure__ or ()]
    out = []
    for v in vals:
        for x in (v if isinstance(v, tuple) else (v,)):
            if isinstance(x, torch.Tensor):
                out.append(x)
    return out


def _operand_shapes(fn) -> list:
    return [[list(x.shape), list(x.stride())] for x in _closure_tensors(fn)]


def _variant(fn) -> dict:
    """{"variant": ...} of a (min,+) case where the checkout can say which
    kernel takes it, else {}."""
    from repro_torch.kernels import minplus

    if not hasattr(minplus, "kernel_variant"):
        return {}
    return {"variant": minplus.kernel_variant(*_closure_tensors(fn))}


def _nvcc_all(units: dict, out_dir: Path, build, stem: str = "viterbi_scan") -> dict:
    """{name: ctypes library} of each {name: source text}, at most one nvcc
    a core at a time."""
    out_dir.mkdir(parents=True, exist_ok=True)
    flags = [f for f in build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    todo, running, libs = list(units.items()), [], {}
    while todo or running:
        while todo and len(running) < (os.cpu_count() or 4):
            name, text = todo.pop(0)
            unit = out_dir / f"{stem}_{name}.cu"
            unit.write_text(text)
            so = out_dir / f"lib{stem}_{name}.so"
            running.append((name, so, subprocess.Popen(
                [build._nvcc(), *flags, "-o", str(so), str(unit)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        name, so, proc = running.pop(0)
        text, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{text}")
        libs[name] = ctypes.CDLL(str(so))
    return libs


@contextlib.contextmanager
def _library(lib):
    """The package's viterbi_scan, survivors and minplus wrappers launch
    from ``lib`` inside."""
    from repro_torch.kernels import _build, minplus, survivors, viterbi_scan

    load = _build.load
    _build.load = lambda name: lib
    for m in (viterbi_scan, survivors, minplus):
        m._launcher.cache_clear()
    try:
        yield
    finally:
        _build.load = load
        for m in (viterbi_scan, survivors, minplus):
            m._launcher.cache_clear()


def _substitute(text: str, subs, what: str) -> str:
    """``text`` with each (old, new) of ``subs`` replaced where ``old``
    occurs (at most once); fails when none occurs."""
    hits = 0
    for old, new in subs:
        n = text.count(old)
        if n > 1:
            raise SystemExit(f"split: {what}: {old[:40]!r} occurs {n} times")
        hits += n
        text = text.replace(old, new)
    if not hits:
        raise SystemExit(f"split: {what}: the kernel's text changed ({subs[0][0][:40]!r})")
    return text


def split(gen, fh, src):
    from repro_torch.kernels import _build

    source = (_build.CSRC / "viterbi_scan.cu").read_text()
    # the design that runs each shape's kernel in this source
    designs = {"session": "chain" if "VITERBI_CUT" in source else "block",
               "main": "chain" if "VITERBI_WIDE_CHOICES" in source else "block",
               "fused": "block" if "struct ScanArgs" in source else "chain"}
    designs["streaming"] = designs["session"]
    units = {}
    if "chain" in designs.values():
        units["chain/as_is"] = source
        units.update({f"chain/{k}": f"#define VITERBI_CUT {v}\n#include \"{_build.CSRC}"
                                    f"/viterbi_scan.cu\"\n" for k, v in CUTS.items()})
    if "block" in designs.values():
        units["block/as_is"] = source
        for name, bits in BLOCK_VARIANTS.items():
            text = source
            for bit, subs in BLOCK_CUTS.items():
                if bits & bit:
                    text = _substitute(text, subs, f"block cut {bit}")
            units[f"block/{name}"] = text
    walk_source = (_build.CSRC / "survivors.cu").read_text()
    walk = "staged" if "TRACEBACK_CUT" in walk_source else "direct"
    walk_units = {f"{walk}/as_is": walk_source}
    for name, bits in WALK_CUTS.items():
        if walk == "staged":
            walk_units[f"{walk}/{name}"] = (f"#define TRACEBACK_CUT {bits}\n#include "
                                            f"\"{_build.CSRC}/survivors.cu\"\n")
        else:
            text = walk_source
            for bit, subs in DIRECT_WALK_CUTS.items():
                if bits & bit:
                    text = _substitute(text, subs, f"walk cut {bit}")
            walk_units[f"{walk}/{name}"] = text
    # the full walk (#2) and the square (min,+) kernel (#11) are cut only
    # where the checkout builds them with their cut flags
    full = "bool FULL" in walk_source
    mp_source = (_build.CSRC / "minplus.cu").read_text()
    mp_units = ({"square/as_is": mp_source} | {
        f"square/{k}": f"#define MINPLUS_CUT {v}\n#include \"{_build.CSRC}/minplus.cu\"\n"
        for k, v in MINPLUS_CUTS.items()}) if "MINPLUS_CUT" in mp_source else {}
    libs = _nvcc_all({k.replace("/", "_"): v for k, v in units.items()},
                     _build.BUILD_ROOT / "measure", _build)
    libs.update(_nvcc_all({k.replace("/", "_"): v for k, v in walk_units.items()},
                          _build.BUILD_ROOT / "measure", _build, stem="survivors"))
    libs.update(_nvcc_all({k.replace("/", "_"): v for k, v in mp_units.items()},
                          _build.BUILD_ROOT / "measure", _build, stem="minplus"))
    cases = _device_cases(gen)
    cases["fused"] = _path_only_cases(gen)["fused"]
    cases.update(_walk_cases(gen))
    shapes = [(label, designs[label], units, MAIN_T if label in ("main", "fused") else STREAM_T)
              for label in ("session", "streaming", "main", "fused")]
    shapes += [(label, walk, walk_units, None) for label in ("pinned_walk", "long_planned_walk")]
    if full:
        shapes.append(("main_walk", walk, walk_units, MAIN_T))
    if mp_units:
        cases.update(_captured_cases(gen))
        shapes.append(("combine_nasa_0", "square", mp_units, None))
    for label, design, variants, steps in shapes:
        name, fn = cases[label]
        n = _reps(fn)
        for unit in variants:
            if not unit.startswith(design + "/"):
                continue
            variant = unit.split("/")[1]
            with _library(libs[unit.replace("/", "_")]):
                ms, rounds = _graph_ms(fn, n)
            row = dict(mode="split", src=str(src), design=design, shape=label, kernel=name,
                       variant=variant, device_ms=ms, rounds=rounds)
            if steps:
                row["us_per_step"] = ms * 1e3 / steps
            fh.write(json.dumps(row) + "\n")
            print(f"[split] {src} {design} {label} {name} {variant}: {ms!r} ms"
                  + (f" = {ms * 1e3 / steps!r} us a step" if steps else ""))


def paths(gen, fh, src):
    import torch

    from repro_torch.core import CODE_K3_STD, CODE_K7_NASA
    from repro_torch.decode import CodecSpec, DecodeContext, DecodeRequest, decode
    from repro_torch.stream import StreamSession

    spec = CodecSpec(code=CODE_K7_NASA, metric="hard")
    bits = torch.randint(0, 2, (STREAM_B, 65536), generator=gen, device="cuda",
                         dtype=torch.int32)
    rx = spec.channel(gen, spec.encode(bits), flip_prob=0.03)
    nasa = spec.channel(gen, spec.encode(torch.randint(0, 2, (1024, 1024), generator=gen,
                                                       device="cuda", dtype=torch.int32)),
                        flip_prob=0.03)
    spec3 = CodecSpec(code=CODE_K3_STD, metric="hard")
    long = spec3.channel(gen, spec3.encode(torch.randint(0, 2, (1, 65536), generator=gen,
                                                         device="cuda", dtype=torch.int32)),
                         flip_prob=0.01)
    short = spec.channel(gen, spec.encode(torch.randint(0, 2, (MAIN_B, 1000), generator=gen,
                                                        device="cuda", dtype=torch.int32)),
                         flip_prob=0.03)
    torch.cuda.synchronize()

    def host_s(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    runs = {
        "session": lambda: host_s(lambda: StreamSession(
            spec, batch=STREAM_B, chunk=STREAM_T, backend="fused_packed",
            inputs="received").decode_all(rx)) * 1e3,
        "streaming_decode": lambda: host_s(lambda: decode(
            DecodeRequest(spec, received=rx), ctx=DecodeContext(streaming=True))) * 1e3,
    }
    for label, ctx, n in (("fused_packed", None, 5), ("nasa_planned", DecodeContext(), 3),
                          ("nasa_pinned_p8", DecodeContext(tiles=8), 3)):
        r = DecodeRequest(spec, received=short if label == "fused_packed" else nasa)
        runs[label] = lambda r=r, c=ctx, n=n: _eager_ms(lambda: decode(r, ctx=c), n)[0]
    # the unpacked route (#6 and the plain traceback) and the paper's step
    # driven once a step (#8, 1006 launches), on the fused_packed decode's
    # symbols, as chip_smoke.py times them
    fused = DecodeRequest(spec, received=short)
    bm_t = spec.branch_metrics(short).transpose(0, 1).contiguous()
    runs["fused"] = lambda: _eager_ms(lambda: decode(fused, backend="fused"), 1)[0]
    runs["texpand_driven"] = lambda: _eager_ms(lambda: _texpand_decode(spec.code, bm_t), 1)[0]
    # the long stream as planned: tiled, P = default_tiles (the walk's 512 lanes)
    runs["long_planned"] = lambda: _eager_ms(
        lambda: decode(DecodeRequest(spec3, received=long)), 1)[0]
    for label, r, chunk in (("parallel_nasa", DecodeRequest(spec, received=nasa), 64),
                            ("parallel_long", DecodeRequest(spec3, received=long), 512)):
        runs[label] = lambda r=r, c=chunk: _eager_ms(
            lambda: decode(r, backend="parallel", ctx=DecodeContext(chunk=c)), 1)[0]
    for label, fn in runs.items():
        if label in ("session", "streaming_decode"):
            fn()  # warm-up: builds, caches, first launches
        ms = fn()
        fh.write(json.dumps(dict(mode="paths", src=str(src), path=label, ms=ms)) + "\n")
        print(f"[paths] {src} {label}: {ms!r} ms")


def peak(gen, fh, src):
    import torch

    from repro_torch.core import CODE_K3_STD, CODE_K7_NASA
    from repro_torch.decode import CodecSpec, DecodeContext, DecodeRequest, decode

    spec = CodecSpec(code=CODE_K7_NASA, metric="hard")
    spec3 = CodecSpec(code=CODE_K3_STD, metric="hard")
    nasa = spec.channel(gen, spec.encode(torch.randint(0, 2, (1024, 1024), generator=gen,
                                                       device="cuda", dtype=torch.int32)),
                        flip_prob=0.03)
    long = spec3.channel(gen, spec3.encode(torch.randint(0, 2, (1, LONG_INFO), generator=gen,
                                                         device="cuda", dtype=torch.int32)),
                         flip_prob=0.01)
    runs = {"parallel_long": (DecodeRequest(spec3, received=long), DecodeContext(chunk=512)),
            "parallel_nasa": (DecodeRequest(spec, received=nasa), DecodeContext(chunk=64))}
    for i, label in enumerate(["parallel_long"] * 3 + ["parallel_nasa"] + ["parallel_long"] * 2):
        r, ctx = runs[label]
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        decode(r, backend="parallel", ctx=ctx)
        torch.cuda.synchronize()
        nbytes = torch.cuda.max_memory_allocated() - base
        fh.write(json.dumps(dict(mode="peak", src=str(src), path=label, call=i,
                                 peak_bytes=nbytes)) + "\n")
        print(f"[peak] {src} call {i} {label}: {nbytes} bytes above the live tensors")


def _texpand_decode(code, bm_t):
    """chip_smoke.py's texpand-driven decode: one ``texpand`` launch a step of
    (T, B, M) tables from state 0, then the plain traceback: bits."""
    import torch

    from repro_torch.core.viterbi import _traceback
    from repro_torch.kernels import ops

    T, B, _ = bm_t.shape
    pm = torch.full((B, code.n_states), 1e30, dtype=torch.float32, device=bm_t.device)
    pm[:, 0] = 0.0
    bps = []
    for t in range(T):
        pm, bp = ops.texpand_op(code, pm, bm_t[t])
        bps.append(bp)
    final_state = torch.zeros((B,), dtype=torch.int32, device=bm_t.device)
    return _traceback(code, torch.stack(bps), final_state)[0]


def _candidates(S):
    """(G, L, Tc) the chain kernel takes at S: up to 8 states a thread; a
    group of a warp or less in blocks of 32, 64 or 128 threads, a larger one
    1 or 2 lanes a block (at most 1024 threads); 8, 16, 32 or 64 steps a
    tile."""
    out = []
    for G in (2 ** i for i in range(11)):
        if G > S or S // G > 8:
            continue
        lanes = ([tb // G for tb in (32, 64, 128) if tb >= G] if G <= 32
                 else [L for L in (1, 2) if G * L <= 1024])
        out += [(G, L, Tc) for L in lanes for Tc in (8, 16, 32, 64)]
    return out


def _table(pick):
    """A VITERBI_CHOICES initializer: ``pick(S) -> (G, L, Tc)``."""
    return "VITERBI_CHOICES {" + ", ".join("{%d, %d, %d}" % pick(S) for S in STATES) + "}"


def _sweep_shapes(gen, S):
    """[(label, packed, pick, inputs, want)] at S: inputs (pm0, data, b0, b1,
    rb) and the package's outputs on them, held against the plain version."""
    import torch

    from repro_torch.core import ConvCode
    from repro_torch.kernels import viterbi_scan as vs

    code = ConvCode(*CODES[S])
    shapes = []
    feats, w = _hard(gen, code, STREAM_B, STREAM_T)
    shapes.append(("session", True, True, (_seeds(gen, STREAM_B, S), feats, *w)))
    tw = vs.table_weights(code, "cuda")
    shapes.append(("streaming", False, True,
                   (_seeds(gen, STREAM_B, S), _tables(gen, code, STREAM_B, STREAM_T), *tw)))
    for label, (Sr, B, T) in RESCAN.items():
        if Sr == S:
            shapes.append((label, False, True, (_seeds(gen, B, S), _tables(gen, code, B, T), *tw)))
    out = []
    for label, packed, pick, args in shapes:
        if packed:
            want = vs.viterbi_scan_packed_carry(code, *args)
            plain = vs.viterbi_scan_packed_carry_plain(code, *args)
        else:
            want = vs.viterbi_scan_carry(code, args[0], args[1])
            plain = vs.viterbi_scan_carry_plain(code, args[0], args[1])
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(want, plain)):
            raise SystemExit(f"S={S} {label}: the package's kernel differs from plain")
        out.append((label, packed, pick, args, want))
    return code, out


def sweep(gen, fh):
    import torch

    from repro_torch.kernels import _build
    from repro_torch.kernels import viterbi_scan as vs

    cands = {S: _candidates(S) for S in STATES}
    n_var = max(map(len, cands.values()))
    src = _build.CSRC / "viterbi_scan.cu"
    libs = _nvcc_all({f"choice{i}": "#define " + _table(lambda S: cands[S][i % len(cands[S])])
                      + f"\n#include \"{src}\"\n" for i in range(n_var)},
                     _build.BUILD_ROOT / "measure", _build)
    for S in STATES:
        code, shapes = _sweep_shapes(gen, S)
        rows = []
        for label, packed, pick, (pm0, data, b0, b1, rb), want in shapes:
            B, T, F = data.shape
            table, maps = vs.row_operands(b0, b1, rb)
            final = torch.empty_like(want[0])
            surv = torch.empty_like(want[1])
            own = _graph_ms(
                lambda: (vs.viterbi_scan_packed_carry(code, pm0, data, b0, b1, rb) if packed
                         else vs.viterbi_scan_carry(code, pm0, data)), 5)[0]
            symbol = ("viterbi_scan_packed_carry_launch" if packed
                      else "viterbi_scan_carry_launch")
            for i, cfg in enumerate(cands[S]):
                fn = getattr(libs[f"choice{i}"], symbol)
                fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
                fn.restype = ctypes.c_int
                ptrs = [t.data_ptr() for t in (pm0, data, table, maps, final, surv)]

                def launch(fn=fn, ptrs=ptrs, B=B, T=T, F=F):  # on the current (capture) stream
                    return fn(*ptrs, B, T, F, S, table.shape[0],
                              torch.cuda.current_stream().cuda_stream)
                err = launch()
                torch.cuda.synchronize()
                if err:
                    print(f"[skip] S={S} {label} {cfg}: error {err}")
                    continue
                if not (torch.equal(final, want[0]) and torch.equal(surv, want[1])):
                    raise SystemExit(f"S={S} {label} {cfg}: differs from the package's build")
                ms = _graph_ms(launch, _reps(launch))[0]
                row = dict(mode="sweep", S=S, shape=label, B=B, T=T, group=cfg[0], lanes=cfg[1],
                           tile=cfg[2], ms=ms, us_per_step=ms * 1e3 / T, built_ms=own,
                           pick_shape=pick)
                rows.append(row)
                fh.write(json.dumps(row) + "\n")
        _pick(fh, S, rows)
        del shapes, rows


def _kernel_key(name: str):
    """A mangled scan or walk kernel's name, the same on every checkout, or
    None."""
    m = re.search(r"chain_kernelILi(\d+)ELi(\d+)ELi(\d+)ELb(\d)EEEv", name)
    if m:
        S, G, L, P = m.groups()
        return f"chain S={S} G={G} L={L} {'packed' if P == '1' else 'unpacked'} carried"
    m = re.search(r"wide_kernelILi(\d+)ELi(\d+)ELi(\d+)ELb(\d)E(?:Lb(\d)E)?EEv", name)
    if m:
        S, G, L, W, P = m.groups()
        if P == "0":
            return f"chain S={S} G={G} L={L} unpacked state0"
        return f"chain S={S} G={G} L={L} packed {'window' if W == '1' else 'state0'}"
    m = re.search(r"window_walk_kernelILi(\d+)ELi(\d+)E(?:Lb(\d)ELi(\d)E)?EEv", name)
    if m:
        S, D, full, V = m.groups()
        if full == "1":
            return f"walk packed staged S={S} D={D} V={V}"
        return f"walk window staged S={S} D={D}"
    m = re.search(r"minplus_square_kernelILi(\d+)EEEv", name)
    if m:
        return f"minplus square S={m.group(1)}"
    for kernel, key in (("traceback_window_kernel", "walk window direct"),
                        ("traceback_packed_kernel", "walk packed"),
                        ("minplus_kernel", "minplus general")):
        if kernel in name:
            return key
    m = re.search(r"scan_kernelILi(\d+)E((?:Lb\dE){3})?EEv", name)
    if m:
        flags = m.group(2) or "Lb0ELb0ELb0E"
        return f"block SPT={m.group(1)}" + ("" if flags == "Lb0ELb0ELb0E" else f" {flags}")
    return None


def sass(fh, src):
    from repro_torch.kernels import _build

    tool = Path(_build._nvcc()).parent / "cuobjdump"
    text = "".join(subprocess.run([str(tool), "-sass", str(_build.build_all()[lib].path)],
                                  capture_output=True, text=True, check=True).stdout
                   for lib in ("viterbi_scan", "survivors", "minplus"))
    parts = re.split(r"\n\s*Function : (\S+)\n", text)
    for name, body in zip(parts[1::2], parts[2::2]):
        key = _kernel_key(name)
        if key is None:
            continue
        ins = [(int(a, 16), t) for a, t in re.findall(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", body)]
        norm = "\n".join(re.sub(r"c\[0x0\]\[0x[0-9a-f]+\]", "c[0x0][*]", t) for _, t in ins)
        row = dict(mode="sass", src=str(src), kernel=key, instructions=len(ins),
                   digest=hashlib.sha256(norm.encode()).hexdigest()[:16])
        if key.startswith("chain S=64 "):
            loops = []
            for addr, t in ins:
                m = re.search(r"BRA (0x[0-9a-f]+)", t)
                if m and int(m.group(1), 16) < addr:
                    loop = [x for a, x in ins if int(m.group(1), 16) <= a <= addr]
                    n_shfl = sum("SHFL" in x for x in loop)
                    if n_shfl:
                        loops.append((len(loop) / (n_shfl / 2), len(loop), n_shfl, loop))
            if loops:
                per, n, n_shfl, loop = min(loops)
                ops = {}
                for x in loop:
                    op = re.sub(r"^@!?U?P\w+\s+", "", x).split()[0].split(".")[0]
                    ops[op] = ops.get(op, 0) + 1
                row["step_loop"] = dict(instructions=n, shuffles=n_shfl, per_state_step=per,
                                        ops=dict(sorted(ops.items(), key=lambda kv: -kv[1])))
        # the walks' step loop (one shared-memory load a step) and the square
        # (min,+) kernel's k loop (one FMNMX a candidate) at S=64
        marker = ("LDS" if re.match(r"walk (packed|window) staged S=64 ", key)
                  else "FMNMX" if key == "minplus square S=64" else None)
        if marker:
            row["inner_loop"] = _inner_loop(ins, marker)
        fh.write(json.dumps(row) + "\n")
        loop = row.get("step_loop")
        inner = row.get("inner_loop")
        print(f"[sass] {src} {key}: {len(ins)} instructions, digest {row['digest']}"
              + (f"; step loop {loop['instructions']} instructions, {loop['shuffles']} shuffles, "
                 f"{loop['per_state_step']!r} a state-step, {loop['ops']}" if loop else "")
              + (f"; inner loop {inner['instructions']} instructions, {inner['marker']} "
                 f"{inner['marked']}, {inner['per_marked']!r} a {inner['marker']}, "
                 f"{inner['ops']}" if inner else ""))


def _inner_loop(ins, marker: str):
    """Of the loops (backward branches) of ``ins`` that hold ``marker``
    instructions, the one with the fewest instructions per marker: its size,
    marker count, instructions per marker and op mix."""
    best = None
    for addr, t in ins:
        m = re.search(r"BRA (0x[0-9a-f]+)", t)
        if not (m and int(m.group(1), 16) < addr):
            continue
        loop = [x for a, x in ins if int(m.group(1), 16) <= a <= addr]
        ops = {}
        for x in loop:
            op = re.sub(r"^@!?U?P\w+\s+", "", x).split()[0].split(".")[0]
            ops[op] = ops.get(op, 0) + 1
        if ops.get(marker) and (best is None or len(loop) / ops[marker] < best["per_marked"]):
            best = dict(instructions=len(loop), marker=marker, marked=ops[marker],
                        per_marked=len(loop) / ops[marker],
                        ops=dict(sorted(ops.items(), key=lambda kv: -kv[1])))
    return best


def _pick(fh, S, rows, relative=True):
    """Print and record, for S, the choice with the least sum over the shapes
    of its time over that shape's best (``relative``) or of its time, each
    shape's best and the time of the package's own build."""
    best = {}
    for r in rows:
        best[r["shape"]] = min(best.get(r["shape"], r["ms"]), r["ms"])
    score = {}
    for r in rows:
        if r["pick_shape"]:
            score.setdefault((r["group"], r["lanes"], r["tile"]), []).append(
                r["ms"] / best[r["shape"]] if relative else r["ms"])
    n_pick = len({r["shape"] for r in rows if r["pick_shape"]})
    pick = min((k for k, v in score.items() if len(v) == n_pick), key=lambda k: sum(score[k]))
    mine = {r["shape"]: r["ms"] for r in rows if (r["group"], r["lanes"], r["tile"]) == pick}
    argbest = {s: next((r["group"], r["lanes"], r["tile"]) for r in rows
                       if r["shape"] == s and r["ms"] == b) for s, b in best.items()}
    own = {r["shape"]: r["built_ms"] for r in rows}
    print(f"[pick] S={S}: G={pick[0]} L={pick[1]} Tc={pick[2]} score "
          f"{sum(score[pick])!r} | " + " ".join(
              f"{s} {mine.get(s)!r} ms (best {best[s]!r} at {argbest[s]}, package's "
              f"build {own[s]!r})" for s in best))
    fh.write(json.dumps(dict(mode="pick", S=S, group=pick[0], lanes=pick[1], tile=pick[2],
                             ms=mine, best=best, best_choice=argbest, built_ms=own)) + "\n")


#: MINPLUS_SQUARE_CHOICE candidates: (rows of a thread's tile, threads a
#: block, stages); the first is the source's own
SQUARE_CHOICES = ((4, 256, 2), (4, 256, 3), (8, 128, 2), (8, 128, 3))


def sweep_square(gen, fh):
    import math

    import torch

    from repro_torch.kernels import _build, minplus

    src = _build.CSRC / "minplus.cu"
    libs = _nvcc_all({f"square{i}": "#define MINPLUS_SQUARE_CHOICE {%d, %d, %d}\n" % c
                      + f"#include \"{src}\"\n" for i, c in enumerate(SQUARE_CHOICES)},
                     _build.BUILD_ROOT / "measure", _build, stem="minplus")
    cases = {k: v for k, v in _captured_cases(gen).items() if v[0] == "minplus_matmul"}
    for S in (2, 4, 8, 16, 32, 64, 128):
        n = 1024 if S == 128 else 4096
        a, b = (torch.randn((n, S, S), generator=gen, device="cuda") for _ in range(2))
        cases[f"square_{S}"] = ("minplus_matmul",
                                lambda a=a, b=b: minplus.minplus_matmul(a, b, math.inf))
    want = {label: fn() for label, (_, fn) in cases.items()}
    totals = {}
    for i, choice in enumerate(SQUARE_CHOICES):
        with _library(libs[f"square{i}"]):
            for label, (_, fn) in cases.items():
                got = fn()
                torch.cuda.synchronize()
                if not torch.equal(got.view(torch.int32), want[label].view(torch.int32)):
                    raise SystemExit(f"square {choice} {label}: differs from the package's build")
                ms = _graph_ms(fn, _reps(fn))[0]
                fh.write(json.dumps(dict(mode="square", choice=list(choice), shape=label,
                                         device_ms=ms)) + "\n")
                print(f"[square] {choice} {label}: {ms!r} ms")
                if label.startswith("combine_nasa"):
                    totals[choice] = totals.get(choice, 0.0) + ms
    for choice, ms in totals.items():
        print(f"[square] {choice}: the NASA combines {ms!r} ms"
              + (" (the source's choice)" if choice == SQUARE_CHOICES[0] else ""))
        fh.write(json.dumps(dict(mode="square_total", choice=list(choice), device_ms=ms)) + "\n")


def _wide_candidates(S):
    """(G, L, Tc) the wide entries take at S: up to 8 states a thread; a group
    of a warp or less in blocks of 32, 64, 128 or 256 threads, a larger one 1
    or 2 lanes a block (at most 1024 threads); 32 or 64 steps a tile."""
    out = []
    for G in (2 ** i for i in range(11)):
        if G > S or S // G > 8:
            continue
        lanes = ([tb // G for tb in (32, 64, 128, 256) if tb >= G] if G <= 32
                 else [L for L in (1, 2) if G * L <= 1024])
        out += [(G, L, Tc) for L in lanes for Tc in (32, 64)]
    return out


#: the wide entry of each length of arguments after ``code``
WIDE_ENTRIES = {4: "viterbi_scan_packed", 7: "viterbi_scan_packed_window", 1: "viterbi_scan"}


def _wide_shapes(gen, S):
    """[(label, args)] at S, each the arguments after ``code`` of
    viterbi_scan_packed (4 of them), viterbi_scan_packed_window (7) or
    viterbi_scan (1)."""
    import torch

    from repro_torch.core import ConvCode

    code = ConvCode(*CODES[S])
    B = MAIN_B if S == 64 else WIDE_LANE_STATES // S
    feats, w = _hard(gen, code, B, MAIN_T)
    shapes = [("main", (feats, *w))]
    if S == 64:
        shapes += [(label, args[1:]) for label, args in _window_cases(gen).items()]
    else:
        Bw = 4 * WIDE_LANE_STATES // S
        fw, ww = _hard(gen, code, Bw, 129)
        lo = torch.zeros((Bw,), dtype=torch.int32, device="cuda")
        hi = torch.where(torch.arange(Bw, device="cuda") % 8 == 7, 129, 128).int()
        shapes.append(("window", (_seeds(gen, Bw, S), fw, *ww, lo, hi)))
    shapes.append(("fused", (_tables(gen, code, B, MAIN_T),)))
    return code, shapes


def sweep_wide(gen, fh):
    import torch

    from repro_torch.kernels import _build
    from repro_torch.kernels import viterbi_scan as vs

    cands = {S: _wide_candidates(S) for S in STATES}
    n_var = max(map(len, cands.values()))
    src = _build.CSRC / "viterbi_scan.cu"

    def table(pick):
        return ("VITERBI_WIDE_CHOICES {" + ", ".join("{%d, %d, %d}" % pick(S) for S in STATES)
                + "}")
    libs = _nvcc_all({f"wide{i}": "#define VITERBI_WIDE_ONLY\n#define "
                      + table(lambda S: cands[S][i % len(cands[S])])
                      + f"\n#include \"{src}\"\n" for i in range(n_var)},
                     _build.BUILD_ROOT / "measure", _build)
    for S in STATES:
        code, shapes = _wide_shapes(gen, S)
        rows = []
        for label, args in shapes:
            name = WIDE_ENTRIES[len(args)]
            window = len(args) == 7
            fn = getattr(vs, name)
            want = fn(code, *args)
            plain = getattr(vs, name + "_plain")(code, *args)
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(want, plain)):
                raise SystemExit(f"S={S} {label}: the package's kernel differs from plain")
            del plain
            own = _graph_ms(lambda: fn(code, *args), 5)[0]
            if name == "viterbi_scan":
                pm0, (data, (b0, b1, rb)), win = None, (args[0],
                                                        vs.cached_table_weights(code, "cuda")), ()
            else:
                pm0, (data, b0, b1, rb), win = ((args[0], args[1:5], args[5:]) if window
                                                else (None, args, ()))
            B, T, F = data.shape
            table_t, maps = vs.row_operands(b0, b1, rb)
            final = torch.empty_like(want[0])
            surv = torch.empty_like(want[1])
            ptrs = [t.data_ptr() for t in (pm0, data, table_t, maps, *win, final, surv)
                    if t is not None]
            for i, cfg in enumerate(cands[S]):
                launch_fn = getattr(libs[f"wide{i}"], name + "_launch")
                launch_fn.argtypes = ([ctypes.c_void_p] * len(ptrs) + [ctypes.c_int] * 5
                                      + [ctypes.c_void_p])
                launch_fn.restype = ctypes.c_int

                def launch(f=launch_fn, B=B, T=T, F=F):  # on the current (capture) stream
                    return f(*ptrs, B, T, F, S, table_t.shape[0],
                             torch.cuda.current_stream().cuda_stream)
                err = launch()
                torch.cuda.synchronize()
                if err:
                    print(f"[skip] S={S} {label} {cfg}: error {err}")
                    continue
                if not (torch.equal(final, want[0]) and torch.equal(surv, want[1])):
                    raise SystemExit(f"S={S} {label} {cfg}: differs from the package's build")
                ms = _graph_ms(launch, _reps(launch))[0]
                row = dict(mode="wide", S=S, shape=label, B=B, T=T, group=cfg[0], lanes=cfg[1],
                           tile=cfg[2], ms=ms, us_per_step=ms * 1e3 / T, built_ms=own,
                           pick_shape=name != "viterbi_scan")
                rows.append(row)
                fh.write(json.dumps(row) + "\n")
            del want, final, surv
        # by time, not time over the best: a planned one-frame pass of 0.01 ms
        # must not outweigh the main path and the S-fold passes
        _pick(fh, S, rows, relative=False)
        del shapes, rows
        torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("modes", nargs="+",
                    choices=("device", "split", "paths", "peak", "sweep", "wide", "square",
                             "sass"))
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the directory that holds the repro_torch to measure (all but sweep)")
    ap.add_argument("--out", default=None, help="append every row here as JSON lines")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("scan_measure: no CUDA device available", file=sys.stderr)
        return 1
    # a graph that captured nothing (a launch on another stream) times nothing
    warnings.filterwarnings("error", message="The CUDA Graph is empty")
    src = Path(args.src).resolve()
    if {"sweep", "wide", "square"} & set(args.modes) and src != (ROOT / "src").resolve():
        print("scan_measure: the sweeps measure this checkout's source only", file=sys.stderr)
        return 1
    sys.path.insert(0, str(src))
    from repro_torch.kernels import _build

    print(_smi())
    for line in _build.build_all()["viterbi_scan"].compiler_output.splitlines():
        if "ptxas info" in line or "spill" in line:
            print(f"[build] {line.strip()}")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    with open(args.out or os.devnull, "a") as fh:
        for mode in args.modes:
            gen = torch.Generator(device="cuda").manual_seed(0)
            if mode == "device":
                device(gen, fh, src)
            elif mode == "split":
                split(gen, fh, src)
            elif mode == "paths":
                paths(gen, fh, src)
            elif mode == "peak":
                peak(gen, fh, src)
            elif mode == "sweep":
                sweep(gen, fh)
            elif mode == "sass":
                sass(fh, src)
            elif mode == "square":
                sweep_square(gen, fh)
            else:
                sweep_wide(gen, fh)
    return 0


if __name__ == "__main__":
    sys.exit(main())
