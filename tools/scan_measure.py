#!/usr/bin/env python3
"""Measurements of the ACS scan kernels (``src/repro_torch/csrc/viterbi_scan.cu``)
and of ``texpand`` at the shapes their paths give them, on one NVIDIA card.

    python3 tools/scan_measure.py device split paths [--src DIR] [--out FILE.jsonl]
    python3 tools/scan_measure.py sweep [--out FILE.jsonl]

``device``  device-only time of #3 (the packed session's chunk), #7 (the
            ``streaming`` chunk and both ``parallel`` re-scans), #8 (one
            texpand step) and #1 (the main path): a CUDA graph of N captured
            wrapper calls, replayed, its CUDA-event time over N.  Beside it
            the back-to-back time of N eager calls (CUDA events around them),
            whose floor is the wrapper's host time, and that host time (the
            host clock over the N calls, before the synchronize).  Each row
            carries a digest of its outputs, so the rows of two checkouts can
            be held equal.
``split``   device-only times of #3 and #7 at the stream chunk's shape on
            builds with part of a step cut out (their outputs are wrong):
            the features' load, the branch-metric dots, the survivor stores
            and, for the block kernel, the step's barrier.  A source that
            takes ``VITERBI_CUT`` (the chain kernel) is cut through it; the
            block kernel's body, which runs #3 and #7 up to PR 15, is cut by
            exact text substitutions on a copy of the source.
``paths``   the paths that launch #3 and #7, end to end as ``chip_smoke.py``
            drives them: the packed 64k session (128 streams x 65536 info
            bits, K=7 hard, chunk 64) and the ``streaming`` decode of the same
            symbols (host clock around each, after a synchronize), and the
            ``parallel`` decodes of the NASA frame (1024 x 1024 info bits,
            chunk 64) and the K=3 long stream (65536 info bits, chunk 512)
            (CUDA events, median of 5 after a warm-up).  Host-bound paths
            vary between runs: run two checkouts in turns in one call.
``sweep``   every launch choice of the chain kernel (G threads a lane, L
            lanes a block, Tc steps a tile) at every S of its table, each a
            build of the source with its own ``VITERBI_CHOICES`` (a
            translation unit that defines it and includes ``viterbi_scan.cu``).
            Shapes: the session's (128 lanes x 64 steps, folded hard weights,
            F=2, packed) and the ``streaming`` chunk's (bm tables, F=M,
            unpacked) at every S; both ``parallel`` re-scans (17408 x 64 at
            S=64, 129 x 512 at S=4); for the record, #1's shape (8192 x 1006,
            state-0 init, packed) at S=64.  Each choice's outputs are held
            exactly against the package's build (#1's shape: against #1),
            and that against the plain version.  It prints, for each S, the
            choice with the least sum over the session, streaming and
            re-scan shapes of its time over that shape's best, each shape's
            best, and the time of the choice the source builds.

``--src DIR`` measures the ``repro_torch`` under DIR (default: this
checkout's ``src``), for ``device``, ``split`` and ``paths``; run them on two checkouts
in one call to compare them.  Device-only times are the median of 5
replays, back-to-back times of 5 rounds, after a warm-up call.  Builds go
to ``<DIR>/repro_torch/_build/measure/``.
"""
from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import os
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
CUTS = {"features": 1, "dots": 2, "stores": 4, "all": 7}
#: the block kernel's step, cut on a copy: bit -> (text, replacement)
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
    """Calls a timing takes: enough for ~2 ms of device time, 5 to 200."""
    import torch

    fn()
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    fn()
    e1.record()
    torch.cuda.synchronize()
    return max(5, min(200, int(2.0 / max(e0.elapsed_time(e1), 1e-3))))


def _digest(outs) -> list:
    """Shape and int64 sum of the 32-bit words of every output."""
    import torch

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


def device(gen, fh, src):
    import torch

    for label, (name, fn) in _device_cases(gen).items():
        outs = fn()
        torch.cuda.synchronize()
        n = _reps(fn)
        ms, rounds = _graph_ms(fn, n)
        b2b, host = _eager_ms(fn, n)
        row = dict(mode="device", src=str(src), shape=label, kernel=name, device_ms=ms,
                   device_rounds=rounds, back_to_back_ms=b2b, host_ms=host, calls=n,
                   digest=_digest(outs))
        fh.write(json.dumps(row) + "\n")
        print(f"[device] {src} {label} {name}: device-only {ms!r} ms, back-to-back {b2b!r} ms, "
              f"host {host!r} ms a call (n={n}); digest {row['digest']}")
        del outs


def _nvcc_all(units: dict, out_dir: Path, build) -> dict:
    """{name: ctypes library} of each {name: source text}, at most one nvcc
    a core at a time."""
    out_dir.mkdir(parents=True, exist_ok=True)
    flags = [f for f in build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    todo, running, libs = list(units.items()), [], {}
    while todo or running:
        while todo and len(running) < (os.cpu_count() or 4):
            name, text = todo.pop(0)
            unit = out_dir / f"viterbi_scan_{name}.cu"
            unit.write_text(text)
            so = out_dir / f"libviterbi_scan_{name}.so"
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
    """The package's viterbi_scan wrappers launch from ``lib`` inside."""
    from repro_torch.kernels import _build, viterbi_scan

    load = _build.load
    _build.load = lambda name: lib
    viterbi_scan._launcher.cache_clear()
    try:
        yield
    finally:
        _build.load = load
        viterbi_scan._launcher.cache_clear()


def split(gen, fh, src):
    from repro_torch.kernels import _build

    source = (_build.CSRC / "viterbi_scan.cu").read_text()
    if "VITERBI_CUT" in source:
        design = "chain"
        units = {"as_is": source, **{k: f"#define VITERBI_CUT {v}\n#include \"{_build.CSRC}"
                                        f"/viterbi_scan.cu\"\n" for k, v in CUTS.items()}}
    else:
        design = "block"
        units = {"as_is": source}
        for name, bits in BLOCK_VARIANTS.items():
            text = source
            for bit, subs in BLOCK_CUTS.items():
                for old, new in subs if bits & bit else ():
                    if text.count(old) != 1:
                        raise SystemExit(f"split: the block kernel's text changed ({old[:40]!r})")
                    text = text.replace(old, new)
            units[name] = text
    libs = _nvcc_all(units, _build.BUILD_ROOT / "measure", _build)
    cases = _device_cases(gen)
    for label in ("session", "streaming"):
        name, fn = cases[label]
        n = _reps(fn)
        for variant, lib in libs.items():
            with _library(lib):
                ms, rounds = _graph_ms(fn, n)
            row = dict(mode="split", src=str(src), design=design, shape=label, kernel=name,
                       variant=variant, device_ms=ms, rounds=rounds,
                       us_per_step=ms * 1e3 / STREAM_T)
            fh.write(json.dumps(row) + "\n")
            print(f"[split] {src} {design} {label} {name} {variant}: {ms!r} ms = "
                  f"{ms * 1e3 / STREAM_T!r} us a step")


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
    if S == 64:
        init = torch.full((MAIN_B, S), 1e30, device="cuda")
        init[:, 0] = 0.0
        shapes.append(("main", True, False, (init, *_hard(gen, code, MAIN_B, MAIN_T)[:1], *w)))
    out = []
    for label, packed, pick, args in shapes:
        if label == "main":
            want = vs.viterbi_scan_packed(code, *args[1:])
            plain = vs.viterbi_scan_packed_plain(code, *args[1:])
        elif packed:
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
            built = vs.viterbi_scan_packed if label == "main" else None
            own = _graph_ms(
                (lambda: built(code, data, b0, b1, rb)) if built else
                (lambda: (vs.viterbi_scan_packed_carry(code, pm0, data, b0, b1, rb) if packed
                          else vs.viterbi_scan_carry(code, pm0, data))), 5)[0]
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
        best = {}
        for r in rows:
            best[r["shape"]] = min(best.get(r["shape"], r["ms"]), r["ms"])
        score = {}
        for r in rows:
            if r["pick_shape"]:
                score.setdefault((r["group"], r["lanes"], r["tile"]), []).append(
                    r["ms"] / best[r["shape"]])
        n_pick = len({r["shape"] for r in rows if r["pick_shape"]})
        pick = min((k for k, v in score.items() if len(v) == n_pick), key=lambda k: sum(score[k]))
        mine = {r["shape"]: r["ms"] for r in rows
                if (r["group"], r["lanes"], r["tile"]) == pick}
        argbest = {s: next((r["group"], r["lanes"], r["tile"]) for r in rows
                           if r["shape"] == s and r["ms"] == b) for s, b in best.items()}
        own = {r["shape"]: r["built_ms"] for r in rows}
        print(f"[pick] S={S}: G={pick[0]} L={pick[1]} Tc={pick[2]} score "
              f"{sum(score[pick])!r} | " + " ".join(
                  f"{s} {mine.get(s)!r} ms (best {best[s]!r} at {argbest[s]}, package's "
                  f"build {own[s]!r})" for s in best))
        fh.write(json.dumps(dict(mode="pick", S=S, group=pick[0], lanes=pick[1], tile=pick[2],
                                 ms=mine, best=best, best_choice=argbest, built_ms=own)) + "\n")
        del shapes, rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("modes", nargs="+", choices=("device", "split", "paths", "sweep"))
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
    if "sweep" in args.modes and src != (ROOT / "src").resolve():
        print("scan_measure: sweep measures this checkout's source only", file=sys.stderr)
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
            else:
                sweep(gen, fh)
    return 0


if __name__ == "__main__":
    sys.exit(main())
