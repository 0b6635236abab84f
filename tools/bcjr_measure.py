#!/usr/bin/env python3
"""Measurements of the two BCJR kernels (``src/repro_torch/csrc/bcjr.cu``)
and of the turbo decode around them, on one NVIDIA card.

    python3 tools/bcjr_measure.py sweep split [--out FILE.jsonl]
    python3 tools/bcjr_measure.py turbo [--src DIR] [--out FILE.jsonl]

``sweep``  times launch choices -- threads a lane (G), consumer threads a
           block, steps a chunk (Tc) -- for every trellis size S at the two
           shapes the turbo decoders give the kernels: the repo's N=512
           block (B=8192, T=512) and LTE's N=6144 block (B=1024, T=6144),
           one-parity codes (F=3), random features.  Each variant is a
           build of the source with its own ``BCJR_CHOICES`` table (a
           translation unit that defines it and includes ``bcjr.cu``); its
           outputs are held against the package's build exactly, and that
           against the plain version on the first (alpha) or last (beta) 64
           steps.  It prints, for each S and kernel, the choice with the
           least sum over the two shapes of time over that shape's best,
           and the time of the choice the source builds.
``split``  times builds with part of the producers' work cut out
           (``BCJR_CUT``: 1 the next chunk's dots, 2 the staging, 4 the
           alpha's A_t stores, 7 all three; their outputs are wrong) at S=8,
           at both shapes, with the source's own launch choice.
``turbo``  splits turbo decodes (N=512 B=8192 and N=6144 B=1024, Eb/N0 1 dB,
           6 iterations, early exit) of the ``repro_torch`` under ``--src``
           (default: this checkout's) into the SISO passes and the rest:
           device time from CUDA events around each pass and each
           iteration, host time to enqueue each, and the host's wait in the
           iteration's read-back.  Run it on two checkouts to compare them.

Times are CUDA events, the median of 3 rounds after one warm-up (``turbo``:
of 5 decodes after one).  Builds go to ``src/repro_torch/_build/measure/``.
"""
from __future__ import annotations

import argparse
import ctypes
import itertools
import json
import math
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
SHAPES = {"turbo512": (8192, 512), "lte6144": (1024, 6144)}
#: an RSC code of each size, one parity (F = 3) as the LTE constituent
CODES = {2: (2, 0b11, (0b10,)), 4: (3, 0b111, (0b101,)), 8: (4, 0o13, (0o15,)),
         16: (5, 0o23, (0o35,)), 32: (6, 0o43, (0o75,)), 64: (7, 0o133, (0o171,))}
STATES = (2, 4, 8, 16, 32, 64)
CUTS = (1, 2, 4, 7)
CHECK_STEPS = 64


def _candidates(S):
    """(G, consumers, Tc) the kernels take at S: 2..32 threads a lane, 1..8
    states a thread."""
    groups = [g for g in (2, 4, 8, 16, 32) if g <= S and S // g <= 8]
    return list(itertools.product(groups, (128, 256), (8, 16, 32)))


def _ms(fn, rounds=3):
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
    return statistics.median(out)


def _build_variants(variants):
    """{name: ctypes library} of ``bcjr.cu`` built under each name's
    ``#define`` lines, at most one nvcc a core at a time."""
    from repro_torch.kernels import _build

    out_dir = _build.BUILD_ROOT / "measure"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = _build.CSRC / "bcjr.cu"
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    todo, running, libs = list(variants.items()), [], {}
    while todo or running:
        while todo and len(running) < (os.cpu_count() or 4):
            name, defines = todo.pop(0)
            unit = out_dir / f"bcjr_{name}.cu"
            unit.write_text("".join(f"#define {d}\n" for d in defines) + f'#include "{src}"\n')
            so = out_dir / f"libbcjr_{name}.so"
            running.append((name, so, subprocess.Popen(
                [_build._nvcc(), *flags, "-o", str(so), str(unit)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        name, so, proc = running.pop(0)
        text, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{text}")
        libs[name] = ctypes.CDLL(str(so))
    return libs


def _launchers(lib):
    fa = lib.bcjr_alpha_scan_launch
    fa.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fb = lib.bcjr_beta_llr_scan_launch
    fb.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    return fa, fb


def _kernel_runs(lib, code, feat, alphas, final, llr):
    """{kernel: fn() -> error code} of one library on one input."""
    import torch

    from repro_torch.kernels import bcjr

    fa, fb = _launchers(lib)
    op = bcjr.operands(code, feat.device)
    T, F, B = feat.shape
    S = code.n_states
    st = torch.cuda.current_stream().cuda_stream
    return {
        "alpha": lambda: fa(op.rows.data_ptr(), op.b0_row.data_ptr(), op.b1_row.data_ptr(),
                            feat.data_ptr(), alphas.data_ptr(), final.data_ptr(), B, T, F, S,
                            op.n_rows, st),
        "beta": lambda: fb(op.rows.data_ptr(), op.c0_row.data_ptr(), op.c1_row.data_ptr(),
                           op.w0_row.data_ptr(), op.w1_row.data_ptr(), op.reg_bit.data_ptr(),
                           alphas.data_ptr(), feat.data_ptr(), llr.data_ptr(), B, T, F, S,
                           op.n_rows, 0, st),
    }


def _table(pick):
    """A BCJR_CHOICES initializer: ``pick(S, kernel) -> (G, consumers, Tc)``."""
    rows = ("{" + ", ".join("{%d, %d, %d}" % pick(S, k) for k in ("alpha", "beta")) + "}"
            for S in STATES)
    return "BCJR_CHOICES {" + ", ".join(rows) + "}"


def sweep(gen, fh):
    import torch

    from repro_torch.kernels import bcjr
    from repro_torch.siso import RSCCode

    cands = {S: _candidates(S) for S in STATES}
    n_var = max(map(len, cands.values()))
    libs = _build_variants({f"choice{i}": [_table(lambda S, k: cands[S][i % len(cands[S])])]
                            for i in range(n_var)})
    built = {}  # kernel -> (S -> time of the package's own build) per shape
    for S in STATES:
        code = RSCCode(*CODES[S])
        rows = {"alpha": [], "beta": []}
        for shape, (B, T) in SHAPES.items():
            feat = torch.randn((T, code.n_features, B), generator=gen, device="cuda") * 2
            ref_a = bcjr.bcjr_alpha_scan(code, feat)
            ref_l = bcjr.bcjr_beta_llr_scan(code, ref_a[0], feat, False)
            plain_a = bcjr.bcjr_alpha_scan_plain(code, feat[:CHECK_STEPS])
            plain_l = bcjr.bcjr_beta_llr_scan_plain(code, ref_a[0][-CHECK_STEPS:],
                                                    feat[-CHECK_STEPS:], False)
            if not (torch.equal(ref_a[0][:CHECK_STEPS], plain_a[0])
                    and torch.equal(ref_l[-CHECK_STEPS:], plain_l)):
                raise SystemExit(f"S={S} {shape}: the package's kernels differ from plain")
            for kernel, fn in (("alpha", lambda: bcjr.bcjr_alpha_scan(code, feat)),
                               ("beta", lambda: bcjr.bcjr_beta_llr_scan(code, ref_a[0], feat))):
                built.setdefault(kernel, {}).setdefault(S, {})[shape] = _ms(fn)
            alphas, final = torch.empty_like(ref_a[0]), torch.empty_like(ref_a[1])
            llr = torch.empty_like(ref_l)
            for i, cfg in enumerate(cands[S]):
                runs = _kernel_runs(libs[f"choice{i}"], code, feat, alphas, final, llr)
                for kernel, fn in runs.items():
                    if kernel == "beta":
                        alphas.copy_(ref_a[0])
                    err = fn()
                    torch.cuda.synchronize()
                    if err:  # more shared memory than a block has
                        print(f"[skip] S={S} {shape} {kernel} {cfg}: error {err}")
                        continue
                    same = (torch.equal(alphas, ref_a[0]) and torch.equal(final, ref_a[1])
                            if kernel == "alpha" else torch.equal(llr, ref_l))
                    if not same:
                        raise SystemExit(f"S={S} {shape} {kernel} {cfg}: differs")
                    ms = _ms(fn)
                    row = dict(mode="sweep", S=S, shape=shape, B=B, T=T, kernel=kernel,
                               group=cfg[0], consumers=cfg[1], chunk=cfg[2], ms=ms,
                               us_per_step=ms * 1e3 / T)
                    rows[kernel].append(row)
                    fh.write(json.dumps(row) + "\n")
            del feat, ref_a, ref_l, alphas, final, llr
        for kernel, krows in rows.items():
            best = {s: min(r["ms"] for r in krows if r["shape"] == s) for s in SHAPES}
            score = {}
            for r in krows:
                key = (r["group"], r["consumers"], r["chunk"])
                score.setdefault(key, []).append(r["ms"] / best[r["shape"]])
            pick = min((k for k, v in score.items() if len(v) == len(SHAPES)),
                       key=lambda k: sum(score[k]))
            mine = {r["shape"]: r["ms"] for r in krows
                    if (r["group"], r["consumers"], r["chunk"]) == pick}
            own = built[kernel][S]
            print(f"[pick] S={S} {kernel}: G={pick[0]} consumers={pick[1]} Tc={pick[2]} | "
                  + " ".join(f"{s} {mine[s]!r} ms (best {best[s]!r}, source's own choice "
                             f"{own[s]!r})" for s in SHAPES))
            fh.write(json.dumps(dict(mode="pick", S=S, kernel=kernel, group=pick[0],
                                     consumers=pick[1], chunk=pick[2], ms=mine, best=best,
                                     built_ms=own)) + "\n")


def split(gen, fh):
    import torch

    from repro_torch.siso import RSC_K4_LTE

    libs = _build_variants({"as_is": [], **{f"cut{c}": [f"BCJR_CUT {c}"] for c in CUTS}})
    code = RSC_K4_LTE
    for shape, (B, T) in SHAPES.items():
        feat = torch.randn((T, code.n_features, B), generator=gen, device="cuda") * 2
        alphas = torch.empty((T, code.n_states, B), device="cuda")
        final = torch.empty((code.n_states, B), device="cuda")
        llr = torch.empty((T, B), device="cuda")
        for name, lib in libs.items():
            for kernel, fn in _kernel_runs(lib, code, feat, alphas, final, llr).items():
                if name == "cut4" and kernel == "beta":
                    continue  # the beta scan stores no A_t
                if fn():
                    raise SystemExit(f"{name} {kernel}: launch failed")
                ms = _ms(fn)
                row = dict(mode="split", shape=shape, B=B, T=T, variant=name, kernel=kernel,
                           ms=ms, us_per_step=ms * 1e3 / T)
                fh.write(json.dumps(row) + "\n")
                print(f"[split] {shape} {kernel} {name}: {ms!r} ms = {ms * 1e3 / T!r} us a step")


def turbo(gen, fh, src):
    import torch

    from repro_torch.siso import RSC_K4_LTE, QPPInterleaver, TurboSpec, turbo_decode
    from repro_torch.siso import turbo as turbo_mod

    passes, iters = [], []
    op, iteration = turbo_mod.bcjr_llr_op, turbo_mod._iteration

    def timed(store, fn):
        def wrapped(*args, **kwargs):
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            h0 = time.perf_counter()
            e0.record()
            out = fn(*args, **kwargs)
            e1.record()
            store.append((e0, e1, h0, time.perf_counter()))
            return out
        return wrapped

    turbo_mod.bcjr_llr_op = timed(passes, op)
    turbo_mod._iteration = timed(iters, iteration)
    snr = 1.0 + 10 * math.log10(1 / 3)  # Eb/N0 1 dB at rate 1/3
    for label, B, qpp in (("turbo512", 8192, (512, 31, 64)), ("lte6144", 1024, (6144, 263, 480))):
        spec = TurboSpec(code=RSC_K4_LTE, interleaver=QPPInterleaver(*qpp))
        bits = torch.randint(0, 2, (B, spec.block_len), generator=gen, device="cuda",
                             dtype=torch.int32)
        llrs = spec.channel_llrs(spec.channel(gen, spec.encode(bits), snr_db=snr))
        runs = []
        for rep in range(6):
            passes.clear()
            iters.clear()
            torch.cuda.synchronize()
            h0 = time.perf_counter()
            res = turbo_decode(spec, llrs, device="cuda")
            torch.cuda.synchronize()
            wall = (time.perf_counter() - h0) * 1e3
            n = res.iterations_run
            pass_dev = sum(a.elapsed_time(b) for a, b, _, _ in passes)
            iter_dev = sum(a.elapsed_time(b) for a, b, _, _ in iters)
            pass_host = sum(h1 - h0_ for _, _, h0_, h1 in passes) * 1e3
            iter_host = sum(h1 - h0_ for _, _, h0_, h1 in iters) * 1e3
            # host time from each iteration's enqueue to the next one's (or
            # the decode's end): the read-back's wait and the bookkeeping
            ends = [h1 for _, _, _, h1 in iters]
            starts = [h0_ for _, _, h0_, _ in iters[1:]] + [h0 + wall / 1e3]
            readback = sum(b - a for a, b in zip(ends, starts)) * 1e3
            row = dict(mode="turbo", src=str(src), shape=label, B=B, N=spec.block_len,
                       iterations=n, wall_ms=wall, passes=len(passes), pass_device_ms=pass_dev,
                       iteration_device_ms=iter_dev, rest_device_ms=iter_dev - pass_dev,
                       pass_enqueue_ms=pass_host, rest_enqueue_ms=iter_host - pass_host,
                       readback_wait_ms=readback)
            if rep:  # the first is the warm-up
                runs.append(row)
                fh.write(json.dumps(row) + "\n")
        med = {k: statistics.median(r[k] for r in runs) for k in runs[0]
               if isinstance(runs[0][k], float)}
        print(f"[turbo] {src} {label} B={B} iterations={runs[0]['iterations']} median of "
              f"{len(runs)}: " + ", ".join(f"{k} {v!r}" for k, v in med.items()))
    turbo_mod.bcjr_llr_op, turbo_mod._iteration = op, iteration


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("modes", nargs="+", choices=("sweep", "split", "turbo"))
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the directory that holds the repro_torch to measure (turbo)")
    ap.add_argument("--out", default=None, help="append every row here as JSON lines")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("bcjr_measure: no CUDA device available", file=sys.stderr)
        return 1
    src = Path(args.src).resolve()
    sys.path.insert(0, str(src))
    from repro_torch.kernels import _build

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    if {"sweep", "split"} & set(args.modes):
        for line in _build.build_all()["bcjr"].compiler_output.splitlines():
            if "ptxas info" in line:
                print(f"[build] {line.strip()}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    with open(args.out or os.devnull, "a") as fh:
        for mode in args.modes:
            if mode == "turbo":
                turbo(gen, fh, src)
            else:
                (sweep if mode == "sweep" else split)(gen, fh)
    return 0


if __name__ == "__main__":
    sys.exit(main())
