#!/usr/bin/env python3
"""The mesh paths over the cards of one host: a mesh of n distinct cards
against the same n shards on one card (bits and metrics equal), both timed.

    python3 tools/mesh_measure.py [seq] [sched] [lm] [--seed N] [--out chiprun_out/mesh.jsonl]

``seq`` (the default runs both) — ``seqparallel``; the planner picks it
from the mesh in every case:

  nasa_1030  K=7 (171,133) hard, BSC p=0.03, B=1024 frames of 1024 info
             bits (T=1030): 1 and 2 shards;
  nasa_1152  the same with 1146 info bits (T=1152): 1, 2 and 4 shards
             (288 steps a shard at 4: the packed re-scan);
  long       K=3 (7,5), one stream of 65536 info bits, BSC p=0.01
             (T=65538, ``examples/long_context.py``): 1, 2 and 3 shards;

each through ``decode(DecodeRequest(...), ctx=DecodeContext(mesh=...))``
over a (1, n) (data, model) mesh of n cells on cuda:0 and, where the host
has n cards, of n distinct cards.  Time: the host clock around one decode
that ends in a synchronize of every card, 5 rounds after one warm-up, every
round printed, beside the cards' names and power limits.

``sched`` — the slot-sharded ``StreamScheduler`` at the ``STREAM``
deployment weak-scaled over n = 1, 2, 4 ``data`` shards (n x 64 slots,
chunk 64, depth 5K, 512 rows buffered a stream, ``fused_packed`` on raw
symbols): n x 64 streams of 16384 info bits (K=7 (171,133), BSC p=0.03),
one wave, each fed by a producer of seeded arrivals of 1-512 rows, over an
(n, 1) (data, model) mesh of n cells on cuda:0 and of n distinct cards.
Every stream's bits and metric must be equal on the two.  Time: the host
clock from the first open to the last result (through a synchronize of
every card), 2 rounds each, one card and n cards in turns, after a warm-up
run; tick time p50/p99 from the scheduler's histogram.

``lm`` (run only when named) — the LM's data-parallel mesh path at
qwen2.5-3b's full width, weak-scaled over n = 1, 2, 4 ``data`` shards, on
an (n, 1) (data, model) mesh of n cells on cuda:0 and of n distinct cards:
``ServeEngine(mesh=)`` on 4 rows a shard (prompts of 16, 32 greedy tokens:
the tokens must be equal on the two; generate time of 32 and of 16 tokens,
3 rounds each after a warm-up, decode time a token from their
difference, tokens/s) and the data-parallel train step on 2 x 4096 rows a
shard (AdamW, remat "full", lr 1e-4, warm-up 2: the step-0 loss equal on
the two, the updated parameters within 1e-2 relative L2 a leaf — the tied
embedding's bf16 scatter-add gradient sums in no fixed order on the card —
and the later losses within rtol 1e-3; step time, host clock through a
synchronize of every card, of steps 1-2 after step 0, tokens/s).  Each
card's name and power limit are printed.

Exits non-zero without a card or when a check fails.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

SRC = Path(__file__).resolve().parent.parent / "src"

#: ``sched``: shard counts, info bits a stream, timed rounds a layout
SCHED_SHARDS = (1, 2, 4)
SCHED_INFO = 16384
SCHED_ROUNDS = 2

#: ``lm``: shard counts; serving rows a shard, prompt, new tokens; training
#: rows a shard, sequence, steps (the first untimed); the equality bounds
LM_SHARDS = (1, 2, 4)
LM_SERVE_ROWS, LM_PROMPT, LM_NEW = 4, 16, 32
LM_TRAIN_ROWS, LM_SEQ, LM_STEPS = 2, 4096, 3
LM_PARAM_TOL, LM_LOSS_RTOL = 1e-2, 1e-3

#: (label, K, B, info bits, BSC flip probability, shard counts)
CASES = (("nasa_1030", 7, 1024, 1024, 0.03, (1, 2)),
         ("nasa_1152", 7, 1024, 1146, 0.03, (1, 2, 4)),
         ("long", 3, 1, 65536, 0.01, (1, 2, 3)))


def _sync_all(torch):
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def _rounds(torch, fn, rounds: int = 5) -> list:
    """Host ms of ``fn()`` through a synchronize of every card, after one
    warm-up call."""
    fn()
    _sync_all(torch)
    out = []
    for _ in range(rounds):
        t0 = time.perf_counter()
        fn()
        _sync_all(torch)
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def _run_scheduler(torch, spec, rx, mesh, seed):
    """One drained run of the deployment scheduler over ``mesh`` on the
    host symbols ``rx`` (streams x rows x n_out): (results, wall s, ticks,
    tick-time histogram)."""
    import numpy as np

    from repro_torch.configs import STREAM
    from repro_torch.stream import GeneratorProducer, StreamScheduler

    def arrivals(table, rng):
        i = 0
        while i < len(table):
            n = int(rng.integers(1, 513))
            yield table[i:i + n]
            i += n

    _sync_all(torch)
    t0 = time.perf_counter()
    sched = StreamScheduler(spec, n_slots=STREAM.n_slots_for(mesh.shape["data"]),
                            chunk=STREAM.chunk, depth=STREAM.depth(spec.code),
                            backend="fused_packed", inputs="received",
                            max_buffered=STREAM.max_buffered, mesh=mesh)
    for i, table in enumerate(rx):
        sched.open_stream(f"s{i}", producer=GeneratorProducer(
            arrivals(table, np.random.default_rng([seed, i]))))
    results = sched.run()
    _sync_all(torch)
    wall = time.perf_counter() - t0
    return results, wall, sched.stats.ticks, sched.telemetry.metrics.histogram(
        "stream_tick_seconds")


def _sched_rows(torch, args, cards, n_cards) -> list:
    """The ``sched`` case's rows (see the module doc); raises on a check."""
    import numpy as np

    from repro_torch.core import CODE_K7_NASA
    from repro_torch.decode import CodecSpec
    from repro_torch.kernels.common import launch_counts, plain_counts, reset_counts
    from repro_torch.launch.mesh import make_mesh

    card0 = torch.device("cuda", 0)
    gen = torch.Generator(device=card0).manual_seed(args.seed)
    spec = CodecSpec(code=CODE_K7_NASA, metric="hard")
    rows = []
    for n in SCHED_SHARDS:
        if n > n_cards:
            print(f"[sched] {n} shards: not run, {n_cards} cards")
            continue
        bits = torch.randint(0, 2, (64 * n, SCHED_INFO), generator=gen, device=card0,
                             dtype=torch.int32)
        rx = spec.channel(gen, spec.encode(bits), flip_prob=0.03).to(torch.float32).cpu().numpy()
        layouts = {"one_card": make_mesh((n, 1), ("data", "model"), devices=[card0] * n),
                   "n_cards": make_mesh((n, 1), ("data", "model"))}
        _run_scheduler(torch, spec, rx[:, :1024], layouts["n_cards"], args.seed)  # warm-up
        row = dict(case="sched", shards=n, streams=64 * n, n_slots=64 * n, info=SCHED_INFO)
        results = {}
        for _ in range(SCHED_ROUNDS):
            for name, mesh in layouts.items():
                _sync_all(torch)
                reset_counts()
                got, wall, ticks, hist = _run_scheduler(torch, spec, rx, mesh, args.seed)
                if plain_counts or launch_counts["traceback_packed"] != n * ticks:
                    raise RuntimeError(f"sched {name} x{n}: launches {dict(launch_counts)}, "
                                       f"plain calls {dict(plain_counts)}")
                if name in results and any(
                        not np.array_equal(got[s][0], results[name][s][0])
                        or got[s][1] != results[name][s][1] for s in got):
                    raise RuntimeError(f"sched {name} x{n}: rounds differ")
                results[name] = got
                row.setdefault(f"{name}_wall_s", []).append(wall)
                row.setdefault(f"{name}_info_bits_per_s", []).append(
                    64 * n * SCHED_INFO / wall)
                row.setdefault(f"{name}_tick_s", []).append(
                    dict(p50=hist.quantile(0.5), p99=hist.quantile(0.99), mean=hist.mean))
                row[f"{name}_ticks"] = ticks
        for s, (b, m) in results["one_card"].items():
            got_b, got_m = results["n_cards"][s]
            if not (np.array_equal(b, got_b) and m == got_m):
                raise RuntimeError(f"sched x{n}: stream {s} differs on {n} cards")
        print(f"[sched] {n} shards x 64 slots, {64 * n} streams x {SCHED_INFO} info bits: one "
              f"card {row['one_card_wall_s']} s, {n} cards {row['n_cards_wall_s']} s; info "
              f"bits/s {row['one_card_info_bits_per_s']} vs {row['n_cards_info_bits_per_s']}; "
              f"ticks {row['one_card_ticks']}; tick s {row['one_card_tick_s']} vs "
              f"{row['n_cards_tick_s']}; bits equal ({cards[:n]})")
        rows.append(row)
    return rows


def _free(torch):
    import gc

    gc.collect()
    _sync_all(torch)
    torch.cuda.empty_cache()


def _lm_rows(torch, args, cards, n_cards) -> list:
    """The ``lm`` case's rows (see the module doc); raises on a check."""
    import statistics as st

    from repro_torch.configs import get_arch
    from repro_torch.data import SyntheticLM
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import build
    from repro_torch.serve import ServeEngine
    from repro_torch.train.optimizer import adamw, cosine_warmup
    from repro_torch.train.train_loop import make_train_step, read_metrics
    from repro_torch.train.tree import tree_leaves

    card0 = torch.device("cuda", 0)
    model = build(get_arch("qwen2_5_3b"), device=card0)
    rows = []
    for n in LM_SHARDS:
        if n > n_cards:
            print(f"[lm] {n} shards: not run, {n_cards} cards")
            continue
        layouts = {"one_card": make_mesh((n, 1), ("data", "model"), devices=[card0] * n),
                   "n_cards": make_mesh((n, 1), ("data", "model"))}
        row = dict(case="lm", shards=n, serve_rows=LM_SERVE_ROWS * n,
                   train_rows=LM_TRAIN_ROWS * n, seq=LM_SEQ)
        gen = torch.Generator(device=card0).manual_seed(args.seed)
        params = model.init(gen)
        prompts = torch.randint(0, model.cfg.vocab, (LM_SERVE_ROWS * n, LM_PROMPT),
                                generator=gen, device=card0)
        tokens = {}
        for name, mesh in layouts.items():
            engine = ServeEngine(model, params, max_len=LM_PROMPT + LM_NEW, mesh=mesh)
            tokens[name] = engine.generate(prompts, LM_NEW)["tokens"].cpu()
            full = _rounds(torch, lambda: engine.generate(prompts, LM_NEW), 3)
            half = _rounds(torch, lambda: engine.generate(prompts, LM_NEW // 2), 3)
            row[f"{name}_generate_ms"], row[f"{name}_generate_half_ms"] = full, half
            row[f"{name}_decode_ms_per_token"] = (st.median(full) - st.median(half)) / (
                LM_NEW - LM_NEW // 2)
            row[f"{name}_serve_tokens_per_s"] = LM_SERVE_ROWS * n * LM_NEW / (st.median(full) / 1e3)
            del engine
        if not torch.equal(tokens["one_card"], tokens["n_cards"]):
            raise RuntimeError(f"lm x{n}: served tokens differ on {n} cards")
        del params
        _free(torch)
        batch = SyntheticLM(model.cfg.vocab, LM_SEQ, LM_TRAIN_ROWS * n, seed=args.seed,
                            device=str(card0))(0)
        ref = None
        for name, mesh in layouts.items():
            opt = adamw()
            params = model.init(torch.Generator(device=card0).manual_seed(args.seed))
            state = opt.init(params)
            step = make_train_step(model, opt, cosine_warmup(1e-4, 2, LM_STEPS), mesh=mesh)
            losses, times = [], []
            for i in range(LM_STEPS):
                _sync_all(torch)
                t0 = time.perf_counter()
                params, state, met = step(params, state, batch, i)
                losses.append(read_metrics(met)["loss"])
                _sync_all(torch)
                times.append((time.perf_counter() - t0) * 1e3)
                if i == 0 and ref is None:
                    ref = [p.gather().to("cpu", copy=True) for p in tree_leaves(params)]
                elif i == 0:
                    errs = [((p.gather(card0).float() - r.to(card0).float()).norm()
                             / r.to(card0).float().norm().clamp_min(1e-30)).item()
                            for p, r in zip(tree_leaves(params), ref)]
                    row["max_param_rel_err"] = max(errs)
            row[f"{name}_losses"], row[f"{name}_step_ms"] = losses, times
            row[f"{name}_train_tokens_per_s"] = LM_TRAIN_ROWS * n * LM_SEQ / (
                st.median(times[1:]) / 1e3)
            del params, state, step, met
            _free(torch)
        del ref, batch
        _free(torch)
        one, many = row["one_card_losses"], row["n_cards_losses"]
        if one[0] != many[0] or row["max_param_rel_err"] > LM_PARAM_TOL or any(
                abs(a - b) > LM_LOSS_RTOL * abs(a) for a, b in zip(one, many)):
            raise RuntimeError(f"lm x{n}: training on {n} cards differs from one card: {row}")
        print(f"[lm] qwen2.5-3b over {n} shards: serving {LM_SERVE_ROWS * n} x {LM_PROMPT} + "
              f"{LM_NEW} tokens, tokens equal; decode ms a token one card "
              f"{row['one_card_decode_ms_per_token']!r}, {n} cards "
              f"{row['n_cards_decode_ms_per_token']!r}; tokens/s "
              f"{row['one_card_serve_tokens_per_s']!r} vs {row['n_cards_serve_tokens_per_s']!r}; "
              f"training {LM_TRAIN_ROWS * n} x {LM_SEQ}: "
              f"losses {one} vs {many}, updated parameters' largest relative L2 error "
              f"{row['max_param_rel_err']!r}; step ms {row['one_card_step_ms']} vs "
              f"{row['n_cards_step_ms']}; tokens/s {row['one_card_train_tokens_per_s']!r} vs "
              f"{row['n_cards_train_tokens_per_s']!r} ({cards[:n]})")
        rows.append(row)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("cases", nargs="*", help="seq, sched and/or lm (default: seq and sched)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None, help="JSON lines file of the rows")
    args = ap.parse_args(argv)
    args.cases = args.cases or ["seq", "sched"]
    if set(args.cases) - {"seq", "sched", "lm"}:
        ap.error(f"unknown cases {sorted(set(args.cases) - {'seq', 'sched', 'lm'})}")

    import torch

    if not torch.cuda.is_available():
        print("mesh_measure: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    from repro_torch.core import ConvCode
    from repro_torch.decode import CodecSpec, DecodeContext, DecodeRequest, decode
    from repro_torch.kernels import _build
    from repro_torch.kernels.common import launch_counts, plain_counts, reset_counts
    from repro_torch.launch.mesh import make_mesh

    if {"seq", "sched"} & set(args.cases):  # the lm case launches no kernel of the port's
        _build.build_all()
    cards = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()
    n_cards = torch.cuda.device_count()
    print(f"[mesh] {n_cards} cards: {cards}")
    card0 = torch.device("cuda", 0)
    gen = torch.Generator(device=card0).manual_seed(args.seed)
    rows = []
    for label, K, B, n_info, flip, shards in CASES if "seq" in args.cases else ():
        code = ConvCode(K, (0o171, 0o133) if K == 7 else (0b111, 0b101))
        spec = CodecSpec(code=code, metric="hard")
        bits = torch.randint(0, 2, (B, n_info), generator=gen, device=card0, dtype=torch.int32)
        rq = DecodeRequest(spec, received=spec.channel(gen, spec.encode(bits), flip_prob=flip))
        T = spec.n_steps(n_info)
        for n in shards:
            row = dict(case=label, K=K, B=B, T=T, shards=n, steps_a_shard=T // n)
            one = DecodeContext(mesh=make_mesh((1, n), ("data", "model"), devices=[card0] * n))
            want = decode(rq, ctx=one)
            row["one_card_ms"] = _rounds(torch, lambda: decode(rq, ctx=one))
            if n <= n_cards:
                many = DecodeContext(mesh=make_mesh((1, n), ("data", "model")))
                _sync_all(torch)
                reset_counts()
                got = decode(rq, ctx=many)
                _sync_all(torch)
                row["launches"] = dict(launch_counts)
                if (got.plan.backend != "seqparallel" or want.plan.backend != "seqparallel"
                        or plain_counts or got.bits.device != want.bits.device
                        or not torch.equal(got.bits, want.bits)
                        or not torch.equal(got.path_metric, want.path_metric)):
                    print(f"mesh_measure: {label} over {n} cards differs from {n} shards on "
                          f"one card (backends {got.plan.backend}/{want.plan.backend}, "
                          f"plain calls {dict(plain_counts)})", file=sys.stderr)
                    return 1
                row["n_cards_ms"] = _rounds(torch, lambda: decode(rq, ctx=many))
            print(f"[mesh] {label} K={K} B={B} T={T} over {n} shards of {T // n} steps: one "
                  f"card {row['one_card_ms']} ms (median "
                  f"{statistics.median(row['one_card_ms'])!r}), {n} cards "
                  f"{row.get('n_cards_ms', 'not run')} (median "
                  f"{statistics.median(row['n_cards_ms']) if 'n_cards_ms' in row else None!r}); "
                  f"launches on {n} cards {row.get('launches')} ({cards[0]})")
            rows.append(row)
    if "sched" in args.cases:
        rows += _sched_rows(torch, args, cards, n_cards)
    if "lm" in args.cases:
        rows += _lm_rows(torch, args, cards, n_cards)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "w") as f:
            for row in rows:
                f.write(json.dumps(dict(row, cards=cards)) + "\n")
    print(json.dumps({"ok": True, "cards": cards, "rows": len(rows)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
