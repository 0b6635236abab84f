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

``tp`` (run only when named) — tensor-parallel serving over the host's
cards.  qwen3-moe-30b-a3b at all 48 layers over a (1, 4) (data, model)
mesh of four distinct cards (heads, KV heads, vocab and 32 of 128 experts
a card): the weights drawn block by block on their cards
(``Model.init_on_mesh``: no card ever holds a whole leaf, let alone the
~120e9-byte model), each card's bytes and peak beside the blocks it holds;
``ServeEngine`` on 4 prompts of 16, 32 greedy tokens: no host sync a token
(``sanitized()``, 32 against 16 tokens), two calls bit-equal, generate time
of 32 and 16 tokens (2 rounds each after a warm-up) and decode time a
token from their difference; teacher forcing on the mesh at capacity
factor 64 (prefill of 16 then a decode step against a prefill over all 17,
bf16 and float32 compute over the bf16 caches; the routes of both passes
recorded, the rows whose routes agree held to (0.25, 0.05) and (0.05,
0.02) (atol, rtol)).  Then qwen2.5-3b at full width over (1, n), n = 1,
2, 4: one card's one-device engine, the (1, n) mesh of n cells on cuda:0
and of n distinct cards — the tokens equal on the last two, their
equality with one device's reported — and each one's decode time a token.

Exits non-zero without a card or when a check fails.
"""
from __future__ import annotations

import argparse
import json
import math
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

#: ``tp``: the MoE's (arch, mesh), qwen2.5's model-axis sizes, the
#: teacher-forcing capacity factor and tolerances (atol, rtol) by compute dtype
TP_MOE = ("qwen3_moe_30b_a3b", (1, 4))
TP_SHARDS = (1, 2, 4)
TP_TF_CAPACITY = 64.0
TP_TF_TOL = {"bfloat16": (0.25, 0.05), "float32": (0.05, 0.02)}

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


def _host_syncs(fn):
    from repro_torch.analysis import sanitized

    with sanitized(transfer_guard=None, debug_nans=False) as rep:
        out = fn()
    return out, rep.host_syncs, dict(rep.sync_sites)


def _gen_times(torch, engine, prompts) -> dict:
    """generate of LM_NEW and LM_NEW // 2 tokens, 2 rounds each after a
    warm-up: the rounds and the decode time a token from their medians."""
    full = _rounds(torch, lambda: engine.generate(prompts, LM_NEW), 2)
    half = _rounds(torch, lambda: engine.generate(prompts, LM_NEW // 2), 2)
    return {"generate_ms": full, "generate_half_ms": half,
            "decode_ms_per_token": (statistics.median(full) - statistics.median(half))
            / (LM_NEW - LM_NEW // 2),
            "tokens_per_s": LM_SERVE_ROWS * LM_NEW / (statistics.median(full) / 1e3)}


def _tf_on_mesh(torch, model, params, toks, mesh, dtype) -> dict:
    """Teacher forcing on ``mesh`` at TP_TF_CAPACITY: prefill(S) + decode
    against a prefill over S+1, the routes of both passes' last position."""
    import dataclasses

    from repro_torch.models import moe as moe_mod
    from repro_torch.models.model_zoo import Model

    cfg = model.cfg
    cfg = dataclasses.replace(cfg, compute_dtype=dtype, moe=dataclasses.replace(
        cfg.moe, capacity_factor=TP_TF_CAPACITY))
    m = Model(cfg=cfg, part=model.part, param_specs=model.param_specs, device=model.device)
    B, S1 = toks.shape
    routes, orig = [], moe_mod.route

    def record(probs, k):
        vals, idx = orig(probs, k)
        routes.append(idx[:, -1].sort(-1).values)
        return vals, idx

    moe_mod.route = record
    try:
        with torch.inference_mode():
            full, _ = m.prefill(params, {"tokens": toks}, m.init_cache(B, S1, mesh=mesh),
                                mesh=mesh)
            caches = m.init_cache(B, S1, mesh=mesh)
            m.prefill(params, {"tokens": toks[:, :-1]}, caches, mesh=mesh)
            dec, _ = m.decode_step(params, toks[:, -1:], torch.full(
                (B,), S1 - 1, dtype=torch.int32, device=toks.device), caches, mesh=mesh)
    finally:
        moe_mod.route = orig
    L = cfg.n_layers
    flips = [(layer, r) for layer in range(L) for r in range(B)
             if not torch.equal(routes[layer][r], routes[2 * L + layer][r])]
    atol, rtol = TP_TF_TOL[dtype]
    full, dec = full.float(), dec.float()
    over = ((dec - full).abs() > atol + rtol * full.abs()).sum(-1).tolist()
    rows = sorted({r for _, r in flips})
    return {"max_abs_diff": (dec - full).abs().max().item(), "over_by_row": over,
            "argmax_equal": (dec.argmax(-1) == full.argmax(-1)).tolist(),
            "route_flips": flips, "atol": atol, "rtol": rtol,
            "over_in_rows_with_equal_routes": sum(n for r, n in enumerate(over)
                                                  if r not in rows)}


def _tp_rows(torch, args, cards, n_cards) -> list:
    """The ``tp`` case's rows (see the module doc); raises on a check."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import build
    from repro_torch.models.common import spec_leaves
    from repro_torch.serve import ServeEngine
    from repro_torch.train.tree import tree_leaves

    card0 = torch.device("cuda", 0)
    rows = []
    arch, shape = TP_MOE
    n = shape[0] * shape[1]
    if n > n_cards:
        print(f"[tp] {arch} over {shape}: not run, {n_cards} cards")
    else:
        model = build(get_arch(arch), device=card0)
        mesh = make_mesh(shape, ("data", "model"))
        devices = list(mesh.devices.flat)
        whole = sum(s.nbytes for s in spec_leaves(model.param_specs))
        held = {d: 0 for d in devices}
        for spec, sh in zip(spec_leaves(model.param_specs),
                            tree_leaves(model.param_shardings(mesh))):
            for d in devices:
                held[d] += math.prod(sh.shard_shape(spec.shape)) * spec.dtype.itemsize
        _free(torch)
        live = {d: torch.cuda.memory_allocated(d) for d in devices}
        for d in devices:
            torch.cuda.reset_peak_memory_stats(d)
        t0 = time.perf_counter()
        params = model.init_on_mesh(mesh, args.seed)
        _sync_all(torch)
        init_s = time.perf_counter() - t0
        placed = {str(d): torch.cuda.memory_allocated(d) - live[d] for d in devices}
        place_peak = {str(d): torch.cuda.max_memory_allocated(d) - live[d] for d in devices}
        row = dict(case="tp", arch=model.cfg.name, layers=model.cfg.n_layers,
                   mesh=dict(mesh.shape), whole_bytes=whole,
                   blocks_bytes={str(d): b for d, b in held.items()}, placed_bytes=placed,
                   placing_peak_bytes=place_peak, init_s=init_s)
        print(f"[tp] {model.cfg.name} ({model.cfg.n_layers} layers, {whole} bytes whole) over "
              f"{dict(mesh.shape)} of {[str(d) for d in devices]}: drawn in {init_s!r} s; bytes "
              f"a card {placed} (its blocks {row['blocks_bytes']}), peak while placing "
              f"{place_peak} ({cards[:n]})")
        if any(v > 2 * held[d] or v >= whole // 2 for d, v in zip(devices, place_peak.values())):
            raise RuntimeError(f"tp: a card held more than its blocks while placing: {row}")
        gen = torch.Generator(device=card0).manual_seed(args.seed)
        prompts = torch.randint(0, model.cfg.vocab, (LM_SERVE_ROWS, LM_PROMPT), generator=gen,
                                device=card0)
        engine = ServeEngine(model, params, max_len=LM_PROMPT + LM_NEW, mesh=mesh)
        engine.generate(prompts, LM_NEW)
        _sync_all(torch)
        out, syncs, sites = _host_syncs(lambda: engine.generate(prompts, LM_NEW))
        _, syncs_half, _ = _host_syncs(lambda: engine.generate(prompts, LM_NEW // 2))
        again = engine.generate(prompts, LM_NEW)
        row.update(host_syncs_generate=syncs, host_syncs_half=syncs_half, sync_sites=sites,
                   generate_bit_equal=bool(torch.equal(out["tokens"], again["tokens"])),
                   **_gen_times(torch, engine, prompts))
        toks = torch.randint(0, model.cfg.vocab, (LM_SERVE_ROWS, LM_PROMPT + 1), generator=gen,
                             device=card0)
        for dtype in TP_TF_TOL:
            row[f"teacher_forcing_{dtype}"] = _tf_on_mesh(torch, model, engine.params, toks,
                                                          mesh, dtype)
        row["peak_bytes"] = {str(d): torch.cuda.max_memory_allocated(d) - live[d]
                             for d in devices}
        print(f"[tp] {model.cfg.name} over {n} cards: host syncs in generate {syncs} for "
              f"{LM_NEW} tokens, {syncs_half} for {LM_NEW // 2} ({sites}); two calls bit-equal "
              f"{row['generate_bit_equal']}; decode {row['decode_ms_per_token']!r} ms a token "
              f"(generate ms {row['generate_ms']}, {LM_NEW // 2} tokens "
              f"{row['generate_half_ms']}), {row['tokens_per_s']!r} tokens/s; peak a card "
              f"{row['peak_bytes']}; teacher forcing bf16 {row['teacher_forcing_bfloat16']}, "
              f"float32 {row['teacher_forcing_float32']} ({cards[:n]})")
        if syncs != syncs_half or not row["generate_bit_equal"]:
            raise RuntimeError(f"tp: syncs a token or two calls differ: {row}")
        for dtype in TP_TF_TOL:
            tf = row[f"teacher_forcing_{dtype}"]
            kept = [r for r in range(LM_SERVE_ROWS) if r not in {r for _, r in tf["route_flips"]}]
            if tf["over_in_rows_with_equal_routes"] or (
                    dtype == "float32" and not all(tf["argmax_equal"][r] for r in kept)):
                raise RuntimeError(f"tp: teacher forcing {dtype} beyond tolerance: {tf}")
        rows.append(row)
        del engine, params, out, again
        _free(torch)
    model = build(get_arch("qwen2_5_3b"), device=card0)
    gen = torch.Generator(device=card0).manual_seed(args.seed)
    params = model.init(gen)
    prompts = torch.randint(0, model.cfg.vocab, (LM_SERVE_ROWS, LM_PROMPT), generator=gen,
                            device=card0)
    one = ServeEngine(model, params, max_len=LM_PROMPT + LM_NEW)
    want = one.generate(prompts, LM_NEW)["tokens"]
    one_times = _gen_times(torch, one, prompts)
    del one
    for n in TP_SHARDS:
        if n > n_cards:
            print(f"[tp] qwen2.5-3b over (1, {n}): not run, {n_cards} cards")
            continue
        row = dict(case="tp", arch=model.cfg.name, mesh={"data": 1, "model": n},
                   one_device=one_times)
        tokens = {}
        for name, mesh in (("one_card", make_mesh((1, n), ("data", "model"),
                                                  devices=[card0] * n)),
                           ("n_cards", make_mesh((1, n), ("data", "model")))):
            engine = ServeEngine(model, params, max_len=LM_PROMPT + LM_NEW, mesh=mesh)
            tokens[name] = engine.generate(prompts, LM_NEW)["tokens"]
            row[name] = _gen_times(torch, engine, prompts)
            del engine
            _free(torch)
        row["tokens_equal_one_card_n_cards"] = bool(torch.equal(tokens["one_card"],
                                                                tokens["n_cards"].to(card0)))
        row["rows_equal_one_device"] = int((tokens["n_cards"].to(card0) == want).all(1).sum())
        print(f"[tp] qwen2.5-3b over (1, {n}): decode ms a token one device "
              f"{one_times['decode_ms_per_token']!r}, {n} cells of one card "
              f"{row['one_card']['decode_ms_per_token']!r}, {n} cards "
              f"{row['n_cards']['decode_ms_per_token']!r}; tokens/s "
              f"{one_times['tokens_per_s']!r} / {row['one_card']['tokens_per_s']!r} / "
              f"{row['n_cards']['tokens_per_s']!r}; tokens equal one card vs {n} cards "
              f"{row['tokens_equal_one_card_n_cards']}, rows equal one device "
              f"{row['rows_equal_one_device']}/{LM_SERVE_ROWS} ({cards[:n]})")
        if not row["tokens_equal_one_card_n_cards"]:
            raise RuntimeError(f"tp: qwen2.5-3b tokens differ on {n} cards")
        rows.append(row)
    del params
    _free(torch)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("cases", nargs="*",
                    help="seq, sched, lm and/or tp (default: seq and sched)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None, help="JSON lines file of the rows")
    args = ap.parse_args(argv)
    args.cases = args.cases or ["seq", "sched"]
    if set(args.cases) - {"seq", "sched", "lm", "tp"}:
        ap.error(f"unknown cases {sorted(set(args.cases) - {'seq', 'sched', 'lm', 'tp'})}")

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

    if {"seq", "sched"} & set(args.cases):  # lm and tp launch no kernel of the port's
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
    if "tp" in args.cases:
        rows += _tp_rows(torch, args, cards, n_cards)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "w") as f:
            for row in rows:
                f.write(json.dumps(dict(row, cards=cards)) + "\n")
    print(json.dumps({"ok": True, "cards": cards, "rows": len(rows)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
