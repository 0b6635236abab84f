#!/usr/bin/env python3
"""``seqparallel`` over the cards of one host: a mesh of n distinct cards
against the same n shards on one card (bits and metric equal), both timed.

    python3 tools/mesh_measure.py [--seed N] [--out chiprun_out/mesh.jsonl]

Cases (the planner picks ``seqparallel`` from the mesh in every one):

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
round printed, beside the cards' names and power limits.  Exits non-zero
without a card or when a check fails.
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None, help="JSON lines file of the rows")
    args = ap.parse_args(argv)

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

    _build.build_all()
    cards = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()
    n_cards = torch.cuda.device_count()
    print(f"[mesh] {n_cards} cards: {cards}")
    card0 = torch.device("cuda", 0)
    gen = torch.Generator(device=card0).manual_seed(args.seed)
    rows = []
    for label, K, B, n_info, flip, shards in CASES:
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
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "w") as f:
            for row in rows:
                f.write(json.dumps(dict(row, cards=cards)) + "\n")
    print(json.dumps({"ok": True, "cards": cards, "rows": len(rows)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
