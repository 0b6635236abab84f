"""The registered hot-path catalog: what the op-trace contract lint and the
sanitizer check, one entry per registered decoder.

  * the block backends (sequential / parallel / fused / fused_packed /
    tiled / seqparallel / bcjr) run their registry entry on a small seeded
    workload at the reference's catalog shapes (B=2, T=64; ``tiled`` at
    T=128, with 4 tiles pinned so its windowed kernels run; ``seqparallel``
    on a unit ``data`` mesh of the device, as the reference's entry;
    ``bcjr`` at N=64);
  * ``streaming`` covers the stream tick: one steady ``StreamScheduler``
    tick (``fused_packed`` on raw symbols, chunk 32), the loop behind
    sessions and the scheduler;
  * ``sharded_stream`` covers the sharded scheduler's tick
    (``make_sharded_stream_step``, ``fused_packed``, device counters on) on
    a unit ``data`` mesh of the device, as the reference's entry: it must
    launch the packed tick's kernels and call no collective — no transfer
    between shards;
  * ``turbo``'s Python loop carries host-side early-exit bookkeeping, so its
    entry is one turbo iteration (two SISO passes + extrinsic exchange),
    where its device time goes.

Each contract states the path's host-sync bound with the lines that sync
(found by reading the code: the blocking copies and scalar reads one call
makes on the card) and the kernels one call must launch.

``check_hot_paths()`` asserts the catalog covers every registered decoder
(a new backend without an entry fails) and runs each entry twice on
``device``: once to warm up (under ``allow_transfers``), then once under
:func:`sanitized` with the op trace inside.  The report per entry: the
dispatched ops, the host syncs and their lines against the bound, uploads,
rebuilds, kernel launches, plain-version calls, the mesh collectives called
(``parallel/collectives.calls``; any outside the contract's
``allowed_collectives`` is a violation) and contract violations.
"""
from __future__ import annotations

import dataclasses
from collections import Counter
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.analysis.guards import sanitized
from repro_torch.analysis.op_lint import Contract, ContractViolation, trace_contract

#: outputs of a block decode: (bits, path_metric)
_BLOCK_OUTPUTS = 2
#: the stream tick returns host arrays only ({stream: bits})
_TICK_OUTPUTS = 0
#: the sync lines the contracts name (held against the source by the tests)
_LANE_ROW = "repro_torch/kernels/ops.py:204"    # _tile_lane_row: a pageable upload
_TILE_INDEX = "repro_torch/kernels/ops.py:211"  # _tile_data: a pageable upload
_TICK_BITS = "repro_torch/stream/scheduler.py:677"  # the tick's committed bits

Builder = Callable[[torch.device], Tuple[Callable, Sequence]]


@dataclasses.dataclass(frozen=True)
class HotPath:
    """One checkable hot path: its backend, its contract, and a builder
    returning ``(fn, args)`` on a device, inputs placed there."""

    name: str
    backend: str               # the registry entry this path covers
    contract: Contract
    build: Builder
    summary: str = ""


def _conv_spec():
    from repro_torch.configs.paper_viterbi import DECODE_SPEC

    return DECODE_SPEC


def _hard_received(spec, B: int, n_info: int, seed: int) -> np.ndarray:
    """Seeded BSC output of random info bits, made with numpy."""
    rng = np.random.default_rng(seed)
    bits = torch.from_numpy(rng.integers(0, 2, (B, n_info)).astype(np.int32))
    coded = spec.encode(bits).numpy()
    return (coded ^ (rng.random(coded.shape) < 0.03)).astype(np.int32)


def _block_builder(backend: str, B: int = 2, T: int = 64, **ctx_kw) -> Builder:
    """The registry entry on (B, T, M) bm tables built on the device."""

    def build(device):
        from repro_torch.decode import DecodeContext, get_decoder

        spec = _conv_spec()
        ctx = DecodeContext(chunk=32, device=str(device), **ctx_kw)
        dec = get_decoder(backend)
        rx = _hard_received(spec, B, T - spec.n_flush, seed=T)
        bm = spec.branch_metrics(torch.from_numpy(rx).to(device))

        def fn(tables):
            res = dec(spec, tables, ctx=ctx)
            return res.bits, res.path_metric

        return fn, (bm,)

    return build


def _seqparallel_builder(B: int = 2, T: int = 64) -> Builder:
    """The registry entry over a unit ``data`` mesh of the device, sharded
    along ``data`` (the reference's catalog entry): one shard of T steps."""

    def build(device):
        from repro_torch.launch.mesh import make_mesh

        mesh = make_mesh((1,), ("data",), devices=[device])
        return _block_builder("seqparallel", B, T, mesh=mesh, mesh_axis="data")(device)

    return build


def _sharded_tick_builder(chunk: int = 32, B: int = 4) -> Builder:
    """The sharded scheduler's tick (``make_sharded_stream_step``,
    ``fused_packed`` on bm tables) over a unit ``data`` mesh of the device,
    device counters on — the richest per-tick computation, and the one
    whose freedom from transfers between shards the multi-device scaling
    rests on.  Every slot decodes a full chunk of arena rows."""

    def build(device):
        from repro_torch.launch.mesh import make_mesh
        from repro_torch.stream import window as w

        spec = _conv_spec()
        code = spec.code
        mesh = make_mesh((1,), ("data",), devices=[device])
        tick = w.make_sharded_stream_step(code, mesh, "data", chunk=chunk,
                                          backend=w.PACKED_BACKEND, device_metrics=True)
        depth = w.packed_depth(w.default_depth(code))
        rx = torch.from_numpy(_hard_received(spec, B, chunk - spec.n_flush, seed=B))
        bm = spec.branch_metrics(rx.to(device)).reshape(B * chunk, -1)
        arena = torch.cat([torch.zeros_like(bm[:chunk]), bm])  # the zero prefix first
        idx = torch.arange(chunk, chunk + B * chunk, dtype=torch.int32,
                           device=device).reshape(B, chunk)
        active = torch.ones((B,), dtype=torch.bool, device=device)
        state = w.init_stream_state(code, B, depth, chunk, packed=True, device=device)
        counters = w.init_device_counters(B, device)

        def fn(arena, idx, active, pm, ring, *ctr):
            state, bits, delta, out_ctr = tick(
                (arena,), (idx,), (active,), w.StreamState(pm=(pm,), ring=(ring,)),
                w.DeviceCounters(*((c,) for c in ctr)))
            return (state.pm[0], state.ring[0], bits[0], delta[0]) + tuple(c[0] for c in out_ctr)

        return fn, (arena, idx, active, state.pm, state.ring, *counters)

    return build


def _stream_tick_builder(chunk: int = 32, n_slots: int = 4, n_chunks: int = 4) -> Builder:
    """One steady tick of a StreamScheduler (``fused_packed`` on raw symbols):
    every stream's rows are submitted, admitted and uploaded by the first
    (warm-up) tick, so the checked tick only gathers, steps and commits."""

    def build(device):
        from repro_torch.stream import StreamScheduler

        spec = _conv_spec()
        sched = StreamScheduler(spec, n_slots=n_slots, chunk=chunk, backend="fused_packed",
                                inputs="received", device=str(device))
        rx = _hard_received(spec, n_slots, chunk * n_chunks, seed=chunk)
        for i in range(n_slots):
            sched.open_stream(f"s{i}")
            sched.submit_chunk(f"s{i}", rx[i])
        return sched.step, ()

    return build


def _bcjr_builder(B: int = 2, N: int = 64) -> Builder:
    def build(device):
        from repro_torch.decode import CodecSpec, DecodeContext, get_decoder
        from repro_torch.siso import RSC_K4_LTE

        spec = CodecSpec(code=RSC_K4_LTE, metric="soft", terminated=False)
        ctx = DecodeContext(device=str(device))
        dec = get_decoder("bcjr")
        rng = np.random.default_rng(N)
        llr = rng.standard_normal((B, N, 1 + spec.code.n_parity)).astype(np.float32)

        def fn(llr_coded):
            res = dec(spec, llr_coded, ctx=ctx)
            return res.bits, res.path_metric

        return fn, (torch.from_numpy(llr).to(device),)

    return build


def _turbo_iteration_builder(B: int = 2) -> Builder:
    def build(device):
        from repro_torch.siso import RSC_K4_LTE, QPPInterleaver, TurboSpec
        from repro_torch.siso.turbo import _iteration

        spec = TurboSpec(code=RSC_K4_LTE, interleaver=QPPInterleaver(64, 7, 16))
        N = spec.block_len
        rng = np.random.default_rng(N)
        llrs = torch.from_numpy(
            rng.standard_normal((B, N, spec.n_streams)).astype(np.float32)).to(device)
        le2 = torch.zeros((B, N), dtype=torch.float32, device=device)
        prev = torch.full((B, N), -1, dtype=torch.int32, device=device)
        done = torch.zeros((B,), dtype=torch.bool, device=device)
        return (lambda *a: _iteration(spec, *a)), (llrs, le2, prev, done)

    return build


def _contract(name: str, syncs: Sequence[Tuple[str, int]] = (), **kw) -> Contract:
    return Contract(name=name, max_host_syncs=sum(n for _, n in syncs),
                    sync_sites=tuple(site for site, _ in syncs), **kw)


def hot_path_catalog() -> Tuple[HotPath, ...]:
    """One entry per registered decoder.  Adding a backend without extending
    this catalog fails ``check_hot_paths``."""
    block = dict(max_outputs=_BLOCK_OUTPUTS)
    scan_walk = ("viterbi_scan_packed", "traceback_packed")
    siso = ("bcjr_alpha_scan", "bcjr_beta_llr_scan")
    return (
        HotPath(
            name="sequential", backend="sequential",
            contract=_contract("sequential", **block),
            build=_block_builder("sequential"),
            summary="plain sequential oracle (torch ops a step, no kernel)",
        ),
        HotPath(
            name="parallel", backend="parallel",
            # the windows' upper ends (one per chunk lane) leave the host
            contract=_contract(
                "parallel", syncs=[(_LANE_ROW, 1)], **block,
                kernels=("viterbi_scan_packed_window", "minplus_matmul",
                         "viterbi_scan_carry", "traceback_packed")),
            build=_block_builder("parallel"),
            summary="(min,+) associative-scan block decode",
        ),
        HotPath(
            name="fused", backend="fused",
            contract=_contract("fused", kernels=("viterbi_scan",), **block),
            build=_block_builder("fused"),
            summary="unpacked scan kernel + plain traceback",
        ),
        HotPath(
            name="fused_packed", backend="fused_packed",
            contract=_contract("fused_packed", kernels=scan_walk, **block),
            build=_block_builder("fused_packed"),
            summary="packed scan + packed traceback kernels",
        ),
        HotPath(
            name="tiled", backend="tiled",
            # the tile gather index, then the lane rows of pass 1 (lo, hi),
            # pass 2 (lo, hi) and the walk (exit states, hi)
            contract=_contract(
                "tiled", syncs=[(_TILE_INDEX, 1), (_LANE_ROW, 6)], **block,
                kernels=("viterbi_scan_packed_window", "traceback_packed_window")),
            build=_block_builder("tiled", T=128, tiles=4),
            summary="time-parallel tiled decode, exact min-plus seams",
        ),
        HotPath(
            name="seqparallel", backend="seqparallel",
            # no host sync at any shard count: each shard is one whole
            # chunk, so its window bounds are filled on the device; a shard
            # of 64 steps re-scans into whole packed words
            contract=_contract(
                "seqparallel", **block,
                # the one path allowed to communicate: it gathers each
                # shard's (S, S) transfer matrix (tiny, T-independent)
                allowed_collectives=frozenset({"all_gather"}),
                kernels=("viterbi_scan_packed_window", "minplus_matmul",
                         "viterbi_scan_packed_carry", "traceback_packed")),
            build=_seqparallel_builder(),
            summary="sequence-parallel decode over a unit data mesh",
        ),
        HotPath(
            name="stream_tick", backend="streaming",
            contract=_contract(
                "stream_tick", syncs=[(_TICK_BITS, 1)], max_outputs=_TICK_OUTPUTS,
                kernels=("viterbi_scan_packed_carry", "traceback_packed")),
            build=_stream_tick_builder(),
            summary="one steady StreamScheduler tick (fused_packed, raw symbols)",
        ),
        HotPath(
            name="sharded_stream_tick", backend="sharded_stream",
            # no collective: slots are independent streams, so the tick
            # makes no transfer between shards (and no host sync)
            contract=_contract(
                "sharded_stream_tick",
                max_outputs=4 + 6,  # (pm, ring, bits, delta) + the counters
                kernels=("viterbi_scan_packed_carry", "traceback_packed")),
            build=_sharded_tick_builder(),
            summary="one sharded scheduler tick on a unit data mesh, device counters on",
        ),
        HotPath(
            name="bcjr", backend="bcjr",
            contract=_contract("bcjr", kernels=siso, **block),
            build=_bcjr_builder(),
            summary="max-log-MAP BCJR kernel pair (alpha scan + beta/LLR)",
        ),
        HotPath(
            name="turbo_iteration", backend="turbo",
            # (le2, bits, llr, done, agree)
            contract=_contract("turbo_iteration", max_outputs=5, kernels=siso),
            build=_turbo_iteration_builder(),
            summary="one turbo iteration (2 BCJR SISO passes)",
        ),
    )


def _check_one(p: HotPath, device: torch.device) -> Dict[str, object]:
    from repro_torch.kernels.common import launch_counts, plain_counts, reset_counts
    from repro_torch.parallel import collectives

    with sanitized(device=device) as rep:
        with rep.allow_transfers():
            fn, args = p.build(device)
            fn(*args)  # warm: builds, loads, caches, admits
        if device.type == "cuda":
            torch.cuda.synchronize()
        base, sites_before = rep.snapshot(), Counter(rep.sync_sites)
        reset_counts()
        calls_before = Counter(collectives.calls)
        trace, violations = trace_contract(fn, args, p.contract, device=device.type)
        called = dict(collectives.calls - calls_before)
        if device.type == "cuda":
            torch.cuda.synchronize()
        launches, plain = dict(launch_counts), dict(plain_counts)
        syncs = rep.host_syncs - base.host_syncs
        rebuilds = rep.rebuilds - base.rebuilds
        uploads = rep.uploads - base.uploads
        sites = dict(rep.sync_sites - sites_before)
    c = p.contract
    for name in sorted(set(called) - c.allowed_collectives):
        violations.append(ContractViolation(
            contract=c.name, kind="collective", op=name,
            detail=f"mesh collective called {called[name]} times outside the contract "
                   "allowlist", where="repro_torch/parallel/collectives.py"))
    if syncs > c.max_host_syncs:
        violations.append(ContractViolation(
            contract=c.name, kind="host-sync", op="<call>",
            detail=f"{syncs} host syncs exceed the bound {c.max_host_syncs} "
                   f"(sites {sites})", where=""))
    missing = [k for k in c.kernels if device.type == "cuda" and not launches.get(k)]
    return dict(backend=p.backend, summary=p.summary, ops=len(trace), host_syncs=syncs,
                sync_sites=sites, max_host_syncs=c.max_host_syncs, uploads=uploads,
                rebuilds=rebuilds, launches=launches, plain=plain, collectives=called,
                missing_kernels=missing, violations=violations)


def check_hot_paths(
    catalog: Optional[Tuple[HotPath, ...]] = None,
    device="cuda",
) -> Dict[str, Dict[str, object]]:
    """Run every catalog entry on ``device`` (the card by default; raises
    without one) and check its contract.

    Returns {path name: {backend, ops, host_syncs, sync_sites,
    max_host_syncs, uploads, rebuilds, launches, plain, collectives,
    missing_kernels, violations, summary}}.  Raises AssertionError if the catalog does not
    cover the full decoder registry.  The caller judges the rest:
    ``problems(entry)`` lists what fails an entry."""
    from repro_torch.decode import list_decoders
    from repro_torch.kernels.common import resolve_device

    dev = resolve_device(device)
    paths = hot_path_catalog() if catalog is None else catalog
    covered = {p.backend for p in paths}
    registered = set(list_decoders())
    assert covered == registered, (
        f"hot-path catalog out of sync with the registry: "
        f"missing {sorted(registered - covered)}, stale {sorted(covered - registered)}"
    )
    report: Dict[str, Dict[str, object]] = {}
    for p in paths:
        report[p.name] = _check_one(p, dev)
    return report


def problems(entry: Dict[str, object], device="cuda") -> List[str]:
    """What fails one report entry: contract violations, rebuilds on the
    steady call, and on the card a named kernel that did not launch or any
    plain version that ran."""
    out = [str(v) for v in entry["violations"]]
    if entry["rebuilds"]:
        out.append(f"{entry['rebuilds']} rebuilds on the steady call")
    if torch.device(device).type == "cuda":
        out += [f"kernel {k} did not launch" for k in entry["missing_kernels"]]
        if entry["plain"]:
            out.append(f"plain versions ran: {entry['plain']}")
    return out


def flatten_violations(report: Dict[str, Dict[str, object]]) -> List[ContractViolation]:
    out: List[ContractViolation] = []
    for row in report.values():
        out.extend(row["violations"])
    return out
