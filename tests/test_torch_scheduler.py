"""The port's stream scheduler held against the live reference scheduler.

Every case drives ``repro.stream.StreamScheduler`` (its Pallas kernels in
interpret mode on the CPU) and ``repro_torch.stream.StreamScheduler(
device="cpu")`` call for call through :class:`Twin` on the same numpy
inputs, and after every call requires, with no tolerance: the call's
result (bits committed this tick, final bits and metrics, credits, evicted
prefixes, errors raised), the stats, results and structured errors, the
slot table and each stream's watermarks and arena rows, the carried path
metrics, survivor ring (packed words compared as uint32), offsets and
device counters, the arena's used prefix, and ``load_report()`` (latency
counts; their values are wall-clock times).  Soft metrics included.

The cases follow the reference's own scheduler tests (tests/test_stream.py
and tests/test_obs.py), ported rather than imported; ingestion and
resilience have files of their own (test_torch_ingest.py,
test_torch_resilience.py), which take their harness from here.
"""
import dataclasses
import functools

import jax  # noqa: F401  (both frameworks in one process; JAX stays on the CPU)
import numpy as np
import pytest
import torch

import repro.decode as RD
import repro.obs as R_obs
import repro.stream as R_stream
from repro.core.puncture import PUNCTURE_2_3
from repro.core.trellis import ConvCode as RCode
from repro.stream import window as R_w
from repro_torch import decode as PD
from repro_torch import obs as P_obs
from repro_torch import stream as P_stream
from repro_torch.core.trellis import ConvCode as PCode
from repro_torch.kernels.common import plain_counts, reset_counts
from repro_torch.stream import window as P_w

torch.set_num_threads(1)

CODES = {"k3": (3, (0b111, 0b101)), "k7": (7, (0o171, 0o133))}


def specs(name="k3", metric="hard", punctured=False, terminated=True):
    """The same CodecSpec in both packages."""
    K, polys = CODES[name]
    kw = dict(metric=metric, puncture=PUNCTURE_2_3 if punctured else None,
              terminated=terminated)
    return RD.CodecSpec(code=RCode(K, polys), **kw), PD.CodecSpec(code=PCode(K, polys), **kw)


def stream_rows(pspec, seed, n_info, inputs="bm", flip=0.03):
    """One stream's (T, width) float32 rows, made with numpy: the channel
    output of random info bits (BSC for hard specs, BPSK + AWGN for soft),
    as raw symbols (``inputs="received"``) or bm tables."""
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, (1, n_info)).astype(np.int32)
    coded = pspec.encode(torch.from_numpy(bits)).numpy()
    if pspec.soft:
        rx = (1.0 - 2.0 * coded + 0.8 * rng.standard_normal(coded.shape)).astype(np.float32)
    else:
        rx = (coded ^ (rng.random(coded.shape) < flip)).astype(np.float32)
    if inputs == "received":
        return rx[0]
    return pspec.branch_metrics(torch.from_numpy(rx)).numpy()[0]


def chunks_of(table, sizes):
    """Split a (T, ·) table into arrival chunks of the given sizes (the last
    chunk absorbs any remainder)."""
    out, i = [], 0
    for sz in sizes:
        out.append(table[i:i + sz])
        i += sz
        if i >= len(table):
            break
    if i < len(table):
        out.append(table[i:])
    return [c for c in out if len(c)]


def offline_bits(pspec, table, terminated=True):
    """The port's sequential block decode of one stream's bm table."""
    res = PD.get_decoder("sequential")(
        dataclasses.replace(pspec, terminated=terminated), torch.from_numpy(table[None]),
        ctx=PD.DecodeContext(device="cpu"))
    return res.bits.numpy()[0], float(res.path_metric[0])


def assert_same(want, got, where=""):
    """Equal with no tolerance, through dicts, sequences, arrays, floats and
    dataclasses (StreamError records of the two packages)."""
    if dataclasses.is_dataclass(want):
        assert type(want).__name__ == type(got).__name__, where
        assert_same(dataclasses.asdict(want), dataclasses.asdict(got), where)
    elif isinstance(want, dict):
        assert set(want) == set(got), f"{where}: keys {sorted(want)} != {sorted(got)}"
        for k in want:
            assert_same(want[k], got[k], f"{where}[{k!r}]")
    elif isinstance(want, (list, tuple)):
        assert len(want) == len(got), where
        for i, (a, b) in enumerate(zip(want, got)):
            assert_same(a, b, f"{where}[{i}]")
    elif isinstance(want, np.ndarray) or isinstance(got, np.ndarray):
        want, got = np.asarray(want), np.asarray(got)
        assert want.dtype == got.dtype, f"{where}: dtype {want.dtype} != {got.dtype}"
        np.testing.assert_array_equal(got, want, err_msg=where)
    else:
        assert want == got, f"{where}: {want!r} != {got!r}"


def stats_of(sched):
    """SchedulerStats but the straggler count, which flags wall-clock
    outliers (the reference's first ticks compile)."""
    stats = sched.stats.asdict()
    del stats["straggler_ticks"]
    return stats


def _host(x, packed=False):
    a = np.asarray(x) if not isinstance(x, torch.Tensor) else x.numpy()
    return a.view(np.uint32) if packed else a


class Twin:
    """The reference scheduler ``r`` and the port's ``p`` (on the CPU),
    driven call for call: ``twin.name(*args)`` calls ``name`` on both,
    requires equal results (or the same exception, re-raised from the port)
    and then equal observable state (:meth:`check`).  ``producer=`` takes a
    factory ``(package, scheduler) -> producer``, so each side polls its own
    source (and its own package's producer classes)."""

    def __init__(self, rspec=None, pspec=None, *, telemetry=None, pair=None, **kw):
        if pair is not None:
            self.r, self.p = pair
        else:
            tele = telemetry or (lambda obs: obs.Telemetry())
            self.r = R_stream.StreamScheduler(rspec, telemetry=tele(R_obs), **kw)
            self.p = P_stream.StreamScheduler(pspec, telemetry=tele(P_obs), device="cpu", **kw)
        self.check()

    def both(self, name, *args, producer=None, **kw):
        outs = []
        for pkg, sched in ((R_stream, self.r), (P_stream, self.p)):
            call_kw = dict(kw)
            if producer is not None:
                call_kw["producer"] = producer(pkg, sched)
            try:
                outs.append((None, getattr(sched, name)(*args, **call_kw)))
            except Exception as e:  # noqa: BLE001 — compared, then re-raised
                outs.append((e, None))
        (r_err, r_out), (p_err, p_out) = outs
        if r_err is not None or p_err is not None:
            assert (type(r_err).__name__, str(r_err)) == (type(p_err).__name__, str(p_err)), (
                f"{name}: reference {r_err!r}, port {p_err!r}")
            self.check()
            raise p_err
        assert_same(r_out, p_out, name)
        self.check()
        return p_out

    def __getattr__(self, name):
        return functools.partial(self.both, name)

    def check(self):
        r, p = self.r, self.p
        assert_same(stats_of(r), stats_of(p), "stats")
        assert_same(r.results, p.results, "results")
        assert_same(r.errors, p.errors, "errors")
        assert r.pending_work() == p.pending_work()
        assert [st.stream_id for st in r.pending] == [st.stream_id for st in p.pending]
        assert {s: st.stream_id for s, st in r.active.items()} == {
            s: st.stream_id for s, st in p.active.items()}
        for slot, rst in r.active.items():
            pst = p.active[slot]
            for f in ("fed", "pos", "committed", "closed", "terminated", "queued_rows",
                      "max_buffered", "priority", "deadline_tick"):
                assert getattr(rst, f) == getattr(pst, f), (rst.stream_id, f)
            assert_same(rst.rows, pst.rows, f"{rst.stream_id} rows")
        assert r.packed == p.packed and (r.depth, r.chunk) == (p.depth, p.chunk)
        assert_same(_host(r.state.pm), _host(p.state.pm), "pm")
        assert_same(_host(r.state.ring, r.packed), _host(p.state.ring, p.packed), "ring")
        assert_same(_host(r.offset), _host(p.offset), "offset")
        assert (r._counters is None) == (p._counters is None)
        if r._counters is not None:
            for f, a, b in zip(R_w.DeviceCounters._fields, r._counters, p._counters):
                assert_same(_host(a), _host(b), f"counter {f}")
        assert r._arena_len == p._arena_len
        n = r._arena_len[0]
        assert_same(_host(r._arena)[0, :n], _host(p._arena)[0, :n], "arena")
        rr, pr = r.load_report(), p.load_report()
        assert rr.pop("latency_s")["count"] == pr.pop("latency_s")["count"]
        assert_same(rr, pr, "load_report")

    def run_fed(self, feeds, every=1, guard=2000):
        """Tick until drained, feeding each stream's next arrival chunk
        before every ``every``-th tick (the i-th stream offset by i ticks),
        closing a stream after its last chunk; returns the ticks taken.  A chunk larger than the stream's credit is split to
        fit it: a stream starved with fewer than ``chunk`` rows buffered
        never drains, so a chunk that needs the whole queue would never fit
        (the submit_chunk contract, tests in test_torch_ingest.py)."""
        ticks = 0
        while self.p.pending_work():
            for i, (sid, chunks) in enumerate(feeds.items()):
                if chunks and (ticks + i) % every == 0:
                    credit = self.credit(sid)
                    if not credit:
                        continue
                    if len(chunks[0]) > credit:
                        chunks[:1] = [chunks[0][:credit], chunks[0][credit:]]
                    self.submit_chunk(sid, chunks.pop(0))
                    if not chunks:
                        self.close(sid)
            self.step()
            ticks += 1
            assert ticks < guard, "drain did not converge"
        return ticks


# --------------------------------------------------------------------------- #
# the grid: backends x codes x metrics x termination                           #
# --------------------------------------------------------------------------- #

GRID = [
    # backend, inputs, code, metric, punctured, terminated
    ("scan", "bm", "k3", "hard", False, True),
    ("scan", "bm", "k7", "soft", False, False),
    ("fused", "bm", "k3", "soft", False, True),
    ("fused", "bm", "k7", "hard", True, False),
    ("fused_packed", "bm", "k3", "hard", False, False),
    ("fused_packed", "bm", "k7", "soft", False, True),
    ("fused_packed", "received", "k3", "soft", True, True),
    ("fused_packed", "received", "k7", "hard", True, False),
]


@pytest.mark.parametrize("backend,inputs,name,metric,punctured,terminated", GRID,
                         ids=["-".join(map(str, c)) for c in GRID])
def test_scheduler_matches_reference_tick_for_tick(backend, inputs, name, metric, punctured,
                                                   terminated):
    """Six streams of two lengths through three slots, fed in arrival
    chunks unrelated to the decode chunk (odd tails, starved ticks, slot
    reuse), device counters on: every tick equal to the reference's.  (Few
    distinct row counts: each is a compile on the reference's side.)"""
    rspec, pspec = specs(name, metric, punctured, terminated)
    chunk = 32 if backend == "fused_packed" else 16
    tw = Twin(rspec, pspec, n_slots=3, chunk=chunk, backend=backend, inputs=inputs,
              max_buffered=4 * chunk,
              telemetry=lambda obs: obs.Telemetry(device_counters=True))
    feeds = {}
    for i in range(6):
        sid = f"s{i}"
        tw.open_stream(sid)
        feeds[sid] = chunks_of(stream_rows(pspec, 100 + i, (61, 93)[i % 2], inputs), (24, 40) * 3)
    tw.run_fed(feeds, every=3)
    assert tw.p.stats.streams_finished == 6
    assert tw.p.stats.slot_claims == 6 > tw.p.n_slots
    assert tw.p.stats.starved_slot_ticks > 0


# --------------------------------------------------------------------------- #
# continuous batching + slot reuse (tests/test_stream.py, scheduler cases)     #
# --------------------------------------------------------------------------- #


def _submit_all(tw, pspec, lengths, seed=0, flip=0.01, **kw):
    tables = {}
    for i, n in enumerate(lengths):
        tables[f"s{i}"] = stream_rows(pspec, seed + i, n, flip=flip)
        tw.submit(f"s{i}", tables[f"s{i}"], **kw)
    return tables


def test_scheduler_slot_reuse_across_completions():
    """More streams than slots, staggered lengths: every stream decodes
    exactly (against the offline decode too), and slots turn over."""
    rspec, pspec = specs()
    tw = Twin(rspec, pspec, n_slots=4, chunk=16, depth=30, backend="scan")
    tables = _submit_all(tw, pspec, [(96, 130, 64, 150)[i % 4] for i in range(6)])
    out = tw.run()
    assert tw.p.stats.streams_finished == 6
    assert tw.p.stats.slot_claims == 6 > tw.p.n_slots
    assert tw.p.utilization() == 0.0
    for sid, table in tables.items():
        # depth 30 truncates: the reference equality above is the exact
        # check; the offline decode agrees on this low-noise channel
        assert (out[sid][0] != offline_bits(pspec, table)[0]).mean() < 0.02


def test_scheduler_one_gather_and_one_step_per_tick(monkeypatch):
    """The hot loop: one device gather and one batched stream_step per
    tick, many live streams."""
    rspec, pspec = specs()
    tw = Twin(rspec, pspec, n_slots=4, chunk=16, depth=30, backend="scan")
    calls = {"gather": 0, "step": 0}
    gather, step_fn = tw.p._gather, tw.p._step_fn

    def counting_gather(arena, idx):
        calls["gather"] += 1
        return gather(arena, idx)

    def counting_step(*args, **kw):
        calls["step"] += 1
        return step_fn(*args, **kw)

    monkeypatch.setattr(tw.p, "_gather", counting_gather)
    monkeypatch.setattr(tw.p, "_step_fn", counting_step)
    _submit_all(tw, pspec, [(60, 94)[i % 2] for i in range(6)])
    tw.run()
    assert calls["gather"] == calls["step"] == tw.p.stats.ticks > 0


def test_scheduler_short_stream_admitted_mid_run():
    """A stream shorter than one chunk queued behind a full slot retires
    cleanly when admitted mid-run."""
    rspec, pspec = specs()
    tw = Twin(rspec, pspec, n_slots=1, chunk=32, depth=15, backend="scan")
    short = stream_rows(pspec, 1, 10, flip=0.0)
    tw.submit("long", stream_rows(pspec, 0, 126, flip=0.0))
    tw.submit("short", short)
    out = tw.run()
    assert set(out) == {"long", "short"}
    assert_same(offline_bits(pspec, short)[0], out["short"][0])


def test_scheduler_slot_state_reset_after_idle_ticks():
    """A slot that sat free through real ticks is re-initialized when a
    later stream claims it."""
    rspec, pspec = specs()
    tw = Twin(rspec, pspec, n_slots=2, chunk=16, depth=30, backend="scan")
    tw.submit("a", stream_rows(pspec, 0, 158, flip=0.01))
    for _ in range(4):
        tw.step()
    table_b = stream_rows(pspec, 7, 94, flip=0.12)
    tw.submit("b", table_b)
    out = tw.run()
    # depth 30 of 96 steps on a noisy channel: the reference equality is the
    # exact check; the metric is the full path's either way (an un-reset,
    # drifted initial pm would understate it)
    assert out["b"][1] == offline_bits(pspec, table_b)[1]


def test_scheduler_batched_slot_flush(monkeypatch):
    """All slots retiring in one tick flush through ONE batched traceback
    (grouped tail-feeds over three tail lengths), bit-exact."""
    rspec, pspec = specs()
    tw = Twin(rspec, pspec, n_slots=4, chunk=16, depth=90, backend="scan")
    flush_factory = P_w.jitted_stream_flush
    calls = {"n": 0}

    def counting_flush(code, terminated=True, packed=False):
        calls["n"] += 1
        return flush_factory(code, terminated=terminated, packed=packed)

    monkeypatch.setattr(P_w, "jitted_stream_flush", counting_flush)
    tables = _submit_all(tw, pspec, (80, 83, 87, 83), flip=0.02)
    out = tw.run()
    assert tw.p.stats.streams_finished == 4
    assert calls["n"] == 1
    for sid, table in tables.items():
        want = offline_bits(pspec, table)
        assert_same(want[0], out[sid][0])
        assert out[sid][1] == want[1]


def test_scheduler_evict_active_pending_and_draining():
    rspec, pspec = specs()
    tw = Twin(rspec, pspec, n_slots=2, chunk=16, depth=15, backend="scan")
    for i in range(3):
        tw.submit(f"s{i}", stream_rows(pspec, i, 158, flip=0.0))
    tw.submit("d", stream_rows(pspec, 9, 40, flip=0.01))
    tw.step()
    assert tw.evict("s2") is None  # still pending
    assert tw.evict("s0") is not None  # active: its committed prefix
    for _ in range(8):  # 'd' now holds s0's slot: step it into its draining window
        tw.step()
        st = next((s for s in tw.p.active.values() if s.stream_id == "d"), None)
        if st is not None and 0 < st.available < tw.p.chunk:
            break
    else:
        pytest.fail("stream 'd' never reached the draining window")
    partial = tw.evict("d")
    assert partial.dtype == np.int32
    out = tw.run()
    assert set(out) == {"s1"}
    with pytest.raises(KeyError):
        tw.evict("d")


def test_scheduler_zero_length_stream_and_second_wave():
    rspec, pspec = specs()
    tw = Twin(rspec, pspec, n_slots=2, chunk=16, depth=30, backend="scan")
    tw.submit("empty", np.zeros((0, pspec.code.n_symbols), np.float32))
    tw.submit("real", stream_rows(pspec, 0, 62))
    out = tw.run()
    assert out["empty"][0].shape == (0,)
    assert not tw.p.pending_work() and tw.p.utilization() == 0.0
    wave2 = stream_rows(pspec, 99, 94, flip=0.05)
    tw.submit("wave2", wave2)
    out = tw.run()
    assert out["wave2"][1] == offline_bits(pspec, wave2)[1]
    assert tw.p.stats.streams_finished == 3


@pytest.mark.parametrize("ratio", [1, 2])
def test_scheduler_compaction_with_live_slots(ratio):
    """Compaction (forced at toy sizes) rebuilds the arena around live,
    partially consumed streams — including sub-chunk and zero-length
    streams admitted and retired in one tick — and the decode goes on
    unchanged."""
    rspec, pspec = specs()
    tw = Twin(rspec, pspec, n_slots=3, chunk=16, depth=15, backend="scan")
    for s in (tw.r, tw.p):
        s._compact_floor, s._compact_ratio = 0, ratio
    for j in range(2):
        tw.submit(f"long{j}", stream_rows(pspec, j, 190, flip=0.02))
    tw.step()
    for i in range(8):
        n = (10, 0, 3, 14)[i % 4]
        tw.submit(f"tiny{i}", stream_rows(pspec, 50 + i, n) if n else
                  np.zeros((0, pspec.code.n_symbols), np.float32))
        tw.step()  # the tiny stream admits AND retires inside this tick
    tw.run()
    assert tw.p.stats.arena_compactions > 0


def test_scheduler_chunk_fed_submit_tick_compact_interleaving():
    rspec, pspec = specs()
    tw = Twin(rspec, pspec, n_slots=2, chunk=16, depth=15, backend="scan")
    for s in (tw.r, tw.p):
        s._compact_floor, s._compact_ratio = 0, 1
    feeds = {}
    for i, n in enumerate((90, 61, 170, 44)):
        tw.open_stream(f"s{i}")
        table = stream_rows(pspec, i, n, flip=0.02)
        feeds[f"s{i}"] = [table[k:k + 23] for k in range(0, len(table), 23)]
    tw.run_fed(feeds)
    assert tw.p.stats.arena_compactions > 0


def test_packed_scheduler_odd_tails_open_trellis_truncated():
    """Packed hot loop, depth < T, odd tails of several lengths retiring in
    mixed cohorts, open trellises."""
    rspec, pspec = specs("k3", terminated=False)
    tw = Twin(rspec, pspec, n_slots=3, chunk=32, depth=64, backend="fused_packed")
    for i, n in enumerate((97, 130, 65, 201, 99, 33)):
        tw.submit(f"s{i}", stream_rows(pspec, i, n), terminated=False)
    tw.run()


# --------------------------------------------------------------------------- #
# telemetry (tests/test_obs.py, scheduler cases)                               #
# --------------------------------------------------------------------------- #


def test_scheduler_telemetry_leaves_decode_unchanged_and_covers_the_tick():
    rspec, pspec = specs()
    tables = {f"s{i}": stream_rows(pspec, i, 94) for i in range(3)}
    traced = Twin(rspec, pspec, n_slots=2, chunk=16, depth=30, backend="scan",
                  telemetry=lambda obs: obs.Telemetry.enabled(device_counters=True))
    for sid, t in tables.items():
        traced.submit(sid, t)
    out = traced.run()
    plain = P_stream.StreamScheduler(pspec, n_slots=2, chunk=16, depth=30, backend="scan",
                                     device="cpu")
    for sid, t in tables.items():
        plain.submit(sid, t)
    assert_same(plain.run(), out)
    p = traced.p
    tr = p.telemetry.tracer
    assert len(tr.durations_s("tick")) >= p.stats.ticks > 0
    assert tr.coverage("tick", P_stream.scheduler.TICK_PHASES) >= 0.95
    assert P_stream.scheduler.TICK_PHASES == R_stream.scheduler.TICK_PHASES
    snap = p.metrics_snapshot()
    for name, v in p.stats.asdict().items():
        assert snap[f"scheduler_{name}"] == v
    assert snap["scheduler_active_slots"] == 0 and snap["scheduler_utilization"] == 0.0
    rsnap = traced.r.metrics_snapshot()
    counters = [k for k, v in rsnap.items() if not isinstance(v, dict) and "straggler" not in k]
    assert {k: snap[k] for k in counters} == {k: rsnap[k] for k in counters}
    assert {k: snap[k]["count"] for k in snap if isinstance(snap[k], dict)} == {
        k: rsnap[k]["count"] for k in rsnap if isinstance(rsnap[k], dict)}
    text = p.metrics_text()
    assert "# TYPE scheduler_ticks counter" in text
    assert "stream_arrival_to_commit_seconds_count" in text
    # deterministic accounting: one merge-depth observation per retiring stream
    T = 94 + pspec.n_flush
    s = p.stats
    assert s.streams_submitted == s.streams_finished == s.slot_claims == 3
    assert s.steps_decoded == 3 * T and s.chunks_submitted == 3 and s.busy_rejections == 0
    assert p.telemetry.metrics.histogram("stream_merge_depth").count == 3


@pytest.mark.parametrize("device_counters", [False, True])
def test_load_report_and_device_counters_mid_flight(device_counters):
    rspec, pspec = specs()
    tw = Twin(rspec, pspec, n_slots=2, chunk=16, depth=60, backend="scan",
              telemetry=lambda obs: obs.Telemetry.enabled(device_counters=device_counters))
    tw.submit("s0", stream_rows(pspec, 0, 126))
    tw.submit("s1", stream_rows(pspec, 1, 126))
    for _ in range(3):
        tw.step()
    report = tw.p.load_report()  # Twin.check: the reference's, latency values aside
    assert report["active_total"] == 2 and ("merge_depth" in report) == device_counters
    if device_counters:
        assert_same(tw.r.device_counter_report(), tw.p.device_counter_report())
        assert {row["ticks"] for row in report["merge_depth"].values()} == {3}
    else:
        with pytest.raises(RuntimeError, match="device counters are off"):
            tw.device_counter_report()
    tw.run()
    assert tw.p.load_report()["latency_s"]["count"] >= 2


# --------------------------------------------------------------------------- #
# construction, device, exports, the ported pure-Python pieces                 #
# --------------------------------------------------------------------------- #


def test_scheduler_defaults_to_the_card_and_refuses_a_mesh(monkeypatch):
    _, pspec = specs()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        P_stream.StreamScheduler(pspec)
    with pytest.raises(NotImplementedError, match="item 9b"):
        P_stream.StreamScheduler(pspec, mesh=object(), device="cpu")
    with pytest.raises(ValueError, match="max_buffered"):
        P_stream.StreamScheduler(pspec, chunk=16, max_buffered=8, device="cpu")
    with pytest.raises(ValueError, match="received"):
        P_stream.StreamScheduler(pspec, backend="fused", inputs="received", device="cpu")
    sched = P_stream.StreamScheduler(pspec, n_slots=2, chunk=32, backend="fused_packed",
                                     inputs="received", device="cpu")
    assert sched.device == torch.device("cpu") and sched.depth == 32
    assert sched.state.pm.device == sched._arena.device == sched.offset.device


def test_scheduler_runs_the_kernels_plain_versions_on_the_cpu():
    """device='cpu': every tick's scan and walk run their plain versions
    (on the card the same calls launch the kernels, tests/test_torch_gpu.py)."""
    _, pspec = specs("k7")
    for backend, kernels in (("fused_packed", ("viterbi_scan_packed_carry", "traceback_packed")),
                             ("fused", ("viterbi_scan_carry",))):
        sched = P_stream.StreamScheduler(pspec, n_slots=2, chunk=32, backend=backend,
                                         device="cpu")
        sched.submit("a", stream_rows(pspec, 0, 120))
        reset_counts()
        sched.run()
        for k in kernels:
            assert plain_counts[k] == sched.stats.ticks > 0, (backend, k)


def test_stream_exports_match_the_reference_but_the_mesh_helpers():
    mesh_helpers = {"make_sharded_stream_step", "shard_stream_state", "state_shardings"}
    assert set(R_stream.__all__) - mesh_helpers == set(P_stream.__all__)
    assert sorted(P_stream.__all__) == sorted(set(P_stream.__all__))
    for name in P_stream.__all__:
        assert hasattr(P_stream, name), name
    assert P_stream.FAULT_CLASSES == R_stream.FAULT_CLASSES
    assert P_stream.SNAPSHOT_VERSION == R_stream.SNAPSHOT_VERSION
    assert [f.name for f in dataclasses.fields(P_stream.SchedulerStats)] == [
        f.name for f in dataclasses.fields(R_stream.SchedulerStats)]


def test_configs_serve_and_train_pieces_match_the_reference():
    import repro.configs.paper_viterbi as R_cfg
    import repro.serve.kv_cache as R_kv
    import repro.train.fault_tolerance as R_ft
    import repro_torch.configs as P_cfg
    from repro_torch.serve import kv_cache as P_kv
    from repro_torch.train import StragglerDetector

    assert P_cfg.SERVE_BITS_PER_TOKEN == R_cfg.SERVE_BITS_PER_TOKEN
    assert dataclasses.asdict(P_cfg.STREAM) == dataclasses.asdict(R_cfg.STREAM)
    assert P_cfg.STREAM.n_slots_for(4) == R_cfg.STREAM.n_slots_for(4) == 256
    for name, code in R_cfg.CODES.items():
        pc = P_cfg.CODES[name]
        assert (pc.constraint, pc.polys) == (code.constraint, code.polys)
        assert P_cfg.STREAM.depth(pc) == R_cfg.STREAM.depth(code)
    for pb, rb in ((P_cfg.ARCH, R_cfg.ARCH), (P_cfg.SMOKE, R_cfg.SMOKE)):
        assert [dataclasses.asdict(s) for s in pb.shapes] == [
            dataclasses.asdict(s) for s in rb.shapes]
    for ps, rs in ((P_cfg.DECODE_SPEC, R_cfg.DECODE_SPEC),
                   (P_cfg.DECODE_SPEC_SOFT, R_cfg.DECODE_SPEC_SOFT)):
        assert (ps.metric, ps.terminated, ps.code.polys) == (rs.metric, rs.terminated,
                                                              rs.code.polys)
    assert P_kv.DEFAULT_BUCKETS == R_kv.DEFAULT_BUCKETS
    for need in ((10, 1000), (5000, 0), (1, 524287)):
        assert P_kv.pick_bucket(*need) == R_kv.pick_bucket(*need)
    with pytest.raises(ValueError, match="max bucket"):
        P_kv.pick_bucket(524288, 1)
    pa, ra = P_kv.SlotAllocator(3), R_kv.SlotAllocator(3)
    for op in ("a", "b", 2, "c", "d", 0, "e"):
        if isinstance(op, int):
            pa.release(op)
            ra.release(op)
        else:
            assert pa.claim(op) == ra.claim(op)
        assert (pa.free, pa.active, pa.utilization()) == (ra.free, ra.active, ra.utilization())
    pd, rd = StragglerDetector(zscore=2.0, warmup_steps=2), R_ft.StragglerDetector(
        zscore=2.0, warmup_steps=2)
    for step, dt in enumerate((0.01, 0.012, 0.011, 0.5, 0.01, 0.013, 2.0)):
        assert pd.observe(step, dt) == rd.observe(step, dt)
        assert (pd.mean, pd.var, pd.n) == (rd.mean, rd.var, rd.n)
    assert pd.events == rd.events and pd.events
