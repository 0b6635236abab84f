"""Serving resilience in the port held against the reference: snapshot and
restore, the chaos harness and graceful degradation, with the scheduler on
the CPU beside the live reference scheduler through the :class:`Twin` of
test_torch_scheduler.py (every call's result and the observable state after
it, exactly).

Snapshots: the port's payload at a tick equals the reference's at the same
tick (packed survivor words compared as uint32: the port holds them as
int32 and its images carry the ``packed`` flag), and a restored pair goes on
tick for tick equal to the reference restored from its own snapshot and
bit-exact with the uninterrupted run.  Chaos: the same seeded policy injects
the same faults into both (the ledgers are equal), and each scheduler
reacts the same way.  The cases follow tests/test_stream_resilience.py,
ported.
"""
import contextlib
import dataclasses
import pickle

import numpy as np
import pytest
import torch
from test_torch_scheduler import Twin, assert_same, chunks_of, specs, stream_rows

import repro.obs as R_obs
import repro.stream as R_stream
from repro.train.fault_tolerance import StragglerDetector as RStraggler
from repro_torch import obs as P_obs
from repro_torch import stream as P_stream
from repro_torch.train import StragglerDetector

torch.set_num_threads(1)

RSPEC, PSPEC = specs()


def _table(seed, n_info, flip=0.02):
    return stream_rows(PSPEC, seed, n_info, flip=flip)


def _run_uninterrupted(tables, **kw):
    sched = P_stream.StreamScheduler(PSPEC, device="cpu", **kw)
    for sid, t in tables.items():
        sched.open_stream(sid, max_buffered=max(kw.get("chunk", 64), len(t)))
        sched.submit_chunk(sid, t, close=True)
    return sched.run()


def assert_same_snapshots(rsnap, psnap):
    """The port's snapshot equals the reference's field for field."""
    assert psnap.version == rsnap.version
    assert psnap.config == rsnap.config
    # but the straggler count: it flags wall-clock outliers
    assert {**psnap.stats, "straggler_ticks": 0} == {**rsnap.stats, "straggler_ticks": 0}
    assert_same(rsnap.results, psnap.results, "results")
    assert_same(rsnap.errors, psnap.errors, "errors")
    assert psnap.straggler["n"] == rsnap.straggler["n"]
    assert psnap.stream_ids == rsnap.stream_ids
    for rim, pim in zip(rsnap.active + rsnap.pending, psnap.active + psnap.pending):
        want, got = dataclasses.asdict(rim), dataclasses.asdict(pim)
        assert got.pop("packed") == (rsnap.config["backend"] == "fused_packed"
                                     and rim.slot is not None)
        if pim.packed:
            assert want["ring"].dtype == np.uint32
            got["ring"] = got["ring"].view(np.uint32)
        assert_same(want, got, rim.stream_id)


def _restored_twin(tw, **kw):
    """Snapshot both sides (through pickle, the across-host shape), require
    equal payloads, and restore each on its own package."""
    rsnap = pickle.loads(pickle.dumps(tw.r.snapshot()))
    psnap = pickle.loads(pickle.dumps(tw.p.snapshot()))
    assert_same_snapshots(rsnap, psnap)
    rtel = kw.pop("telemetry", None)
    return Twin(pair=(
        R_stream.StreamScheduler.restore(rsnap, telemetry=rtel and rtel(R_obs), **kw),
        P_stream.StreamScheduler.restore(psnap, telemetry=rtel and rtel(P_obs), device="cpu",
                                         **kw)))


# --------------------------------------------------------------------------- #
# snapshot / restore                                                           #
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("backend", ["scan", "fused_packed"])
@pytest.mark.parametrize("snap_tick", [0, 1, 4])
def test_snapshot_restore_bit_exact(backend, snap_tick):
    tables = {f"s{i}": _table(i, 180) for i in range(5)}
    kw = dict(n_slots=4, chunk=32, backend=backend)
    ref = _run_uninterrupted(tables, **kw)
    tw = Twin(RSPEC, PSPEC, **kw)
    for sid, t in tables.items():
        tw.open_stream(sid, max_buffered=max(64, len(t)))
        tw.submit_chunk(sid, t, close=True)
    for _ in range(snap_tick):
        tw.step()
    restored = _restored_twin(tw)
    assert_same(ref, restored.run())


def test_snapshot_restore_mid_drip_with_device_counters():
    """Streams frozen at arbitrary window positions — some starved, some
    with pre-admission queued rows — restore bit-exact, counters included;
    the original keeps serving after its snapshot."""
    tables = {f"s{i}": _table(10 + i, 240) for i in range(6)}
    kw = dict(n_slots=4, chunk=32, backend="fused_packed")
    ref = _run_uninterrupted(tables, **kw)
    counters = lambda obs: obs.Telemetry(device_counters=True)  # noqa: E731
    tw = Twin(RSPEC, PSPEC, telemetry=counters, **kw)
    served = {sid: 0 for sid in tables}

    def drip(twin, upto):
        for sid, t in tables.items():
            while served[sid] < min(upto, len(t)):
                n = min(50, len(t) - served[sid], upto - served[sid])
                try:
                    twin.submit_chunk(sid, t[served[sid]:served[sid] + n])
                    served[sid] += n
                except P_stream.StreamBusy:
                    break
            if served[sid] >= len(t):
                with contextlib.suppress(KeyError):  # already retired
                    twin.close(sid)

    for sid in tables:
        tw.open_stream(sid, max_buffered=256)
    for _ in range(6):
        drip(tw, 120)
        tw.step()
    restored = _restored_twin(tw, telemetry=counters)
    tw.step()  # non-destructive: the original goes on
    while restored.p.pending_work():
        drip(restored, 10**9)
        restored.step()
    assert_same(ref, restored.p.results)
    assert restored.p.stats.ticks >= 6


@pytest.mark.parametrize("punctured", [False, True])
def test_snapshot_restore_received_inputs(punctured):
    """inputs='received': arena rows are stored post-feature-transform, so a
    restore must not apply the transform again."""
    rspec, pspec = specs("k3", punctured=punctured)
    rx = stream_rows(pspec, 3, 200, inputs="received")
    kw = dict(n_slots=2, chunk=32, backend="fused_packed", inputs="received")
    tw = Twin(rspec, pspec, **kw)
    tw.open_stream("rx", max_buffered=256)
    tw.submit_chunk("rx", rx, close=True)
    for _ in range(3):
        tw.step()
    restored = _restored_twin(tw)
    ref = P_stream.StreamScheduler(pspec, device="cpu", **kw)
    ref.submit("rx", rx)
    assert_same(ref.run(), restored.run())


def test_snapshot_save_load_and_version_gate(tmp_path):
    table = _table(1, 100)
    sched = P_stream.StreamScheduler(PSPEC, n_slots=2, chunk=32, backend="scan", device="cpu")
    sched.open_stream("a", max_buffered=128)
    sched.submit_chunk("a", table, close=True)
    sched.step()
    snap = sched.snapshot()
    path = tmp_path / "sched.snap"
    snap.save(path)
    loaded = P_stream.StreamSnapshot.load(path)
    assert loaded.version == P_stream.SNAPSHOT_VERSION and loaded.stream_ids == ["a"]
    assert_same(_run_uninterrupted({"a": table}, n_slots=2, chunk=32, backend="scan"),
                P_stream.StreamScheduler.restore(loaded, device="cpu").run())
    loaded.version = P_stream.SNAPSHOT_VERSION + 1
    with pytest.raises(ValueError, match="snapshot version"):
        P_stream.StreamScheduler.restore(loaded, device="cpu")
    (tmp_path / "junk").write_bytes(pickle.dumps({"not": "a snapshot"}))
    with pytest.raises(TypeError):
        P_stream.StreamSnapshot.load(tmp_path / "junk")
    with pytest.raises(NotImplementedError, match="item 9b"):
        P_stream.StreamScheduler.restore(snap, mesh=object(), device="cpu")
    # a ring of the other storage kind is refused, not mis-read
    snap.config["backend"] = "fused_packed"
    snap.config["depth"] = 32
    with pytest.raises(ValueError, match="unpacked"):
        P_stream.StreamScheduler.restore(snap, device="cpu")


def test_snapshot_carries_stats_results_errors():
    tw = Twin(RSPEC, PSPEC, n_slots=2, chunk=32, backend="scan")
    tw.submit("done", _table(4, 80))
    tw.run()
    tw.open_stream("poisoned", max_buffered=128)
    bad = _table(5, 80).copy()
    bad[3, 1] = np.nan
    tw.open_stream("live", max_buffered=128)
    tw.submit_chunk("live", _table(6, 80), close=True)
    tw.attach_producer("poisoned", producer=lambda pkg, sched: iter([bad]))
    tw.step()
    assert tw.p.errors["poisoned"].reason == "poisoned_chunk"
    restored = _restored_twin(tw)
    assert restored.p.stats.ticks == tw.p.stats.ticks
    assert restored.p.stats.streams_quarantined == 1 and "poisoned" in restored.p.errors
    restored.run()
    assert "live" in restored.p.results


@pytest.mark.parametrize("case", range(3))
def test_snapshot_restore_fuzz_seeded(case):
    """Seeded draws over (arrival sizes, snapshot tick, stream count)."""
    rng = np.random.RandomState(case)
    sizes = rng.randint(1, 90, size=24).tolist()
    snap_tick, n_streams = int(rng.randint(0, 8)), int(rng.randint(2, 5))
    tables = {f"s{i}": _table(100 + i, 150) for i in range(n_streams)}
    kw = dict(n_slots=2, chunk=32, backend="fused_packed")
    ref = _run_uninterrupted(tables, **kw)
    tw = Twin(RSPEC, PSPEC, **kw)
    feeds = {sid: chunks_of(t, sizes) for sid, t in tables.items()}
    for sid in tables:
        tw.open_stream(sid, max_buffered=256)

    def feed(twin):
        for sid, chunks in feeds.items():
            while chunks:
                try:
                    twin.submit_chunk(sid, chunks[0])
                    chunks.pop(0)
                except P_stream.StreamBusy:
                    break
                except KeyError:
                    chunks.clear()
            if not chunks:
                with contextlib.suppress(KeyError):  # already retired
                    twin.close(sid)

    for _ in range(snap_tick):
        feed(tw)
        tw.step()
    restored = _restored_twin(tw)
    guard = 0
    while restored.p.pending_work():
        feed(restored)
        restored.step()
        guard += 1
        assert guard < 1000
    assert_same(ref, restored.p.results)


# --------------------------------------------------------------------------- #
# chaos harness: every fault class survived, detected, the same on both sides  #
# --------------------------------------------------------------------------- #


def test_chaos_policy_catalog_and_seeded_injections_match_the_reference():
    for pkg in (R_stream, P_stream):
        pol = pkg.ChaosPolicy(seed=1, **{cls: 0.5 for cls in pkg.FAULT_CLASSES})
        assert all(pol.rate(cls) == 0.5 for cls in pkg.FAULT_CLASSES)
    assert dataclasses.asdict(P_stream.ChaosPolicy.producer_mix(0.4, seed=9)) == \
        dataclasses.asdict(R_stream.ChaosPolicy.producer_mix(0.4, seed=9))
    table = _table(7, 120)
    kinds = dict(producer_stall=0.3, slow_drip=0.3, corrupt_nan=0.2, corrupt_inf=0.2,
                 corrupt_shape=0.2)

    def run(pkg):
        prod = pkg.ChaosProducer(iter([table]), pkg.ChaosPolicy(seed=42, **kinds), "det")
        out = []
        for _ in range(40):
            out.append(prod.poll(16))
            if prod.exhausted:
                break
        return out, dict(prod.injected)

    ref, got = run(R_stream), run(P_stream)
    assert_same(ref, got)
    assert_same(got, run(P_stream))
    assert len(got[1]) >= 3  # several classes fired, identically on both sides
    assert issubclass(P_stream.InjectedDeviceFault, P_stream.TickFault)


def _chaos_producer(cls, rate, seed, table, sid):
    return lambda pkg, sched: pkg.ChaosProducer(
        iter([table]), pkg.ChaosPolicy(seed=seed, **{cls: rate}), sid, sched.telemetry.metrics)


@pytest.mark.parametrize(
    "cls", ["producer_exception", "corrupt_nan", "corrupt_inf", "corrupt_shape"])
def test_chaos_fatal_faults_quarantine_one_stream(cls):
    good_t, bad_t = _table(20, 160), _table(21, 160)
    ref = _run_uninterrupted({"good": good_t}, n_slots=2, chunk=32, backend="scan")
    tw = Twin(RSPEC, PSPEC, n_slots=2, chunk=32, backend="scan")
    tw.open_stream("good", max_buffered=256)
    tw.submit_chunk("good", good_t, close=True)
    tw.open_stream("bad", producer=_chaos_producer(cls, 1.0, 5, bad_t, "bad"),
                   max_buffered=256)
    while tw.p.pending_work():
        tw.step()
    assert_same(ref["good"], tw.p.results["good"])
    err = tw.pop_error("bad")
    assert err.reason == ("producer_error" if cls == "producer_exception" else "poisoned_chunk")
    text = tw.p.metrics_text()
    assert f"chaos_{cls}_total" in text and "stream_quarantined_total 1" in text


@pytest.mark.parametrize("cls", ["producer_stall", "slow_drip"])
def test_chaos_timing_faults_never_change_the_decode(cls):
    tables = {f"s{i}": _table(30 + i, 140) for i in range(3)}
    ref = _run_uninterrupted(tables, n_slots=2, chunk=32, backend="scan")
    tw = Twin(RSPEC, PSPEC, n_slots=2, chunk=32, backend="scan")
    for sid, t in tables.items():
        tw.open_stream(sid, producer=_chaos_producer(cls, 0.6, 11, t, sid), max_buffered=256)
    guard = 0
    while tw.p.pending_work():
        tw.step()
        guard += 1
        assert guard < 2000
    assert_same(ref, tw.p.results)
    assert not tw.p.errors and f"chaos_{cls}_total" in tw.p.metrics_text()


def test_chaos_device_step_failure_drops_tick_and_retries():
    table = _table(40, 200)
    ref = _run_uninterrupted({"a": table}, n_slots=2, chunk=32, backend="scan")
    tw = Twin(RSPEC, PSPEC, n_slots=2, chunk=32, backend="scan")
    policy = dict(seed=3, device_step_failure=0.3)
    r_inj = R_stream.install_tick_faults(tw.r, R_stream.ChaosPolicy(**policy))
    p_inj = P_stream.install_tick_faults(tw.p, P_stream.ChaosPolicy(**policy))
    tw.open_stream("a", max_buffered=256)
    tw.submit_chunk("a", table, close=True)
    while tw.p.pending_work():
        tw.step()
    assert_same(ref, tw.p.results)
    n_faults = p_inj.injected["device_step_failure"]
    assert r_inj.injected == p_inj.injected and n_faults > 0
    assert tw.p.stats.tick_device_failures == n_faults
    assert f"stream_tick_device_failures_total {n_faults}" in tw.p.metrics_text()


def test_tick_fault_hook_catches_only_tick_faults():
    tw = Twin(RSPEC, PSPEC, n_slots=2, chunk=32, backend="scan")
    tw.submit("a", _table(41, 100))

    def boom(tick):
        raise ZeroDivisionError(f"not a tick fault at {tick}")

    for s in (tw.r, tw.p):
        s.tick_fault_hook = boom
    with pytest.raises(ZeroDivisionError):
        tw.step()
    for s in (tw.r, tw.p):
        s.tick_fault_hook = None
    tw.run()


def test_chaos_clock_skew_is_bit_exact():
    table = _table(41, 160)
    ref = _run_uninterrupted({"r": table}, n_slots=1, chunk=32, backend="scan")
    tw = Twin(RSPEC, PSPEC, n_slots=1, chunk=32, backend="scan")
    clocks = {}

    def producer(pkg, sched):
        fake = {"t": 0.0}

        def base_clock():
            fake["t"] += 0.005
            return fake["t"]

        clocks[pkg] = pkg.ChaosClock(pkg.ChaosPolicy(seed=13, clock_skew=0.5), max_skew_s=0.5,
                                     clock=base_clock, metrics=sched.telemetry.metrics)
        return pkg.RateLimitedProducer(table, rows_per_s=2000.0, clock=clocks[pkg])

    tw.open_stream("r", producer=producer, max_buffered=256)
    while tw.p.pending_work():
        tw.step()
    assert_same(ref, tw.p.results)
    assert clocks[P_stream].injector.injected == clocks[R_stream].injector.injected
    assert clocks[P_stream].injector.injected["clock_skew"] > 0
    assert "chaos_clock_skew_total" in tw.p.metrics_text()


# --------------------------------------------------------------------------- #
# graceful degradation                                                         #
# --------------------------------------------------------------------------- #


def test_non_finite_and_bad_shape_chunks_rejected_at_submit():
    tw = Twin(RSPEC, PSPEC, n_slots=2, chunk=32, backend="scan")
    tw.open_stream("a", max_buffered=128)
    bad = _table(1, 60).copy()
    bad[5, 0] = np.inf
    with pytest.raises(ValueError, match="non-finite"):
        tw.submit_chunk("a", bad)
    bad[5, 0], bad[7, 2] = 0.0, np.nan
    with pytest.raises(ValueError, match="non-finite"):
        tw.submit_chunk("a", bad)
    with pytest.raises(ValueError, match="shaped"):
        tw.submit_chunk("a", bad[:, :3])
    assert tw.p.stats.poisoned_rejections == 2
    tw.submit_chunk("a", _table(1, 60), close=True)  # the stream kept its slot
    assert "a" in tw.run()


def test_ttl_expiry_flushes_partial_and_records_error():
    table = _table(8, 300)
    tw = Twin(RSPEC, PSPEC, n_slots=2, chunk=32, backend="scan")
    tw.open_stream("t", ttl_ticks=3, max_buffered=512)
    tw.submit_chunk("t", table)  # never closed
    for _ in range(6):
        tw.step()
    err = tw.p.errors["t"]
    bits, _ = tw.p.results["t"]
    assert err.reason == "expired" and err.committed_bits == bits.shape[0] > 0
    assert "stream_expired_total 1" in tw.p.metrics_text()
    ref_bits = _run_uninterrupted({"t": table}, n_slots=2, chunk=32, backend="scan")["t"][0]
    firm = bits.shape[0] - tw.p.depth
    assert_same(ref_bits[:firm], bits[:firm])


def test_overload_sheds_lowest_priority_with_partial_flush():
    tw = Twin(RSPEC, PSPEC, n_slots=2, chunk=32, backend="scan", max_pending=1)
    t = _table(9, 100)
    for i in range(3):
        tw.open_stream(f"p{i}", priority=i, max_buffered=256)
        tw.submit_chunk(f"p{i}", t)
    tw.step()
    assert not tw.p.errors
    tw.open_stream("p3", priority=3, max_buffered=256)
    tw.open_stream("p4", priority=4, max_buffered=256)
    assert sorted(tw.p.errors) == ["p0", "p1"]
    assert all(e.reason == "shed" for e in tw.p.errors.values())
    assert tw.p.errors["p0"].committed_bits == tw.p.results["p0"][0].shape[0]
    assert "stream_shed_total 2" in tw.p.metrics_text()


def test_evict_while_producer_has_pending_credit():
    t_long, t_other = _table(14, 400), _table(15, 120)
    tw = Twin(RSPEC, PSPEC, n_slots=2, chunk=32, backend="scan")
    prods = {}

    def producer(pkg, sched):
        prods[pkg] = pkg.RateLimitedProducer(t_long, rows_per_s=1e9)
        return prods[pkg]

    tw.open_stream("victim", producer=producer, max_buffered=64)
    tw.open_stream("other", max_buffered=256)
    tw.submit_chunk("other", t_other, close=True)
    for _ in range(3):
        tw.step()
    assert not prods[P_stream].exhausted
    assert tw.evict("victim") is not None and "victim" not in tw.p.errors
    with pytest.raises(KeyError):
        tw.credit("victim")
    while tw.p.pending_work():
        tw.step()
    tw.open_stream("next", max_buffered=256)
    tw.submit_chunk("next", t_other, close=True)
    tw.run()
    assert_same(tw.p.results["other"][0], tw.p.results["next"][0])
    with pytest.raises(KeyError):
        tw.evict("victim")


# --------------------------------------------------------------------------- #
# backpressure hint + straggler wiring                                         #
# --------------------------------------------------------------------------- #


def test_stream_busy_carries_retry_after_ticks():
    tw = Twin(RSPEC, PSPEC, n_slots=1, chunk=32, backend="scan")
    tw.open_stream("a", max_buffered=64)
    big = _table(2, 500)
    with pytest.raises(P_stream.StreamBusy) as exc:
        tw.submit_chunk("a", big)
    assert exc.value.retry_after_ticks == 1 and "retry in ~1 tick(s)" in str(exc.value)
    tw.submit_chunk("a", big[:64])
    with pytest.raises(P_stream.StreamBusy) as exc_full:
        tw.submit_chunk("a", big[64:])
    assert exc_full.value.retry_after_ticks == 2
    tw.open_stream("b", max_buffered=64)
    tw.submit_chunk("b", big[:64])
    with pytest.raises(P_stream.StreamBusy) as exc_b:
        tw.submit_chunk("b", big[64:])
    assert exc_b.value.retry_after_ticks > exc_full.value.retry_after_ticks
    assert tw.p.telemetry.metrics.histogram("stream_busy_retry_ticks").count == 3


def test_rate_limited_pump_backoff_converges():
    table = _table(3, 2000)
    ref = _run_uninterrupted({"r": table}, n_slots=1, chunk=32, backend="scan")
    tw = Twin(RSPEC, PSPEC, n_slots=1, chunk=32, backend="scan")
    tw.open_stream("r", max_buffered=64)
    rprod = R_stream.RateLimitedProducer(table, rows_per_s=1e9)
    pprod = P_stream.RateLimitedProducer(table, rows_per_s=1e9)
    ticks = 0
    while tw.p.pending_work():
        assert rprod.pump(tw.r, "r") == pprod.pump(tw.p, "r")
        tw.step()
        ticks += 1
        assert ticks < 500, "backoff loop did not converge"
    assert_same(ref, tw.p.results)
    assert (pprod.busy_events, pprod.skipped_pumps) == (rprod.busy_events, rprod.skipped_pumps)
    assert 0 < pprod.busy_events <= ticks / 2 + 1 and pprod.skipped_pumps >= pprod.busy_events


def test_straggler_detector_wired_into_tick():
    sched = P_stream.StreamScheduler(PSPEC, n_slots=2, chunk=32, backend="scan", device="cpu")
    sched.submit("a", _table(4, 200))
    sched.run()
    assert sched.straggler.n == sched.stats.ticks > 0
    sched.step()  # an idle tick does not feed the EMA
    assert sched.straggler.n == sched.stats.ticks
    flagged = sched.stats.straggler_ticks  # the run's own ticks: wall-clock
    sched.straggler = StragglerDetector(zscore=2.0, warmup_steps=1)
    ref = RStraggler(zscore=2.0, warmup_steps=1)
    for i, dt in enumerate((0.01, 0.01, 5.0)):
        sched._observe_tick_time(dt)
        ref.observe(sched.stats.ticks, dt)
        assert (sched.straggler.mean, sched.straggler.var) == (ref.mean, ref.var), i
    assert sched.stats.straggler_ticks == flagged + 1
    assert f"stream_tick_straggler_total {flagged + 1}" in sched.metrics_text()
    assert sched.metrics_snapshot()["stream_tick_seconds"]["count"] >= 3
