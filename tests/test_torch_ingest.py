"""Online ingestion in the port held against the reference: the producer
adapters of ``repro_torch.stream.ingest`` beside ``repro.stream.ingest`` on
the same polls, and the chunk-fed scheduler on the CPU beside the live
reference scheduler through the :class:`Twin` of test_torch_scheduler.py
(every call's result and the observable state after it, exactly).

The invariant the reference's ingestion tests lean on holds here too:
ARRIVAL SCHEDULE NEVER CHANGES THE DECODE — bursty, drip-fed, starved or
early-closed, the committed bits and final metric equal the one-shot
``submit`` of the concatenated rows (and, at depth >= T, the offline block
decode).  The cases follow tests/test_stream_ingest.py, ported.
"""
import numpy as np
import pytest
import torch
from test_torch_scheduler import Twin, assert_same, chunks_of, offline_bits, specs, stream_rows

import repro.stream as R_stream
from repro_torch import obs as P_obs
from repro_torch import stream as P_stream

torch.set_num_threads(1)

RSPEC, PSPEC = specs()
M = PSPEC.code.n_symbols


# --------------------------------------------------------------------------- #
# producer adapters, poll for poll against the reference's                     #
# --------------------------------------------------------------------------- #


def _polls(make, polls):
    """Each package's producer from ``make(pkg)``, polled with the same
    credits: results and ``exhausted`` after each poll."""
    outs = []
    for pkg in (R_stream, P_stream):
        prod = make(pkg)
        outs.append([(prod.poll(n), prod.exhausted) for n in polls])
    assert_same(outs[0], outs[1])
    return outs[1]


def test_generator_producer_splits_and_fills_credit():
    rows = np.arange(20, dtype=np.float32).reshape(10, 2)
    got = _polls(lambda pkg: pkg.GeneratorProducer(iter([rows[:7], rows[7:]])), (3, 4, 100, 5))
    assert_same([g for g, _ in got[:3]], [rows[:3], rows[3:7], rows[7:]])
    assert got[3] == (None, True)
    tiny = _polls(lambda pkg: pkg.GeneratorProducer(rows[i:i + 1] for i in range(10)), (8, 8, 1))
    assert_same(tiny[0][0], rows[:8])
    assert _polls(lambda pkg: pkg.GeneratorProducer(iter([rows])), (0,)) == [(None, False)]


def test_callable_producer_none_means_not_ready():
    def make(pkg):
        state = {"n": 0}

        def fn(max_rows):
            state["n"] += 1
            if state["n"] == 1:
                return None
            if state["n"] == 2:
                return np.ones((4, 2), np.float32)
            raise StopIteration

        return pkg.CallableProducer(fn)

    got = _polls(make, (8, 8, 8))
    assert got[0] == (None, False) and got[1][0].shape == (4, 2) and got[2] == (None, True)


def test_push_producer_feed_poll_and_bound():
    for pkg in (R_stream, P_stream):
        prod = pkg.PushProducer(max_rows=8)
        prod.feed(np.zeros((5, 2), np.float32))
        with pytest.raises(pkg.StreamBusy):
            prod.feed(np.zeros((4, 2), np.float32), block=False)
        assert prod.poll(3).shape == (3, 2)
        prod.feed(np.zeros((4, 2), np.float32), block=False)
        prod.close()
        assert not prod.exhausted
        assert prod.poll(100).shape == (6, 2) and prod.exhausted
        with pytest.raises(RuntimeError, match="closed"):
            prod.feed(np.zeros((1, 2), np.float32))
        with pytest.raises(pkg.StreamBusy, match="queue full"):
            full = pkg.PushProducer(max_rows=2)
            full.feed(np.zeros((2, 2), np.float32))
            full.feed(np.zeros((1, 2), np.float32), timeout=0.01)


def test_as_producer_coercion_and_rate_limit():
    for pkg in (R_stream, P_stream):
        assert isinstance(pkg.as_producer(iter([])), pkg.GeneratorProducer)
        assert isinstance(pkg.as_producer([np.zeros((1, 2))]), pkg.GeneratorProducer)
        assert isinstance(pkg.as_producer(lambda n: None), pkg.CallableProducer)
        p = pkg.PushProducer()
        assert pkg.as_producer(p) is p
    table = np.arange(40, dtype=np.float32).reshape(20, 2)

    def make(pkg):
        now = iter([0.0, 0.0, 0.5, 10.0, 10.0, 10.0])
        return pkg.RateLimitedProducer(table, rows_per_s=10.0, clock=lambda: next(now))

    got = _polls(make, (100, 100, 4, 100))
    assert got[0] == (None, False)
    assert_same([g for g, _ in got[1:]], [table[:5], table[5:9], table[9:]])
    assert got[-1][1]


# --------------------------------------------------------------------------- #
# chunk-fed decode == one-shot submit == offline block decode                  #
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("backend,chunk", [("scan", 16), ("fused", 16), ("fused_packed", 32)])
def test_chunk_fed_bit_exact_vs_offline(backend, chunk):
    """Drip-fed arrival (sizes unrelated to the decode chunk, an early
    close mid-chunk): equal to the reference, and at depth >= T to the
    offline block decode."""
    tw = Twin(RSPEC, PSPEC, n_slots=2, chunk=chunk, depth=400, backend=backend)
    tables, feeds = {}, {}
    for i in range(4):
        tables[f"s{i}"] = stream_rows(PSPEC, i, (91, 130, 64, 175)[i])
        feeds[f"s{i}"] = chunks_of(tables[f"s{i}"], (5, 31, 2, 64, 17, 9, 50))
        tw.open_stream(f"s{i}")
    tw.run_fed(feeds)
    for sid, table in tables.items():
        bits, metric = offline_bits(PSPEC, table)
        assert_same(bits, tw.p.results[sid][0])
        assert tw.p.results[sid][1] == metric


@pytest.mark.parametrize("backend,chunk", [("scan", 16), ("fused_packed", 32)])
def test_starved_slot_idles_without_corruption(backend, chunk):
    """A stream fed one chunk every third tick starves its slot while a
    neighbour keeps decoding; starvation never evicts."""
    tw = Twin(RSPEC, PSPEC, n_slots=2, chunk=chunk, depth=16 * chunk, backend=backend)
    table_a = stream_rows(PSPEC, 0, 8 * chunk - 2, flip=0.05)
    table_b = stream_rows(PSPEC, 1, 6 * chunk - 2, flip=0.05)
    tw.submit("a", table_a)
    tw.open_stream("b")
    fed, tick = 0, 0
    while tw.p.pending_work():
        if fed < len(table_b) and tick % 3 == 0:
            n = min(chunk, len(table_b) - fed)
            tw.submit_chunk("b", table_b[fed:fed + n])
            fed += n
            if fed == len(table_b):
                tw.close("b")
        tick += 1
        tw.step()
        assert "b" in {st.stream_id for st in tw.p.active.values()} or "b" in tw.p.results
    assert tw.p.stats.starved_slot_ticks > 0
    for sid, table in (("a", table_a), ("b", table_b)):
        assert_same(offline_bits(PSPEC, table)[0], tw.p.results[sid][0])


def test_submit_is_adapter_over_chunk_path(monkeypatch):
    tw = Twin(RSPEC, PSPEC, n_slots=2, chunk=16, depth=30, backend="scan")
    calls = {"open": 0, "chunk": 0}
    orig_open, orig_chunk = tw.p.open_stream, tw.p.submit_chunk

    def open_spy(*a, **k):
        calls["open"] += 1
        return orig_open(*a, **k)

    def chunk_spy(*a, **k):
        calls["chunk"] += 1
        return orig_chunk(*a, **k)

    monkeypatch.setattr(tw.p, "open_stream", open_spy)
    monkeypatch.setattr(tw.p, "submit_chunk", chunk_spy)
    tw.submit("s", stream_rows(PSPEC, 0, 62))
    assert next(iter(tw.p.active.values())).closed
    tw.run()
    assert calls == {"open": 1, "chunk": 1}


# --------------------------------------------------------------------------- #
# backpressure                                                                 #
# --------------------------------------------------------------------------- #


def test_submit_chunk_credit_and_stream_busy():
    tw = Twin(RSPEC, PSPEC, n_slots=1, chunk=16, depth=30, backend="scan", max_buffered=32)
    table = stream_rows(PSPEC, 0, 126)
    tw.open_stream("s")
    assert tw.credit("s") == 32
    assert tw.submit_chunk("s", table[:20]) == 12
    with pytest.raises(P_stream.StreamBusy) as exc:
        tw.submit_chunk("s", table[20:40])  # 20 > 12: the reference raises the same
    assert (exc.value.credit, exc.value.offered) == (12, 20)
    assert tw.p.stats.busy_rejections == 1 and tw.credit("s") == 12
    tw.step()
    assert tw.credit("s") == 28
    tw.submit_chunk("s", table[20:40])
    fed = 40
    while fed < len(table):
        n = min(tw.credit("s"), len(table) - fed)
        if n:
            tw.submit_chunk("s", table[fed:fed + n])
            fed += n
        tw.step()
    tw.close("s")
    assert tw.run()["s"][0].shape == (len(table),)


def test_backpressure_bounds_queue_depth():
    """A producer can never push a stream's unconsumed rows past its bound."""
    tw = Twin(RSPEC, PSPEC, n_slots=1, chunk=16, depth=30, backend="scan", max_buffered=48)
    table = stream_rows(PSPEC, 0, 510)
    tw.open_stream("s", producer=lambda pkg, sched: iter([table]))  # one 512-row burst
    depths = []
    while tw.p.pending_work():
        tw.step()
        depths.append(tw.p.load_report()["queued_rows_total"])
    assert max(depths) <= 48


def test_producer_fed_run_drains_everything():
    tw = Twin(RSPEC, PSPEC, n_slots=2, chunk=16, depth=300, backend="scan", max_buffered=40)
    tables = {}
    for i in range(5):
        tables[f"s{i}"] = stream_rows(PSPEC, i, (80, 130, 62)[i % 3])
        tw.open_stream(f"s{i}", producer=lambda pkg, sched, t=tables[f"s{i}"]: chunks_of(
            t, (9, 33, 5, 70, 21, 48)))
    out = tw.run()
    for sid, table in tables.items():
        assert_same(offline_bits(PSPEC, table)[0], out[sid][0])


def test_run_raises_on_starved_stream_without_producer():
    tw = Twin(RSPEC, PSPEC, n_slots=1, chunk=16, depth=30, backend="scan")
    tw.open_stream("stuck")
    tw.submit_chunk("stuck", stream_rows(PSPEC, 0, 6))
    with pytest.raises(RuntimeError, match="starved with no producer"):
        tw.run()
    tw.close("stuck")
    assert "stuck" in tw.run()


# --------------------------------------------------------------------------- #
# lifecycle edges of the chunk path                                            #
# --------------------------------------------------------------------------- #


def test_open_close_zero_rows_and_early_close_mid_chunk():
    tw = Twin(RSPEC, PSPEC, n_slots=2, chunk=32, depth=200, backend="scan")
    tw.open_stream("empty")
    tw.close("empty")
    table = stream_rows(PSPEC, 0, 75)  # 77 steps: 2 full chunks + a 13-row tail
    tw.open_stream("s")
    tw.submit_chunk("s", table[:64])
    tw.step()
    tw.submit_chunk("s", table[64:])
    tw.close("s")
    out = tw.run()
    assert out["empty"][0].shape == (0,)
    assert_same(offline_bits(PSPEC, table)[0], out["s"][0])


def test_chunk_api_validation():
    with pytest.raises(ValueError, match="max_buffered"):
        P_stream.StreamScheduler(PSPEC, n_slots=1, chunk=16, backend="scan", max_buffered=8,
                                 device="cpu")
    tw = Twin(RSPEC, PSPEC, n_slots=1, chunk=16, depth=30, backend="scan")
    with pytest.raises(ValueError, match="max_buffered"):
        tw.open_stream("tiny-bound", max_buffered=4)
    with pytest.raises(ValueError, match="ttl_ticks"):
        tw.open_stream("ttl", ttl_ticks=0)
    with pytest.raises(KeyError, match="unknown or finished"):
        tw.submit_chunk("nope", np.zeros((4, M), np.float32))
    with pytest.raises(KeyError, match="unknown or finished"):
        tw.close("nope")
    tw.open_stream("s")
    with pytest.raises(KeyError, match="duplicate"):
        tw.open_stream("s")
    with pytest.raises(ValueError, match="shaped"):
        tw.submit_chunk("s", np.zeros((4, 3), np.float32))
    tw.close("s")
    with pytest.raises(RuntimeError, match="closed"):
        tw.submit_chunk("s", np.zeros((4, M), np.float32))
    with pytest.raises(RuntimeError, match="closed"):
        tw.attach_producer("s", producer=lambda pkg, sched: iter([]))
    tw.run()
    with pytest.raises(KeyError):
        tw.close("s")


def test_evict_pending_chunk_fed_stream_and_load_report():
    tw = Twin(RSPEC, PSPEC, n_slots=1, chunk=16, depth=30, backend="scan", max_buffered=64)
    tw.submit("a", stream_rows(PSPEC, 0, 158))
    tw.open_stream("b")
    tw.submit_chunk("b", stream_rows(PSPEC, 1, 62))
    assert tw.evict("b") is None
    assert set(tw.run()) == {"a"}
    tw2 = Twin(RSPEC, PSPEC, n_slots=2, chunk=16, depth=30, backend="scan", max_buffered=64)
    table = stream_rows(PSPEC, 2, 62)
    tw2.open_stream("starved")
    tw2.open_stream("fed")
    tw2.submit_chunk("fed", table[:40])
    report = tw2.p.load_report()
    assert (report["active_total"], report["queued_rows_total"]) == (2, 40)
    assert report["starved_active"] >= 1 and sum(report["per_shard_queued_rows"]) == 40
    tw2.submit_chunk("fed", table[40:], close=True)
    tw2.close("starved")
    tw2.run()
    assert tw2.p.load_report()["queued_rows_total"] == 0


# --------------------------------------------------------------------------- #
# arrival-schedule fuzz (seeded, a few cases)                                  #
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fuzz_arrival_schedule_invariance(seed):
    """Drawn per-stream plans (bursty sizes, starvation gaps, early EOF):
    the online decode, full telemetry on, equals the reference tick for
    tick and the port's one-shot ``submit`` of the same rows.  Chunks are
    split to the credit (a chunk larger than a starved stream's credit
    never fits whole; see ``Twin.run_fed``)."""
    rng = np.random.default_rng(seed)
    online = Twin(RSPEC, PSPEC, n_slots=2, chunk=16, depth=400, backend="scan",
                  telemetry=lambda obs: obs.Telemetry.enabled(device_counters=True))
    offline = P_stream.StreamScheduler(PSPEC, n_slots=2, chunk=16, depth=400, backend="scan",
                                       device="cpu")
    feeds = {}
    for i in range(int(rng.integers(2, 5))):
        table = stream_rows(PSPEC, 1000 * seed + i, int(rng.integers(20, 141)), flip=0.04)
        chunks = chunks_of(table, tuple(rng.integers(1, 71, int(rng.integers(1, 9)))))
        if rng.integers(0, 2):
            chunks = chunks[:max(1, len(chunks) - 1)]  # early EOF: drop the tail
        offline.submit(f"s{i}", np.concatenate(chunks))
        online.open_stream(f"s{i}")
        feeds[f"s{i}"] = chunks
    online.run_fed(feeds, every=int(rng.integers(1, 4)))
    assert_same(offline.run(), online.p.results)
    assert isinstance(online.p.telemetry, P_obs.Telemetry)
