"""The slot-sharded stream — ``StreamScheduler(mesh=)``, ``StreamSession(
mesh=)``, the ``sharded_stream`` backend, snapshot/restore across meshes —
and the mesh pieces beside it (``elastic_mesh``, ``parallel/pipeline.py``,
the window's mesh helpers), on CPU meshes whose devices repeat.

The reference's own mesh stream paths fail under this jax before they
compute anything (the sharded scheduler raises ``ShardingTypeError``, a
sharded session indexes a sharded ref by integers), so the port is held
against what the reference's tests equate them to: the reference's
single-device scheduler and session and its ``viterbi_decode``, on the same
numpy inputs.  Bits and metrics are compared with no tolerance — slots are
independent lanes, and placement never changes what a slot's kernel sees —
except the ``sharded_stream`` grid's soft metrics, held at rtol 1e-5 as the
reference's decode grid holds its backends (tests/test_decode_api.py).

The cases mirror tests/multidevice/ (test_sharded_stream.py,
test_resilience_sharded.py, test_differential.py) at their shapes (K=3,
chunk 16 or 32, depth 30, 8 slots) on the (8, 1) and (4, 2) meshes: each
drives the reference oracle once and holds both meshes against it.
"""
import contextlib
import types

import jax  # noqa: F401  (both frameworks in one process; JAX stays on the CPU)
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_scheduler import chunks_of, specs, stream_rows

import repro.decode as RD
import repro.stream as R_stream
from repro.core import viterbi as R_vit
from repro.core.puncture import PUNCTURE_2_3
from repro.core.trellis import ConvCode as RCode
from repro.parallel import pipeline as R_pipe
from repro.train import fault_tolerance as R_ft
from repro_torch import decode as PD
from repro_torch import obs as P_obs
from repro_torch import stream as P_stream
from repro_torch.core.trellis import ConvCode as PCode
from repro_torch.kernels.common import plain_counts, reset_counts
from repro_torch.launch.mesh import make_mesh
from repro_torch.parallel import collectives as P_coll
from repro_torch.parallel import pipeline as P_pipe
from repro_torch.stream import window as P_w
from repro_torch.train.fault_tolerance import elastic_mesh

torch.set_num_threads(1)

RSPEC, PSPEC = specs()  # K=3 (7, 5), hard, terminated


def _mesh(shape, axes=("data", "model")):
    return make_mesh(shape, axes, devices=["cpu"] * int(np.prod(shape)))


MESH81, MESH42 = _mesh((8, 1)), _mesh((4, 2))
MESHES = {"mesh81": MESH81, "mesh42": MESH42}


def _tables(n, lengths, seed=0, flip=0.02, pspec=PSPEC, inputs="bm"):
    return {f"s{i}": stream_rows(pspec, seed + i, lengths[i % len(lengths)], inputs, flip)
            for i in range(n)}


def _submit_all(sched, tables):
    for sid, t in tables.items():
        sched.submit(sid, t)
    return sched.run()


def _reference(tables, rspec=RSPEC, **kw):
    """The reference's single-device scheduler on the same submissions."""
    return _submit_all(R_stream.StreamScheduler(rspec, **kw), tables)


def _port(tables, mesh, pspec=PSPEC, **kw):
    sched = P_stream.StreamScheduler(pspec, device="cpu", mesh=mesh, **kw)
    return _submit_all(sched, tables), sched


def assert_same_results(want, got):
    """Every stream's bits and metric equal, with no tolerance."""
    assert set(want) == set(got)
    for sid in want:
        np.testing.assert_array_equal(got[sid][0], want[sid][0], err_msg=sid)
        assert got[sid][1] == want[sid][1], (sid, got[sid][1], want[sid][1])


# --------------------------------------------------------------------------- #
# the sharded scheduler (tests/multidevice/test_sharded_stream.py)             #
# --------------------------------------------------------------------------- #


def test_sharded_scheduler_bit_exact_with_single_device():
    """Staggered lengths + slot turnover: both meshes commit the reference
    single-device scheduler's bits and metrics on every stream."""
    tables = _tables(10, (92, 60))
    kw = dict(n_slots=8, chunk=16, depth=30, backend="scan")
    want = _reference(tables, **kw)
    for mesh in MESHES.values():
        got, sched = _port(tables, mesh, **kw)
        assert sched.stats.streams_finished == 10
        assert sched.stats.slot_claims == 10 > sched.n_slots  # slots recycled
        assert_same_results(want, got)


def test_sharded_fused_backend_matches_reference_and_block_decode():
    """The unpacked kernel backend's hot loop (#7) once per shard a tick,
    depth >= T: the reference scheduler's results, and the full-block
    Viterbi decode's bits.  (The packed hot loop, #3 + #2 once per shard a
    tick, is held against the reference in the snapshot cases below.)"""
    tables = _tables(6, (60, 92), seed=20)
    kw = dict(n_slots=8, chunk=16, depth=96, backend="fused")
    want = _reference(tables, **kw)
    for mesh in MESHES.values():
        reset_counts()
        got, sched = _port(tables, mesh, **kw)
        assert_same_results(want, got)
        # once per shard a tick (the plain versions on the CPU)
        assert plain_counts["viterbi_scan_carry"] == sched.n_shards * sched.stats.ticks > 0
    for sid, t in tables.items():
        ref_bits, _ = R_vit.viterbi_decode(RSPEC.code, jnp.asarray(t)[None])
        np.testing.assert_array_equal(want[sid][0], np.asarray(ref_bits)[0])


def test_sharded_arena_compaction_with_live_sharded_slots():
    """Compaction rebuilds every shard's slab mid-run without disturbing
    live sharded streams."""
    tables = _tables(16, (60,), flip=0.01)
    kw = dict(n_slots=8, chunk=16, depth=30, backend="scan")
    want = _reference(tables, **kw)
    for mesh in MESHES.values():
        sched = P_stream.StreamScheduler(PSPEC, device="cpu", mesh=mesh, **kw)
        sched._compact_floor = 0
        sched._compact_ratio = 2
        got = _submit_all(sched, tables)
        assert sched.stats.arena_compactions > 0
        assert len({slab.shape for slab in sched._arena}) == 1  # uniform capacity
        assert_same_results(want, got)


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_sharded_state_layout_and_load_report(mesh_name):
    """The slot table is partitioned contiguously: each shard's pm rows,
    ring columns, offsets, counters and arena slab are its own blocks on its
    device, and the load report's reduced totals agree with the per-shard
    counts."""
    mesh = MESHES[mesh_name]
    n = mesh.shape["data"]
    sched = P_stream.StreamScheduler(
        PSPEC, n_slots=2 * n, chunk=16, depth=30, backend="scan", device="cpu", mesh=mesh,
        telemetry=P_obs.Telemetry(device_counters=True))
    assert sched.n_shards == n and sched.slots_per_shard == 2
    layout = P_w.state_shardings(mesh, "data")
    assert layout.pm.dim == 0 and layout.ring.dim == 1 and layout.pm.devices == mesh.shard_devices("data")
    assert len(sched.state.pm) == len(sched.state.ring) == len(sched._arena) == n
    assert all(pm.shape == (2, 4) for pm in sched.state.pm)
    assert all(ring.shape[1] == 2 for ring in sched.state.ring)
    assert all(len(leaf) == n and leaf[0].shape == (2,) for leaf in sched._counters)
    assert P_w.shard_stream_state(mesh, "data", sched.state).pm[0] is sched.state.pm[0]
    for sid, t in _tables(5, (92,)).items():
        sched.submit(sid, t)
    sched.step()
    report = sched.load_report()
    assert report["n_shards"] == n
    assert report["active_total"] == sum(report["per_shard_active"]) == 5
    assert report["queued_rows_total"] == sum(report["per_shard_queued_rows"])
    assert report["utilization"] == pytest.approx(5 / (2 * n))
    assert set(report["merge_depth"]) == {f"s{i}" for i in range(5)}
    # claims pop slots from the top: the first streams fill the last shards
    assert report["per_shard_active"][-1] == 2
    sched.run()


def test_sharded_session_matches_single_device():
    """A mesh-sharded StreamSession: the single-device session's bits chunk
    by chunk, and its metric, on both meshes — the reference's session
    (scan, bm tables), and for the packed hot loop on raw symbols with
    device counters the port's single-device session (held to the
    reference's by tests/test_torch_stream.py)."""
    rspec, pspec = specs("k3", "soft")
    rng = np.random.default_rng(5)
    bits = rng.integers(0, 2, (8, 124)).astype(np.int32)
    coded = pspec.encode(torch.from_numpy(bits)).numpy()
    rx = (1.0 - 2.0 * coded + 0.8 * rng.standard_normal(coded.shape)).astype(np.float32)
    bm = np.array(rspec.branch_metrics(jnp.asarray(rx)))
    tele = P_obs.Telemetry(device_counters=True)
    for backend, inputs, depth in (("scan", "bm", 128), ("fused_packed", "received", 30)):
        data = rx if inputs == "received" else bm
        if backend == "scan":
            ref = R_stream.StreamSession(rspec, batch=8, chunk=32, depth=depth, backend=backend)
            push, end = (lambda x: ref.push(jnp.asarray(x))), ref.finish
            wrap = jnp.asarray
        else:
            ref = P_stream.StreamSession(pspec, batch=8, chunk=32, depth=depth, backend=backend,
                                         inputs=inputs, device="cpu", telemetry=tele)
            push, end, wrap = ref.push, ref.finish, torch.from_numpy
        want = [np.asarray(push(wrap(data[:, i:i + 32]))) for i in range(0, 96, 32)]
        want_tail, want_metric = (np.asarray(x) for x in end(wrap(data[:, 96:])))
        for mesh in MESHES.values():
            sess = P_stream.StreamSession(pspec, batch=8, chunk=32, depth=depth, backend=backend,
                                          inputs=inputs, device="cpu", mesh=mesh, telemetry=tele)
            for i, w in zip(range(0, 96, 32), want):
                np.testing.assert_array_equal(sess.push(torch.from_numpy(data[:, i:i + 32])).numpy(), w)
            tail, metric = sess.finish(torch.from_numpy(data[:, 96:]))
            np.testing.assert_array_equal(tail.numpy(), want_tail)
            np.testing.assert_array_equal(metric.numpy(), want_metric)
            if backend != "scan":
                assert sess.device_counter_report() == ref.device_counter_report()


def test_session_and_scheduler_refuse_what_does_not_divide():
    """The reference's messages: the batch and the slot table must divide
    over the shards, and the mesh must have the axis."""
    for make in (lambda: P_stream.StreamSession(PSPEC, batch=3, chunk=32, device="cpu",
                                                mesh=MESH81),
                 lambda: P_stream.StreamScheduler(PSPEC, n_slots=12, chunk=16, device="cpu",
                                                  mesh=MESH81)):
        with pytest.raises(ValueError, match="divide evenly"):
            make()
    for make in (lambda: P_stream.StreamSession(PSPEC, batch=8, device="cpu", mesh=MESH81,
                                                mesh_axis="pod"),
                 lambda: P_stream.StreamScheduler(PSPEC, device="cpu", mesh=MESH81,
                                                  mesh_axis="pod")):
        with pytest.raises(ValueError, match="has no 'pod' axis"):
            make()


def test_planner_routes_streaming_mesh_to_sharded_stream():
    """ctx.streaming + a multi-shard data axis -> sharded_stream (as the
    reference plans); without a mesh the same context stays on streaming."""
    pspec = PD.CodecSpec(code=PSPEC.code)
    rspec = RD.CodecSpec(code=RSPEC.code)
    for mesh in MESHES.values():
        ctx = PD.DecodeContext(streaming=True, chunk=32, stream_depth=128, device="cpu",
                               mesh=mesh)
        rctx = RD.DecodeContext(streaming=True, chunk=32, stream_depth=128,
                                mesh=types.SimpleNamespace(shape=dict(mesh.shape)))
        assert PD.plan_decode(pspec, (8, 128), ctx=ctx).backend == "sharded_stream"
        assert RD.plan_decode(rspec, (8, 128), ctx=rctx).backend == "sharded_stream"
    ctx = PD.DecodeContext(streaming=True, chunk=32, stream_depth=128, device="cpu")
    assert PD.plan_decode(pspec, (8, 128), ctx=ctx).backend == "streaming"


GRID = [(code, metric, punctured, terminated) for code in ("k3", "k7")
        for metric in ("hard", "soft") for punctured in (False, True)
        for terminated in (True, False)]


@pytest.mark.parametrize("code", ["k3", "k7"])
def test_sharded_stream_backend_matches_reference_decode_over_the_grid(code):
    """The registry backend end to end at stream_depth = T over the decode
    grid's hard/soft x punctured x terminated cells: the reference's
    viterbi_decode's bits, hard metrics equal and soft metrics within rtol
    1e-5; B = 6 over the 4 shards of the (4, 2) mesh pads the slot table to
    8 slots, chunk 32 takes the packed hot loop.  (The reference decodes
    the cells of one termination flag in one call.)"""
    cells = {}
    for _, metric, punctured, terminated in [c for c in GRID if c[0] == code]:
        rspec, pspec = specs(code, metric, punctured, terminated)
        rng = np.random.default_rng(len(metric) + 2 * punctured + 4 * terminated)
        bits = rng.integers(0, 2, (6, 24)).astype(np.int32)
        coded = pspec.encode(torch.from_numpy(bits)).numpy()
        if pspec.soft:
            rx = (1.0 - 2.0 * coded + 0.7 * rng.standard_normal(coded.shape)).astype(np.float32)
        else:
            rx = (coded ^ (rng.random(coded.shape) < 0.04)).astype(np.float32)
        cells[(metric, punctured, terminated)] = (
            pspec, np.array(rspec.branch_metrics(jnp.asarray(rx))))
    want = {}
    for terminated in (True, False):
        keys = [k for k in cells if k[2] == terminated]
        stacked = np.concatenate([cells[k][1] for k in keys])
        ref_bits, ref_metric = R_vit.viterbi_decode(specs(code)[0].code, jnp.asarray(stacked),
                                                    terminated=terminated)
        for i, k in enumerate(keys):
            want[k] = (np.asarray(ref_bits)[6 * i:6 * i + 6],
                       np.asarray(ref_metric)[6 * i:6 * i + 6])
    for key, (pspec, bm) in cells.items():
        T = bm.shape[1]
        ctx = PD.DecodeContext(mesh=MESH42, streaming=True, chunk=32, stream_depth=T,
                               device="cpu")
        res = PD.get_decoder("sharded_stream")(pspec, torch.from_numpy(bm), ctx=ctx)
        assert res.diagnostics == {"backend": "sharded_stream", "shards": 4,
                                   "batch_axis": "data", "n_slots": 8, "depth": T,
                                   "hot_loop": "fused_packed"}
        np.testing.assert_array_equal(res.bits.numpy(), want[key][0], err_msg=str(key))
        if pspec.soft:
            np.testing.assert_allclose(res.path_metric.numpy(), want[key][1], rtol=1e-5,
                                       err_msg=str(key))
        else:
            np.testing.assert_array_equal(res.path_metric.numpy(), want[key][1])


def test_sharded_stream_backend_unpacked_hot_loop_matches_reference_backend():
    """A chunk that is no multiple of 32 takes the ``fused`` hot loop; the
    entry equals the reference's sequential decode and reports it."""
    rspec, pspec = specs("k7", "hard")
    bm = np.stack([stream_rows(pspec, 50 + i, 58) for i in range(4)])
    ref_bits, ref_metric = R_vit.viterbi_decode(rspec.code, jnp.asarray(bm))
    ctx = PD.DecodeContext(mesh=MESH81, streaming=True, chunk=16, stream_depth=64,
                           device="cpu")
    res = PD.get_decoder("sharded_stream")(pspec, torch.from_numpy(bm), ctx=ctx)
    assert res.diagnostics["hot_loop"] == "fused" and res.diagnostics["n_slots"] == 8
    np.testing.assert_array_equal(res.bits.numpy(), np.asarray(ref_bits))
    np.testing.assert_array_equal(res.path_metric.numpy(), np.asarray(ref_metric))


def test_sharded_online_chunk_fed_with_starvation():
    """Producer-fed streams with bursty arrivals starve their slots across
    shards; results equal the reference scheduler's fed the same way, and
    the per-shard queue accounting reduces coherently."""
    tables = _tables(6, (92, 60))
    kw = dict(n_slots=8, chunk=16, depth=30, backend="scan", max_buffered=64)

    def bursts(table):
        """11 rows a tick (nothing ready on the poll after a burst): a
        16-row chunk only every other tick, so slots starve."""
        chunks, ready = iter(chunks_of(table, [11] * 20)), [True]

        def poll(max_rows):
            ready[0] = not ready[0]
            return None if ready[0] else next(chunks)
        return poll

    def feed(pkg, sched):
        for sid, t in tables.items():
            sched.open_stream(sid, producer=bursts(t))

    ref = R_stream.StreamScheduler(RSPEC, **kw)
    feed(R_stream, ref)
    want = ref.run()
    for mesh in MESHES.values():
        sched = P_stream.StreamScheduler(PSPEC, device="cpu", mesh=mesh, **kw)
        feed(P_stream, sched)
        seen = {"queued": 0, "starved": 0}
        while sched.pending_work():
            sched.step()
            report = sched.load_report()
            assert report["queued_rows_total"] == sum(report["per_shard_queued_rows"])
            seen["queued"] = max(seen["queued"], report["queued_rows_total"])
            seen["starved"] = max(seen["starved"], report["starved_active"])
        assert seen["queued"] > 0 and sched.stats.starved_slot_ticks > 0
        assert_same_results(want, sched.results)


def test_sharded_submit_adapter_over_chunk_path():
    """submit() rides the chunk ingestion path (open + submit_chunk +
    close) on the mesh too, and both equal the reference."""
    tables = _tables(8, (60,))
    kw = dict(n_slots=8, chunk=16, depth=30, backend="scan")
    want = _reference(tables, **kw)
    for mesh in MESHES.values():
        via_submit, _ = _port(tables, mesh, **kw)
        via_chunks = P_stream.StreamScheduler(PSPEC, device="cpu", mesh=mesh, **kw)
        for sid, t in tables.items():
            via_chunks.open_stream(sid, max_buffered=max(via_chunks.max_buffered, len(t)))
            via_chunks.submit_chunk(sid, t[:37])
            via_chunks.submit_chunk(sid, t[37:], close=True)
        assert_same_results(want, via_submit)
        assert_same_results(want, via_chunks.run())


@pytest.mark.parametrize("device_counters", [False, True])
def test_sharded_tick_equals_stream_step_per_shard_and_is_memoized(device_counters):
    """make_sharded_stream_step: memoized on its static configuration when
    weight-free; one tick equals stream_step on each shard's rows, whole or
    pre-cut inputs alike."""
    code = PSPEC.code
    kw = dict(chunk=16, backend="fused", device_metrics=device_counters)
    tick = P_w.make_sharded_stream_step(code, MESH42, "data", **kw)
    assert P_w.make_sharded_stream_step(code, MESH42, "data", **kw) is tick
    B, C = 8, 16
    rng = np.random.default_rng(1)
    arena = [torch.from_numpy(rng.integers(0, 3, (40, 4)).astype(np.float32)) for _ in range(4)]
    idx = torch.from_numpy(rng.integers(0, 40, (B, C)).astype(np.int32))
    active = torch.from_numpy(rng.random(B) < 0.7)
    state = P_w.init_stream_state(code, B, 30, C, device="cpu")
    counters = P_w.init_device_counters(B, "cpu")
    sharded = P_w.shard_stream_state(MESH42, "data", state)
    args = (counters,) if device_counters else ()
    out = tick(arena, idx, active, sharded, *args)
    out_cut = tick(arena, torch.split(idx, 2), torch.split(active, 2), sharded,
                   *(P_w.DeviceCounters(*(torch.split(c, 2) for c in counters)),)[:len(args)])
    for i in range(4):
        rows = slice(2 * i, 2 * i + 2)
        block = arena[i][idx[rows].reshape(-1).long()].reshape(2, C, 4)
        want = P_w.stream_step(
            code, P_w.StreamState(state.pm[rows], state.ring[:, rows]), block,
            active=active[rows], backend="fused",
            counters=P_w.DeviceCounters(*(c[rows] for c in counters)) if device_counters else None)
        for got in (out, out_cut):
            assert torch.equal(got[0].pm[i], want[0].pm) and torch.equal(got[0].ring[i], want[0].ring)
            for k in range(1, len(want)):
                for a, b in zip(got[k] if k == 3 else (got[k],),
                                want[k] if k == 3 else (want[k],)):
                    assert torch.equal(a[i], b)


# --------------------------------------------------------------------------- #
# snapshot/restore across meshes (tests/multidevice/test_resilience_sharded)  #
# --------------------------------------------------------------------------- #

#: the chip's configuration, cut down: the packed hot loop on raw symbols
KW = dict(n_slots=8, chunk=32, backend="fused_packed", inputs="received")


def _feed_all(sched, tables):
    for sid, t in tables.items():
        sched.open_stream(sid, max_buffered=max(64, len(t)))
        sched.submit_chunk(sid, t, close=True)


@pytest.fixture(scope="module")
def resilience_case():
    """Ten streams of raw symbols and the reference single-device
    scheduler's results on them (the oracle of every case below)."""
    tables = _tables(10, (92, 60), seed=40, inputs="received")
    ref = R_stream.StreamScheduler(RSPEC, **KW)
    _feed_all(ref, tables)
    return tables, ref.run()


def test_sharded_received_inputs_in_kernel_metrics(resilience_case):
    """inputs='received' sharded, uninterrupted: raw symbols through the
    per-shard arena slabs, branch metrics in the scan — the reference's
    results on both meshes."""
    tables, want = resilience_case
    for mesh in MESHES.values():
        sched = P_stream.StreamScheduler(PSPEC, device="cpu", mesh=mesh, **KW)
        _feed_all(sched, tables)
        assert_same_results(want, sched.run())


def _cut(tables, mesh, ticks):
    sched = P_stream.StreamScheduler(PSPEC, device="cpu", mesh=mesh, **KW)
    _feed_all(sched, tables)
    for _ in range(ticks):
        sched.step()
    return sched


@pytest.mark.parametrize("snap_tick", [0, 2, 5])
def test_sharded_snapshot_restores_onto_same_mesh(resilience_case, snap_tick):
    import pickle

    tables, want = resilience_case
    snap = pickle.loads(pickle.dumps(_cut(tables, MESH81, snap_tick).snapshot()))
    restored = P_stream.StreamScheduler.restore(snap, mesh=MESH81, device="cpu")
    assert restored.n_shards == 8
    assert_same_results(want, restored.run())


def test_sharded_snapshot_restores_onto_single_device(resilience_case):
    """Host-failure drain: an 8-shard scheduler collapses onto one device;
    its snapshot has the single-device scheduler's format."""
    tables, want = resilience_case
    snap = _cut(tables, MESH81, 3).snapshot()
    single = _cut(tables, None, 3).snapshot()
    assert [im.stream_id for im in snap.active] == [im.stream_id for im in single.active]
    for a, b in zip(snap.active, single.active):
        np.testing.assert_array_equal(a.ring, b.ring)
        np.testing.assert_array_equal(a.pm, b.pm)
        np.testing.assert_array_equal(a.arena_rows, b.arena_rows)
        assert a.offset == b.offset
    restored = P_stream.StreamScheduler.restore(snap, device="cpu")
    assert restored.n_shards == 1
    assert_same_results(want, restored.run())


def test_single_device_snapshot_restores_onto_mesh(resilience_case):
    """Scale-up migration: single-device state fans out over 8 shards."""
    tables, want = resilience_case
    restored = P_stream.StreamScheduler.restore(_cut(tables, None, 3).snapshot(),
                                                mesh=MESH81, device="cpu")
    assert restored.n_shards == 8
    assert_same_results(want, restored.run())


def test_sharded_snapshot_restores_onto_smaller_mesh(resilience_case):
    """Elastic shrink, 8 -> 4 data shards: the mesh elastic_mesh rebuilds
    over five surviving devices."""
    tables, want = resilience_case
    survivors = elastic_mesh((8, 2), ("data", "model"), devices=["cpu"] * 11)
    assert dict(survivors.shape) == {"data": 4, "model": 2}
    restored = P_stream.StreamScheduler.restore(_cut(tables, MESH81, 4).snapshot(),
                                                mesh=survivors, device="cpu")
    assert restored.n_shards == 4
    assert_same_results(want, restored.run())


def test_sharded_tick_faults_survived_bit_exact(resilience_case):
    """Simulated device-step failures on the sharded tick: dropped ticks
    retry the same gather, the decode never changes."""
    tables, want = resilience_case
    sched = P_stream.StreamScheduler(PSPEC, device="cpu", mesh=MESH42, **KW)
    injector = P_stream.install_tick_faults(
        sched, P_stream.ChaosPolicy(seed=17, device_step_failure=0.25))
    _feed_all(sched, tables)
    reset_counts()
    guard = 0
    while sched.pending_work():
        sched.step()
        guard += 1
        assert guard < 1000
    assert injector.injected["device_step_failure"] > 0
    assert sched.stats.tick_device_failures == injector.injected["device_step_failure"]
    assert_same_results(want, sched.results)
    # the packed hot loop: #3 and #2 once per shard a completed tick (their
    # plain versions on the CPU), none for a dropped one
    assert plain_counts["viterbi_scan_packed_carry"] == plain_counts["traceback_packed"] \
        == 4 * sched.stats.ticks > 0


def test_sharded_snapshot_fuzz_points(resilience_case):
    """Seeded snapshot points under drip-fed arrivals on the mesh: pending,
    starved and mid-window streams all restore bit-exact."""
    tables, want = resilience_case
    rng = np.random.RandomState(7)
    for mesh, restore_onto in ((MESH81, MESH81), (MESH42, MESH81)):
        sched = P_stream.StreamScheduler(PSPEC, device="cpu", mesh=mesh, **KW)
        feeds = {sid: [t] for sid, t in tables.items()}
        for sid in tables:
            sched.open_stream(sid, max_buffered=256)
        snap_tick = int(rng.randint(1, 6))

        def feed(s):
            for sid, chunks in feeds.items():
                while chunks:
                    n = int(rng.randint(1, 80))
                    try:
                        s.submit_chunk(sid, chunks[0][:n])
                        rest = chunks[0][n:]
                        chunks.pop(0)
                        if len(rest):
                            chunks.insert(0, rest)
                    except P_stream.StreamBusy:
                        break
                    except KeyError:
                        chunks.clear()
                if not chunks:
                    with contextlib.suppress(KeyError):  # already retired
                        s.close(sid)

        for _ in range(snap_tick):
            feed(sched)
            sched.step()
        restored = P_stream.StreamScheduler.restore(sched.snapshot(), mesh=restore_onto,
                                                    device="cpu")
        guard = 0
        while restored.pending_work():
            feed(restored)
            restored.step()
            guard += 1
            assert guard < 2000
        assert_same_results(want, restored.results)


# --------------------------------------------------------------------------- #
# differential cases (tests/multidevice/test_differential.py, fixed draws)     #
# --------------------------------------------------------------------------- #

DIFF_CODES = {"k3": (3, (0b111, 0b101)), "k5": (5, (0o23, 0o33)), "k4": (4, (0b1111, 0b1101))}
#: (code, metric, punctured, terminated, info bits, seed) — drawn once from
#: the reference's strategy (decode_cases) and fixed, one a regime
DIFF_CASES = {"exact": ("k5", "soft", True, False, 41, 11),
              "truncated": ("k4", "hard", False, True, 57, 12)}


def _diff_specs(code, metric, punctured, terminated):
    K, polys = DIFF_CODES[code]
    kw = dict(metric=metric, puncture=PUNCTURE_2_3 if punctured else None,
              terminated=terminated)
    return RD.CodecSpec(code=RCode(K, polys), **kw), PD.CodecSpec(code=PCode(K, polys), **kw)


def _diff_tables(pspec, info, seed, batch=4):
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, (batch, info)).astype(np.int32)
    coded = pspec.encode(torch.from_numpy(bits)).numpy()
    if pspec.soft:
        rx = (1.0 - 2.0 * coded + 0.6 * rng.standard_normal(coded.shape)).astype(np.float32)
    else:
        rx = (coded ^ (rng.random(coded.shape) < 0.05)).astype(np.float32)
    return pspec.branch_metrics(torch.from_numpy(rx)).numpy()


@pytest.mark.parametrize("regime,depth", [("exact", 160), ("truncated", 24)])
def test_sharded_and_single_agree_on_drawn_cases(regime, depth):
    """depth >= T: the sharded scheduler, the reference single-device one
    and the offline fused_packed decode agree bit for bit; depth < T: the
    truncated commits of the sharded and single schedulers are identical
    (placement never changes the decode)."""
    code, metric, punctured, terminated, info, seed = DIFF_CASES[regime]
    rspec, pspec = _diff_specs(code, metric, punctured, terminated)
    bm = _diff_tables(pspec, info, seed)
    tables = {f"s{i}": bm[i] for i in range(len(bm))}
    kw = dict(n_slots=8, chunk=16, depth=depth, backend="scan")
    want = _reference(tables, rspec=rspec, **kw)
    got, _ = _port(tables, MESH81, pspec=pspec, **kw)
    assert_same_results(want, got)
    if depth >= bm.shape[1]:
        off = PD.get_decoder("fused_packed")(pspec, torch.from_numpy(bm),
                                             ctx=PD.DecodeContext(device="cpu"))
        for i in range(len(bm)):
            np.testing.assert_array_equal(got[f"s{i}"][0], off.bits.numpy()[i])
            assert got[f"s{i}"][1] == pytest.approx(float(off.path_metric[i]), rel=1e-4,
                                                    abs=1e-3)


def test_sharded_online_ingestion_matches_offline():
    """Chunk-fed arrival (bursty, starved, early-closed) through the
    sharded scheduler equals one-shot submission of the rows it got, on the
    reference's single-device scheduler, bit for bit."""
    plans = [(40, (7, 60), 1, False), (100, (33, 2, 50), 0, True), (16, (60,), 2, False),
             (72, (16, 16, 16), 0, False)]
    kw = dict(n_slots=8, chunk=16, depth=30, backend="scan")
    online = P_stream.StreamScheduler(PSPEC, device="cpu", mesh=MESH42, **kw)
    feeds, actual = {}, {}
    for i, (info, sizes, gap, early_close) in enumerate(plans):
        table = stream_rows(PSPEC, 300 + i, info, flip=0.05)
        chunks, k = [], 0
        for sz in sizes:
            chunks.append(table[k:k + sz])
            k += sz
            if k >= len(table):
                break
        if k < len(table) and not early_close:
            chunks.append(table[k:])
        sid = f"s{i}"
        actual[sid] = np.concatenate(chunks, axis=0)
        online.open_stream(sid)
        feeds[sid] = {"chunks": chunks, "gap": gap, "wait": 0}
    guard = 0
    while online.pending_work():
        for sid, f in feeds.items():
            if not f["chunks"]:
                continue
            if f["wait"] > 0:
                f["wait"] -= 1
                continue
            try:
                online.submit_chunk(sid, f["chunks"][0])
            except P_stream.StreamBusy:
                continue
            f["chunks"].pop(0)
            f["wait"] = f["gap"]
            if not f["chunks"]:
                online.close(sid)
        online.step()
        guard += 1
        assert guard < 2000
    assert_same_results(_reference(actual, **kw), online.results)


# --------------------------------------------------------------------------- #
# elastic_mesh, the pipeline, the collectives                                  #
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("n_devices", [8, 5, 3, 1])
def test_elastic_mesh_matches_reference_shapes(n_devices):
    cpu = jax.devices("cpu")[0]
    for prefer, axes in (((8, 1), ("data", "model")), ((2, 4), ("data", "model")),
                         ((4,), ("data",))):
        want = R_ft.elastic_mesh(prefer, axes, devices=[cpu] * n_devices)
        got = elastic_mesh(prefer, axes, devices=["cpu"] * n_devices)
        assert dict(got.shape) == dict(want.shape), (prefer, n_devices)
        assert got.axis_names == tuple(want.axis_names)


def test_elastic_mesh_without_devices_raises(monkeypatch):
    from repro_torch.launch import mesh as launch_mesh

    monkeypatch.setattr(launch_mesh, "visible_cards", lambda: [])
    with pytest.raises(ValueError, match="no devices"):
        elastic_mesh((8, 1), ("data", "model"))


def _layer_ref(w, h):
    return jnp.tanh(h @ w)


def _layer(w, h):
    return torch.tanh(h @ w)


def test_pipeline_single_stage_matches_reference():
    rng = np.random.default_rng(2)
    W = rng.standard_normal((1, 8, 8)).astype(np.float32)
    x = rng.standard_normal((3, 4, 8)).astype(np.float32)
    want = R_pipe.pipeline_apply(_layer_ref, jnp.asarray(W), jnp.asarray(x),
                                 mesh=jax.make_mesh((1,), ("stage",)), axis="stage")
    got = P_pipe.pipeline_apply(_layer, torch.from_numpy(W), torch.from_numpy(x),
                                mesh=_mesh((1,), ("stage",)), axis="stage")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)
    for n, m in ((4, 12), (2, 1), (1, 5)):
        assert P_pipe.bubble_fraction(n, m) == R_pipe.bubble_fraction(n, m)


@pytest.mark.parametrize("n_stages", [2, 4])
def test_pipeline_stages_compose_the_layers(n_stages):
    """n stages over M microbatches equal the plain composition of the n
    layers on each microbatch (stage parameters a pytree)."""
    rng = np.random.default_rng(n_stages)
    W = torch.from_numpy(0.5 * rng.standard_normal((n_stages, 8, 8)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((n_stages, 8)).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((5, 4, 8)).astype(np.float32))
    got = P_pipe.pipeline_apply(lambda p, h: torch.tanh(h @ p["w"] + p["b"]), {"w": W, "b": b},
                                x, mesh=_mesh((n_stages,), ("stage",)))
    want = x
    for s in range(n_stages):
        want = torch.tanh(want @ W[s] + b[s])
    torch.testing.assert_close(got, want, rtol=1e-5, atol=0)


def test_gather_and_ring_shift_move_each_shard_once():
    mesh = _mesh((4,), ("stage",))
    parts = [torch.full((2,), float(i)) for i in range(4)]
    before = dict(P_coll.calls)
    np.testing.assert_array_equal(P_coll.gather(mesh, "stage", parts).numpy(),
                                  np.repeat(np.arange(4.0), 2).reshape(4, 2))
    shifted = P_coll.ring_shift(mesh, "stage", parts)
    assert [float(t[0]) for t in shifted] == [3.0, 0.0, 1.0, 2.0]
    assert P_coll.calls["gather"] == before.get("gather", 0) + 1
    assert P_coll.calls["ring_shift"] == before.get("ring_shift", 0) + 1
    with pytest.raises(ValueError, match="ring_shift over stage=4 got 3"):
        P_coll.ring_shift(mesh, "stage", parts[:3])
