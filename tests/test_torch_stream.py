"""The port's streaming route held against the reference on identical numpy
inputs: the plain carried unpacked scan against the Pallas
``viterbi_scan_carry`` (interpret mode), ``stream_step`` (pm, ring,
committed bits, delta and DeviceCounters, under an ``active`` mask) for the
``fused``, ``fused_packed`` (bm and received) and ``scan`` backends, the
survivor merge depth, ``StreamSession`` push for push and at ``finish``, the
``streaming`` backend through ``decode()``, and the obs primitives.  Bits
and metrics exactly, soft included."""
import dataclasses
import io
import json

import jax  # noqa: F401  (both frameworks in one process; JAX stays on the CPU)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.decode as RD
import repro.obs as R_obs
from repro.core.puncture import PUNCTURE_2_3
from repro.core.trellis import NEG_UNREACHABLE
from repro.core.trellis import ConvCode as RCode
from repro.kernels import viterbi_scan as R_scan
from repro.kernels.metrics import fused_metric_plan as r_plan
from repro.stream import StreamSession as RSession
from repro.stream import window as R_w
from repro_torch import decode as PD
from repro_torch import obs as P_obs
from repro_torch.core.trellis import ConvCode as PCode
from repro_torch.kernels import viterbi_scan
from repro_torch.kernels.common import plain_counts, reset_counts
from repro_torch.kernels.metrics import fused_metric_plan as p_plan
from repro_torch.stream import StreamSession as PSession
from repro_torch.stream import window as P_w

torch.set_num_threads(1)

CPU = PD.DecodeContext(device="cpu")
CODES = {"k3": (3, (0b111, 0b101)), "k7": (7, (0o171, 0o133))}
B = 8  # one reference lane block
#: (backend, inputs) of every session kind
KINDS = [("fused", "bm"), ("scan", "bm"), ("fused_packed", "bm"), ("fused_packed", "received")]


def _pair(name):
    K, polys = CODES[name]
    return RCode(K, polys), PCode(K, polys)


def _specs(name, metric="hard", punctured=False, terminated=True):
    K, polys = CODES[name]
    kw = dict(metric=metric, puncture=PUNCTURE_2_3 if punctured else None,
              terminated=terminated)
    return RD.CodecSpec(code=RCode(K, polys), **kw), PD.CodecSpec(code=PCode(K, polys), **kw)


def _eq(a, b, msg=""):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=msg)


def _rx(pspec, seed, batch, n_info):
    """Channel output for random info bits, made with numpy."""
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, (batch, n_info)).astype(np.int32)
    coded = pspec.encode(torch.from_numpy(bits)).numpy()
    if pspec.soft:
        return bits, ((1.0 - 2.0 * coded) + 0.7 * rng.standard_normal(coded.shape)).astype(
            np.float32)
    return bits, (coded ^ (rng.random(coded.shape) < 0.05)).astype(np.int32)


def _ring(ring, packed):
    """A reference ring as int32 numpy in the port's storage."""
    r = np.asarray(ring)
    return r.view(np.int32) if packed else r


# --------------------------------------------------------------------------- #
# the carried unpacked scan                                                    #
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("name", ["k3", "k7"])
@pytest.mark.parametrize("tables", ["int", "soft"])
@pytest.mark.parametrize("C", [32, 45])
def test_plain_carry_scan_matches_pallas_kernel(name, tables, C):
    rc, pc = _pair(name)
    rng = np.random.default_rng(C)
    if tables == "int":
        bm = rng.integers(0, 3, (B, C, pc.n_symbols)).astype(np.float32)
    else:
        bm = rng.standard_normal((B, C, pc.n_symbols)).astype(np.float32)
    pm0 = rng.integers(0, 9, (B, pc.n_states)).astype(np.float32)
    pm0[rng.random(pm0.shape) < 0.4] = NEG_UNREACHABLE
    ref_pm, ref_bps = R_scan.viterbi_scan_carry(
        rc, jnp.asarray(pm0.T), jnp.asarray(bm.transpose(1, 2, 0)), B, None)
    reset_counts()
    pm, bps = viterbi_scan.viterbi_scan_carry(pc, torch.from_numpy(pm0), torch.from_numpy(bm))
    assert plain_counts["viterbi_scan_carry"] == 1
    assert bps.shape == (C, B, pc.n_states) and bps.dtype == torch.int32
    _eq(pm, np.asarray(ref_pm).T)
    _eq(bps, np.asarray(ref_bps).transpose(0, 2, 1))
    want = P_w.chunk_forward_scan(pc, torch.from_numpy(pm0), torch.from_numpy(bm))
    _eq(bps, want[1])
    _eq(pm, want[0])


# --------------------------------------------------------------------------- #
# stream_step                                                                  #
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("backend,inputs", KINDS)
@pytest.mark.parametrize("metric", ["hard", "soft"])
def test_stream_step_matches_reference(backend, inputs, metric):
    rspec, pspec = _specs("k3", metric, punctured=(inputs == "received"))
    rc, pc = rspec.code, pspec.code
    chunk, depth = 32, 32
    packed = backend == "fused_packed"
    _, rx = _rx(pspec, 17, B, 4 * chunk - pspec.n_flush)
    rplan = r_plan(rc, metric, rspec.puncture_array)
    pplan = p_plan(pc, metric, pspec.puncture_array)
    rstate = R_w.init_stream_state(rc, B, depth, chunk, packed=packed)
    pstate = P_w.init_stream_state(pc, B, depth, chunk, packed=packed, device="cpu")
    rctr, pctr = R_w.init_device_counters(B), P_w.init_device_counters(B, device="cpu")
    rw = rplan.folded() if inputs == "received" else None
    pw = pplan.folded() if inputs == "received" else None
    actives = [None, np.asarray([1, 0, 1, 1, 0, 1, 1, 1], bool), np.ones(B, bool),
               np.asarray([0, 1, 1, 0, 1, 1, 0, 1], bool)]
    for i, active in enumerate(actives):
        t0 = i * chunk
        sl = slice(t0, t0 + chunk)
        if inputs == "received":
            rdata = rplan.features(jnp.asarray(rx[:, sl]), t0)
            pdata = pplan.features(torch.from_numpy(rx[:, sl]), t0)
        else:
            rdata = rspec.branch_metrics(jnp.asarray(rx[:, sl]))
            pdata = torch.from_numpy(np.array(rdata))
        ra = None if active is None else jnp.asarray(active)
        pa = None if active is None else torch.from_numpy(active)
        rstate, rbits, rdelta, rctr = R_w.stream_step(
            rc, rstate, rdata, rw, ra, backend=backend, counters=rctr)
        pstate, pbits, pdelta, pctr = P_w.stream_step(
            pc, pstate, pdata, pw, pa, backend=backend, counters=pctr)
        msg = f"{backend}/{inputs}/{metric} step {i}"
        _eq(pstate.pm, rstate.pm, msg)
        _eq(pstate.ring, _ring(rstate.ring, packed), msg)
        live = np.ones(B, bool) if active is None else active
        _eq(pbits.numpy()[live], np.asarray(rbits)[live], msg)
        _eq(pdelta, rdelta, msg)
        for field, got, want in zip(P_w.DeviceCounters._fields, pctr, rctr):
            _eq(got, want, f"{msg}: {field}")
    # without counters and without normalization: the 3-tuple
    out = P_w.stream_step(pc, pstate, pdata, pw, backend=backend, normalize=False)
    assert len(out) == 3 and not out[2].any()


@pytest.mark.parametrize("name", ["k3", "k7"])
@pytest.mark.parametrize("packed", [False, True])
def test_survivor_merge_depth_matches_reference(name, packed):
    rc, pc = _pair(name)
    rng = np.random.default_rng(3)
    R, S = 64, pc.n_states
    bps = (rng.random((R, B, S)) < 0.3).astype(np.int32)
    bps[:, 1] = 0  # a row whose walkers merge fast
    bps[:, 2] = np.arange(S) % 2  # and one that keeps its walkers apart longer
    if packed:
        from repro.kernels.survivors import pack_survivors

        ring = np.array(pack_survivors(jnp.asarray(bps)))
        got = P_w.survivor_merge_depth(pc, torch.from_numpy(ring.view(np.int32)), packed=True)
    else:
        ring = bps
        got = P_w.survivor_merge_depth(pc, torch.from_numpy(ring))
    want = R_w.survivor_merge_depth(rc, jnp.asarray(ring))
    assert got.dtype == torch.int32
    _eq(got, want)


def test_stream_step_rejects_bad_backends_and_chunks():
    _, pc = _pair("k3")
    state = P_w.init_stream_state(pc, 2, 32, 32, packed=True, device="cpu")
    with pytest.raises(ValueError, match="chunk"):
        P_w.stream_step(pc, state, torch.zeros((2, 20, 4)), backend="fused_packed")
    with pytest.raises(KeyError):
        P_w.stream_step(pc, P_w.init_stream_state(pc, 2, 8, 8, device="cpu"),
                        torch.zeros((2, 8, 4)), backend="nope")
    with pytest.raises(ValueError, match="packed ring"):
        P_w.init_stream_state(pc, 2, 10, 32, packed=True, device="cpu")
    assert P_w.packed_depth(35) == R_w.packed_depth(35) == 64
    assert P_w.default_depth(pc) == R_w.default_depth(_pair("k3")[0])


# --------------------------------------------------------------------------- #
# StreamSession                                                                #
# --------------------------------------------------------------------------- #


def _session_inputs(rspec, pspec, inputs, n_info, seed):
    _, rx = _rx(pspec, seed, 3, n_info)
    if inputs == "received":
        return rx, rx
    bm = np.array(rspec.branch_metrics(jnp.asarray(rx)))
    return bm, bm


@pytest.mark.parametrize("backend,inputs", KINDS)
@pytest.mark.parametrize("name,metric,punctured,terminated", [
    ("k3", "hard", False, True), ("k7", "soft", True, False), ("k7", "hard", True, True),
])
def test_session_matches_reference_push_for_push(backend, inputs, name, metric, punctured,
                                                 terminated):
    rspec, pspec = _specs(name, metric, punctured, terminated)
    chunk = 32
    # T = 4 chunks + an odd tail of 9 steps; the default depth (5K) keeps the
    # session in the truncation regime
    data_r, data_p = _session_inputs(rspec, pspec, inputs, 4 * chunk + 9 - pspec.n_flush, 29)
    rs = RSession(rspec, batch=3, chunk=chunk, backend=backend, inputs=inputs)
    ps = PSession(pspec, batch=3, chunk=chunk, backend=backend, inputs=inputs, device="cpu")
    assert (ps.depth, ps.ring_size) == (rs.depth, rs.ring_size)
    for i in range(4):
        sl = slice(i * chunk, (i + 1) * chunk)
        got = ps.push(torch.from_numpy(data_p[:, sl]))
        want = rs.push(jnp.asarray(data_r[:, sl]))
        _eq(got, want, f"push {i}")
        assert ps.lag == rs.lag
        _eq(ps.offset, rs.offset)
    tail = slice(4 * chunk, None)
    bits, metric = ps.finish(torch.from_numpy(data_p[:, tail]))
    rbits, rmetric = rs.finish(jnp.asarray(data_r[:, tail]))
    _eq(bits, rbits)
    _eq(metric, rmetric)
    with pytest.raises(RuntimeError):
        ps.push(torch.from_numpy(data_p[:, :chunk]))


@pytest.mark.parametrize("backend,inputs", KINDS)
def test_session_at_full_depth_equals_the_block_decode(backend, inputs):
    rspec, pspec = _specs("k7", "hard", False, True)
    data_r, data_p = _session_inputs(rspec, pspec, inputs, 90, 31)
    T = data_p.shape[1]
    ps = PSession(pspec, batch=3, chunk=32, depth=T + 32, backend=backend, inputs=inputs,
                  device="cpu")
    bits, metric = ps.decode_all(torch.from_numpy(data_p))
    rbits, rmetric = RSession(rspec, batch=3, chunk=32, depth=T + 32, backend=backend,
                              inputs=inputs).decode_all(jnp.asarray(data_r))
    _eq(bits, rbits)
    _eq(metric, rmetric)
    # depth >= T: the window holds the whole history, so the flush IS the
    # sequential decode
    rx = data_p if inputs == "received" else None
    bm = pspec.branch_metrics(torch.from_numpy(rx)) if rx is not None else torch.from_numpy(data_p)
    seq = PD.get_decoder("sequential")(pspec, bm, ctx=CPU)
    _eq(bits, seq.bits)
    _eq(metric, seq.path_metric)


def test_session_counters_spans_and_guards():
    rspec, pspec = _specs("k3")
    data_r, data_p = _session_inputs(rspec, pspec, "bm", 64 - pspec.n_flush, 5)
    tele = P_obs.Telemetry.enabled()
    ps = PSession(pspec, batch=3, chunk=32, backend="fused_packed", telemetry=tele, device="cpu")
    rs = RSession(rspec, batch=3, chunk=32, backend="fused_packed",
                  telemetry=R_obs.Telemetry.enabled())
    for i in range(2):
        ps.push(torch.from_numpy(data_p[:, 32 * i:32 * (i + 1)]))
        rs.push(jnp.asarray(data_r[:, 32 * i:32 * (i + 1)]))
    assert ps.device_counter_report() == rs.device_counter_report()
    assert len(tele.tracer.durations_s("push")) == 2
    bad = data_p[:, :32].copy()
    bad[1, 3, 0] = np.nan
    with pytest.raises(ValueError, match="non-finite"):
        ps.push(torch.from_numpy(bad))
    with pytest.raises(ValueError, match="non-finite"):
        ps.finish(torch.from_numpy(bad[:, :5]))
    with pytest.raises(ValueError):
        ps.push(torch.from_numpy(data_p[:, :31]))
    ps.finish()
    assert len(tele.tracer.durations_s("finish")) == 1
    quiet = PSession(pspec, batch=3, chunk=32, device="cpu")
    with pytest.raises(RuntimeError, match="device counters are off"):
        quiet.device_counter_report()
    with pytest.raises(NotImplementedError, match="item 9"):
        PSession(pspec, mesh=object(), device="cpu")
    with pytest.raises(ValueError, match="received"):
        PSession(pspec, backend="fused", inputs="received", device="cpu")
    with pytest.raises(ValueError, match="chunk"):
        PSession(pspec, chunk=40, backend="fused_packed", device="cpu")


def test_session_on_the_card_by_default_raises_without_one(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, pspec = _specs("k3")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PSession(pspec)
    # the low-level state helpers default to the card as well
    with pytest.raises(RuntimeError, match="no CUDA device"):
        P_w.init_stream_state(pspec.code, 2, 32, 32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        P_w.init_device_counters(2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        P_w.resolve_stream_backend(pspec, 32, 32, "fused_packed", "received")


# --------------------------------------------------------------------------- #
# the streaming backend through decode()                                       #
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("name,metric,punctured,terminated,depth", [
    ("k3", "hard", False, True, None), ("k7", "soft", False, False, None),
    ("k7", "hard", True, True, 40), ("k3", "soft", True, False, 400),
])
def test_streaming_decode_matches_reference(name, metric, punctured, terminated, depth):
    rspec, pspec = _specs(name, metric, punctured, terminated)
    _, rx = _rx(pspec, 41, 3, 150)
    rctx = RD.DecodeContext(streaming=True, stream_depth=depth)
    pctx = dataclasses.replace(CPU, streaming=True, stream_depth=depth)
    ref = RD.decode(RD.DecodeRequest(rspec, received=jnp.asarray(rx)), ctx=rctx)
    reset_counts()
    res = PD.decode(PD.DecodeRequest(pspec, received=torch.from_numpy(rx)), ctx=pctx)
    assert res.plan.backend == ref.plan.backend == "streaming"
    assert res.diagnostics == ref.diagnostics
    assert plain_counts["viterbi_scan_carry"] == rx.shape[1] // 64
    _eq(res.bits, ref.bits)
    _eq(res.path_metric, ref.path_metric)


def test_streaming_backend_honours_chunk_and_depth():
    rspec, pspec = _specs("k3")
    _, rx = _rx(pspec, 43, 2, 100)
    bm = pspec.branch_metrics(torch.from_numpy(rx))
    res = PD.get_decoder("streaming")(pspec, bm, ctx=dataclasses.replace(
        CPU, chunk=16, stream_depth=200))
    assert res.diagnostics == {"backend": "streaming", "depth": 200, "chunk": 16}
    seq = PD.get_decoder("sequential")(pspec, bm, ctx=CPU)
    _eq(res.bits, seq.bits)
    _eq(res.path_metric, seq.path_metric)


# --------------------------------------------------------------------------- #
# obs primitives                                                               #
# --------------------------------------------------------------------------- #


def test_obs_percentile_and_histograms_match_reference():
    rng = np.random.default_rng(0)
    vals = list(rng.exponential(0.01, 200))
    for q in (0.0, 0.5, 0.95, 1.0):
        assert P_obs.percentile(vals, q) == R_obs.percentile(vals, q)
    assert P_obs.percentile([], 0.5, default=-1.0) == R_obs.percentile([], 0.5, default=-1.0)
    with pytest.raises(ValueError):
        P_obs.percentile(vals, 1.5)
    assert P_obs.LATENCY_BUCKETS_S == R_obs.LATENCY_BUCKETS_S
    assert P_obs.DEPTH_BUCKETS == R_obs.DEPTH_BUCKETS
    preg, rreg = P_obs.MetricsRegistry(), R_obs.MetricsRegistry()
    for reg in (preg, rreg):
        h = reg.histogram("lat_s", help="latency")
        for v in vals:
            h.observe(v)
        reg.counter("pushes_total").inc(3)
        reg.gauge("queue").set(7)
        d = reg.histogram("depth", buckets=P_obs.DEPTH_BUCKETS)
        for v in (3, 40, 40, 900):
            d.observe(v)
    assert preg.snapshot() == rreg.snapshot()
    assert preg.render() == rreg.render()
    for q in (0.1, 0.5, 0.95):
        assert preg.histogram("lat_s").quantile(q) == rreg.histogram("lat_s").quantile(q)
    with pytest.raises(TypeError):
        preg.counter("queue")


def test_obs_spans_and_logger_match_reference(tmp_path):
    assert P_obs.span(None, "x") is P_obs.span(None, "y")  # one shared no-op
    with P_obs.span(None, "x"):
        pass
    for obs in (P_obs, R_obs):
        tracer = obs.Tracer("t")
        with obs.span(tracer, "tick"), obs.span(tracer, "step"):
            pass
        tracer.instant("admit")
        assert len(tracer) == 3
        assert 0.0 <= tracer.coverage("tick", ("step",)) <= 1.0
        tracer.write_chrome(tmp_path / "trace.json")
        events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
        assert [e["name"] for e in events] == ["process_name", "step", "tick", "admit"]
    assert P_obs.kv(a=1, b=0.5, c="x y") == R_obs.kv(a=1, b=0.5, c="x y")
    out = io.StringIO()
    log = P_obs.get_logger("test", stream=out)
    log.info("hello", n=2)
    P_obs.get_logger("test", quiet=True, stream=out).info("hidden")
    assert out.getvalue() == "hello n=2\n"
