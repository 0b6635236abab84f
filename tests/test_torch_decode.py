"""The port's decode API (repro_torch.decode) held against the reference
(repro.decode) on identical numpy inputs: the decode grid (K3/K7 x hard/soft
x unpunctured/punctured-2/3 x terminated/open) through ``decode()`` on raw
symbols, through ``fused_packed`` on bm tables and through ``sequential``;
planner parity; the registry's capability records; the routes ported since
the first slice (``tiled``, ``streaming``) through their registry entries;
and the error paths (backends not ported yet, non-finite input, no card)."""
import dataclasses
import zlib

import jax  # noqa: F401  (both frameworks in one process; JAX stays on the CPU)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.decode as RD
from repro.core import viterbi_decode as r_viterbi_decode
from repro.core.puncture import PUNCTURE_2_3
from repro.core.trellis import ConvCode as RCode
from repro_torch import decode as PD
from repro_torch.core.trellis import ConvCode as PCode

torch.set_num_threads(1)

CPU = PD.DecodeContext(device="cpu")
GRID_CODES = {"k3": (3, (0b111, 0b101)), "k7": (7, (0o171, 0o133))}
NOT_PORTED = ("bcjr", "fused", "parallel", "seqparallel", "sharded_stream", "turbo")
#: backends that raised in the first slice and run now
PORTED_SINCE = ("streaming", "tiled")


def _specs(code_name, metric, punctured, terminated):
    K, polys = GRID_CODES[code_name]
    kw = dict(metric=metric, puncture=PUNCTURE_2_3 if punctured else None,
              terminated=terminated)
    return RD.CodecSpec(code=RCode(K, polys), **kw), PD.CodecSpec(code=PCode(K, polys), **kw)


def _grid_inputs(pspec, seed, batch=3, n_info=30):
    """Info bits and channel output, made once with numpy for both packages."""
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, (batch, n_info)).astype(np.int32)
    coded = pspec.encode(torch.from_numpy(bits)).numpy()
    if pspec.soft:
        rx = ((1.0 - 2.0 * coded) + 0.6 * rng.standard_normal(coded.shape)).astype(np.float32)
    else:
        rx = (coded ^ (rng.random(coded.shape) < 0.04)).astype(np.int32)
    return bits, rx


def _assert_metric(spec, got, want):
    if spec.soft:
        # the soft metric is a float32 sum whose order is not pinned across
        # frameworks (XLA's dot vs torch's elementwise adds); rtol=1e-5 is the
        # reference grid's own tolerance (tests/test_decode_api.py)
        np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-5)
    else:  # small integers: exact in any order
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


# --------------------------------------------------------------------------- #
# the decode grid                                                              #
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("code_name", sorted(GRID_CODES))
@pytest.mark.parametrize("punctured", [False, True], ids=["unpunct", "punct23"])
@pytest.mark.parametrize("metric", ["hard", "soft"])
@pytest.mark.parametrize("terminated", [True, False], ids=["term", "open"])
def test_decode_grid_matches_reference(code_name, punctured, metric, terminated):
    rspec, pspec = _specs(code_name, metric, punctured, terminated)
    seed = zlib.crc32(pspec.describe().encode())
    _, rx = _grid_inputs(pspec, seed)

    ref = RD.decode(RD.DecodeRequest(rspec, received=jnp.asarray(rx)))
    res = PD.decode(PD.DecodeRequest(pspec, received=torch.from_numpy(rx)), ctx=CPU)
    assert res.plan.backend == ref.plan.backend == "fused_packed"
    assert res.diagnostics == {"backend": "fused_packed", "metrics": "in-kernel"}
    np.testing.assert_array_equal(res.bits.numpy(), np.asarray(ref.bits))
    np.testing.assert_array_equal(res.info_bits.numpy(), np.asarray(ref.info_bits))
    _assert_metric(pspec, res.path_metric, ref.path_metric)

    # the bm-table entry of fused_packed and the sequential oracle, on the
    # reference's own tables
    bm = np.array(rspec.branch_metrics(jnp.asarray(rx)))
    ref_bits, ref_metric = r_viterbi_decode(rspec.code, jnp.asarray(bm), terminated=terminated)
    for name in ("fused_packed", "sequential"):
        out = PD.get_decoder(name)(pspec, torch.from_numpy(bm), ctx=CPU)
        np.testing.assert_array_equal(out.bits.numpy(), np.asarray(ref_bits), err_msg=name)
        _assert_metric(pspec, out.path_metric, ref_metric)
        assert out.diagnostics["backend"] == name


def test_noiseless_blocks_decode_to_their_info_bits():
    for punctured in (False, True):
        _, pspec = _specs("k7", "hard", punctured, True)
        bits = torch.from_numpy(np.random.default_rng(1).integers(0, 2, (4, 60)).astype(np.int32))
        res = PD.decode(pspec, pspec.encode(bits), ctx=CPU)
        assert torch.equal(res.info_bits, bits)
        assert (res.path_metric == 0).all()


def test_spec_channel_and_branch_metrics_match_reference():
    for metric, punctured in (("hard", True), ("soft", True), ("soft", False)):
        rspec, pspec = _specs("k3", metric, punctured, True)
        _, rx = _grid_inputs(pspec, seed=4)
        got = pspec.branch_metrics(torch.from_numpy(rx))
        np.testing.assert_array_equal(got.numpy(), np.asarray(rspec.branch_metrics(jnp.asarray(rx))))
    gen = torch.Generator().manual_seed(0)
    _, soft = _specs("k3", "soft", False, True)
    coded = soft.encode(torch.zeros((2, 8), dtype=torch.int32))
    assert soft.channel(gen, coded, snr_db=3.0).dtype == torch.float32
    with pytest.raises(ValueError):
        soft.channel(gen, coded)
    with pytest.raises(ValueError):
        soft.channel(gen, coded, snr_db=3.0, flip_prob=0.1)
    _, hard = _specs("k3", "hard", False, True)
    with pytest.raises(ValueError):
        hard.channel(gen, coded, snr_db=3.0)


# --------------------------------------------------------------------------- #
# planner parity                                                               #
# --------------------------------------------------------------------------- #

#: (constraint, polys) of a trellis past the 4096-state fused/tiled caps
BIG_CODE = (14, (0o37421, 0o26355))


@pytest.mark.parametrize("case", [
    "short", "short-k7-wide", "short-open", "long", "long-k7", "pinned-tiles",
    "streaming", "streaming-long", "big-short", "big-long",
])
def test_planner_names_the_reference_backend(case):
    code = BIG_CODE if case.startswith("big") else GRID_CODES["k7" if "k7" in case else "k3"]
    K, polys = code
    terminated = case != "short-open"
    rspec = RD.CodecSpec(code=RCode(K, polys), terminated=terminated)
    pspec = PD.CodecSpec(code=PCode(K, polys), terminated=terminated)
    shape = {
        "short": (32, 256), "short-k7-wide": (8192, 1006), "short-open": (4, 100),
        "long": (4, 1024), "long-k7": (2, 4096), "pinned-tiles": (4, 1024),
        "streaming": (4, 200), "streaming-long": (4, 2048), "big-short": (2, 300),
        "big-long": (2, 2000),
    }[case]
    rctx, pctx = RD.DecodeContext(), CPU
    if case == "pinned-tiles":
        rctx, pctx = RD.DecodeContext(tiles=4), dataclasses.replace(CPU, tiles=4)
    if case.startswith("streaming"):
        rctx, pctx = RD.DecodeContext(streaming=True), dataclasses.replace(CPU, streaming=True)
    ref = RD.plan_decode(rspec, shape, ctx=rctx)
    plan = PD.plan_decode(pspec, shape, ctx=pctx)
    assert plan.backend == ref.backend
    assert (plan.batch, plan.steps) == (ref.batch, ref.steps)
    if case == "pinned-tiles":
        assert plan.ctx.tiles == ref.ctx.tiles == 4
        assert "pinned by caller" in plan.reason
    if plan.backend == "tiled":
        assert "long-conv-tiled" in plan.reason and plan.ctx.tiles >= 1
    assert plan.predicted_costs() is None
    assert plan.backend in plan.explain() and plan.device_kind == "cpu"


@pytest.mark.parametrize("backend", ["bcjr", "seqparallel", "no-such-backend"])
def test_planner_rejects_what_the_reference_rejects(backend):
    rspec, pspec = _specs("k3", "hard", False, True)
    with pytest.raises((ValueError, KeyError)) as ref_err:
        RD.plan_decode(rspec, (4, 100), backend=backend)
    with pytest.raises(ref_err.type):
        PD.plan_decode(pspec, (4, 100), backend=backend, ctx=CPU)


def test_planner_honours_explicit_override():
    _, pspec = _specs("k3", "soft", False, False)
    plan = PD.plan_decode(pspec, (4, 100), backend="sequential", ctx=CPU)
    assert plan.backend == "sequential" and "override" in plan.reason


# --------------------------------------------------------------------------- #
# registry                                                                     #
# --------------------------------------------------------------------------- #


def test_registry_mirrors_reference_capabilities():
    assert PD.list_decoders() == RD.list_decoders()
    for name in RD.list_decoders():
        ref = RD.get_decoder(name)
        dec = PD.get_decoder(name)
        assert dataclasses.asdict(dec.capabilities) == dataclasses.asdict(ref.capabilities), name
        assert (dec.from_received is None) == (ref.from_received is None), name
        assert dec.summary


@pytest.mark.parametrize("name", NOT_PORTED)
def test_backends_not_ported_raise_by_name(name):
    _, pspec = _specs("k3", "hard", False, True)
    bm = torch.zeros((2, 10, pspec.table_width))
    dec = PD.get_decoder(name)
    with pytest.raises(NotImplementedError, match=f"{name}.*ROADMAP"):
        dec(pspec, bm, ctx=CPU)
    if dec.from_received is not None:
        with pytest.raises(NotImplementedError, match=name):
            dec.decode_received(pspec, torch.zeros((2, 10, 2)), ctx=CPU)


@pytest.mark.parametrize("name", PORTED_SINCE)
def test_ported_routes_run_and_match_reference(name):
    rspec, pspec = _specs("k7", "hard", False, False)
    _, rx = _grid_inputs(pspec, seed=8)
    bm = np.array(rspec.branch_metrics(jnp.asarray(rx)))
    rctx = RD.DecodeContext(tiles=3, stream_depth=20, chunk=16)
    pctx = dataclasses.replace(CPU, tiles=3, stream_depth=20, chunk=16)
    ref = RD.get_decoder(name)(rspec, jnp.asarray(bm), ctx=rctx)
    res = PD.get_decoder(name)(pspec, torch.from_numpy(bm), ctx=pctx)
    assert res.diagnostics == ref.diagnostics and res.diagnostics["backend"] == name
    np.testing.assert_array_equal(res.bits.numpy(), np.asarray(ref.bits))
    np.testing.assert_array_equal(res.path_metric.numpy(), np.asarray(ref.path_metric))
    dec = PD.get_decoder(name)
    if dec.from_received is not None:
        got = dec.decode_received(pspec, torch.from_numpy(rx), ctx=pctx)
        np.testing.assert_array_equal(got.bits.numpy(), np.asarray(ref.bits))


def test_planned_not_ported_backend_raises_instead_of_falling_back():
    # a long block past the tiled cap plans `parallel`, which is not ported
    K, polys = BIG_CODE
    pspec = PD.CodecSpec(code=PCode(K, polys))
    rx = torch.zeros((1, 1030, 2), dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="parallel"):
        PD.decode(PD.DecodeRequest(pspec, received=rx), ctx=CPU)
    with pytest.raises(NotImplementedError, match="parallel"):
        PD.decode(PD.DecodeRequest(pspec, received=rx[:, :50]), ctx=CPU)


def test_registry_rejects_duplicates_and_unknown():
    reg = PD.DecoderRegistry()
    reg.register("x", summary="first")(lambda spec, bm, *, ctx: None)
    with pytest.raises(KeyError):
        reg.register("x")(lambda spec, bm, *, ctx: None)
    with pytest.raises(KeyError, match="registered"):
        PD.get_decoder("nope")


# --------------------------------------------------------------------------- #
# error paths                                                                  #
# --------------------------------------------------------------------------- #


def test_non_finite_received_raises():
    _, pspec = _specs("k3", "soft", False, True)
    rx = torch.zeros((2, 12, 2))
    rx[1, 3, 0] = float("nan")
    with pytest.raises(ValueError, match="non-finite"):
        PD.decode(PD.DecodeRequest(pspec, received=rx), ctx=CPU)


def test_default_context_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, pspec = _specs("k3", "hard", False, True)
    rx = torch.zeros((2, 12, 2), dtype=torch.int32)
    assert PD.DecodeContext().device == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PD.decode(PD.DecodeRequest(pspec, received=rx))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PD.plan_decode(pspec, (2, 12))


def test_non_conv_codes_are_not_ported():
    from repro.siso.rsc import RSC_K3_75

    with pytest.raises(NotImplementedError, match="not ported"):
        PD.CodecSpec(code=RSC_K3_75)
    with pytest.raises(TypeError):
        PD.CodecSpec.of("k3")


def test_codec_spec_normalizes_and_validates_like_reference():
    a = PD.CodecSpec(puncture=PUNCTURE_2_3)
    b = PD.CodecSpec(puncture=((1, 1), (1, 0)))
    assert a == b and hash(a) == hash(b) and isinstance(a.puncture, tuple)
    with pytest.raises(ValueError):
        PD.CodecSpec(metric="llr2")
    with pytest.raises(ValueError):
        PD.CodecSpec(puncture=((1, 1),))
    spec = PD.CodecSpec(terminated=True)
    assert spec.describe() == RD.CodecSpec(terminated=True).describe()
    assert spec.n_flush == 2 and spec.n_steps(10) == 12
    assert spec.strip_flush(torch.zeros((2, 12))).shape == (2, 10)
