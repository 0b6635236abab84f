"""The port's tiled long-block route held against the reference on identical
numpy inputs: tile plans, the min-plus seam algebra, the plain carried and
windowed packed scans and the plain windowed traceback against the Pallas
kernels in interpret mode (word for word), the tiled decode through
``decode()`` over K3/K7 x hard/soft x punct x term/open in the exact and the
truncated regimes (bits and metrics exactly), and the planner's long-block
rule.  The CUDA kernels are held against these plain versions on the card in
tests/test_torch_gpu.py."""
import dataclasses
import zlib

import jax  # noqa: F401  (both frameworks in one process; JAX stays on the CPU)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.decode as RD
from repro.core.puncture import PUNCTURE_2_3
from repro.core.trellis import NEG_UNREACHABLE
from repro.core.trellis import ConvCode as RCode
from repro.kernels import minplus as R_mp
from repro.kernels import survivors as R_surv
from repro.kernels import tiling as R_tiling
from repro.kernels import viterbi_scan as R_scan
from repro.kernels.metrics import fused_metric_plan as r_plan
from repro_torch import convert
from repro_torch import decode as PD
from repro_torch.core.trellis import ConvCode as PCode
from repro_torch.kernels import minplus, ops, survivors, tiling, viterbi_scan
from repro_torch.kernels.common import plain_counts, reset_counts
from repro_torch.kernels.metrics import fused_metric_plan as p_plan

torch.set_num_threads(1)

CPU = PD.DecodeContext(device="cpu")
CODES = {"k3": (3, (0b111, 0b101)), "k7": (7, (0o171, 0o133)), "k5": (5, (0b10011, 0b11101))}
B = 8  # one reference lane block, so the Pallas calls need no padding


def _pair(name):
    K, polys = CODES[name]
    return RCode(K, polys), PCode(K, polys)


def _eq(a, b, msg=""):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=msg)


# --------------------------------------------------------------------------- #
# tile plans                                                                   #
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("T,P,overlap", [
    (11, 7, 0), (96, 4, 0), (101, 4, 9), (5, 9, 50), (130, 3, 15), (1030, 8, 0),
    (1030, 8, 16), (64, 1, 0), (3, 4, 0), (200, 3, 300),
])
def test_tile_plans_match_reference(T, P, overlap):
    ref = R_tiling.plan_tiles(T, P, overlap)
    tp = tiling.plan_tiles(T, P, overlap)
    assert dataclasses.asdict(tp) == dataclasses.asdict(ref)
    assert tp.exact == ref.exact
    for got, want in zip(tp.windows(), ref.windows()):
        _eq(got, want)
        assert got.dtype == np.int32
    _eq(tp.gather_index(), ref.gather_index())
    assert [tp.tile_length(p) for p in range(tp.n_tiles)] == [
        ref.tile_length(p) for p in range(ref.n_tiles)]


def test_tile_defaults_and_depth_match_reference():
    for name in ("k3", "k5", "k7"):
        rc, pc = _pair(name)
        assert tiling.truncation_depth(pc) == R_tiling.truncation_depth(rc)
    for args in [(1, 64, 4), (1, 4096, 4), (8, 100_000, 64), (1024, 1030, 64), (2, 2048, 4),
                 (1, 1030, 64), (4, 1024, 4)]:
        assert tiling.default_tiles(*args) == R_tiling.default_tiles(*args), args
    assert tiling.DEPTH_MULTIPLIER == R_tiling.DEPTH_MULTIPLIER
    assert tiling.MIN_TILE_CORE == R_tiling.MIN_TILE_CORE
    with pytest.raises(ValueError):
        tiling.plan_tiles(0, 2)


# --------------------------------------------------------------------------- #
# min-plus seam algebra                                                        #
# --------------------------------------------------------------------------- #


def _maps(seed, shape, high=9, unreachable=0.2):
    rng = np.random.default_rng(seed)
    m = rng.integers(0, high, size=shape).astype(np.float32)
    return np.where(rng.random(shape) < unreachable, np.float32(NEG_UNREACHABLE), m)


def test_minplus_identity_compose_and_associativity_match_reference():
    S = 4
    _eq(minplus.identity_map(S), R_mp.identity_map(S))
    _eq(minplus.identity_map(S, (2, 3)), R_mp.identity_map(S, (2, 3)))
    a, b, c = (_maps(i, (3, S, S)) for i in range(3))
    got = minplus.compose_maps(torch.from_numpy(a), torch.from_numpy(b))
    _eq(got, R_mp.compose_maps(jnp.asarray(a), jnp.asarray(b)))
    eye = minplus.identity_map(S)
    ta, tb, tc = (torch.from_numpy(x) for x in (a, b, c))
    _eq(minplus.compose_maps(eye, ta), a)
    _eq(minplus.compose_maps(ta, eye), a)
    _eq(minplus.compose_maps(minplus.compose_maps(ta, tb), tc),
        minplus.compose_maps(ta, minplus.compose_maps(tb, tc)))
    blocked = torch.full((S, S), NEG_UNREACHABLE)
    _eq(minplus.compose_maps(blocked, blocked), blocked)  # clamped, never 2e30


@pytest.mark.parametrize("P", [1, 2, 5])
def test_prefix_maps_and_entry_metrics_match_reference(P):
    mats = _maps(P, (P, 2, 8, 8))
    excl, total = minplus.prefix_maps(torch.from_numpy(mats))
    r_excl, r_total = R_mp.prefix_maps(jnp.asarray(mats))
    _eq(excl, r_excl)
    _eq(total, r_total)
    _eq(excl[0], R_mp.identity_map(8, (2,)))  # exclusive: excl[0] is the unit
    for init in (0, 3):
        _eq(minplus.tile_entry_metrics(excl, init), R_mp.tile_entry_metrics(r_excl, init))


def test_prefix_maps_soft_values_match_reference():
    rng = np.random.default_rng(5)
    mats = rng.standard_normal((4, 3, 4, 4)).astype(np.float32) * 7
    excl, total = minplus.prefix_maps(torch.from_numpy(mats))
    r_excl, r_total = R_mp.prefix_maps(jnp.asarray(mats))
    _eq(excl, r_excl)
    _eq(total, r_total)


def test_seam_argmin_ties_go_to_the_lowest_state():
    m = np.asarray([[3.0, 1.0, 1.0, 5.0], [2.0, 2.0, 2.0, 2.0], [7.0, 4.0, 9.0, 4.0]],
                   np.float32)
    got = minplus.seam_argmin(torch.from_numpy(m))
    assert got.dtype == torch.int32
    _eq(got, [1, 0, 1])
    _eq(got, R_mp.seam_argmin(jnp.asarray(m)))


# --------------------------------------------------------------------------- #
# plain carried / windowed scans vs the Pallas kernels                         #
# --------------------------------------------------------------------------- #


def _operands(name, weights, T, seed):
    """(data (B, T, F) numpy, reference weights, port weights)."""
    rc, pc = _pair(name)
    rng = np.random.default_rng(seed)
    if weights == "table":  # small integer tables: ties everywhere
        data = rng.integers(0, 3, (B, T, pc.n_symbols)).astype(np.float32)
        return data, R_scan.table_weights(rc), viterbi_scan.table_weights(pc)
    metric, punctured = weights.split("-")
    pattern = PUNCTURE_2_3 if punctured == "punct" else None
    rp = r_plan(rc, metric, pattern)
    if metric == "hard":
        rx = rng.integers(0, 2, (B, T, pc.n_out)).astype(np.int32)
    else:
        rx = rng.standard_normal((B, T, pc.n_out)).astype(np.float32)
    data = np.array(rp.features(jnp.asarray(rx)))
    return data, rp.folded(), p_plan(pc, metric, pattern).folded()


def _pm0(name, seed):
    """Carried metrics holding unreachable (1e30) entries, as streams and the
    tiled pass-1 unit seeds carry them."""
    _, pc = _pair(name)
    rng = np.random.default_rng(seed)
    pm = rng.integers(0, 12, (B, pc.n_states)).astype(np.float32)
    pm[rng.random(pm.shape) < 0.4] = NEG_UNREACHABLE
    pm[0] = NEG_UNREACHABLE
    pm[0, 0] = 0.0  # lane 0: the state-0 start
    return pm


@pytest.mark.parametrize("name", ["k3", "k7"])
@pytest.mark.parametrize("weights", ["table", "hard-plain", "soft-plain", "hard-punct"])
@pytest.mark.parametrize("T", [45, 64])
def test_plain_carry_scan_matches_pallas_kernel(name, weights, T):
    rc, pc = _pair(name)
    data, rw, pw = _operands(name, weights, T, seed=T + 1)
    pm0 = _pm0(name, seed=T)
    ref_pm, ref_words = R_scan.viterbi_scan_packed_carry(
        rc, jnp.asarray(pm0.T), jnp.asarray(data.transpose(1, 2, 0)), *rw, B, None)
    pm, packed = viterbi_scan.viterbi_scan_packed_carry(
        pc, torch.from_numpy(pm0), torch.from_numpy(data), *pw)
    _eq(pm, np.asarray(ref_pm).T)
    _eq(convert.packed_to_reference(packed), ref_words)


#: (lo, hi) per lane: full, lo > 0, hi < T, empty, past the end
def _windows(T):
    lo = np.asarray([0, 5, 0, 17, 3, T, 0, 31], np.int32)
    hi = np.asarray([T, T, T - 9, 40, 3, T, T + 5, 33], np.int32)
    return lo, hi


@pytest.mark.parametrize("name", ["k3", "k7"])
@pytest.mark.parametrize("weights", ["table", "hard-plain", "soft-plain", "soft-punct"])
@pytest.mark.parametrize("T", [45, 70])
def test_plain_window_scan_matches_pallas_kernel(name, weights, T):
    rc, pc = _pair(name)
    data, rw, pw = _operands(name, weights, T, seed=T + 2)
    pm0 = _pm0(name, seed=T + 3)
    lo, hi = _windows(T)
    ref_pm, ref_words = R_scan.viterbi_scan_packed_window(
        rc, jnp.asarray(pm0.T), jnp.asarray(data.transpose(1, 2, 0)), *rw,
        jnp.asarray(lo[None]), jnp.asarray(hi[None]), B, None)
    pm, packed = viterbi_scan.viterbi_scan_packed_window(
        pc, torch.from_numpy(pm0), torch.from_numpy(data), *pw,
        torch.from_numpy(lo), torch.from_numpy(hi))
    _eq(pm, np.asarray(ref_pm).T)
    _eq(convert.packed_to_reference(packed), ref_words)
    # the empty-window lanes passed their metrics through untouched
    _eq(pm[4], pm0[4])
    _eq(pm[5], pm0[5])


def test_carry_and_window_plain_versions_reduce_to_the_state0_scan():
    _, pc = _pair("k3")
    data, _, pw = _operands("k3", "hard-plain", 50, seed=4)
    d = torch.from_numpy(data)
    pm0 = torch.full((B, pc.n_states), NEG_UNREACHABLE)
    pm0[:, 0] = 0.0
    want = viterbi_scan.viterbi_scan_packed_plain(pc, d, *pw)
    full = torch.zeros((B,), dtype=torch.int32)
    for got in (viterbi_scan.viterbi_scan_packed_carry(pc, pm0, d, *pw),
                viterbi_scan.viterbi_scan_packed_window(pc, pm0, d, *pw, full, full + 50)):
        _eq(got[0], want[0])
        _eq(got[1], want[1])


# --------------------------------------------------------------------------- #
# plain windowed traceback vs the Pallas kernel                                #
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("name", ["k3", "k7"])
@pytest.mark.parametrize("T", [31, 33, 70])
def test_plain_window_traceback_matches_pallas_kernel(name, T):
    rc, pc = _pair(name)
    rng = np.random.default_rng(300 + T)
    W, S = -(-T // 32), pc.n_states
    words = rng.integers(0, 2 ** 32, size=(W, S, B), dtype=np.uint64).astype(np.uint32)
    fs = rng.integers(0, S, size=(B,)).astype(np.int32)
    lo = np.asarray([0, 3, 0, 10, 7, 0, T, 1], np.int32)
    hi = np.asarray([T, T, 20, 30, 7, 32 * W, T, T - 1], np.int32)
    ref_bits, ref_entry = R_surv.traceback_packed_window(
        rc, jnp.asarray(words), jnp.asarray(fs[None]), jnp.asarray(lo[None]),
        jnp.asarray(hi[None]), B, None)
    bits, entry = survivors.traceback_packed_window(
        pc, convert.packed_from_reference(words), torch.from_numpy(fs), torch.from_numpy(lo),
        torch.from_numpy(hi))
    assert bits.shape == (B, 32 * W) and bits.dtype == entry.dtype == torch.int32
    _eq(bits, np.asarray(ref_bits).T)
    _eq(entry, np.asarray(ref_entry)[0])


def test_windowed_wrappers_validate_and_count():
    _, pc = _pair("k3")
    b0, b1, rb = p_plan(pc, "hard").folded()
    data = torch.zeros((2, 5, 2))
    pm0 = torch.zeros((2, 4))
    lo = torch.zeros((2,), dtype=torch.int32)
    with pytest.raises(ValueError):
        viterbi_scan.viterbi_scan_packed_carry(pc, torch.zeros((3, 4)), data, b0, b1, rb)
    with pytest.raises(TypeError):
        viterbi_scan.viterbi_scan_packed_window(pc, pm0, data, b0, b1, rb, lo.long(), lo)
    with pytest.raises(ValueError):
        viterbi_scan.viterbi_scan_packed_window(pc, pm0, data, b0, b1, rb, lo[:1], lo)
    with pytest.raises(ValueError):
        viterbi_scan.viterbi_scan_carry(pc, pm0, torch.zeros((2, 5, 3)))
    words = torch.zeros((1, 2, 4), dtype=torch.int32)
    with pytest.raises(ValueError):
        survivors.traceback_packed_window(pc, words, lo, lo, lo[:1])
    with pytest.raises(TypeError):
        survivors.traceback_packed_window(pc, words, lo.long(), lo, lo)
    reset_counts()
    viterbi_scan.viterbi_scan_packed_window(pc, pm0, data, b0, b1, rb, lo, lo + 5)
    viterbi_scan.viterbi_scan_packed_carry(pc, pm0, data, b0, b1, rb)
    survivors.traceback_packed_window(pc, words, lo, lo, lo + 5)
    assert dict(plain_counts) == {"viterbi_scan_packed_window": 1,
                                  "viterbi_scan_packed_carry": 1, "traceback_packed_window": 1}


# --------------------------------------------------------------------------- #
# the tiled decode through decode(), exact and truncated                       #
# --------------------------------------------------------------------------- #

#: (code, metric, punctured, terminated, P): every grid cell once, each cell
#: at T = 100 trellis steps (T % 32 != 0; one length keeps the reference's
#: interpret-mode kernels to one trace per (code, P, F))
GRID = [
    ("k3", "hard", False, True, 4),
    ("k3", "hard", False, False, 3),
    ("k3", "hard", True, True, 1),
    ("k3", "hard", True, False, 4),
    ("k3", "soft", False, True, 3),
    ("k3", "soft", False, False, 1),
    ("k3", "soft", True, True, 4),
    ("k3", "soft", True, False, 3),
    ("k7", "hard", False, True, 4),
    ("k7", "hard", False, False, 3),
    ("k7", "hard", True, True, 3),
    ("k7", "hard", True, False, 1),
    ("k7", "soft", False, True, 1),
    ("k7", "soft", False, False, 4),
    ("k7", "soft", True, True, 4),
    ("k7", "soft", True, False, 3),
]
STEPS = 100


def _cell_inputs(pspec, seed, batch=2, n_info=100):
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, (batch, n_info)).astype(np.int32)
    coded = pspec.encode(torch.from_numpy(bits)).numpy()
    if pspec.soft:
        rx = ((1.0 - 2.0 * coded) + 0.7 * rng.standard_normal(coded.shape)).astype(np.float32)
    else:
        rx = (coded ^ (rng.random(coded.shape) < 0.05)).astype(np.int32)
    return rx


def _tiled_pair(rspec, pspec, rx, P, overlap, entry):
    """(reference result, port result) of the tiled backend on one input."""
    rctx = RD.DecodeContext(tiles=P, tile_overlap=overlap)
    pctx = dataclasses.replace(CPU, tiles=P, tile_overlap=overlap)
    if entry == "received":
        ref = RD.decode(RD.DecodeRequest(rspec, received=jnp.asarray(rx)),
                        backend="tiled", ctx=rctx)
        res = PD.decode(PD.DecodeRequest(pspec, received=torch.from_numpy(rx)),
                        backend="tiled", ctx=pctx)
    else:
        bm = np.array(rspec.branch_metrics(jnp.asarray(rx)))
        ref = RD.get_decoder("tiled")(rspec, jnp.asarray(bm), ctx=rctx)
        res = PD.get_decoder("tiled")(pspec, torch.from_numpy(bm), ctx=pctx)
    return ref, res


@pytest.mark.parametrize(
    "code_name,metric,punctured,terminated,P", GRID,
    ids=[f"{c}-{m}-{'p' if pu else 'u'}-{'t' if te else 'o'}-P{P}" for c, m, pu, te, P in GRID],
)
def test_tiled_decode_matches_reference(code_name, metric, punctured, terminated, P):
    K, polys = CODES[code_name]
    kw = dict(metric=metric, puncture=PUNCTURE_2_3 if punctured else None,
              terminated=terminated)
    rspec, pspec = RD.CodecSpec(code=RCode(K, polys), **kw), PD.CodecSpec(code=PCode(K, polys), **kw)
    seed = zlib.crc32(pspec.describe().encode()) + P
    rx = _cell_inputs(pspec, seed, n_info=STEPS - pspec.n_flush)
    # exact regime through both entries; truncated regime (overlap < 5K)
    # through one entry, alternating over the grid
    trunc_entry = "received" if (P + punctured + terminated) % 2 else "bm"
    for overlap, entry in ((None, "received"), (None, "bm"), (K + 1, trunc_entry)):
        ref, res = _tiled_pair(rspec, pspec, rx, P, overlap, entry)
        msg = f"{pspec.describe()} P={P} overlap={overlap} entry={entry}"
        assert res.diagnostics == {
            "backend": "tiled", "tiles": P, "overlap": overlap,
            "metrics": "in-kernel" if entry == "received" else "table"}, msg
        assert res.diagnostics == ref.diagnostics, msg
        _eq(res.bits, ref.bits, msg)
        # same operations in the same order on both sides: equal bit for
        # bit, soft metrics included
        _eq(res.path_metric, ref.path_metric, msg)


def test_exact_tiling_equals_the_untiled_decode_and_overlap_promotes():
    _, pc = _pair("k7")
    spec = PD.CodecSpec(code=pc, metric="hard", terminated=False)
    rx = torch.from_numpy(_cell_inputs(spec, 11, batch=3, n_info=200))
    bm = spec.branch_metrics(rx)
    want_bits, want_metric = ops.viterbi_decode_packed(pc, bm, terminated=False)
    for P, overlap in ((4, None), (7, 35), (3, 10_000)):
        bits, metric = ops.viterbi_decode_tiled_op(pc, bm, P, overlap=overlap, terminated=False)
        _eq(bits, want_bits)
        _eq(metric, want_metric)


@pytest.mark.parametrize("overlap", [None, 5])
def test_tiled_capture_holds_the_operands_each_kernel_was_given(overlap):
    _, pc = _pair("k3")
    spec = PD.CodecSpec(code=pc, metric="soft")
    rx = torch.from_numpy(_cell_inputs(spec, 5, batch=3, n_info=90))
    plan = p_plan(pc, "soft")
    want = ops.viterbi_decode_tiled_fused(plan, rx, 3, overlap=overlap)
    got = {}
    _eq(ops.viterbi_decode_tiled_fused(plan, rx, 3, overlap=overlap, capture=got)[0], want[0])
    assert ("pass1" in got) == (overlap is None)
    if overlap is None:
        fpm1, _ = viterbi_scan.viterbi_scan_packed_window(*got["pass1"])
        _eq(fpm1.reshape(3, 3, 4, 4).transpose(0, 1), got["maps"])
    _, words = viterbi_scan.viterbi_scan_packed_window(*got["pass2"])
    _eq(words, got["packed"])
    _eq(words.repeat_interleave(4, dim=1), got["traceback"][1])
    bits, _ = survivors.traceback_packed_window(*got["traceback"])
    assert bits.shape[0] == 3 * 3 * 4  # lanes (b, p, s)


def test_pinned_tiles_are_honoured_or_raise():
    _, pc = _pair("k3")
    spec = PD.CodecSpec(code=pc)
    rx = torch.from_numpy(_cell_inputs(spec, 3, n_info=60))
    reset_counts()
    res = PD.decode(PD.DecodeRequest(spec, received=rx), backend="tiled",
                    ctx=dataclasses.replace(CPU, tiles=3))
    assert res.diagnostics["tiles"] == 3
    assert plain_counts["viterbi_scan_packed_window"] == 2
    assert plain_counts["traceback_packed_window"] == 1
    with pytest.raises(ValueError, match="tiles"):
        PD.decode(PD.DecodeRequest(spec, received=rx), backend="tiled",
                  ctx=dataclasses.replace(CPU, tiles=0))


# --------------------------------------------------------------------------- #
# planner: long blocks route to tiled                                          #
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("shape,tiles", [((4, 1024), None), ((2, 4096), None),
                                         ((1024, 1030), None), ((4, 2000), 8)])
def test_planner_routes_long_blocks_to_tiled(shape, tiles):
    rc, pc = _pair("k7")
    ref = RD.plan_decode(RD.CodecSpec(code=rc), shape, ctx=RD.DecodeContext(tiles=tiles))
    plan = PD.plan_decode(PD.CodecSpec(code=pc), shape, ctx=dataclasses.replace(CPU, tiles=tiles))
    assert plan.backend == ref.backend == "tiled"
    assert "long-conv-tiled" in plan.reason
    want = tiles if tiles is not None else tiling.default_tiles(*shape, pc.n_states)
    assert plan.ctx.tiles == want
    short = PD.plan_decode(PD.CodecSpec(code=pc), (shape[0], 1023), ctx=CPU)
    assert short.backend == "fused_packed"


def test_long_block_decode_runs_the_planned_tiled_route():
    _, pc = _pair("k3")
    spec = PD.CodecSpec(code=pc, metric="hard")
    rx = torch.from_numpy(_cell_inputs(spec, 21, batch=2, n_info=1030))
    res = PD.decode(PD.DecodeRequest(spec, received=rx), ctx=CPU)
    assert res.plan.backend == "tiled" and res.diagnostics["tiles"] == res.plan.ctx.tiles
    assert res.plan.ctx.tiles == tiling.default_tiles(2, 1032, 4) > 1
    seq = PD.decode(PD.DecodeRequest(spec, received=rx), backend="sequential", ctx=CPU)
    _eq(res.bits, seq.bits)
    _eq(res.path_metric, seq.path_metric)
