"""The PyTorch port's kernel modules (repro_torch.kernels) held against the
JAX reference's Pallas kernels (run in interpret mode on the CPU) on
identical numpy inputs: metric plans, the plain packed scan vs
``viterbi_scan_packed``, the plain traceback vs ``traceback_packed``, the
pack/unpack helpers and the ops layer — all exact, word for word.  The
CUDA kernels themselves are held against these plain versions on the card in
tests/test_torch_gpu.py."""
import jax  # noqa: F401  (both frameworks in one process; JAX stays on the CPU)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ConvCode as RCode
from repro.core.puncture import PUNCTURE_2_3
from repro.kernels import ops as R_ops
from repro.kernels import survivors as R_surv
from repro.kernels import viterbi_scan as R_scan
from repro.kernels.metrics import _phase_mask as r_phase_mask
from repro.kernels.metrics import fused_metric_plan as r_plan
from repro_torch import convert
from repro_torch.core import ConvCode as PCode
from repro_torch.kernels import _build, ops, survivors, viterbi_scan
from repro_torch.kernels.common import launch_counts, plain_counts, reset_counts
from repro_torch.kernels.metrics import _phase_mask as p_phase_mask
from repro_torch.kernels.metrics import fused_metric_plan as p_plan

torch.set_num_threads(1)

CODES = {
    "k2": (2, (0b11, 0b10)),
    "k3": (3, (0b111, 0b101)),
    "k5": (5, (0b10011, 0b11101)),
    "k7": (7, (0o171, 0o133)),
}
#: (metric, punctured) of every plan the decode path builds
PLANS = [("hard", False), ("soft", False), ("hard", True), ("soft", True)]
B = 8  # one reference lane block, so the Pallas call needs no padding


def _pair(name):
    K, polys = CODES[name]
    return RCode(K, polys), PCode(K, polys)


def _eq(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _received(code, metric, T, seed, batch=B):
    rng = np.random.default_rng(seed)
    if metric == "hard":
        return rng.integers(0, 2, (batch, T, code.n_out)).astype(np.int32)
    return rng.standard_normal((batch, T, code.n_out)).astype(np.float32)


# --------------------------------------------------------------------------- #
# metric plans                                                                 #
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("name", ["k3", "k7"])
@pytest.mark.parametrize("metric,punctured", PLANS)
def test_metric_plans_match(name, metric, punctured):
    rc, pc = _pair(name)
    pattern = PUNCTURE_2_3 if punctured else None
    rp = r_plan(rc, metric, pattern)
    native = p_plan(pc, metric, pattern)
    bridged = convert.plan_from_arrays(pc, metric, pattern, np.asarray(rp.weight),
                                       np.asarray(rp.bias))
    rx = _received(pc, metric, 23, seed=9)
    ref_feats = rp.features(jnp.asarray(rx), t0=1)
    ref_folded = rp.folded()
    for plan in (native, bridged):
        assert plan.puncture == rp.puncture and plan.n_features == rp.n_features
        _eq(plan.weight, rp.weight)
        _eq(plan.bias, rp.bias)
        for x, y in zip(plan.folded(), ref_folded):
            _eq(x, y)
        feats = plan.features(torch.from_numpy(rx), t0=1)
        _eq(feats, ref_feats)
        _eq(plan.bm_tables(torch.from_numpy(rx), t0=1), rp.bm_tables(jnp.asarray(rx), t0=1))


def test_metric_plan_rejects_unknown_kind_and_bad_bridge_shapes():
    _, pc = _pair("k3")
    with pytest.raises(ValueError):
        p_plan(pc, "llr")
    with pytest.raises(ValueError):
        convert.plan_from_arrays(pc, "hard", None, np.zeros((3, 2)), np.zeros((4,)))


@pytest.mark.parametrize("phase", [0, 1])
def test_phase_mask_matches(phase):
    rc, pc = _pair("k7")
    pat = tuple(tuple(int(v) for v in row) for row in PUNCTURE_2_3)
    _eq(p_phase_mask(pc, 11, pat, phase), r_phase_mask(rc, 11, pat, phase))


# --------------------------------------------------------------------------- #
# the packed scan: plain version vs the Pallas kernel                          #
# --------------------------------------------------------------------------- #


def _scan_operands(name, weights, T, seed):
    """(data (B, T, F) numpy, reference weights, port weights) for one case."""
    rc, pc = _pair(name)
    rng = np.random.default_rng(seed)
    if weights == "table-int":  # integer tables: ties everywhere
        data = rng.integers(0, 3, (B, T, pc.n_symbols)).astype(np.float32)
        return data, R_scan.table_weights(rc), viterbi_scan.table_weights(pc)
    if weights == "table-soft":
        data = rng.standard_normal((B, T, pc.n_symbols)).astype(np.float32)
        return data, R_scan.table_weights(rc), viterbi_scan.table_weights(pc)
    metric, punctured = weights.split("-")
    pattern = PUNCTURE_2_3 if punctured == "punct" else None
    rp = r_plan(rc, metric, pattern)
    rx = _received(pc, metric, T, seed)
    data = np.array(rp.features(jnp.asarray(rx)))
    return data, rp.folded(), p_plan(pc, metric, pattern).folded()


@pytest.mark.parametrize("name", ["k3", "k7"])
@pytest.mark.parametrize("weights", ["table-int", "table-soft", "hard-plain", "soft-plain",
                                     "hard-punct", "soft-punct"])
@pytest.mark.parametrize("T", [37, 70])
def test_plain_scan_matches_pallas_kernel(name, weights, T):
    rc, pc = _pair(name)
    data, rw, pw = _scan_operands(name, weights, T, seed=T)
    ref_pm, ref_words = R_scan.viterbi_scan_packed(
        rc, jnp.asarray(data.transpose(1, 2, 0)), *rw, B, None)
    pm, packed = viterbi_scan.viterbi_scan_packed(pc, torch.from_numpy(data), *pw)
    assert packed.dtype == torch.int32 and packed.shape == (-(-T // 32), B, pc.n_states)
    # every product is exact (weights are 0/±1) and the sums run in the same
    # order, so soft metrics are bit-equal too
    _eq(_np(pm), np.asarray(ref_pm).T)
    _eq(convert.packed_to_reference(packed), np.asarray(ref_words))
    _eq(packed, convert.packed_from_reference(np.asarray(ref_words)))


@pytest.mark.parametrize("name", ["k2", "k5"])
def test_plain_scan_matches_pallas_kernel_small_trellises(name):
    rc, pc = _pair(name)
    data, rw, pw = _scan_operands(name, "hard-plain", 45, seed=3)
    ref_pm, ref_words = R_scan.viterbi_scan_packed(
        rc, jnp.asarray(data.transpose(1, 2, 0)), *rw, B, None)
    pm, packed = viterbi_scan.viterbi_scan_packed(pc, torch.from_numpy(data), *pw)
    _eq(_np(pm), np.asarray(ref_pm).T)
    _eq(convert.packed_to_reference(packed), np.asarray(ref_words))


# --------------------------------------------------------------------------- #
# packed traceback: plain version vs the Pallas kernel                         #
# --------------------------------------------------------------------------- #


#: the walk's codes: CODES and S = 128 and 256, where the card's full walk
#: goes from the staged design to the direct one
WALK_CODES = dict(CODES, k8=(8, (0o247, 0o371)), k9=(9, (0o561, 0o753)))


@pytest.mark.parametrize("name", ["k2", "k3", "k7", "k8", "k9"])
@pytest.mark.parametrize("T", [1, 31, 32, 33, 64, 70, 1006])
def test_plain_traceback_matches_pallas_kernel(name, T):
    K, polys = WALK_CODES[name]
    rc, pc = RCode(K, polys), PCode(K, polys)
    rng = np.random.default_rng(100 + T)
    W, S = -(-T // 32), pc.n_states
    words = rng.integers(0, 2 ** 32, size=(W, S, B), dtype=np.uint64).astype(np.uint32)
    fs = rng.integers(0, S, size=(B,)).astype(np.int32)
    ref = R_surv.traceback_packed(rc, jnp.asarray(words), jnp.asarray(fs[None, :]), T, B, None)
    bits = survivors.traceback_packed(pc, convert.packed_from_reference(words),
                                      torch.from_numpy(fs), T)
    assert bits.shape == (B, T) and bits.dtype == torch.int32
    _eq(bits, np.asarray(ref)[:T].T)


@pytest.mark.parametrize("T", [1, 2, 31, 32, 33, 65, 107])
def test_pack_unpack_match_reference(T):
    rng = np.random.default_rng(T)
    bps = rng.integers(0, 2, size=(T, 4, 3)).astype(np.int32)
    ref = np.asarray(R_surv.pack_survivors(jnp.asarray(bps)))
    packed = survivors.pack_survivors(torch.from_numpy(bps))
    assert packed.dtype == torch.int32 and packed.shape[0] == survivors.n_words(T)
    _eq(_np(packed).view(np.uint32), ref)
    _eq(survivors.unpack_survivors(packed, T), bps)
    _eq(survivors.unpack_survivors(packed, T), R_surv.unpack_survivors(jnp.asarray(ref), T))


def test_packed_words_carry_tail_zeros_and_bit31():
    bps = torch.ones((32 + 5, 2, 2), dtype=torch.int32)
    packed = survivors.pack_survivors(bps)
    assert (_np(packed[0]).view(np.uint32) == 0xFFFFFFFF).all()
    assert (_np(packed[1]).view(np.uint32) == 0x1F).all()


# --------------------------------------------------------------------------- #
# ops layer + bridge                                                           #
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("name", ["k3", "k7"])
@pytest.mark.parametrize("metric", ["hard", "soft"])
def test_forward_and_decode_ops_match(name, metric):
    rc, pc = _pair(name)
    rx = _received(pc, metric, 50, seed=21, batch=5)
    ref_pm, ref_packed = R_ops.viterbi_forward_fused_op(r_plan(rc, metric), jnp.asarray(rx))
    pm, packed = ops.viterbi_forward_fused_op(p_plan(pc, metric), torch.from_numpy(rx))
    _eq(pm, ref_pm)
    _eq(_np(packed).view(np.uint32), ref_packed)  # same (W, B, S) user layout
    for terminated in (True, False):
        rb, rm = R_ops.viterbi_decode_fused_packed(r_plan(rc, metric), jnp.asarray(rx),
                                                   terminated=terminated)
        b, m = ops.viterbi_decode_fused_packed(p_plan(pc, metric), torch.from_numpy(rx),
                                               terminated=terminated)
        _eq(b, rb)
        _eq(m, rm)
        bm = np.array(r_plan(rc, metric).bm_tables(jnp.asarray(rx)))
        rb2, rm2 = R_ops.viterbi_decode_packed(rc, jnp.asarray(bm), terminated=terminated)
        b2, m2 = ops.viterbi_decode_packed(pc, torch.from_numpy(bm), terminated=terminated)
        _eq(b2, rb2)
        _eq(m2, rm2)


def test_frontier_takes_lowest_index_argmin():
    pm = torch.tensor([[3.0, 1.0, 1.0, 2.0], [0.0, 0.0, 0.0, 0.0], [5.0, 4.0, 9.0, 4.0]])
    state, metric = ops._frontier(pm, terminated=False)
    _eq(state, [1, 0, 1])
    _eq(metric, [1.0, 0.0, 4.0])
    rs, rm = R_ops._frontier(jnp.asarray(_np(pm)), False)
    _eq(state, rs)
    _eq(metric, rm)
    state, metric = ops._frontier(pm, terminated=True)
    _eq(state, [0, 0, 0])
    _eq(metric, [3.0, 0.0, 5.0])


def test_convert_bridges_round_trip():
    rng = np.random.default_rng(0)
    words = rng.integers(0, 2 ** 32, size=(3, 4, 5), dtype=np.uint64).astype(np.uint32)
    packed = convert.packed_from_reference(words)
    assert packed.shape == (3, 5, 4) and packed.dtype == torch.int32
    _eq(convert.packed_to_reference(packed), words)
    code = convert.code_from_arrays(np.int64(7), np.array([0o171, 0o133]))
    assert code == PCode(7, (0o171, 0o133))
    with pytest.raises(ValueError):
        convert.packed_from_reference(words.astype(np.int32))


# --------------------------------------------------------------------------- #
# wrappers: validation, the kernel-or-plain rule, counters                     #
# --------------------------------------------------------------------------- #


def test_wrappers_validate_inputs():
    _, pc = _pair("k3")
    b0, b1, rb = p_plan(pc, "hard").folded()
    data = torch.zeros((2, 5, 2))
    with pytest.raises(TypeError):
        viterbi_scan.viterbi_scan_packed(pc, data.double(), b0, b1, rb)
    with pytest.raises(ValueError):
        viterbi_scan.viterbi_scan_packed(pc, torch.zeros((2, 5, 3)), b0, b1, rb)
    with pytest.raises(ValueError):
        viterbi_scan.viterbi_scan_packed(pc, torch.zeros((2, 2, 5)).transpose(1, 2), b0, b1, rb)
    big = PCode(14, (0o37421, 0o26355))
    with pytest.raises(ValueError, match="4096"):
        viterbi_scan.viterbi_scan_packed(big, data, b0, b1, rb)
    packed = torch.zeros((1, 2, 4), dtype=torch.int32)
    with pytest.raises(ValueError):
        survivors.traceback_packed(pc, packed, torch.zeros((2,), dtype=torch.int32), 40)
    with pytest.raises(TypeError):
        survivors.traceback_packed(pc, packed, torch.zeros((2,), dtype=torch.int64), 5)


def test_cpu_tensors_run_plain_versions_and_count_them():
    _, pc = _pair("k3")
    reset_counts()
    rx = torch.from_numpy(_received(pc, "hard", 40, seed=1))
    ops.viterbi_decode_fused_packed(p_plan(pc, "hard"), rx)
    assert plain_counts["viterbi_scan_packed"] == 1
    assert plain_counts["traceback_packed"] == 1
    assert not launch_counts
    reset_counts()
    assert not plain_counts


def test_kernel_sources_and_build_key_are_stable():
    assert set(_build._sources()) == {"viterbi_scan", "survivors", "texpand", "bcjr", "minplus"}
    assert _build.build_dir() == _build.build_dir()
    assert _build.build_dir().parent == _build.BUILD_ROOT
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    assert "--use_fast_math" not in _build.NVCC_FLAGS


# --------------------------------------------------------------------------- #
# the chain kernel's operands: distinct weight rows and the state -> row map   #
# --------------------------------------------------------------------------- #

ROW_CODES = {"k3": (3, (0b111, 0b101)), "k7": (7, (0o171, 0o133)),
             "k11": (11, (0o3345, 0o3613))}


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.int32)


def _rebuilds(rows, maps, b0, b1, rb):
    """rows[maps[:, j]] is (b_j, rb[:, j]) bit for bit."""
    F = b0.shape[1]
    assert rows.dtype == torch.float32 and maps.dtype == torch.int32
    assert maps.shape == (b0.shape[0], 2) and rows.shape[1] == F + 1
    for j, b in enumerate((b0, b1)):
        picked = rows[maps[:, j].long()]
        assert torch.equal(_bits(picked[:, :F]), _bits(b))
        assert torch.equal(_bits(picked[:, F]), _bits(rb[:, j]))


@pytest.mark.parametrize("name", ROW_CODES)
@pytest.mark.parametrize("weights", ["hard", "soft", "punct", "table"])
def test_row_operands_rebuild_the_weights(name, weights):
    code = PCode(*ROW_CODES[name])
    if weights == "table":
        b0, b1, rb = viterbi_scan.table_weights(code)
    else:
        metric = "soft" if weights == "soft" else "hard"
        b0, b1, rb = p_plan(code, metric, PUNCTURE_2_3 if weights == "punct" else None).folded()
    rows, maps = viterbi_scan.row_operands(b0, b1, rb)
    _rebuilds(rows, maps, b0, b1, rb)
    assert rows.shape[0] == code.n_symbols  # R = M: one row per output symbol


def test_row_operands_keep_arbitrary_weights_and_are_cached_per_tensor():
    rng = np.random.default_rng(3)
    S, F = 64, 3
    b0, b1 = (torch.from_numpy(rng.standard_normal((S, F)).astype(np.float32)) for _ in "01")
    rb = torch.from_numpy(rng.standard_normal((S, 2)).astype(np.float32))
    b0[1] = -0.0  # a signed zero and a NaN are rows of their own
    b0[2] = 0.0
    b1[5, 1] = np.nan
    first = viterbi_scan.row_operands(b0, b1, rb)
    _rebuilds(*first, b0, b1, rb)
    assert first[0].shape[0] == 2 * S
    assert viterbi_scan.row_operands(b0, b1, rb) is first
    b0[:, 0] = 0.0  # modified in place: built again
    b1[7] = b0[7]
    rb[7, 1] = rb[7, 0]  # state 7's two branches now share a row
    rows, maps = viterbi_scan.row_operands(b0, b1, rb)
    assert rows is not first[0]
    _rebuilds(rows, maps, b0, b1, rb)
    assert rows.shape[0] == 2 * S - 1 and maps[7, 0] == maps[7, 1]


# --------------------------------------------------------------------------- #
# the weights a decode hands the scans: uploaded once, rows from the host      #
# --------------------------------------------------------------------------- #

from repro_torch.core import (  # noqa: E402
    CODE_K3_PAPER, CODE_K3_STD, CODE_K5_GSM, CODE_K7_NASA, PUNCTURE_3_4, PUNCTURE_5_6)

NAMED_CODES = {"k3_std": CODE_K3_STD, "k3_paper": CODE_K3_PAPER, "k5_gsm": CODE_K5_GSM,
               "k7_nasa": CODE_K7_NASA}
PUNCTURES = {"none": None, "2/3": PUNCTURE_2_3, "3/4": PUNCTURE_3_4, "5/6": PUNCTURE_5_6}
DECODE_WEIGHTS = [(m, p) for m in ("hard", "soft") for p in PUNCTURES] + [("table", "none")]


@pytest.mark.parametrize("name", NAMED_CODES)
@pytest.mark.parametrize("metric,puncture", DECODE_WEIGHTS,
                         ids=[f"{m}-{p}" for m, p in DECODE_WEIGHTS])
def test_decode_row_operands_equal_those_of_the_weights(name, metric, puncture):
    """The weights and row operands the decode path takes (uploaded once,
    rows derived from the host arrays) equal the plan's own tensors and
    ``row_operands`` of them, bit for bit."""
    code = NAMED_CODES[name]
    if metric == "table":
        fresh = viterbi_scan.table_weights(code)
        cached = viterbi_scan.cached_table_weights(code, torch.device("cpu"))
    else:
        plan = p_plan(code, metric, PUNCTURES[puncture])
        fresh = plan.folded()
        cached = ops.plan_weights(plan, "cpu")
    for a, b in zip(cached, fresh):
        assert a.dtype == b.dtype and torch.equal(_bits(a), _bits(b))
    copies = viterbi_scan.row_builds["copy"]
    rows, maps = viterbi_scan.row_operands(*cached)
    assert viterbi_scan.row_builds["copy"] == copies  # derived as they were uploaded
    want_rows, want_maps = viterbi_scan.row_operands(*fresh)
    assert torch.equal(_bits(rows), _bits(want_rows)) and torch.equal(maps, want_maps)
    _rebuilds(rows, maps, *fresh)


@pytest.mark.parametrize("backend,ctx", [
    ("fused_packed", {}), ("tiled", {"tiles": 2}), ("parallel", {"chunk": 16})])
def test_second_decode_builds_no_weights_or_row_operands(backend, ctx):
    """A second decode of the same spec on the same device uploads no weights
    and builds no row operands; no decode copies weights back to derive them."""
    from repro_torch.decode import CodecSpec, DecodeContext, DecodeRequest, decode

    spec = CodecSpec(code=CODE_K5_GSM, metric="soft", puncture=PUNCTURE_3_4)
    rng = np.random.default_rng(17)
    rx = torch.from_numpy(rng.standard_normal((3, 40, 2)).astype(np.float32))
    builds = []
    for _ in range(2):
        before = dict(viterbi_scan.row_builds)
        decode(DecodeRequest(spec, received=rx), backend=backend,
               ctx=DecodeContext(device="cpu", **ctx))
        builds.append({k: viterbi_scan.row_builds[k] - before.get(k, 0) for k in ("host", "copy")})
    assert builds[0]["host"] <= 1 and builds[0]["copy"] == 0
    assert builds[1] == {"host": 0, "copy": 0}
    plan = p_plan(CODE_K5_GSM, "soft", PUNCTURE_3_4)
    first = ops.plan_weights(plan, "cpu")
    assert all(a is b for a, b in zip(first, ops.plan_weights(plan, torch.device("cpu"))))


def test_received_session_takes_the_decode_weights():
    """A packed session fed raw symbols holds the weights of ``plan_weights``
    (uploaded once, rows from the host arrays): a second session of the same
    spec uploads nothing and no session copies weights back."""
    from repro_torch.decode import CodecSpec
    from repro_torch.stream import StreamSession

    spec = CodecSpec(code=CODE_K5_GSM, metric="soft", puncture=PUNCTURE_3_4)
    before = dict(viterbi_scan.row_builds)
    sessions = [StreamSession(spec, batch=2, chunk=32, backend="fused_packed", inputs="received",
                              device="cpu") for _ in range(2)]
    built = {k: viterbi_scan.row_builds[k] - before.get(k, 0) for k in ("host", "copy")}
    assert built["host"] <= 1 and built["copy"] == 0
    want = ops.plan_weights(p_plan(CODE_K5_GSM, "soft", PUNCTURE_3_4), "cpu")
    for session in sessions:
        assert all(a is b for a, b in zip(session._weights, want))
