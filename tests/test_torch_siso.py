"""The port's SISO family (repro_torch.siso, the BCJR kernels' plain
versions, ``bcjr_llr_op``, the ``bcjr`` and ``turbo`` backends) held
against the JAX reference on identical numpy inputs: RSC tables and the
encoder, the interleavers, the plain alpha and beta/LLR scans vs the Pallas
kernels in interpret mode, the SISO op, the turbo decoder (bits, LLRs,
iterations, agreement, converged streams), ``decode()`` of rsc and turbo
specs, the planner's family rule and the turbo telemetry — exact, soft
values included, with two stated exceptions: the soft metrics of a
two-parity code (test_two_parity_scans_match_pallas_kernel_to_summation_order)
and the turbo backend's ``path_metric`` (test_turbo_backend_matches_reference)."""
import dataclasses

import jax  # noqa: F401  (both frameworks in one process; JAX stays on the CPU)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.decode as RD
import repro.siso as RS
from repro.core import ConvCode as RCode
from repro.core.puncture import PUNCTURE_2_3 as R_PUNCTURE_2_3
from repro.core.puncture import PUNCTURE_TURBO_1_2 as R_PUNCTURE_TURBO_1_2
from repro.core.puncture import effective_rate as r_effective_rate
from repro.core.puncture import pattern_mask as r_pattern_mask
from repro.kernels import bcjr as R_bcjr
from repro.kernels import ops as R_ops
from repro.obs import MetricsRegistry as RMetrics
from repro_torch import convert
from repro_torch import decode as PD
from repro_torch.core import PUNCTURE_2_3, PUNCTURE_TURBO_1_2, effective_rate, pattern_mask
from repro_torch.kernels import bcjr, ops
from repro_torch.kernels.common import launch_counts, plain_counts, reset_counts
from repro_torch.obs import MetricsRegistry
from repro_torch.siso import TurboSpec, turbo_decode

torch.set_num_threads(1)

CPU = PD.DecodeContext(device="cpu")
#: (constraint, feedback, forward) of the codes held against the reference
CODES = {"k3": (3, 0b111, (0b101,)), "k4": (4, 0o13, (0o15,)), "k5": (5, 0o23, (0o35, 0o27))}
B = 8  # one reference lane block: the Pallas calls need no padding


def _pair(name):
    K, fb, fwd = CODES[name]
    return RS.RSCCode(K, fb, fwd), convert.rsc_code_from_arrays(K, fb, fwd)


def _eq(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _bits(shape, seed):
    return np.random.default_rng(seed).integers(0, 2, shape).astype(np.int32)


# --------------------------------------------------------------------------- #
# RSC codes, interleavers, puncturing                                          #
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("name", sorted(CODES))
def test_rsc_tables_match_reference(name):
    rc, pc = _pair(name)
    assert (pc.n_states, pc.n_out, pc.n_features, pc.n_flush) == (
        rc.n_states, rc.n_out, rc.n_features, rc.n_flush)
    for table in ("feedback_bits", "next_state", "out_bits"):
        _eq(getattr(pc, table), getattr(rc, table))
    for pair in ("select_matrices", "alpha_weights", "beta_matrices", "beta_weights",
                 "llr_matrices", "llr_weights"):
        for p, r in zip(getattr(pc, pair), getattr(rc, pair)):
            assert p.dtype == r.dtype
            _eq(p, r)


@pytest.mark.parametrize("name", sorted(CODES))
@pytest.mark.parametrize("terminate", [True, False])
def test_rsc_encode_matches_reference(name, terminate):
    rc, pc = _pair(name)
    bits = _bits((3, 2, 21), seed=len(name))
    coded = pc.encode(torch.from_numpy(bits), terminate=terminate)
    assert coded.dtype == torch.int32
    _eq(coded, rc.encode(jnp.asarray(bits), terminate=terminate))


def test_named_codes_and_validation_match_reference():
    from repro_torch.siso import RSC_K3_75, RSC_K4_LTE, RSCCode

    assert RSC_K3_75 == _pair("k3")[1] and RSC_K4_LTE == _pair("k4")[1]
    for bad in ((3, 0b011, (0b101,)), (1, 0b1, (0b1,)), (3, 0b111, ()), (3, 0b111, (0b1000,))):
        with pytest.raises(ValueError):
            RS.RSCCode(*bad)
        with pytest.raises(ValueError):
            RSCCode(*bad)


@pytest.mark.parametrize("params", [("qpp", 64, 7, 16), ("qpp", 512, 31, 64),
                                    ("qpp", 40, 3, 10), ("block", 4, 16), ("block", 8, 8)])
def test_interleavers_match_reference(params):
    kind, *args = params
    if kind == "qpp":
        ref, port = RS.QPPInterleaver(*args), convert.qpp_from_arrays(*args)
    else:
        ref, port = RS.BlockInterleaver(*args), convert.block_interleaver_from_arrays(*args)
    assert port.n == ref.n
    _eq(port.permutation, ref.permutation)
    _eq(port.inverse, ref.inverse)
    assert (port.permutation[port.inverse] == np.arange(port.n)).all()


def test_interleaver_validation_matches_reference():
    from repro_torch.siso import BlockInterleaver, QPPInterleaver

    for cls_r, cls_p, args in ((RS.QPPInterleaver, QPPInterleaver, (64, 2, 2)),
                               (RS.QPPInterleaver, QPPInterleaver, (1, 1, 0)),
                               (RS.BlockInterleaver, BlockInterleaver, (0, 4))):
        with pytest.raises(ValueError):
            cls_r(*args)
        with pytest.raises(ValueError):
            cls_p(*args)


def test_turbo_puncture_helpers_match_reference():
    _eq(PUNCTURE_TURBO_1_2, R_PUNCTURE_TURBO_1_2)
    _, pc = _pair("k3")
    assert effective_rate(pc, PUNCTURE_TURBO_1_2) == r_effective_rate(pc, R_PUNCTURE_TURBO_1_2)
    assert effective_rate(pc, PUNCTURE_2_3) == pytest.approx(2 / 3)
    _eq(pattern_mask(3, 5, PUNCTURE_TURBO_1_2), r_pattern_mask(3, 5, R_PUNCTURE_TURBO_1_2))


# --------------------------------------------------------------------------- #
# the BCJR scans: plain versions vs the Pallas kernels                         #
# --------------------------------------------------------------------------- #


def _features(code, T, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((T, code.n_features, B)) * 2).astype(np.float32)


def _ref_alpha(rc, feat):
    mats = tuple(jnp.asarray(m) for m in (*rc.select_matrices, *rc.alpha_weights))
    return R_bcjr.bcjr_alpha_scan(mats, jnp.asarray(feat), B, True)


@pytest.mark.parametrize("name", ["k3", "k4"])
@pytest.mark.parametrize("T", [1, 70])
def test_plain_alpha_scan_matches_pallas_kernel(name, T):
    rc, pc = _pair(name)
    feat = _features(pc, T, seed=T)
    ref_alphas, ref_pm = _ref_alpha(rc, feat)
    reset_counts()
    alphas, final_pm = bcjr.bcjr_alpha_scan(pc, torch.from_numpy(feat))
    assert plain_counts["bcjr_alpha_scan"] == 1 and not launch_counts
    assert alphas.shape == (T, pc.n_states, B) and final_pm.shape == (pc.n_states, B)
    _eq(alphas, ref_alphas)
    _eq(final_pm, ref_pm)


@pytest.mark.parametrize("name", ["k3", "k4"])
@pytest.mark.parametrize("terminated", [True, False], ids=["term", "open"])
def test_plain_beta_llr_scan_matches_pallas_kernel(name, terminated):
    rc, pc = _pair(name)
    feat = _features(pc, 70, seed=3)
    ref_alphas, _ = _ref_alpha(rc, feat)
    mats = tuple(jnp.asarray(m) for m in (*rc.beta_matrices, *rc.llr_matrices,
                                          *rc.beta_weights, *rc.llr_weights))
    ref = R_bcjr.bcjr_beta_llr_scan(mats, ref_alphas, jnp.asarray(feat), terminated, B, True)
    reset_counts()
    llr = bcjr.bcjr_beta_llr_scan(pc, torch.from_numpy(np.array(ref_alphas)),
                                  torch.from_numpy(feat), terminated)
    assert plain_counts["bcjr_beta_llr_scan"] == 1 and not launch_counts
    _eq(llr, ref)


@pytest.mark.parametrize("terminated", [True, False], ids=["term", "open"])
def test_two_parity_scans_match_pallas_kernel_to_summation_order(terminated):
    """A two-parity code has F = 4 features, so a branch cost is a sum of
    up to four soft terms.  The port sums them f = 0..3 in order (the
    kernel's order, as for the F <= 3 codes above, which match exactly);
    the reference's CPU dot sums four terms pairwise, so the last bits of
    the soft metrics differ.  The decisions (LLR signs) are exact; the
    values agree to 1e-5 (float32 rounding of a four-term sum, carried over
    70 renormalised steps)."""
    rc, pc = _pair("k5")
    feat = _features(pc, 70, seed=5)
    ref_alphas, ref_pm = _ref_alpha(rc, feat)
    alphas, final_pm = bcjr.bcjr_alpha_scan(pc, torch.from_numpy(feat))
    np.testing.assert_allclose(alphas.numpy(), np.asarray(ref_alphas), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(final_pm.numpy(), np.asarray(ref_pm), rtol=1e-5, atol=1e-5)
    mats = tuple(jnp.asarray(m) for m in (*rc.beta_matrices, *rc.llr_matrices,
                                          *rc.beta_weights, *rc.llr_weights))
    ref = np.asarray(R_bcjr.bcjr_beta_llr_scan(mats, ref_alphas, jnp.asarray(feat),
                                               terminated, B, True))
    llr = bcjr.bcjr_beta_llr_scan(pc, alphas, torch.from_numpy(feat), terminated).numpy()
    np.testing.assert_allclose(llr, ref, rtol=1e-5, atol=1e-5)
    _eq(llr < 0, ref < 0)


@pytest.mark.parametrize("name", ["k3", "k4", "k5"])
def test_bcjr_kernel_tables_rebuild_the_weight_tables(name):
    """The kernels' operands: the distinct weight rows and one state -> row
    map per (S, F) table rebuild the reference's alpha, beta and LLR weight
    tables exactly; R is 4 with one parity and 8 with two; the register-bit
    table is ``next_state >= S/2``."""
    rc, pc = _pair(name)
    op = bcjr.operands(pc, torch.device("cpu"))
    assert op.rows.dtype == torch.float32 and op.n_rows == (4 if pc.n_parity == 1 else 8)
    assert op.rows.shape == (op.n_rows, pc.n_features)
    assert len({tuple(r) for r in op.rows.tolist()}) == op.n_rows
    want = (*rc.alpha_weights, *rc.beta_weights, *rc.llr_weights)
    for label, ref in zip(("b0", "b1", "c0", "c1", "w0", "w1"), want):
        rows_of = getattr(op, f"{label}_row")
        assert rows_of.dtype == torch.int32 and rows_of.shape == (pc.n_states,)
        _eq(op.rows[rows_of.long()], ref)
        _eq(getattr(op, label), ref)
    assert op.reg_bit.dtype == torch.int32
    _eq(op.reg_bit, (np.asarray(rc.next_state) >= pc.n_states // 2).astype(np.int32))


def test_bcjr_scans_reject_what_the_kernel_cannot_take():
    _, pc = _pair("k3")
    with pytest.raises(ValueError, match="must be"):
        bcjr.bcjr_alpha_scan(pc, torch.zeros((5, 4, 2)))  # F = 3 for this code
    with pytest.raises(TypeError):
        bcjr.bcjr_alpha_scan(pc, torch.zeros((5, 3, 2), dtype=torch.float64))
    with pytest.raises(ValueError, match="alphas"):
        bcjr.bcjr_beta_llr_scan(pc, torch.zeros((4, 4, 2)), torch.zeros((5, 3, 2)))
    big = convert.rsc_code_from_arrays(8, 0o235, (0o357,))  # S = 128
    with pytest.raises(ValueError, match="S=128"):
        bcjr.bcjr_alpha_scan(big, torch.zeros((5, 3, 2)))


@pytest.mark.parametrize("name", ["k3", "k4"])
@pytest.mark.parametrize("terminated", [True, False], ids=["term", "open"])
@pytest.mark.parametrize("apriori", [True, False], ids=["apriori", "none"])
def test_bcjr_llr_op_matches_reference(name, terminated, apriori):
    rc, pc = _pair(name)
    rng = np.random.default_rng(int(terminated) + 2 * int(apriori))
    batch, T = 5, 40  # 5 lanes: the reference pads the lane axis
    coded = rng.standard_normal((batch, T, pc.n_out)).astype(np.float32)
    la = rng.standard_normal((batch, T)).astype(np.float32) if apriori else None
    ref_llr, ref_metric = R_ops.bcjr_llr_op(
        rc, jnp.asarray(coded), None if la is None else jnp.asarray(la), terminated)
    reset_counts()
    llr, metric = ops.bcjr_llr_op(pc, torch.from_numpy(coded),
                                  None if la is None else torch.from_numpy(la), terminated)
    assert dict(plain_counts) == {"bcjr_alpha_scan": 1, "bcjr_beta_llr_scan": 1}
    assert llr.shape == (batch, T) and metric.shape == (batch,)
    _eq(llr, ref_llr)
    _eq(metric, ref_metric)


# --------------------------------------------------------------------------- #
# turbo                                                                        #
# --------------------------------------------------------------------------- #

#: (code, interleaver, punctured) of every turbo spec held against the reference
TURBO_CASES = {
    "k3-qpp": ("k3", ("qpp", 64, 7, 16), False),
    "k4-qpp-punct": ("k4", ("qpp", 40, 3, 10), True),
    "k4-block": ("k4", ("block", 4, 16), False),
    "k3-block-punct": ("k3", ("block", 8, 8), True),
}


def _turbo_specs(case, **kw):
    name, (kind, *args), punctured = TURBO_CASES[case]
    rc, pc = _pair(name)
    if kind == "qpp":
        ri, pi = RS.QPPInterleaver(*args), convert.qpp_from_arrays(*args)
    else:
        ri, pi = RS.BlockInterleaver(*args), convert.block_interleaver_from_arrays(*args)
    rp = R_PUNCTURE_TURBO_1_2 if punctured else None
    pp = PUNCTURE_TURBO_1_2 if punctured else None
    return (RS.TurboSpec(code=rc, interleaver=ri, puncture=rp, **kw),
            TurboSpec(code=pc, interleaver=pi, puncture=pp, **kw))


def _turbo_received(pspec, seed, snr_db=0.5, batch=B):
    """(info bits, channel output) for both packages, made with numpy."""
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, (batch, pspec.block_len)).astype(np.int32)
    coded = pspec.encode(torch.from_numpy(bits)).numpy()
    sigma = np.sqrt(1.0 / (2.0 * 10 ** (snr_db / 10)))
    rx = (1.0 - 2.0 * coded + sigma * rng.standard_normal(coded.shape)).astype(np.float32)
    return bits, rx


@pytest.mark.parametrize("case", sorted(TURBO_CASES))
def test_turbo_spec_encode_and_llrs_match_reference(case):
    rspec, pspec = _turbo_specs(case)
    assert pspec.describe() == rspec.describe()
    assert (pspec.n_streams, pspec.block_len, pspec.table_width) == (
        rspec.n_streams, rspec.block_len, rspec.table_width)
    bits, rx = _turbo_received(pspec, seed=1)
    _eq(pspec.encode(torch.from_numpy(bits)), rspec.encode(jnp.asarray(bits)))
    for snr in (None, 0.5):
        _eq(pspec.channel_llrs(torch.from_numpy(rx), snr_db=snr),
            rspec.channel_llrs(jnp.asarray(rx), snr_db=snr))


@pytest.mark.parametrize("case", sorted(TURBO_CASES))
@pytest.mark.parametrize("early_exit", [True, False], ids=["early", "fixed"])
def test_turbo_decode_matches_reference(case, early_exit):
    rspec, pspec = _turbo_specs(case, iterations=4)
    bits, rx = _turbo_received(pspec, seed=len(case) + int(early_exit))
    llrs = pspec.channel_llrs(torch.from_numpy(rx), snr_db=0.5)
    ref = RS.turbo_decode(rspec, jnp.asarray(llrs.numpy()), early_exit=early_exit)
    reset_counts()
    res = turbo_decode(pspec, llrs, early_exit=early_exit, device="cpu")
    assert res.iterations_run == ref.iterations_run
    assert dict(plain_counts) == {"bcjr_alpha_scan": 2 * res.iterations_run,
                                  "bcjr_beta_llr_scan": 2 * res.iterations_run}
    assert res.agreement == ref.agreement
    _eq(res.bits, ref.bits)
    _eq(res.llr, ref.llr)
    _eq(res.converged, ref.converged)
    assert (res.bits.numpy() != bits).mean() < 0.2


def test_turbo_early_exit_equals_fixed_iterations():
    _, pspec = _turbo_specs("k4-block")
    _, rx = _turbo_received(pspec, seed=9, snr_db=2.0)
    llrs = pspec.channel_llrs(torch.from_numpy(rx))
    early = turbo_decode(pspec, llrs, device="cpu")
    fixed = turbo_decode(pspec, llrs, early_exit=False, device="cpu")
    assert early.iterations_run < fixed.iterations_run == pspec.iterations
    assert bool(early.converged.all())
    _eq(early.bits, fixed.bits)


def test_turbo_records_the_reference_telemetry():
    rspec, pspec = _turbo_specs("k3-qpp")
    bits, _ = _turbo_received(pspec, seed=4)
    clean = pspec.channel_llrs(1.0 - 2.0 * pspec.encode(torch.from_numpy(bits)).float())
    reg, rreg = MetricsRegistry(), RMetrics()
    res = turbo_decode(pspec, clean, device="cpu", metrics=reg)
    ref = RS.turbo_decode(rspec, jnp.asarray(clean.numpy()), metrics=rreg)
    assert reg.snapshot() == rreg.snapshot()
    snap = reg.snapshot()
    assert snap["turbo_iterations_total"] == res.iterations_run == ref.iterations_run
    assert snap["turbo_early_exits_total"] == 1
    assert snap["turbo_converged_streams"] == float(B)
    assert reg.histogram("turbo_llr_agreement").count == res.iterations_run
    _eq(res.bits, bits)


def test_turbo_validation_and_device_rule(monkeypatch):
    _, pspec = _turbo_specs("k3-qpp")
    with pytest.raises(ValueError):
        TurboSpec(iterations=0)
    with pytest.raises(ValueError):
        TurboSpec(puncture=PUNCTURE_2_3)  # 2 rows, 3 streams
    with pytest.raises(ValueError, match="block length"):
        pspec.encode(torch.zeros((2, 10), dtype=torch.int32))
    with pytest.raises(ValueError, match="LLRs"):
        turbo_decode(pspec, torch.zeros((2, 10, 3)), device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        turbo_decode(pspec, torch.zeros((2, 64, 3)))
    gen = torch.Generator().manual_seed(0)
    rx = pspec.channel(gen, pspec.encode(torch.zeros((2, 64), dtype=torch.int32)), snr_db=1.0)
    assert rx.shape == (2, 64, 3) and rx.dtype == torch.float32


# --------------------------------------------------------------------------- #
# decode(): specs, backends, planner                                           #
# --------------------------------------------------------------------------- #


def _rsc_specs(name, metric, punctured, terminated):
    rc, pc = _pair(name)
    kw = dict(metric=metric, terminated=terminated)
    return (RD.CodecSpec(code=rc, puncture=R_PUNCTURE_2_3 if punctured else None, **kw),
            PD.CodecSpec(code=pc, puncture=PUNCTURE_2_3 if punctured else None, **kw))


@pytest.mark.parametrize("name", ["k3", "k4"])
@pytest.mark.parametrize("metric", ["hard", "soft"])
@pytest.mark.parametrize("punctured", [False, True], ids=["unpunct", "punct23"])
@pytest.mark.parametrize("terminated", [True, False], ids=["term", "open"])
def test_rsc_decode_matches_reference(name, metric, punctured, terminated):
    rspec, pspec = _rsc_specs(name, metric, punctured, terminated)
    assert pspec.family == rspec.family == "rsc"
    assert pspec.table_width == rspec.table_width and pspec.describe() == rspec.describe()
    rng = np.random.default_rng(len(name) + 4 * punctured + 8 * terminated)
    bits = rng.integers(0, 2, (4, 36)).astype(np.int32)
    coded = pspec.encode(torch.from_numpy(bits)).numpy()
    _eq(coded, rspec.encode(jnp.asarray(bits)))
    if metric == "soft":
        rx = (1.0 - 2.0 * coded + 0.8 * rng.standard_normal(coded.shape)).astype(np.float32)
    else:
        rx = (coded ^ (rng.random(coded.shape) < 0.05)).astype(np.int32)
    _eq(pspec.branch_metrics(torch.from_numpy(rx)), rspec.branch_metrics(jnp.asarray(rx)))
    ref = RD.decode(RD.DecodeRequest(rspec, received=jnp.asarray(rx)))
    res = PD.decode(PD.DecodeRequest(pspec, received=torch.from_numpy(rx)), ctx=CPU)
    assert res.plan.backend == ref.plan.backend == "bcjr"
    assert set(res.diagnostics) == set(ref.diagnostics) == {"backend", "llr"}
    _eq(res.bits, ref.bits)
    _eq(res.info_bits, ref.info_bits)
    _eq(res.path_metric, ref.path_metric)
    _eq(res.diagnostics["llr"], ref.diagnostics["llr"])
    # the table entry, on the reference's own LLR columns
    lam = np.array(rspec.branch_metrics(jnp.asarray(rx)))
    out = PD.get_decoder("bcjr")(pspec, torch.from_numpy(lam), ctx=CPU)
    _eq(out.bits, ref.bits)


def test_rsc_noiseless_punctured_roundtrip():
    _, pspec = _rsc_specs("k3", "soft", True, True)
    bits = torch.from_numpy(_bits((4, 32), seed=2))
    res = PD.decode(pspec, 1.0 - 2.0 * pspec.encode(bits).float(), ctx=CPU)
    assert res.plan.backend == "bcjr"
    _eq(res.info_bits, bits)


@pytest.mark.parametrize("case", ["k3-qpp", "k4-qpp-punct"])
def test_turbo_backend_matches_reference(case):
    rspec, pspec = _turbo_specs(case)
    _, rx = _turbo_received(pspec, seed=7)
    ref = RD.decode(RD.DecodeRequest(rspec, received=jnp.asarray(rx)))
    res = PD.decode(PD.DecodeRequest(pspec, received=torch.from_numpy(rx)), ctx=CPU)
    assert res.plan.backend == ref.plan.backend == "turbo"
    assert set(res.diagnostics) == set(ref.diagnostics)
    for key in ("backend", "iterations", "agreement"):
        assert res.diagnostics[key] == ref.diagnostics[key]
    _eq(res.diagnostics["converged"], ref.diagnostics["converged"])
    _eq(res.diagnostics["llr"], ref.diagnostics["llr"])
    _eq(res.bits, ref.bits)
    _eq(res.info_bits, ref.info_bits)
    # minus the mean |LLR| over N float32 values: XLA's reduction and
    # torch's sum their terms in different orders, so the last bits of this
    # one soft quantity differ (its LLRs above are exact)
    np.testing.assert_allclose(res.path_metric.numpy(), np.asarray(ref.path_metric), rtol=1e-6)


@pytest.mark.parametrize("case", [
    "rsc-short", "rsc-long", "rsc-streaming", "turbo", "turbo-streaming", "conv-short",
    "conv-long", "conv-streaming",
])
def test_planner_names_the_reference_backend_for_every_family(case):
    family, _, shape_kind = case.partition("-")
    if family == "rsc":
        rspec, pspec = _rsc_specs("k4", "soft", False, True)
    elif family == "turbo":
        rspec, pspec = _turbo_specs("k3-qpp")
    else:
        rspec = RD.CodecSpec(code=RCode(7, (0o171, 0o133)))
        pspec = PD.CodecSpec(code=convert.code_from_arrays(7, (0o171, 0o133)))
    shape = (4, 2048) if shape_kind == "long" else (4, 64)
    streaming = shape_kind == "streaming"
    ref = RD.plan_decode(rspec, shape, ctx=RD.DecodeContext(streaming=streaming))
    plan = PD.plan_decode(pspec, shape, ctx=dataclasses.replace(CPU, streaming=streaming))
    assert plan.backend == ref.backend
    if family != "conv":
        assert "family" in plan.reason and plan.backend in ("bcjr", "turbo")
    assert plan.spec.describe() in plan.explain()


def test_planner_rejects_a_family_mismatch_like_the_reference():
    rspec, pspec = _rsc_specs("k3", "soft", False, True)
    for backend in ("fused_packed", "turbo"):
        with pytest.raises(ValueError, match="family"):
            RD.plan_decode(rspec, (4, 64), backend=backend)
        with pytest.raises(ValueError, match="family"):
            PD.plan_decode(pspec, (4, 64), backend=backend, ctx=CPU)
