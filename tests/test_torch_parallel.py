"""The port's block-parallel route held against the reference on identical
numpy inputs: the (min,+) product (plain version at both inits against the
Pallas kernel in interpret mode and the jnp product, ``minplus_matmul_op``
against the reference op), the associative-scan copy against
``jax.lax.associative_scan``, the plain ``viterbi_decode_parallel`` and
``viterbi_decode_parallel_op`` over K3/K7 x hard/soft x punct x term/open x
chunk (bits and metrics exactly, soft included), the ``parallel`` backend
through ``decode()``, ``hmm_viterbi`` and the CRF.  The CUDA kernel is held
against its plain version on the card in tests/test_torch_gpu.py."""
import dataclasses
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.decode as RD
from repro.core import crf as R_crf
from repro.core import viterbi as R_vit
from repro.core.puncture import PUNCTURE_2_3
from repro.core.trellis import ConvCode as RCode
from repro.kernels import minplus as R_mp
from repro.kernels.ops import minplus_matmul_op as r_minplus_op
from repro_torch import decode as PD
from repro_torch.core import crf as P_crf
from repro_torch.core import viterbi as P_vit
from repro_torch.core.trellis import NEG_UNREACHABLE
from repro_torch.core.trellis import ConvCode as PCode
from repro_torch.kernels import minplus, ops
from repro_torch.kernels.common import launch_counts, plain_counts, reset_counts

torch.set_num_threads(1)

CPU = PD.DecodeContext(device="cpu")
CODES = {"k3": (3, (0b111, 0b101)), "k7": (7, (0o171, 0o133))}
INF = float("inf")

#: one compiled reference per (code, chunk, terminated, shape): eager
#: lax.scans would recompile on every call
_r_parallel = jax.jit(R_vit.viterbi_decode_parallel, static_argnums=(0, 2, 3))


def _eq(a, b, msg=""):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=msg)


def _operands(shape, seed, extremes=True):
    """(a, b) float32 numpy operands of an (N, I, K) x (N, K, J) product;
    with ``extremes`` some entries are exactly 1e30 and 2e30 (the
    unreachable metrics a decode's transfer matrices hold)."""
    N, I, K, J = shape
    rng = np.random.default_rng(seed)
    a = (rng.standard_normal((N, I, K)) * 5).astype(np.float32)
    b = (rng.standard_normal((N, K, J)) * 5).astype(np.float32)
    if extremes:
        for x in (a, b):
            x[rng.random(x.shape) < 0.2] = NEG_UNREACHABLE
            x[rng.random(x.shape) < 0.1] = 2 * NEG_UNREACHABLE
    return a, b


def _padded(x, axis, block):
    pad = [(0, 0)] * x.ndim
    pad[axis] = (0, (-x.shape[axis]) % block)
    return np.pad(x, pad, constant_values=NEG_UNREACHABLE)


# --------------------------------------------------------------------------- #
# the (min,+) product                                                          #
# --------------------------------------------------------------------------- #

SHAPES = [(1, 4, 4, 4), (2, 8, 16, 8), (3, 130, 64, 70), (2, 5, 1, 3), (1, 1, 200, 1)]


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_plain_product_at_1e30_matches_pallas_kernel(shape):
    # the Pallas kernel in interpret mode takes block multiples: both sides
    # get the same operands padded with 1e30 (the reference op's padding)
    a, b = _operands(shape, zlib.crc32(repr(shape).encode()))
    bi, bj, bk = 8, 128, 8
    a = _padded(_padded(a, 1, bi), 2, bk)
    b = _padded(_padded(b, 1, bk), 2, bj)
    want = R_mp.minplus_matmul(jnp.asarray(a), jnp.asarray(b), bi, bj, bk, True)
    got = minplus.minplus_matmul(torch.from_numpy(a), torch.from_numpy(b), NEG_UNREACHABLE)
    _eq(got.numpy(), want)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_plain_product_at_inf_matches_jnp_product(shape):
    # +inf is the unclamped product: 2e30 + anything stays above 1e30
    a, b = _operands(shape, zlib.crc32(repr(shape).encode()) + 1)
    a[:, 0, :] = 2 * NEG_UNREACHABLE  # a row no path reaches: its products stay >= 2e30
    want = R_vit.minplus_matmul(jnp.asarray(a), jnp.asarray(b))
    got = minplus.minplus_matmul(torch.from_numpy(a), torch.from_numpy(b), INF)
    _eq(got.numpy(), want)
    assert (got.numpy() > NEG_UNREACHABLE).any()  # the unclamped entries are there


@pytest.mark.parametrize("init", [NEG_UNREACHABLE, INF], ids=["1e30", "inf"])
def test_plain_product_propagates_nan_as_jnp(init):
    a, b = _operands((2, 6, 9, 5), 7)
    a[0, 1, 3] = np.nan
    b[1, 4, 2] = np.nan
    want = np.asarray(jnp.minimum(init, R_vit.minplus_matmul(jnp.asarray(a), jnp.asarray(b))))
    got = minplus.minplus_matmul(torch.from_numpy(a), torch.from_numpy(b), init).numpy()
    assert np.isnan(want).any()
    _eq(np.isnan(got), np.isnan(want))
    _eq(got[~np.isnan(got)], want[~np.isnan(want)])


@pytest.mark.parametrize("S", [2, 4, 8, 16, 32, 64, 128])
@pytest.mark.parametrize("init", [NEG_UNREACHABLE, INF], ids=["1e30", "inf"])
def test_plain_square_product_matches_jnp_product(S, init):
    # the square shapes the card's square kernel takes (I = K = J = S, a
    # power of two from 2 to 128), two products, with 1e30 and NaN entries
    a, b = _operands((2, S, S, S), 1900 + S)
    a[0, S - 1, 0] = np.nan
    b[1, 0, S // 2] = np.nan
    want = np.asarray(jnp.minimum(init, R_vit.minplus_matmul(jnp.asarray(a), jnp.asarray(b))))
    got = minplus.minplus_matmul(torch.from_numpy(a), torch.from_numpy(b), init).numpy()
    assert np.isnan(want).any() and (a == NEG_UNREACHABLE).any()
    _eq(np.isnan(got), np.isnan(want))
    _eq(got[~np.isnan(got)], want[~np.isnan(want)])


@pytest.mark.parametrize("shape", SHAPES + [(2, 3, 4, 8, 5)],
                         ids=lambda s: "x".join(map(str, s)))
def test_minplus_matmul_op_matches_reference_op(shape):
    *batch, I, K, J = shape
    rng = np.random.default_rng(len(shape) + I)
    a = (rng.standard_normal((*batch, I, K)) * 5).astype(np.float32)
    b = (rng.standard_normal((*batch, K, J)) * 5).astype(np.float32)
    a[rng.random(a.shape) < 0.2] = NEG_UNREACHABLE
    b[rng.random(b.shape) < 0.2] = NEG_UNREACHABLE
    want = r_minplus_op(jnp.asarray(a), jnp.asarray(b))
    got = ops.minplus_matmul_op(torch.from_numpy(a), torch.from_numpy(b))
    assert tuple(got.shape) == tuple(want.shape)
    _eq(got.numpy(), want)


def test_product_wrapper_contract():
    a, b = (torch.from_numpy(x) for x in _operands((4, 6, 5, 3), 3))
    reset_counts()
    # strided batch views (an associative scan's slices) equal their copies
    a4, b4 = a.reshape(2, 2, 6, 5), b.reshape(2, 2, 5, 3)
    got = minplus.minplus_matmul(a4[:, ::2], b4[:, 1::2], INF)
    _eq(got.numpy(), minplus.minplus_matmul_plain(a4[:, ::2].contiguous(),
                                                  b4[:, 1::2].contiguous(), INF).numpy())
    assert plain_counts["minplus_matmul"] == 1 and not launch_counts
    # an empty batch returns an empty product and runs nothing
    empty = minplus.minplus_matmul(a4[:, 0:0], b4[:, 0:0], INF)
    assert tuple(empty.shape) == (2, 0, 6, 3) and plain_counts["minplus_matmul"] == 1
    with pytest.raises(ValueError, match="row-major"):
        minplus.minplus_matmul(a.transpose(1, 2).contiguous().transpose(1, 2), b)
    with pytest.raises(ValueError, match="product"):
        minplus.minplus_matmul(a, b[:, :4])
    with pytest.raises(ValueError, match="3-D or 4-D"):
        minplus.minplus_matmul(a[0], b[0])
    with pytest.raises(TypeError, match="float32"):
        minplus.minplus_matmul(a.double(), b.double())
    with pytest.raises(ValueError, match="device"):
        minplus.minplus_matmul(a, b.to("meta"))  # operands on two devices
    # meta operands take the shape route: an empty output, nothing run
    plains = dict(plain_counts)
    out = minplus.minplus_matmul(a.to("meta"), b.to("meta"))
    assert out.device.type == "meta" and out.shape == minplus.minplus_matmul(a, b).shape
    assert plain_counts["minplus_matmul"] == plains["minplus_matmul"] + 1


# --------------------------------------------------------------------------- #
# the associative scan                                                         #
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("n", [1, 2, 3, 16, 17])
def test_associative_scan_matches_jax(n):
    rng = np.random.default_rng(n)
    mats = rng.integers(0, 9, (3, n, 4, 4)).astype(np.float32)
    mats[rng.random(mats.shape) < 0.3] = NEG_UNREACHABLE
    want = jax.lax.associative_scan(R_vit.minplus_matmul, jnp.asarray(mats), axis=1)
    got = P_vit._associative_scan(P_vit.minplus_matmul, torch.from_numpy(mats), axis=1)
    _eq(got.numpy(), want)
    # the association tree itself: float sums are not associative, so only
    # jax's tree gives jax's bits
    x = (rng.standard_normal((n, 5)) * 10 ** rng.uniform(-3, 3, (n, 5))).astype(np.float32)
    want = jax.lax.associative_scan(jnp.add, jnp.asarray(x), axis=0)
    _eq(P_vit._associative_scan(torch.add, torch.from_numpy(x), axis=0).numpy(), want)


# --------------------------------------------------------------------------- #
# the block-parallel decode                                                    #
# --------------------------------------------------------------------------- #


def _specs(code_name, metric, punctured, terminated):
    K, polys = CODES[code_name]
    kw = dict(metric=metric, puncture=PUNCTURE_2_3 if punctured else None,
              terminated=terminated)
    return RD.CodecSpec(code=RCode(K, polys), **kw), PD.CodecSpec(code=PCode(K, polys), **kw)


def _inputs(pspec, seed, batch=3, n_info=151):
    """Info bits and channel output, made once with numpy for both packages
    (n_info + flush steps is a multiple of no chunk in the grid, and spans
    more than one chunk of each)."""
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, (batch, n_info)).astype(np.int32)
    coded = pspec.encode(torch.from_numpy(bits)).numpy()
    if pspec.soft:
        rx = ((1.0 - 2.0 * coded) + 0.7 * rng.standard_normal(coded.shape)).astype(np.float32)
    else:
        rx = (coded ^ (rng.random(coded.shape) < 0.05)).astype(np.int32)
    return bits, rx


@pytest.mark.parametrize("code_name", sorted(CODES))
@pytest.mark.parametrize("metric", ["hard", "soft"])
@pytest.mark.parametrize("punctured", [False, True], ids=["unpunct", "punct23"])
@pytest.mark.parametrize("terminated", [True, False], ids=["term", "open"])
@pytest.mark.parametrize("chunk", [4, 16, 64])
def test_parallel_decode_matches_reference(code_name, metric, punctured, terminated, chunk):
    rspec, pspec = _specs(code_name, metric, punctured, terminated)
    _, rx = _inputs(pspec, zlib.crc32(pspec.describe().encode()))
    bm = np.array(rspec.branch_metrics(jnp.asarray(rx)))
    assert bm.shape[1] % chunk != 0
    ref_bits, ref_metric = _r_parallel(rspec.code, jnp.asarray(bm), chunk, terminated)
    plain = P_vit.viterbi_decode_parallel(pspec.code, torch.from_numpy(bm), chunk, terminated)
    reset_counts()
    op = ops.viterbi_decode_parallel_op(pspec.code, torch.from_numpy(bm), chunk, terminated)
    for label, (bits, metric_) in (("core", plain), ("op", op)):
        _eq(bits.numpy(), ref_bits, label)
        _eq(metric_.numpy(), ref_metric, label)  # soft too: the same sums in the same tree
    # the op ran every kernel's plain version of the card path, and only those
    assert plain_counts["viterbi_scan_packed_window"] == 1
    assert plain_counts["viterbi_scan_carry"] == 1
    assert plain_counts["traceback_packed"] == 1
    assert plain_counts["minplus_matmul"] >= 1
    assert not launch_counts


@pytest.mark.parametrize("chunk", [1, 70, 200])
def test_parallel_decode_at_edge_chunks(chunk):
    # one step per chunk, one chunk with a partial tail, one chunk past T
    rspec, pspec = _specs("k3", "soft", False, False)
    _, rx = _inputs(pspec, chunk, batch=2, n_info=68)
    bm = np.array(rspec.branch_metrics(jnp.asarray(rx)))
    ref_bits, ref_metric = _r_parallel(rspec.code, jnp.asarray(bm), chunk, False)
    bits, metric = ops.viterbi_decode_parallel_op(pspec.code, torch.from_numpy(bm), chunk, False)
    _eq(bits.numpy(), ref_bits)
    _eq(metric.numpy(), ref_metric)


@pytest.mark.parametrize("metric", ["hard", "soft"])
def test_parallel_backend_through_decode(metric):
    rspec, pspec = _specs("k7", metric, False, True)
    bits, rx = _inputs(pspec, 11, batch=4, n_info=60)
    ref = RD.decode(RD.DecodeRequest(rspec, received=jnp.asarray(rx)), backend="parallel",
                    ctx=RD.DecodeContext(chunk=16))
    ctx = dataclasses.replace(CPU, chunk=16)
    res = PD.decode(PD.DecodeRequest(pspec, received=torch.from_numpy(rx)), backend="parallel",
                    ctx=ctx)
    assert res.plan.backend == ref.plan.backend == "parallel"
    assert res.diagnostics == ref.diagnostics == {"backend": "parallel", "chunk": 16}
    _eq(res.bits.numpy(), ref.bits)
    _eq(res.info_bits.numpy(), ref.info_bits)
    if metric == "hard":
        _eq(res.path_metric.numpy(), ref.path_metric)
    else:
        # the spec's soft tables are built by each framework's own float ops
        # (XLA's dot vs torch's elementwise adds); rtol=1e-5 is the reference
        # grid's own tolerance (tests/test_decode_api.py)
        np.testing.assert_allclose(res.path_metric.numpy(), np.asarray(ref.path_metric),
                                   rtol=1e-5)
    # noiseless: the info bits come back
    coded = pspec.encode(torch.from_numpy(bits))
    clean_rx = 1.0 - 2.0 * coded.float() if pspec.soft else coded
    clean = PD.decode(PD.DecodeRequest(pspec, received=clean_rx), backend="parallel", ctx=ctx)
    _eq(clean.info_bits.numpy(), bits)


def test_parallel_decode_refuses_trellises_past_the_scan_cap():
    # K=14 (8192 states): the planner's pick for a long block past the tiled
    # cap; the scan kernels take 4096 states, so the op raises before it
    # builds any S-fold operand
    code = PCode(14, (0o37421, 0o26355))
    with pytest.raises(ValueError, match="4096"):
        ops.viterbi_decode_parallel_op(code, torch.zeros((1, 50, 4)), 16)


# --------------------------------------------------------------------------- #
# HMM Viterbi and the CRF                                                      #
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("case", ["uniform-init", "given-init", "ties"])
def test_hmm_viterbi_matches_reference(case):
    rng = np.random.default_rng(zlib.crc32(case.encode()))
    B, T, S = 4, 23, 5
    if case == "ties":  # small integers: many equal candidates
        trans = rng.integers(-2, 1, (S, S)).astype(np.float32)
        emit = rng.integers(-2, 1, (B, T, S)).astype(np.float32)
    else:
        trans = np.log(rng.dirichlet(np.ones(S), S)).astype(np.float32)
        emit = rng.standard_normal((B, T, S)).astype(np.float32)
    init = None
    if case == "given-init":
        init = np.log(rng.dirichlet(np.ones(S))).astype(np.float32)
    want_states, want_ll = R_vit.hmm_viterbi(
        jnp.asarray(trans), jnp.asarray(emit), None if init is None else jnp.asarray(init))
    states, ll = P_vit.hmm_viterbi(
        torch.from_numpy(trans), torch.from_numpy(emit),
        None if init is None else torch.from_numpy(init))
    assert states.dtype == torch.int32
    _eq(states.numpy(), want_states)
    _eq(ll.numpy(), want_ll)


def _crf_inputs(seed, B=3, T=9, S=4):
    rng = np.random.default_rng(seed)
    trans = rng.standard_normal((S, S)).astype(np.float32)
    emit = rng.standard_normal((B, T, S)).astype(np.float32)
    tags = rng.integers(0, S, (B, T)).astype(np.int32)
    return trans, emit, tags


# log-sum-exp sums its terms in another order in each framework: log Z holds
# to rtol 1e-6 / atol 1e-5, the marginals (a gradient through it) to 1e-5
LOGZ_TOL = dict(rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("T", [2, 3, 9, 16])
@pytest.mark.parametrize("parallel", [False, True], ids=["sequential", "parallel"])
def test_crf_log_norm_matches_reference(T, parallel):
    trans, emit, _ = _crf_inputs(T, T=T)
    want = R_crf.crf_log_norm(jnp.asarray(trans), jnp.asarray(emit), parallel=parallel)
    got = P_crf.crf_log_norm(torch.from_numpy(trans), torch.from_numpy(emit), parallel=parallel)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGZ_TOL)


def test_crf_score_loss_decode_and_marginals_match_reference():
    trans, emit, tags = _crf_inputs(5)
    rt, re, rg = (jnp.asarray(x) for x in (trans, emit, tags))
    pt, pe, pg = (torch.from_numpy(x) for x in (trans, emit, tags))
    np.testing.assert_allclose(P_crf.crf_score(pt, pe, pg).numpy(),
                               np.asarray(R_crf.crf_score(rt, re, rg)), **LOGZ_TOL)
    np.testing.assert_allclose(P_crf.crf_loss(pt, pe, pg).numpy(),
                               np.asarray(R_crf.crf_loss(rt, re, rg)), **LOGZ_TOL)
    want_tags, want_score = R_crf.crf_decode(rt, re)
    got_tags, got_score = P_crf.crf_decode(pt, pe)
    _eq(got_tags.numpy(), want_tags)
    np.testing.assert_allclose(got_score.numpy(), np.asarray(want_score), **LOGZ_TOL)
    marg = P_crf.crf_marginals(pt, pe)
    np.testing.assert_allclose(marg.numpy(), np.asarray(R_crf.crf_marginals(rt, re)), rtol=1e-5)
    # marginals are distributions over tags
    np.testing.assert_allclose(marg.sum(-1).numpy(), 1.0, rtol=1e-5)
