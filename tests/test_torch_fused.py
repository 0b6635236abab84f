"""The port's unpacked ``fused`` route and the paper's ``texpand`` step held
against the JAX reference on identical numpy inputs: the plain unpacked scan
vs ``viterbi_scan`` and the plain ``texpand`` vs the Pallas ``texpand``
(both in interpret mode on the CPU), ties included; a decode driven one
``texpand`` step at a time against the scan; ``viterbi_decode_fused`` and
the ``fused`` backend over the K3/K7 x hard/soft x punct x term/open grid —
all exact, soft metrics too.  The CUDA kernels are held against these plain
versions on the card in tests/test_torch_gpu.py."""
import zlib

import jax  # noqa: F401  (both frameworks in one process; JAX stays on the CPU)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.decode as RD
from repro.core.puncture import PUNCTURE_2_3
from repro.core.trellis import NEG_UNREACHABLE
from repro.kernels import ops as R_ops
from repro.kernels import viterbi_scan as R_scan
from repro_torch import convert
from repro_torch import decode as PD
from repro_torch.core.viterbi import _initial_pm
from repro_torch.kernels import ops, texpand, viterbi_scan
from repro_torch.kernels.common import launch_counts, plain_counts, reset_counts

torch.set_num_threads(1)

CPU = PD.DecodeContext(device="cpu")
CODES = {
    "k2": (2, (0b11, 0b10)),
    "k3": (3, (0b111, 0b101)),
    "k3p": (3, (0b110, 0b010)),
    "k5": (5, (0b10011, 0b11101)),
    "k7": (7, (0o171, 0o133)),
}
B = 8  # one reference lane block: the Pallas call needs no padding


def _pair(name):
    K, polys = CODES[name]
    from repro.core import ConvCode as RCode

    return RCode(K, polys), convert.code_from_arrays(K, polys)


def _eq(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _tables(code, T, kind, seed, batch=B):
    rng = np.random.default_rng(seed)
    if kind == "int":  # integer tables: ties everywhere
        return rng.integers(0, 3, (batch, T, code.n_symbols)).astype(np.float32)
    return rng.standard_normal((batch, T, code.n_symbols)).astype(np.float32)


# --------------------------------------------------------------------------- #
# the unpacked scan: plain version vs the Pallas kernel                        #
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("name", ["k2", "k3", "k5", "k7"])
@pytest.mark.parametrize("kind", ["int", "soft"])
@pytest.mark.parametrize("T", [1, 45])
def test_plain_unpacked_scan_matches_pallas_kernel(name, kind, T):
    rc, pc = _pair(name)
    bm = _tables(pc, T, kind, seed=T + len(name))
    ref_pm, ref_bps = R_scan.viterbi_scan(rc, jnp.asarray(bm.transpose(1, 2, 0)), B, True)
    reset_counts()
    pm, bps = viterbi_scan.viterbi_scan(pc, torch.from_numpy(bm))
    assert plain_counts["viterbi_scan"] == 1 and not launch_counts
    assert bps.dtype == torch.int32 and bps.shape == (T, B, pc.n_states)
    _eq(pm, np.asarray(ref_pm).T)
    _eq(bps, np.asarray(ref_bps).transpose(0, 2, 1))
    _eq(pm, viterbi_scan.viterbi_scan_plain(pc, torch.from_numpy(bm))[0])


@pytest.mark.parametrize("name", ["k3", "k7"])
@pytest.mark.parametrize("kind", ["int", "soft"])
def test_unpacked_scan_row_operands_match_pallas_kernel(name, kind):
    """The card's route of ``viterbi_scan``: the kernel takes the distinct
    rows and row map of the table weights (``row_operands``, derived on the
    host by ``device_weights``, no weight copied back) in place of the
    weights.  The weights rebuilt from them are the table weights bit for
    bit, and the scan on them equals the Pallas kernel's, hard (integer
    tables: ties everywhere) and soft."""
    rc, pc = _pair(name)
    T = 45
    bm = _tables(pc, T, kind, seed=70 + len(name))
    copies = viterbi_scan.row_builds["copy"]
    b0, b1, rb = viterbi_scan.cached_table_weights(pc, "cpu")
    rows, maps = viterbi_scan.row_operands(b0, b1, rb)
    assert viterbi_scan.row_builds["copy"] == copies
    F = b0.shape[1]
    assert rows.shape == (pc.n_symbols, F + 1) and maps.shape == (pc.n_states, 2)
    w0, w1 = rows[maps[:, 0].long()], rows[maps[:, 1].long()]
    rebuilt = (w0[:, :F].contiguous(), w1[:, :F].contiguous(),
               torch.stack([w0[:, F], w1[:, F]], dim=1))
    for got, want in zip(rebuilt, (b0, b1, rb)):
        assert torch.equal(got, want)
    pm, bps = viterbi_scan._scan_plain(pc, None, torch.from_numpy(bm), *rebuilt, pack=False)
    ref_pm, ref_bps = R_scan.viterbi_scan(rc, jnp.asarray(bm.transpose(1, 2, 0)), B, True)
    _eq(pm, np.asarray(ref_pm).T)
    _eq(bps, np.asarray(ref_bps).transpose(0, 2, 1))


@pytest.mark.parametrize("batch", [1, 13])
def test_forward_op_matches_reference_forward_op(batch):
    rc, pc = _pair("k7")
    bm = _tables(pc, 40, "soft", seed=batch, batch=batch)
    ref_pm, ref_bps = R_ops.viterbi_forward_op(rc, jnp.asarray(bm))
    pm, bps = ops.viterbi_forward_op(pc, torch.from_numpy(bm))
    _eq(pm, ref_pm)
    _eq(bps, ref_bps)


# --------------------------------------------------------------------------- #
# texpand: the paper's one-step instruction                                    #
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("name", ["k3", "k3p", "k5", "k7"])
@pytest.mark.parametrize("batch", [1, 8, 13])
def test_plain_texpand_matches_pallas_kernel(name, batch):
    rc, pc = _pair(name)
    rng = np.random.default_rng(batch * 7 + len(name))
    pm = (rng.standard_normal((batch, pc.n_states)) * 10).astype(np.float32)
    bm = rng.uniform(0, 2, (batch, pc.n_symbols)).astype(np.float32)
    ref_pm, ref_bp = R_ops.texpand_op(rc, jnp.asarray(pm), jnp.asarray(bm))
    reset_counts()
    new_pm, bp = ops.texpand_op(pc, torch.from_numpy(pm), torch.from_numpy(bm))
    assert plain_counts["texpand"] == 1 and not launch_counts
    assert new_pm.shape == bp.shape == (batch, pc.n_states) and bp.dtype == torch.int32
    _eq(new_pm, ref_pm)
    _eq(bp, ref_bp)


@pytest.mark.parametrize("name", ["k3", "k7"])
def test_texpand_ties_go_to_the_lower_predecessor(name):
    rc, pc = _pair(name)
    # all-zero operands: every state ties, so every select is 0 (strict <)
    zeros_pm = torch.zeros((8, pc.n_states))
    _, bp = texpand.texpand(pc, zeros_pm, torch.zeros((8, pc.n_symbols)))
    assert (bp == 0).all()
    # small integers: ties on many states, checked against the reference
    rng = np.random.default_rng(5)
    pm = rng.integers(0, 3, (B, pc.n_states)).astype(np.float32)
    bm = rng.integers(0, 2, (B, pc.n_symbols)).astype(np.float32)
    ref_pm, ref_bp = R_ops.texpand_op(rc, jnp.asarray(pm), jnp.asarray(bm))
    new_pm, bp = texpand.texpand(pc, torch.from_numpy(pm), torch.from_numpy(bm))
    _eq(new_pm, ref_pm)
    _eq(bp, ref_bp)


@pytest.mark.parametrize("kind", ["int", "soft"])
def test_texpand_steps_equal_the_unpacked_scan(kind):
    """A decode driven one texpand step at a time equals the scan kernel's
    final metrics and survivors exactly (the unreachable states stay at 1e30:
    1e30 + m rounds back to 1e30, so the scan's clamp never bites)."""
    _, pc = _pair("k7")
    bm = torch.from_numpy(_tables(pc, 30, kind, seed=11))
    pm = _initial_pm(pc, (B,))
    bps = []
    for t in range(bm.shape[1]):
        pm, bp = ops.texpand_op(pc, pm, bm[:, t])
        bps.append(bp)
    want_pm, want_bps = viterbi_scan.viterbi_scan(pc, bm)
    assert float(pm.max()) <= NEG_UNREACHABLE
    _eq(pm, want_pm)
    _eq(torch.stack(bps), want_bps)


def test_texpand_rejects_bad_operands():
    _, pc = _pair("k3")
    with pytest.raises(ValueError):
        texpand.texpand(pc, torch.zeros((2, 8)), torch.zeros((2, 4)))
    with pytest.raises(ValueError):
        texpand.texpand(pc, torch.zeros((2, 4)), torch.zeros((3, 4)))
    with pytest.raises(TypeError):
        texpand.texpand(pc, torch.zeros((2, 4), dtype=torch.float64), torch.zeros((2, 4)))
    with pytest.raises(ValueError):
        texpand.texpand(pc, torch.zeros((4, 2)).T, torch.zeros((2, 4)))


# --------------------------------------------------------------------------- #
# the fused decode and the ``fused`` backend                                   #
# --------------------------------------------------------------------------- #


def _specs(code_name, metric, punctured, terminated):
    rc, pc = _pair(code_name)
    kw = dict(metric=metric, puncture=PUNCTURE_2_3 if punctured else None,
              terminated=terminated)
    return RD.CodecSpec(code=rc, **kw), PD.CodecSpec(code=pc, **kw)


def _received(pspec, seed, batch=3, n_info=30):
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, (batch, n_info)).astype(np.int32)
    coded = pspec.encode(torch.from_numpy(bits)).numpy()
    if pspec.soft:
        return ((1.0 - 2.0 * coded) + 0.6 * rng.standard_normal(coded.shape)).astype(np.float32)
    return (coded ^ (rng.random(coded.shape) < 0.04)).astype(np.int32)


@pytest.mark.parametrize("code_name", ["k3", "k7"])
@pytest.mark.parametrize("punctured", [False, True], ids=["unpunct", "punct23"])
@pytest.mark.parametrize("metric", ["hard", "soft"])
@pytest.mark.parametrize("terminated", [True, False], ids=["term", "open"])
def test_fused_decode_grid_matches_reference(code_name, punctured, metric, terminated):
    rspec, pspec = _specs(code_name, metric, punctured, terminated)
    rx = _received(pspec, seed=zlib.crc32(pspec.describe().encode()))
    bm = np.array(rspec.branch_metrics(jnp.asarray(rx)))
    ref_bits, ref_metric = R_ops.viterbi_decode_fused(rspec.code, jnp.asarray(bm),
                                                      terminated=terminated)
    reset_counts()
    bits, metric_p = ops.viterbi_decode_fused(pspec.code, torch.from_numpy(bm),
                                              terminated=terminated)
    assert plain_counts["viterbi_scan"] == 1 and not launch_counts
    _eq(bits, ref_bits)
    # one-hot table weights select each bm exactly, and the adds run in the
    # reference's order, so the metric is exact for both metric kinds
    _eq(metric_p, ref_metric)

    # the registry entry, through decode() on raw symbols (the table is built
    # by the spec: `fused` has no raw-symbol entry, as in the reference)
    ref = RD.decode(RD.DecodeRequest(rspec, received=jnp.asarray(rx)), backend="fused")
    res = PD.decode(PD.DecodeRequest(pspec, received=torch.from_numpy(rx)), backend="fused",
                    ctx=CPU)
    assert res.plan.backend == ref.plan.backend == "fused"
    assert res.diagnostics == ref.diagnostics == {"backend": "fused"}
    _eq(res.bits, ref.bits)
    _eq(res.info_bits, ref.info_bits)
    _eq(res.path_metric, ref.path_metric)


def test_fused_equals_fused_packed_on_the_same_symbols():
    _, pspec = _specs("k7", "soft", False, True)
    rx = torch.from_numpy(_received(pspec, seed=3, batch=5, n_info=70))
    fused = PD.decode(PD.DecodeRequest(pspec, received=rx), backend="fused", ctx=CPU)
    packed = PD.decode(PD.DecodeRequest(pspec, received=rx), ctx=CPU)
    assert packed.plan.backend == "fused_packed"
    _eq(fused.bits, packed.bits)
    np.testing.assert_allclose(fused.path_metric.numpy(), packed.path_metric.numpy(),
                               rtol=1e-5)


def test_planner_never_picks_fused():
    rspec, pspec = _specs("k3", "hard", False, True)
    for shape in ((4, 100), (64, 1000), (2, 2048)):
        ref = RD.plan_decode(rspec, shape)
        plan = PD.plan_decode(pspec, shape, ctx=CPU)
        assert plan.backend == ref.backend != "fused"
