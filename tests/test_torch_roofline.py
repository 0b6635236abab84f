"""The port's cost model (repro_torch.roofline, the kernels' cost entries and
``meta`` route, ``DecodePlan.predicted_costs``) held against the reference
(repro.roofline, repro.decode) on identical inputs: the counter on the
reference's own micro-cases, ``model_flops`` for every configuration and
shape, the roofline terms and report, the collectives' bytes, each kernel's
counted bound against ``PERF.md`` §6's "Bound ms" column, ``cpu`` and
``meta`` counts of every traceable backend, and which plans cannot be
costed.

Two counts differ from the reference's by design (ROADMAP §3, divergences):
a ``pallas_call`` counts its output bytes there and its kernel's formula
here, and a derivative counts the ops autograd dispatches (torch's one
``tanh_backward`` where the reference's jvp has three elementwise ops)."""
import dataclasses
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.decode as RD
from repro.configs.base import SHAPES as R_SHAPES
from repro.configs.base import arch_ids as r_arch_ids
from repro.configs.base import get_arch as r_get_arch
from repro.core.trellis import ConvCode as RCode
from repro.roofline import analysis as R_analysis
from repro.roofline.jaxpr_cost import count_fn_costs as r_count
from repro_torch import decode as PD
from repro_torch.configs.base import SHAPES, get_arch, get_smoke_arch
from repro_torch.core.trellis import CODE_K7_NASA
from repro_torch.core.trellis import ConvCode as PCode
from repro_torch.decode.planner import _pick_tiles
from repro_torch.kernels import bcjr, fused_metric_plan, ops, survivors, texpand, viterbi_scan
from repro_torch.kernels.common import launch_counts, plain_counts, reset_counts
from repro_torch.kernels.tiling import MIN_TILE_CORE, default_tiles
from repro_torch.models import build
from repro_torch.roofline import analysis, op_cost, steps
from repro_torch.roofline.op_cost import CostCounter, count_fn_costs
from repro_torch.siso import RSC_K4_LTE
from repro_torch.train.optimizer import get_optimizer

torch.set_num_threads(1)

K3 = (3, (0b111, 0b101))
K7 = (7, (0o171, 0o133))
META = "meta"
CPU = PD.DecodeContext(device="cpu")


# --------------------------------------------------------------------------- #
# the counter on the reference's micro-cases                                   #
# --------------------------------------------------------------------------- #


def test_loop_trips_count_as_the_reference_scan():
    """tests/test_sharding_and_parallel.py's 10-trip ``tanh(h @ W)`` scan:
    each trip's product and tanh, exactly."""
    W = np.zeros((32, 32), np.float32)

    def r_fn(x):
        h, _ = jax.lax.scan(lambda h, _: (jnp.tanh(h @ W), None), x, None, length=10)
        return h

    def p_fn(h):
        Wt = torch.from_numpy(W)
        for _ in range(10):
            h = torch.tanh(h @ Wt)
        return h

    want = r_count(r_fn, jnp.zeros((4, 32)))
    assert count_fn_costs(p_fn, torch.zeros((4, 32))) == want
    assert want == {"flops": 10 * (2 * 4 * 32 * 32 + 4 * 32), "bytes": 61440.0,
                    "input_bytes": 512.0}


def _grad_costs(checkpointed):
    """(reference, port) counts of the gradient of tanh(tanh(x W) W).sum(),
    each block checkpointed or not."""
    W = np.zeros((16, 16), np.float32)
    Wt = torch.from_numpy(W)

    def r_loss(x):
        f = lambda h: jnp.tanh(h @ W)  # noqa: E731
        f = jax.checkpoint(f) if checkpointed else f
        return f(f(x)).sum()

    def p_grad(x):
        from torch.utils.checkpoint import checkpoint

        f = lambda h: torch.tanh(h @ Wt)  # noqa: E731
        g = (lambda h: checkpoint(f, h, use_reentrant=False)) if checkpointed else f
        x = x.detach().requires_grad_()
        return torch.autograd.grad(g(g(x)).sum(), x)[0]

    return r_count(jax.grad(r_loss), jnp.zeros((2, 16))), count_fn_costs(p_grad, torch.zeros((2, 16)))


def test_checkpoint_recompute_counts_as_the_reference_remat():
    """The checkpointed gradient recomputes both blocks' product and tanh:
    what checkpointing adds is equal in both packages, flops and bytes.  The
    rest differs only by tanh's derivative: one ``tanh_backward`` (n flops,
    3n words) here, ``sub``, ``mul``, ``mul`` there (3n flops; a 1.0
    literal, 8n words)."""
    (r_ck, p_ck), (r_no, p_no) = _grad_costs(True), _grad_costs(False)
    for key in ("flops", "bytes"):
        assert p_ck[key] - p_no[key] == r_ck[key] - r_no[key] > 0
    assert p_ck["flops"] - p_no["flops"] == 2 * (2 * 2 * 16 * 16 + 2 * 16)  # two products, two tanh
    n = 2 * 16  # elements of one block's output
    for r, p in ((r_ck, p_ck), (r_no, p_no)):
        assert r["flops"] - p["flops"] == 2 * (3 * n - n)
        assert r["bytes"] - p["bytes"] == 2 * (4 + 8 * n * 4 - 3 * n * 4)
        assert r["input_bytes"] == p["input_bytes"] == 2 * 16 * 4


def test_products_elementwise_layout_and_input_bytes_equal_the_reference():
    rng = np.random.default_rng(0)
    a, b = rng.standard_normal((3, 5, 7), np.float32), rng.standard_normal((3, 7, 4), np.float32)
    x, y = rng.standard_normal((6, 8), np.float32), rng.standard_normal((6, 8), np.float32)
    idx = np.arange(6, dtype=np.int32)
    cases = [
        (lambda a, b: jnp.einsum("bmk,bkn->bmn", a, b),
         lambda a, b: torch.einsum("bmk,bkn->bmn", a, b), (a, b)),
        (lambda x, y: x @ y.T, lambda x, y: x @ y.T, (x, y)),
        (lambda x, y: jnp.exp(x) + jnp.maximum(x, y),
         lambda x, y: torch.exp(x) + torch.maximum(x, y), (x, y)),
        (lambda x, y, i: jnp.concatenate([x.T.reshape(4, 12), y[:, 2:6].reshape(4, 6)], axis=1),
         lambda x, y, i: torch.cat([x.T.reshape(4, 12), y[:, 2:6].reshape(4, 6)], dim=1),
         (x, y, idx)),
    ]
    for r_fn, p_fn, args in cases:
        want = r_count(r_fn, *map(jnp.asarray, args))
        got = count_fn_costs(p_fn, *map(torch.from_numpy, args))
        assert got == want
    assert got == {"flops": 0.0, "bytes": 0.0, "input_bytes": 4.0 * (48 + 48 + 6)}


def test_counter_nests_with_the_op_lint_recorder():
    """A path traced under op_lint's recorder and the counter at once gives
    both their records, each as when it runs alone."""
    from repro_torch.analysis.op_lint import OpRecorder

    spec = PD.CodecSpec(code=PCode(*K3))
    bm = torch.zeros((4, 64, 4))

    def run():
        return PD.get_decoder("fused").fn(spec, bm, ctx=CPU).bits

    run()  # the first call uploads the table weights (cached after)
    with OpRecorder() as alone:
        run()
    want = count_fn_costs(run)
    with OpRecorder() as rec, CostCounter() as c:
        run()
    with CostCounter() as c2, OpRecorder() as rec2:
        run()
    assert len(rec.ops) == len(rec2.ops) == len(alone.ops) > 0
    assert (c.flops, c.bytes) == (c2.flops, c2.bytes) == (want["flops"], want["bytes"])


def test_roofline_imports_neither_jax_nor_the_reference():
    src = Path(__file__).resolve().parents[1] / "src"
    code = ("import sys, repro_torch.roofline, repro_torch.roofline.steps; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'repro.'))"
            " or m == 'repro']; print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], env={"PYTHONPATH": str(src)},
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


# --------------------------------------------------------------------------- #
# analysis: model_flops, the roofline terms and report, collective bytes       #
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("arch", r_arch_ids())
def test_model_flops_equals_the_reference(arch):
    rcfg, pcfg = r_get_arch(arch).model, get_arch(arch).model
    assert set(SHAPES) == set(R_SHAPES)
    for name, shape in SHAPES.items():
        assert analysis.model_flops(pcfg, shape) == R_analysis.model_flops(rcfg, R_SHAPES[name])


def test_roofline_terms_and_report_equal_the_reference():
    hw = analysis.HW
    rhw = R_analysis.Hardware(name=hw.name, peak_flops=hw.peak_flops, hbm_bw=hw.hbm_bw,
                              ici_bw=hw.ici_bw, hbm_bytes=hw.hbm_bytes)
    for args in ((3.1e15, 2.2e12, 4.5e9), (1.0e9, 7.0e12, 0.0), (5e12, 1e9, 9e11)):
        assert analysis.roofline_terms(*args) == R_analysis.roofline_terms(*args, hw=rhw)
    cell = {"chips": 4, "jaxpr_cost": {"flops_per_device": 2.75e14, "bytes_per_device": 5.6e12},
            "cost_analysis": {"flops": 1.0, "bytes accessed": 2.0},
            "collectives": {"total": 3.0e9}, "model_flops": 6.1e14}
    assert analysis.roofline_report(cell) == R_analysis.roofline_report(cell, hw=rhw)
    bare = {"cost_analysis": {"flops": 4e12, "bytes accessed": 3e11},
            "collectives": {"total": 0.0}, "model_flops": 1e12}
    assert analysis.roofline_report(bare) == R_analysis.roofline_report(bare, hw=rhw)
    assert (hw.peak_flops, hw.hbm_bw, hw.ici_bw, hw.fp32_flops) == (989.4e12, 3.35e12, 450e9,
                                                                     67e12)


def test_collective_bytes_after_each_collective_on_an_8_device_cpu_mesh():
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.parallel import collectives as C

    mesh = make_mesh((8,), ("model",), devices=["cpu"] * 8)
    shards = [torch.full((3, 5), float(i)) for i in range(8)]
    C.calls.clear()
    C.nbytes.clear()
    assert analysis.collective_bytes()["total"] == 0.0
    C.gather(mesh, "model", shards)
    C.all_gather(mesh, "model", shards)
    C.ring_shift(mesh, "model", shards)
    total = C.reduce_across_shards(mesh, "model", torch.ones((16, 2, 3)), op="sum")
    out = analysis.collective_bytes()
    ref = R_analysis.collective_bytes("")
    assert set(out) == set(ref) and list(out["per_kind"]) == list(ref["per_kind"])
    shard = 3 * 5 * 4
    assert out["per_kind"] == {"all-gather": 2 * 8 * shard, "all-reduce": 2 * 3 * 4,
                               "reduce-scatter": 0.0, "all-to-all": 0.0,
                               "collective-permute": shard}
    assert out["counts"] == {"all-gather": 2, "all-reduce": 1, "reduce-scatter": 0,
                             "all-to-all": 0, "collective-permute": 1}
    assert out["total"] == sum(out["per_kind"].values())
    assert torch.equal(total, torch.full((2, 3), 16.0))


# --------------------------------------------------------------------------- #
# the kernels: counted bounds at PERF.md §6's shapes, the meta route           #
# --------------------------------------------------------------------------- #

HBM = 3.35e12
FP32 = 67e12
#: #11's rate: two fp32 instructions a candidate over 128 lanes x 132 SMs x
#: 1980 MHz (PERF.md §6)
SM_INS = 128 * 132 * 1980e6


def _bound_ms(flops, nbytes, rate=FP32):
    return max(nbytes / HBM, flops / rate) * 1e3


def _meta(*shape, dtype=torch.float32):
    return torch.zeros(shape, dtype=dtype, device=META)


def _launches(fn):
    with CostCounter() as c:
        fn()
    return c.launches


def _path_bounds(fn, name, rate=FP32):
    """Each launch of kernel ``name`` in ``fn()`` on meta: its bound (ms)."""
    return [_bound_ms(f, b, rate) for n, f, b in _launches(fn) if n == name]


def _hard_rx(B, T, code=CODE_K7_NASA):
    plan = fused_metric_plan(code, "hard")
    return plan, _meta(B, T, code.n_out)


def _bm(B, T, code=CODE_K7_NASA):
    return _meta(B, T, code.n_symbols)


def _scan_row(name, B, T, F, code=CODE_K7_NASA):
    """One carried scan (#3 or #7) called on meta operands; its bound."""
    S = code.n_states
    data, w = _meta(B, T, F), [_meta(S, F), _meta(S, F), _meta(S, 2)]
    if name == "viterbi_scan_carry":
        fn = lambda: viterbi_scan.viterbi_scan_carry(code, _meta(B, S), data)  # noqa: E731
    else:
        fn = lambda: viterbi_scan.viterbi_scan_packed_carry(code, _meta(B, S), data, *w)  # noqa: E731
    return _path_bounds(fn, name)


def _bcjr_rows(B, N):
    code, F = RSC_K4_LTE, RSC_K4_LTE.n_features
    feat = _meta(N, F, B)
    a = _path_bounds(lambda: bcjr.bcjr_alpha_scan(code, feat), "bcjr_alpha_scan")
    b = _path_bounds(lambda: bcjr.bcjr_beta_llr_scan(code, _meta(N, code.n_states, B), feat),
                     "bcjr_beta_llr_scan")
    return a + b


K3_CODE = PCode(*K3)


#: PERF.md §6's "Bound ms" column at its shapes (#2 and #5's bytes count the
#: distinct survivor words the card run's walks touched, which depend on the
#: data: chip_smoke.py prints them; WORDS holds them)
WORDS = {"short_blocks": 6605015, "nasa_planned": 844762, "session": 13024, "scheduler": 6565,
         "tiled_p8": 54181761, "long_stream": 33201}

BOUND_ROWS = {
    "#1 fused_packed 8192x1006": (
        lambda: _path_bounds(lambda: ops.viterbi_decode_fused_packed(*_hard_rx(8192, 1006)),
                             "viterbi_scan_packed"), [0.057073052656716416]),
    "#2 short blocks 8192x1006": (
        lambda: [_bound_ms(*op_cost.traceback_cost(8192, 1006, WORDS["short_blocks"]))],
        [0.01773654805970149]),
    "#2 NASA planned 1024x1030": (
        lambda: [_bound_ms(*op_cost.traceback_cost(1024, 1030, WORDS["nasa_planned"]))],
        [0.0022692608955223884]),
    "#2 session push 128x128, scheduler tick 64x128": (
        lambda: [_bound_ms(*op_cost.traceback_cost(128, 128, WORDS["session"])),
                 _bound_ms(*op_cost.traceback_cost(64, 128, WORDS["scheduler"]))],
        [3.5266865671641796e-05, 1.7696716417910447e-05]),
    "#3 session 128x64": (
        lambda: _scan_row("viterbi_scan_packed_carry", 128, 64, 2), [5.914746268656716e-05]),
    "#3 scheduler 64x64": (
        lambda: _scan_row("viterbi_scan_packed_carry", 64, 64, 2), [2.9802985074626863e-05]),
    "#4 pinned P=8, both passes": (
        lambda: [sum(_path_bounds(
            lambda: ops.viterbi_decode_tiled_fused(*_hard_rx(1024, 1030), 8),
            "viterbi_scan_packed_window"))], [0.4747814208955224]),
    "#4 parallel NASA": (
        lambda: _path_bounds(lambda: ops.viterbi_decode_parallel_op(CODE_K7_NASA, _bm(1024, 1030)),
                             "viterbi_scan_packed_window"), [0.6837662185074627]),
    "#5 pinned P=8": (
        lambda: [_bound_ms(*op_cost.traceback_window_cost(
            8192 * 64, 160 // 32, _tiled_walk_steps(1024, 1030, 8), WORDS["tiled_p8"]))],
        [0.1673611856716418]),
    "#5 long stream planned": (
        lambda: [_bound_ms(*op_cost.traceback_window_cost(
            512, 544 // 32, _tiled_walk_steps(1, 65538, 128, K3_CODE), WORDS["long_stream"]))],
        [0.00037465910447761195]),
    "#6 fused 8192x1006": (
        lambda: _path_bounds(lambda: ops.viterbi_decode_fused(CODE_K7_NASA, _bm(8192, 1006)),
                             "viterbi_scan"), [0.6697591211940299]),
    "#7 streaming chunk, NASA and long re-scans": (
        lambda: (_scan_row("viterbi_scan_carry", 128, 64, 4)
                 + _path_bounds(lambda: ops.viterbi_decode_parallel_op(
                     CODE_K7_NASA, _bm(1024, 1030)), "viterbi_scan_carry")
                 + _path_bounds(lambda: ops.viterbi_decode_parallel_op(
                     K3_CODE, _bm(1, 65538, K3_CODE), 512), "viterbi_scan_carry")),
        [0.0006854686567164178, 0.09312057313432835, 0.0006321862686567164]),
    "#8 texpand one step 8192": (
        lambda: _path_bounds(lambda: texpand.texpand(CODE_K7_NASA, _meta(8192, 64), _meta(8192, 4)),
                             "texpand"), [0.0019173253731343282]),
    "#9/#10 turbo N=512, LTE N=6144, bcjr": (
        lambda: _bcjr_rows(8192, 512) + _bcjr_rows(1024, 6144) + _bcjr_rows(8192, 1003),
        [0.055167675223880594, 0.060097623880597015, 0.08264388776119402,
         0.09014636895522388, 0.10799751641791044, 0.11773017791044776]),
    "#11 widest combine, the seven NASA combines": (
        lambda: (lambda b: [max(b), sum(b)])(_path_bounds(
            lambda: ops.viterbi_decode_parallel_op(CODE_K7_NASA, _bm(1024, 1030)),
            "minplus_matmul", SM_INS)), [0.12838396082032447, 0.4332958677685951]),
}


def _tiled_walk_steps(B, T, P, code=CODE_K7_NASA):
    """The windowed walk's lane-steps in a tiled decode, as the op counts them."""
    (_, flops, _), = [x for x in _launches(
        lambda: ops.viterbi_decode_tiled_fused(*_hard_rx(B, T, code), P))
        if x[0] == "traceback_packed_window"]
    return flops // 6


@pytest.mark.parametrize("row", list(BOUND_ROWS))
def test_counted_bounds_reproduce_the_perf_table(row):
    fn, want = BOUND_ROWS[row]
    assert fn() == pytest.approx(want, rel=1e-12)


def test_meta_route_returns_empty_outputs_and_counts_no_run():
    """Every wrapper on meta operands: outputs of the kernel's shapes and
    dtypes on meta, one cost entry, no launch and no plain call."""
    code = CODE_K7_NASA
    S, B, T = code.n_states, 5, 40
    w = [_meta(S, 2), _meta(S, 2), _meta(S, 2)]
    lo, hi = _meta(B, dtype=torch.int32), _meta(B, dtype=torch.int32)
    words = _meta(2, B, S, dtype=torch.int32)
    fs = _meta(B, dtype=torch.int32)
    calls = {
        "viterbi_scan_packed": (lambda: viterbi_scan.viterbi_scan_packed(
            code, _meta(B, T, 2), *w), [((B, S), torch.float32), ((2, B, S), torch.int32)]),
        "viterbi_scan_packed_window": (lambda: viterbi_scan.viterbi_scan_packed_window(
            code, _meta(B, S), _meta(B, T, 2), *w, lo, hi),
            [((B, S), torch.float32), ((2, B, S), torch.int32)]),
        "viterbi_scan": (lambda: viterbi_scan.viterbi_scan(code, _meta(B, T, 4)),
                         [((B, S), torch.float32), ((T, B, S), torch.int32)]),
        "traceback_packed": (lambda: (survivors.traceback_packed(code, words, fs, T),),
                             [((B, T), torch.int32)]),
        "traceback_packed_window": (lambda: survivors.traceback_packed_window(
            code, words, fs, lo, hi), [((B, 64), torch.int32), ((B,), torch.int32)]),
        "texpand": (lambda: texpand.texpand(code, _meta(B, S), _meta(B, 4)),
                    [((B, S), torch.float32), ((B, S), torch.int32)]),
        "bcjr_alpha_scan": (lambda: bcjr.bcjr_alpha_scan(RSC_K4_LTE, _meta(T, 3, B)),
                            [((T, 8, B), torch.float32), ((8, B), torch.float32)]),
        "minplus_matmul": (lambda: (ops._minplus.minplus_matmul(_meta(3, 4, 5), _meta(3, 5, 2)),),
                           [((3, 4, 2), torch.float32)]),
    }
    reset_counts()
    for name, (fn, want) in calls.items():
        with CostCounter() as c:
            out = fn()
        assert [(tuple(t.shape), t.dtype) for t in out] == want, name
        assert all(t.device.type == META for t in out), name
        assert [x[0] for x in c.launches] == [name], name
        assert c.flops > 0 and c.bytes > 0, name
    assert not launch_counts and not plain_counts


# --------------------------------------------------------------------------- #
# the planner: predicted_costs, explain(costs=True), _pick_tiles               #
# --------------------------------------------------------------------------- #


def _plans(code, backend, B=4, T=128):
    """The reference's and the port's plan of one backend at (B, T), built
    directly (no capability check), as the reference's table was."""
    K, polys = code
    rspec, pspec = RD.CodecSpec(code=RCode(K, polys)), PD.CodecSpec(code=PCode(K, polys))
    rctx = RD.DecodeContext(chunk=32, tiles=2 if backend == "tiled" else None)
    pctx = PD.DecodeContext(chunk=32, tiles=rctx.tiles, device="cpu")
    return (RD.DecodePlan(spec=rspec, backend=backend, batch=B, steps=T, ctx=rctx, reason="",
                          device_kind="cpu"),
            PD.DecodePlan(spec=pspec, backend=backend, batch=B, steps=T, ctx=pctx, reason="",
                          device_kind="cpu"))


@pytest.mark.parametrize("code", [K3, K7], ids=["k3", "k7"])
def test_predicted_costs_none_where_the_reference_is_and_cpu_equals_meta(code):
    """Every registered backend at (B=4, T=128): None exactly where the
    reference's is; elsewhere the count on meta (predicted_costs) equals the
    same decode counted on the CPU with real zeros, and runs nothing."""
    traceable = []
    for backend in PD.list_decoders():
        ref, plan = _plans(code, backend)
        reset_counts()
        got = plan.predicted_costs()
        assert not launch_counts and not plain_counts, backend
        assert (got is None) == (ref.predicted_costs() is None), backend
        if got is None:
            continue
        traceable.append(backend)
        bm = torch.zeros((4, 128, plan.spec.table_width))
        on_cpu = count_fn_costs(lambda t: plan.decoder(plan.spec, t, ctx=plan.ctx).bits, bm)
        assert got == on_cpu, backend
        assert got["input_bytes"] == 4 * 128 * plan.spec.table_width * 4
    assert traceable == ["fused", "fused_packed", "parallel", "sequential", "tiled"]


def test_explain_costs_prints_the_counted_prediction():
    """The reference's tests/test_obs.py:542 on the port."""
    plan = PD.plan_decode(PD.CodecSpec(code=PCode(*K3)), (4, 128), ctx=CPU)
    text = plan.explain(costs=True)
    assert "cost:" in text and "flops/byte" in text
    assert "cost:" not in plan.explain()
    c = plan.predicted_costs()
    assert f"~{c['flops']:.3g} flops" in text
    stream = PD.plan_decode(PD.CodecSpec(code=PCode(*K3)), (4, 128),
                            ctx=dataclasses.replace(CPU, streaming=True))
    assert "untraceable" in stream.explain(costs=True)


@pytest.mark.parametrize("code,B,T", [(K3, 4, 1024), (K7, 2, 4096), (K3, 1, 65538)])
def test_pick_tiles_is_the_argmin_of_counted_cost_per_tile(code, B, T):
    spec = PD.CodecSpec(code=PCode(*code))
    S = spec.code.n_states
    P, why = _pick_tiles(spec, B, T, "cpu", 64, "cpu")
    cands = sorted({p for p in (1, 2, 4, 8, 16, 32) if p <= max(1, T // MIN_TILE_CORE)}
                   | {default_tiles(B, T, S)})
    scored = {}
    for p in cands:
        plan = PD.DecodePlan(spec=spec, backend="tiled", batch=B, steps=T,
                             ctx=PD.DecodeContext(tiles=p, device="cpu"), reason="",
                             device_kind="cpu")
        c = plan.predicted_costs()
        scored[p] = (c["flops"] + c["bytes"]) / p
    assert P == min(scored, key=scored.get) and "argmin" in why
    assert _pick_tiles(spec, B, T, "cpu", 64, "cpu") == (P, why)  # cached


# --------------------------------------------------------------------------- #
# the LM's steps on meta                                                       #
# --------------------------------------------------------------------------- #


def test_lm_steps_count_the_same_on_meta_and_on_the_cpu():
    """qwen2.5's smoke model: the train step (remat, AdamW) and a decode
    step counted on meta equal the same steps run on the CPU with real
    tensors; the train step's products cover the model FLOPs."""
    bundle = get_smoke_arch("qwen2_5_3b")
    shape = dataclasses.replace(SHAPES["train_4k"], seq_len=32, global_batch=2)
    meta_model, cpu_model = build(bundle, device=META), build(bundle, device="cpu")
    want = steps.count_train_step(meta_model, shape)
    params = cpu_model.init(torch.Generator().manual_seed(0))
    state = get_optimizer(bundle.partition.optimizer).init(params)
    tokens = torch.randint(1, bundle.model.vocab, (2, 32), dtype=torch.int32,
                           generator=torch.Generator().manual_seed(1))
    got = count_fn_costs(steps.train_step(cpu_model), params, state,
                         {"tokens": tokens, "labels": tokens}, 0)
    assert got == want
    assert want["flops"] > analysis.model_flops(bundle.model, shape)
    dec = dataclasses.replace(SHAPES["decode_32k"], seq_len=16, global_batch=2)
    want = steps.count_decode_step(meta_model, dec)
    caches = cpu_model.init_cache(2, 16)
    got = count_fn_costs(steps.decode_step(cpu_model), params, tokens[:, :1],
                         torch.full((2,), 3, dtype=torch.int32), caches)
    assert got == want
    with torch.inference_mode():  # composite ops arrive whole: decomposed
        assert steps.count_decode_step(meta_model, dec) == want
