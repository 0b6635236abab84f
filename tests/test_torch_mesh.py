"""The port's device mesh, collectives and ``seqparallel`` backend held
against the reference on identical numpy inputs.

The reference's ``viterbi_decode_seqparallel`` fails under this jax before
it computes anything (shard_map's replication check), but its shard function
is built from plain functions that run: the oracle here composes them off
the mesh, shard by shard — ``_local_transfer_and_bps`` for each shard's
transfer matrix, ``prefix_maps`` (the same left fold of ``compose_maps`` as
the shard's ``pref_step``), the clamped ``acs_step`` re-scan from row 0 of
each exclusive prefix, and ``_traceback``.  The port must equal it bit for
bit, soft metrics included, for n = 1, 2, 4, 8 shards of a CPU mesh.

Also: ``decode()`` planning ``seqparallel`` from a mesh alone, planner parity
with meshes (the reference given a ``SimpleNamespace`` mesh shape, the port
a ``Mesh`` of the same shape), ``viterbi_decode(normalize=, unroll=)``, the
collectives, the mesh constructors and the mesh rules.  Nothing here starts
a process group: the mesh is single-controller.
"""
import dataclasses
import functools
import types

import jax  # noqa: F401  (both frameworks in one process; JAX stays on the CPU)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.decode as RD
from repro.core import viterbi as R_vit
from repro.core.acs import acs_step as r_acs_step
from repro.core.trellis import NEG_UNREACHABLE
from repro.core.trellis import ConvCode as RCode
from repro.kernels.minplus import prefix_maps as r_prefix_maps
from repro.parallel import collectives as R_coll
from repro_torch import decode as PD
from repro_torch.core import viterbi as P_vit
from repro_torch.core.trellis import ConvCode as PCode
from repro_torch.kernels.common import plain_counts, reset_counts
from repro_torch.launch import mesh as P_launch_mesh
from repro_torch.launch.mesh import make_mesh, smoke_mesh
from repro_torch.parallel import Mesh
from repro_torch.parallel import collectives as P_coll

torch.set_num_threads(1)

CPU = PD.DecodeContext(device="cpu")
CODES = {"k3": (3, (0b111, 0b101)), "k7": (7, (0o171, 0o133))}


def _cpu_mesh(shape, axes=("data", "model")):
    return make_mesh(shape, axes, devices=["cpu"] * int(np.prod(shape)))


def _specs(code_name, metric, terminated=True):
    K, polys = CODES[code_name]
    kw = dict(metric=metric, terminated=terminated)
    return RD.CodecSpec(code=RCode(K, polys), **kw), PD.CodecSpec(code=PCode(K, polys), **kw)


def _tables(rspec, pspec, B, T, seed):
    """(B, T, M) float32 branch-metric tables of seeded channel output (the
    reference builds them; both packages decode the same numpy array)."""
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, (B, T - pspec.n_flush)).astype(np.int32)
    coded = pspec.encode(torch.from_numpy(bits)).numpy()
    if pspec.soft:
        rx = ((1.0 - 2.0 * coded) + 0.8 * rng.standard_normal(coded.shape)).astype(np.float32)
    else:
        rx = (coded ^ (rng.random(coded.shape) < 0.05)).astype(np.int32)
    return bits, rx, np.array(rspec.branch_metrics(jnp.asarray(rx)))


@functools.lru_cache(maxsize=None)
def _reference_composition(code_name, n, terminated):
    """The reference's shard function composed off the mesh (module
    docstring), its per-shard steps vmapped over the n shards and jitted
    once per (code, n, terminated): bm (B, T, M) -> (bits (B, T), metric
    (B,))."""
    rcode = RCode(*CODES[code_name])

    def bp_step(pm, bm_t):
        new_pm, bp = r_acs_step(rcode, pm, bm_t)
        return jnp.minimum(new_pm, NEG_UNREACHABLE), bp

    def run(bm):
        B, T, M = bm.shape
        shards = bm.reshape(B, n, T // n, M).swapaxes(0, 1)  # (n, B, C, M)
        mats = jax.vmap(lambda x: R_coll._local_transfer_and_bps(rcode, x))(shards)
        excl, total = r_prefix_maps(mats)
        bps = jax.vmap(lambda pm0, x: jax.lax.scan(bp_step, pm0, x.swapaxes(0, 1))[1])(
            excl[:, :, 0, :], shards)  # (n, C, B, S)
        final_pm = total[:, 0, :]
        if terminated:
            final_state, metric = jnp.zeros((B,), jnp.int32), final_pm[:, 0]
        else:
            final_state = jnp.argmin(final_pm, axis=-1).astype(jnp.int32)
            metric = final_pm.min(axis=-1)
        bits, _ = R_vit._traceback(rcode, bps.reshape((T,) + bps.shape[2:]), final_state)
        return bits, metric

    return jax.jit(run)


# --------------------------------------------------------------------------- #
# seqparallel against the reference's composition                             #
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("code_name", ["k3", "k7"])
@pytest.mark.parametrize("metric", ["hard", "soft"])
def test_seqparallel_equals_reference_composition(code_name, metric):
    """n = 1, 2, 4, 8 shards; T = 256 gives shards of 256..32 steps (whole
    packed words, the #3 re-scan) and T = 120 of 120..15 (the #7 re-scan
    and the pack); terminated and open, bit for bit."""
    reset_counts()
    for T, rescan in ((256, "viterbi_scan_packed_carry"), (120, "viterbi_scan_carry")):
        for terminated in (True, False):
            rspec, pspec = _specs(code_name, metric, terminated)
            _, _, bm = _tables(rspec, pspec, 3, T, seed=T + terminated)
            seq_bits, seq_metric = R_vit.viterbi_decode(rspec.code, jnp.asarray(bm),
                                                        terminated=terminated)
            for n in (1, 2, 4, 8):
                want_bits, want_metric = _reference_composition(code_name, n, terminated)(bm)
                bits, metric_ = P_coll.viterbi_decode_seqparallel(
                    pspec, torch.from_numpy(bm), _cpu_mesh((1, n)))
                case = (T, terminated, n)
                np.testing.assert_array_equal(bits.numpy(), np.asarray(want_bits),
                                              err_msg=str(case))
                np.testing.assert_array_equal(metric_.numpy(), np.asarray(want_metric),
                                              err_msg=str(case))
                # the sequential decode: bits always, the metric where the
                # sums are integers
                np.testing.assert_array_equal(bits.numpy(), np.asarray(seq_bits))
                if metric == "hard":
                    np.testing.assert_array_equal(metric_.numpy(), np.asarray(seq_metric))
        assert plain_counts[rescan] > 0
    assert {"viterbi_scan_packed_window", "minplus_matmul",
            "traceback_packed"} <= set(plain_counts)


def test_seqparallel_carries_over_the_reference_unit_mesh_case():
    """tests/test_sharding_and_parallel.py's seqparallel case (K=3, B=4, 62
    info bits, BSC 0.05, a unit (data, model) mesh) against the reference's
    sequential decode of the same tables, with numpy inputs."""
    from repro_torch.core import CODE_K3_STD, bsc, encode, hard_branch_metrics

    rng = np.random.default_rng(0)
    bits = torch.from_numpy(rng.integers(0, 2, (4, 62)).astype(np.int32))
    coded = encode(CODE_K3_STD, bits, terminate=True)
    rx = bsc(torch.Generator().manual_seed(1), coded, 0.05)
    bm = hard_branch_metrics(CODE_K3_STD, rx)
    d_ref, m_ref = R_vit.viterbi_decode(RCode(*CODES["k3"]), jnp.asarray(bm.numpy()))
    d_sp, m_sp = P_coll.viterbi_decode_seqparallel(CODE_K3_STD, bm, _cpu_mesh((1, 1)))
    np.testing.assert_allclose(m_sp.numpy(), np.asarray(m_ref), rtol=1e-5)
    np.testing.assert_array_equal(d_sp.numpy(), np.asarray(d_ref))


def test_fold_step_equals_reference_compose_maps():
    """The fold's step, (min,+) from 1e30 through the product kernel's
    wrapper (its plain version here), equals the reference's clamped
    ``compose_maps`` bit for bit on soft maps with unreachable entries, and
    so does the whole left fold."""
    from repro.kernels.minplus import compose_maps as r_compose_maps
    from repro_torch.kernels import minplus as P_minplus

    rng = np.random.default_rng(11)
    mats = rng.standard_normal((5, 3, 8, 8)).astype(np.float32) * 40
    mats[rng.random(mats.shape) < 0.3] = NEG_UNREACHABLE
    got = P_minplus.compose_maps_kernel(torch.from_numpy(mats[0]), torch.from_numpy(mats[1]))
    want = r_compose_maps(jnp.asarray(mats[0]), jnp.asarray(mats[1]))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    excl, total = P_minplus.prefix_maps(torch.from_numpy(mats),
                                        compose=P_minplus.compose_maps_kernel)
    r_excl, r_total = r_prefix_maps(jnp.asarray(mats))
    np.testing.assert_array_equal(excl.numpy(), np.asarray(r_excl))
    np.testing.assert_array_equal(total.numpy(), np.asarray(r_total))


@pytest.mark.parametrize("T,n", [(120, 4), (256, 2)])
def test_seqparallel_capture_holds_every_launch(T, n):
    """``capture=`` hands back each launch's operands and results: every
    shard's matrix pass and matrix, the stack each device folded and its
    prefixes, every re-scan and its survivors, the stitched words and the
    walk, which replays to the decode's bits."""
    from repro_torch.kernels import survivors as P_surv

    rspec, pspec = _specs("k7", "soft")
    _, _, bm = _tables(rspec, pspec, 2, T, seed=T)
    cap = {}
    bits, _ = P_coll.viterbi_decode_seqparallel(pspec, torch.from_numpy(bm),
                                                _cpu_mesh((1, n)), capture=cap)
    S, C = pspec.code.n_states, T // n
    assert len(cap["pass1"]) == len(cap["mats"]) == len(cap["rescan"]) == len(cap["pieces"]) == n
    assert all(m.shape == (2, 1, S, S) for m in cap["mats"])
    (stack,) = cap["gathered"].values()  # one device: one fold
    (excl, total), = cap["folds"].values()
    assert stack.shape == excl.shape == (n, 2, S, S) and total.shape == (2, S, S)
    torch.testing.assert_close(stack, torch.stack([m[:, 0] for m in cap["mats"]]), rtol=0, atol=0)
    whole = C % 32 == 0
    assert all(len(args) == (6 if whole else 3) for args in cap["rescan"])
    assert cap["packed"].shape == (-(-T // 32), 2, S) and cap["walk"][1] is cap["packed"]
    if whole:
        assert torch.equal(cap["packed"], torch.cat(cap["pieces"]))
    else:
        assert torch.equal(cap["packed"], P_surv.pack_survivors(torch.cat(cap["pieces"])))
    assert torch.equal(P_surv.traceback_packed_plain(*cap["walk"]), bits)


# --------------------------------------------------------------------------- #
# through decode(): the planner picks seqparallel from the mesh               #
# --------------------------------------------------------------------------- #


def test_decode_plans_seqparallel_from_a_mesh_alone():
    rspec, pspec = _specs("k3", "hard")
    _, rx, bm = _tables(rspec, pspec, 2, 1030, seed=3)
    mesh = _cpu_mesh((1, 2))
    res = PD.decode(PD.DecodeRequest(pspec, received=torch.from_numpy(rx)),
                    ctx=PD.DecodeContext(mesh=mesh, device="cpu"))
    assert res.plan.backend == "seqparallel" and "model=2, T divisible" in res.plan.reason
    assert res.diagnostics == {"backend": "seqparallel", "mesh_axis": "model", "mesh_size": 2}
    ref_bits, ref_metric = R_vit.viterbi_decode(rspec.code, jnp.asarray(bm))
    np.testing.assert_array_equal(res.bits.numpy(), np.asarray(ref_bits))
    np.testing.assert_array_equal(res.path_metric.numpy(), np.asarray(ref_metric))
    # mesh= beside the context: the same plan
    same = PD.decode(pspec, torch.from_numpy(rx), mesh=mesh, ctx=CPU)
    assert same.plan.backend == "seqparallel" and torch.equal(same.bits, res.bits)
    # no process group was started: the mesh is single-controller
    assert not (torch.distributed.is_available() and torch.distributed.is_initialized())


def test_mesh_that_does_not_divide_T_plans_tiled_with_the_reference_reason():
    rspec, pspec = _specs("k3", "hard")
    ref = RD.plan_decode(rspec, (2, 1030), mesh=types.SimpleNamespace(shape={"model": 6}))
    plan = PD.plan_decode(pspec, (2, 1030), mesh=_cpu_mesh((6,), ("model",)), ctx=CPU)
    assert plan.backend == ref.backend == "tiled"
    assert "T % model=6 != 0" in plan.reason and "T % model=6 != 0" in ref.reason


MESH_CASES = [
    # (mesh shape, T, streaming, expected backend)
    ({"data": 4, "model": 2}, 1030, False, "seqparallel"),
    ({"data": 4, "model": 2}, 65538, False, "seqparallel"),
    ({"data": 4, "model": 2}, 2048, True, "sharded_stream"),
    ({"data": 1, "model": 2}, 2048, True, "streaming"),
    ({"data": 2}, 1030, False, "tiled"),
    ({"data": 4, "model": 2}, 500, False, "fused_packed"),
]


@pytest.mark.parametrize("shape,T,streaming,backend", MESH_CASES)
def test_planner_parity_with_meshes(shape, T, streaming, backend):
    rspec, pspec = _specs("k3", "hard")
    rctx = RD.DecodeContext(mesh=types.SimpleNamespace(shape=shape), streaming=streaming)
    mesh = _cpu_mesh(tuple(shape.values()), tuple(shape))
    pctx = PD.DecodeContext(mesh=mesh, streaming=streaming, device="cpu")
    ref = RD.plan_decode(rspec, (2, T), ctx=rctx)
    plan = PD.plan_decode(pspec, (2, T), ctx=pctx)
    assert plan.backend == ref.backend == backend
    for axis, size in shape.items():
        if f"{axis}={size}" in ref.reason:
            assert f"{axis}={size}" in plan.reason
    for why_not in ("mesh lacks axis 'model'", "T % model"):
        assert (why_not in plan.reason) == (why_not in ref.reason)
    if backend == "sharded_stream":
        # planned as in the reference, and executed: a request of noisy
        # symbols over the 4 slot shards, at a window deeper than T, decodes
        # to the reference's sequential bits and hard metric
        rng = np.random.default_rng(T)
        bits = rng.integers(0, 2, (2, T - pspec.n_flush)).astype(np.int32)
        coded = pspec.encode(torch.from_numpy(bits)).numpy()
        rx = (coded ^ (rng.random(coded.shape) < 0.03)).astype(np.int32)
        ref_bits, ref_metric = R_vit.viterbi_decode(
            rspec.code, rspec.branch_metrics(jnp.asarray(rx)))
        plan = PD.plan_decode(pspec, (2, T), ctx=dataclasses.replace(pctx, stream_depth=T))
        res = plan.execute_request(PD.DecodeRequest(pspec, received=torch.from_numpy(rx)))
        assert res.diagnostics["shards"] == 4 and res.diagnostics["depth"] == T
        np.testing.assert_array_equal(res.bits.numpy(), np.asarray(ref_bits))
        np.testing.assert_array_equal(res.path_metric.numpy(), np.asarray(ref_metric))


# --------------------------------------------------------------------------- #
# viterbi_decode(normalize=, unroll=)                                          #
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("metric", ["hard", "soft"])
@pytest.mark.parametrize("terminated", [True, False])
def test_viterbi_decode_normalize_and_unroll_match_reference(metric, terminated):
    rspec, pspec = _specs("k7", metric, terminated)
    _, _, bm = _tables(rspec, pspec, 3, 70, seed=11)
    for normalize, unroll in ((True, 1), (True, 4), (False, 2)):
        want = R_vit.viterbi_decode(rspec.code, jnp.asarray(bm), terminated=terminated,
                                    normalize=normalize, unroll=unroll)
        got = P_vit.viterbi_decode(pspec.code, torch.from_numpy(bm), terminated=terminated,
                                   normalize=normalize, unroll=unroll)
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    for bad in (0, 1.5, True):
        with pytest.raises(ValueError, match="unroll"):
            P_vit.viterbi_decode(pspec.code, torch.from_numpy(bm), unroll=bad)


# --------------------------------------------------------------------------- #
# collectives                                                                  #
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("op,fn", [("sum", np.sum), ("max", np.max), ("min", np.min)])
def test_reduce_across_eight_shards_matches_numpy(op, fn):
    mesh = _cpu_mesh((8,), ("data",))
    rows = np.random.default_rng(5).integers(-50, 50, (16, 3)).astype(np.int32)
    got = P_coll.reduce_across_shards(mesh, "data", rows, op=op)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), fn(rows, axis=0))
    with pytest.raises(ValueError, match="does not divide"):
        P_coll.reduce_across_shards(mesh, "data", rows[:3], op=op)


def test_sum_across_shards_and_axis_size_match_the_reference():
    rmesh = jax.make_mesh((1, 1), ("data", "model"))
    pmesh = _cpu_mesh((1, 1))
    for axis in ("data", "model", "nope"):
        assert P_coll.mesh_axis_size(pmesh, axis) == R_coll.mesh_axis_size(rmesh, axis)
    assert P_coll.mesh_axis_size(None, "data") == R_coll.mesh_axis_size(None, "data") == 0
    want = R_coll.sum_across_shards(rmesh, "data", jnp.asarray([[3, 5]]))
    got = P_coll.sum_across_shards(pmesh, "data", np.array([[3, 5]]))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_bad_reduce_op_raises_the_reference_error():
    with pytest.raises(ValueError, match="op must be 'sum', 'max' or 'min', got 'mean'") as ref:
        R_coll.reduce_across_shards(jax.make_mesh((1,), ("data",)), "data",
                                    jnp.zeros((1, 2)), op="mean")
    with pytest.raises(ValueError) as got:
        P_coll.reduce_across_shards(_cpu_mesh((1,), ("data",)), "data", np.zeros((1, 2)),
                                    op="mean")
    assert str(got.value) == str(ref.value)


def test_all_gather_stacks_on_each_shard_and_shares_a_device():
    mesh = _cpu_mesh((2, 4))
    parts = [torch.full((2,), float(i)) for i in range(4)]
    out = P_coll.all_gather(mesh, "model", parts)
    assert len(out) == 4 and all(t is out[0] for t in out)  # one device, one stack
    np.testing.assert_array_equal(out[0].numpy(), np.repeat(np.arange(4.0), 2).reshape(4, 2))
    with pytest.raises(ValueError, match="model=4"):
        P_coll.all_gather(mesh, "model", parts[:3])


# --------------------------------------------------------------------------- #
# the mesh and its rules                                                       #
# --------------------------------------------------------------------------- #


def test_mesh_reads_like_jax_mesh():
    mesh = _cpu_mesh((2, 3))
    rmesh = jax.make_mesh((1, 1), ("data", "model"))
    assert list(mesh.shape.items()) == [("data", 2), ("model", 3)]
    assert type(mesh.shape) is type(rmesh.shape)  # an OrderedDict, with .get
    assert mesh.shape.get("pod", 0) == 0 and mesh.size == 6 and mesh.devices.shape == (2, 3)
    assert mesh.axis_names == ("data", "model") and mesh.device_type == "cpu"
    assert mesh.shard_devices("model") == (torch.device("cpu"),) * 3
    assert mesh == _cpu_mesh((2, 3)) and hash(mesh) == hash(_cpu_mesh((2, 3)))
    assert mesh != _cpu_mesh((3, 2)) and len({mesh, _cpu_mesh((2, 3))}) == 1
    with pytest.raises(ValueError, match="no axis 'pod'"):
        mesh.shard_devices("pod")
    with pytest.raises(ValueError, match="distinct name"):
        Mesh(np.array([torch.device("cpu")] * 2, dtype=object), ("data", "model"))


def test_make_mesh_raises_without_enough_cards(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: make_mesh((1, 2), ("data", "model")),
                 lambda: P_launch_mesh.make_production_mesh(),
                 lambda: P_launch_mesh.make_production_mesh(multi_pod=True),
                 lambda: smoke_mesh()):
        with pytest.raises(ValueError, match="Number of devices 0 must be >= the product"):
            make()
    with pytest.raises(ValueError, match="3 devices given"):
        make_mesh((2,), ("model",), devices=["cpu"] * 3)
    cpu = smoke_mesh(device="cpu")
    assert dict(cpu.shape) == {"data": 1} and cpu.device_type == "cpu"


def test_mesh_rules():
    rspec, pspec = _specs("k3", "hard")
    mesh = _cpu_mesh((1, 2))
    # a mesh on another device type than ctx.device: no silent move
    with pytest.raises(ValueError, match="mesh devices are 'cpu'"):
        PD.DecodeContext(mesh=mesh)
    with pytest.raises(TypeError, match="Mesh"):
        PD.DecodeContext(mesh=types.SimpleNamespace(shape={"model": 2}), device="cpu")
    # T % n != 0 raises before any work
    reset_counts()
    with pytest.raises(ValueError, match="T=63 does not divide over model=2"):
        P_coll.viterbi_decode_seqparallel(pspec, torch.zeros((2, 63, 4)), mesh)
    assert not plain_counts
    # a mesh backend without a mesh: the reference's error
    with pytest.raises(ValueError, match=r"requires a mesh \(pass mesh=/ctx.mesh\)") as ref:
        RD.plan_decode(rspec, (2, 100), backend="seqparallel")
    with pytest.raises(ValueError) as got:
        PD.plan_decode(pspec, (2, 100), backend="seqparallel", ctx=CPU)
    assert str(got.value) == str(ref.value)
    # a sharded stream over a mesh without its batch axis
    with pytest.raises(ValueError, match="shards over mesh axis 'data'"):
        PD.plan_decode(pspec, (2, 100), backend="sharded_stream",
                       ctx=PD.DecodeContext(mesh=_cpu_mesh((2,), ("model",)), device="cpu"))
    # inputs and results on the mesh's first device
    assert PD.DecodeContext(mesh=mesh, device="cpu").place(np.zeros(3)).device.type == "cpu"


def test_lm_sharding_helpers_raise_naming_item_9b():
    """The LM's sharding helpers give placements on any mesh (PR 32 ported
    them; ``tests/test_torch_lm_mesh.py`` holds them against the
    reference); what they place is executed data-parallel only, and a
    tensor-parallel placement raises naming item 9b.3."""
    from repro_torch.configs.base import PartitionConfig, get_smoke_arch
    from repro_torch.models import build
    from repro_torch.parallel import sharding

    mesh = _cpu_mesh((2, 2))
    rules = sharding.make_rules(PartitionConfig())
    assert rules["kv_seq"] == "model" and rules["batch"] == ("pod", "data")
    assert tuple(sharding.batch_spec(mesh, 2)) == ("data", None)
    assert sharding.named_sharding(mesh, sharding.batch_spec(mesh, 2)).shard_shape((4, 3)) == (2, 3)
    assert [tuple(s.spec) for s in sharding.shard_batch_tree(mesh, {"a": torch.zeros(4, 2),
                                                                    "b": torch.zeros(3)}).values()
            ] == [("data", None), ()]
    model = build(get_smoke_arch("qwen2_5_3b"), device="cpu")
    p_sh, c_sh = sharding.step_shardings(model, mesh, "decode", 4, 16)
    with pytest.raises(NotImplementedError, match="item 9b"):
        sharding.require_data_parallel_tree(p_sh, model.param_specs, "params")
    with pytest.raises(NotImplementedError, match="item 9b"):
        sharding.require_data_parallel_tree(c_sh, model.cache_specs(4, 16), "caches")