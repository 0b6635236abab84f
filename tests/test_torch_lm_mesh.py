"""The LM's mesh pieces held against the reference: the logical-axis
placements of every configuration at full width, the data-parallel
``ServeEngine(mesh=)`` and train step on CPU meshes, ``flash_decode_sharded``,
``reshard_restored`` across meshes, the collectives the step reduces with,
the declared refusals and ``launch/train.py --mesh``.

Placements are pure shape arithmetic: the reference's ``resolve_axes``
reads nothing of a mesh but ``mesh.shape``, so both packages run on
stand-in meshes (an object with a ``shape`` mapping) at production sizes
without devices; the reference's ``NamedSharding`` (which wants a jax
mesh) is swapped for one that returns its spec.  Execution uses CPU
meshes whose cells repeat ``cpu``.  The reference's own mesh paths need an
Auto-axis mesh under jax 0.9 (``jax.make_mesh`` gives Explicit axes, which
``with_sharding_constraint`` refuses), built here as ``_auto_mesh``.

Stated tolerances: the repo's LM ones (``tests/test_torch_models.py``,
``tests/test_torch_train.py``): ``FP32`` (rtol 1e-5) for float32 prefill
logits, ``FP32_CACHED`` (1e-2) for decode logits read through bf16 caches,
``BF16_GRAD`` (3e-2 relative L2 a leaf) for a bf16 step's updated
parameters and moments (the data-parallel step sums bf16 gradients of
its shards where the one-device step takes one bf16 gradient of the whole
batch), the loss by rtol 2e-5; ``flash_decode_sharded`` rtol/atol 2e-4
(the reference's own test's).  Greedy tokens, placements, gathers and
checkpoint round trips are exact.
"""
import dataclasses
import functools
import types
from collections import OrderedDict

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs.base as RCB
import repro.parallel.sharding as RS
from repro.models import common as RM
from repro.models.attention import _masked_decode as r_masked_decode
from repro.models.attention import flash_decode_sharded as r_flash_decode
from repro.models.model_zoo import build as r_build
from repro.serve import ServeEngine as RServeEngine
from repro.train import optimizer as ropt
from repro.train.train_loop import _opt_shardings as r_opt_shardings
from repro.train.train_loop import make_train_step as r_make_train_step
import repro_torch.configs.base as PCB
import repro_torch.models.attention as PA
import repro_torch.models.common as PM
import repro_torch.models.transformer as PT
import repro_torch.parallel.sharding as PS
from repro_torch.convert import lm_params_from_arrays
from repro_torch.data import SyntheticLM
from repro_torch.launch.mesh import make_mesh, make_production_mesh
from repro_torch.models import build as p_build
from repro_torch.parallel import collectives
from repro_torch.parallel.placement import NamedSharding, PartitionSpec, Placed
from repro_torch.serve import ServeEngine
from repro_torch.train import checkpoint as pckpt
from repro_torch.train import optimizer as popt
from repro_torch.train.train_loop import _opt_shardings, make_train_step, read_metrics, train
from repro_torch.train.tree import tree_leaves, tree_map

torch.set_num_threads(1)

FP32 = dict(rtol=1e-5, atol=1e-5)
FP32_CACHED = dict(rtol=1e-2, atol=1e-2)
BF16_GRAD = 3e-2
FLASH = dict(rtol=2e-4, atol=2e-4)
B, S, NEW, S_TRAIN = 4, 16, 6, 32
ARCH = "qwen2_5_3b"
CPU_MESHES = ((1, 1), (2, 1), (4, 1))

STAND_INS = {
    "1x1": OrderedDict(data=1, model=1),
    "8x1": OrderedDict(data=8, model=1),
    "4x2": OrderedDict(data=4, model=2),
    "16x16": OrderedDict(data=16, model=16),
    "2x16x16": OrderedDict(pod=2, data=16, model=16),
}

# (partition changes, extra rules): the defaults, then each toggled
VARIANTS = {
    "default": ({}, None),
    "fsdp": (None, None),  # fsdp flipped
    "zero1": ({"fsdp": True, "zero_stage": 1}, None),
    "flash_decode": (None, None),  # flash_decode flipped
    "extra": ({}, {"heads": None, "embed": ("pod", "data"), "kv_seq": None}),
}


def _cpu_mesh(shape, axes=("data", "model")):
    return make_mesh(shape, axes, devices=["cpu"] * int(np.prod(shape)))


def _auto_mesh():
    """A one-device ('data', 'model') mesh with Auto axes: the reference's
    mesh paths run on it under jax 0.9 (they fail on ``jax.make_mesh``'s
    Explicit axes)."""
    return jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))


def _np(x) -> np.ndarray:
    if isinstance(x, Placed):
        x = x.gather()
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy() if x.is_floating_point() else x.numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if str(x.dtype) == "bfloat16" else x


def _rel(got, want) -> float:
    g, w = _np(got).astype(np.float64), _np(want).astype(np.float64)
    assert g.shape == w.shape
    return float(np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30))


def _with(bundle, compute_dtype=None, **part):
    if compute_dtype:
        bundle = dataclasses.replace(bundle, model=dataclasses.replace(
            bundle.model, compute_dtype=compute_dtype))
    if part:
        bundle = dataclasses.replace(bundle, partition=dataclasses.replace(
            bundle.partition, **part))
    return bundle


# --------------------------------------------------------------------------- #
# placements: every configuration at full width, specs only                   #
# --------------------------------------------------------------------------- #


def _ref_specs(tree):
    leaves = jax.tree_util.tree_leaves(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    return [tuple(s) for s in leaves]


def _port_specs(tree):
    return [tuple(s.spec) for s in tree_leaves(tree)]


def _variant(arch, name):
    changes, extra = VARIANTS[name]
    rb, pb = RCB.get_arch(arch), PCB.get_arch(arch)
    if name == "fsdp":
        changes = {"fsdp": not rb.partition.fsdp}
    elif name == "flash_decode":
        changes = {"flash_decode": not rb.partition.flash_decode}
    return _with(rb, **changes), _with(pb, **changes), extra


@pytest.mark.parametrize("mesh_name", sorted(STAND_INS))
@pytest.mark.parametrize("arch", RCB.arch_ids())
def test_placements_equal_reference(arch, mesh_name, monkeypatch):
    """Params, caches (B=128 x 32768 and B=1), AdamW and Adafactor state
    under the optimizer rules, and every step kind's inputs, leaf by leaf,
    under the default rules and each toggle."""
    monkeypatch.setattr(jax.sharding, "NamedSharding", lambda mesh, spec: spec)
    monkeypatch.setattr(RS, "NamedSharding", lambda mesh, spec: spec)
    mesh = types.SimpleNamespace(shape=STAND_INS[mesh_name])
    for name in VARIANTS:
        rb, pb, extra = _variant(arch, name)
        rm, pm = r_build(rb), p_build(pb, device="meta")
        assert PS.make_rules(pb.partition, extra) == RS.make_rules(rb.partition, extra)
        assert _port_specs(pm.param_shardings(mesh, extra)) == \
            _ref_specs(rm.param_shardings(mesh, extra)), name
        for b, s in ((128, 32768), (1, 32768)):
            assert _port_specs(pm.cache_shardings(mesh, b, s, extra)) == \
                _ref_specs(rm.cache_shardings(mesh, b, s, extra)), (name, b)
        for opt in ("adamw", "adafactor"):
            assert _port_specs(_opt_shardings(pm, popt.get_optimizer(opt), mesh, extra)) == \
                _ref_specs(r_opt_shardings(rm, ropt.get_optimizer(opt), mesh, extra)), \
                (name, opt)
        for kind in ("train_4k", "prefill_32k", "decode_32k"):
            got = pm.batch_shardings(mesh, pm.input_specs(PCB.SHAPES[kind]), extra)
            want = rm.batch_shardings(mesh, rm.input_specs(RCB.SHAPES[kind]), extra)
            assert _port_specs(got) == _ref_specs(want), (name, kind)
    for ndim in (1, 3):
        assert tuple(PS.batch_spec(mesh, ndim)) == tuple(RS.batch_spec(mesh, ndim))
    assert PS.batch_axes(mesh) == RS.batch_axes(mesh)


def test_resolve_axes_maybe_shard_semantics_equal_reference():
    """Axes missing from the mesh or used already drop, shorter prefixes
    are tried where the size does not divide, trailing Nones are trimmed;
    qwen2.5-3b's spot values on a (4, 2) mesh."""
    mesh = types.SimpleNamespace(shape=OrderedDict(pod=2, data=4, model=2))
    rules = {**RM.DEFAULT_RULES, "a": ("pod", "data"), "b": "model", "c": ("data", "missing")}
    for shape, axes in [((8, 4), ("a", "b")), ((6, 4), ("a", "b")), ((3, 3), ("a", "b")),
                        ((4, 4, 4), ("b", "b", None)), ((8, 2), ("c", "a")),
                        ((8, 8, 8), ("batch", None, "ff")), ((5,), ("zzz",))]:
        got = PM.resolve_axes(mesh, rules, shape, axes)
        assert isinstance(got, PartitionSpec)
        assert tuple(got) == tuple(RM.resolve_axes(mesh, rules, shape, axes)), (shape, axes)
    m42 = types.SimpleNamespace(shape=OrderedDict(data=4, model=2))
    pm = p_build(PCB.get_arch(ARCH), device="meta")
    p_sh = pm.param_shardings(m42)
    assert tuple(p_sh["blocks"]["p0"]["ffn"]["up"]["kernel"].spec) == (None, None, "model")
    assert tuple(p_sh["final_norm"]["scale"].spec) == ()
    kv = pm.cache_shardings(m42, 4, 64)["p0"]["k"]
    assert tuple(kv.spec) == (None, "data", "model")
    assert tuple(PS.batch_spec(m42, 3)) == ("data", None, None)
    assert PartitionSpec(("data",), None) == PartitionSpec("data", None)


def test_placement_places_blocks_and_gathers_exactly():
    """A replicated leaf is one tensor on cells that share a device (the
    caller's own tensor on its device); a split dimension's blocks are the
    tensor's slices; gather after place is the identity, exactly."""
    mesh = _cpu_mesh((2, 2))
    x = torch.arange(48, dtype=torch.float32).reshape(4, 6, 2)
    repl = NamedSharding(mesh, PartitionSpec()).place(x)
    assert all(b is repl.blocks.flat[0] for b in repl.blocks.flat)
    assert repl.blocks.flat[0].data_ptr() == x.data_ptr()
    assert len(repl.distinct()) == 1 and repl.block((1, 1)) is x
    for spec in (PartitionSpec("data"), PartitionSpec(None, "model"),
                 PartitionSpec("data", "model"), PartitionSpec(("data", "model"))):
        sh = NamedSharding(mesh, spec)
        placed = sh.place(x)
        assert torch.equal(placed.gather(), x)
        for cell in np.ndindex(2, 2):
            coords = sh.block_coords(cell)
            blk = sh.shard_shape(x.shape)
            want = x[tuple(slice(c * b, (c + 1) * b) for c, b in zip(coords, blk))]
            assert torch.equal(placed.block(cell), want)
            assert placed.block(cell).device == mesh.devices[cell]
    # cells with the same block on one device share it
    rows = NamedSharding(mesh, PartitionSpec("data")).place(x)
    assert rows.block((0, 0)) is rows.block((0, 1))
    assert rows.block((0, 0)) is not rows.block((1, 0))
    with pytest.raises(ValueError, match="does not divide"):
        NamedSharding(mesh, PartitionSpec(None, None, "data")).place(torch.zeros(2, 2, 3))
    with pytest.raises(ValueError, match="not in mesh"):
        NamedSharding(mesh, PartitionSpec("pod"))
    with pytest.raises(ValueError, match="twice"):
        NamedSharding(mesh, PartitionSpec("data", "data"))


def test_mesh_shard_devices_over_several_axes_and_sub_meshes():
    mesh = make_mesh((2, 3, 1), ("pod", "data", "model"), devices=["cpu"] * 6)
    assert len(mesh.shard_devices(("pod", "data"))) == 6
    assert mesh.shard_devices(()) == (mesh.devices.flat[0],)
    sub = mesh.sub({"pod": 1, "data": 2})
    assert dict(sub.shape) == {"pod": 1, "data": 1, "model": 1}
    assert sub.devices[0, 0, 0] == mesh.devices[1, 2, 0]
    shards = PS.data_shards(mesh, 12)
    assert [s.rows for s in shards] == [slice(2 * i, 2 * i + 2) for i in range(6)]
    assert shards[4].cell == (1, 1, 0)
    one = PS.data_shards(mesh, 5)  # does not divide: replicated, run once
    assert len(one) == 1 and one[0].rows == slice(0, 5) and one[0].mesh is mesh


# --------------------------------------------------------------------------- #
# collectives                                                                  #
# --------------------------------------------------------------------------- #


def test_all_reduce_and_psum_scalar():
    """Each shard's reduced tensor on its device; shards that share a
    device share one result; None holds no part; calls and bytes count."""
    mesh = _cpu_mesh((4,), ("data",))
    parts = [torch.full((3,), float(i)) for i in range(4)]
    collectives.calls.clear()
    collectives.nbytes.clear()
    out = collectives.all_reduce(mesh, "data", parts)
    assert len(out) == 4 and all(o is out[0] for o in out)
    assert torch.equal(out[0], torch.full((3,), 6.0))
    assert [p[0].item() for p in parts] == [0.0, 1.0, 2.0, 3.0]  # inputs untouched
    assert torch.equal(collectives.all_reduce(mesh, "data", parts, "max")[0],
                       torch.full((3,), 3.0))
    assert torch.equal(collectives.all_reduce(mesh, "data", [None, parts[1], None, parts[3]])[0],
                       torch.full((3,), 4.0))
    s = collectives.psum_scalar(mesh, "data", [torch.tensor(float(i)) for i in range(4)])
    assert s[0].item() == 6.0
    assert collectives.calls["all_reduce"] == 3 and collectives.calls["psum_scalar"] == 1
    assert collectives.nbytes["all_reduce"] == 3 * 12 and collectives.nbytes["psum_scalar"] == 4
    with pytest.raises(ValueError, match="got 2 tensors"):
        collectives.all_reduce(mesh, "data", parts[:2])


# --------------------------------------------------------------------------- #
# serving                                                                      #
# --------------------------------------------------------------------------- #


@functools.lru_cache(maxsize=None)
def _ref_params():
    return jax.jit(r_build(RCB.get_smoke_arch(ARCH)).init)(jax.random.PRNGKey(0))


@functools.lru_cache(maxsize=None)
def _served():
    """(reference model, params, port model, port params, prompts) of the
    float32 smoke qwen2.5."""
    rm = r_build(_with(RCB.get_smoke_arch(ARCH), "float32"))
    pm = p_build(_with(PCB.get_smoke_arch(ARCH), "float32"), device="cpu")
    params = _ref_params()
    pp = lm_params_from_arrays(jax.tree_util.tree_map(np.asarray, params), "cpu")
    prompts = np.random.default_rng(7).integers(1, rm.cfg.vocab, (B, S)).astype(np.int32)
    return rm, params, pm, pp, prompts


@functools.lru_cache(maxsize=None)
def _ref_served():
    """The reference: its engine's tokens off the mesh, then on the Auto
    mesh its prefill logits and its first decode step's logits (through its
    flash decode, the numerics of a decode on a mesh)."""
    rm, params, _, _, prompts = _served()
    out = RServeEngine(rm, params, max_len=S + NEW).generate(jnp.asarray(prompts), NEW)
    with _auto_mesh() as mesh:
        caches = rm.init_cache(B, S + NEW)
        logits, caches = jax.jit(functools.partial(rm.prefill, mesh=mesh))(
            params, {"tokens": jnp.asarray(prompts)}, caches)
        tok = jnp.argmax(logits, -1).astype(jnp.int32)[:, None]
        step, _ = jax.jit(functools.partial(rm.decode_step, mesh=mesh))(
            params, tok, jnp.full((B,), S, jnp.int32), caches)
    return np.asarray(out["tokens"]), np.asarray(out["done"]), np.asarray(logits), \
        np.asarray(step)


@pytest.mark.parametrize("shape", CPU_MESHES)
def test_engine_on_a_cpu_mesh_equals_reference_off_the_mesh(shape):
    """Greedy tokens equal the reference's off the mesh; each shard's
    prefill logits (float32) and first decode step's logits (through the
    flash decode, bf16 caches) match the rows of the reference's on a
    mesh (its decode on a mesh takes its flash decode too)."""
    _, _, pm, pp, prompts = _served()
    want_tok, want_done, want_logits, want_step = _ref_served()
    mesh = _cpu_mesh(shape)
    out = ServeEngine(pm, pp, max_len=S + NEW, mesh=mesh).generate(prompts, NEW)
    np.testing.assert_array_equal(out["tokens"].numpy(), want_tok)
    np.testing.assert_array_equal(out["done"].numpy(), want_done)
    for s in PS.data_shards(mesh, B):
        caches = pm.init_cache(B // shape[0], S + NEW)
        with torch.inference_mode():
            logits, _ = pm.prefill(pp, {"tokens": torch.from_numpy(prompts[s.rows])}, caches,
                                   mesh=s.mesh)
            np.testing.assert_allclose(logits.numpy(), want_logits[s.rows], **FP32)
            tok = torch.argmax(logits, -1).to(torch.int32)[:, None]
            pos = torch.full((tok.shape[0],), S, dtype=torch.int32)
            step, _ = pm.decode_step(pp, tok, pos, caches, mesh=s.mesh)
        np.testing.assert_allclose(step.numpy(), want_step[s.rows], **FP32_CACHED)


def test_engine_on_the_unit_mesh_equals_reference_on_an_auto_mesh():
    """At (1, 1) the reference's own engine on a mesh (flash decode,
    constraints) gives the port's tokens; sampling at a temperature gives
    the one-device engine's tokens on every mesh for one seed."""
    rm, params, pm, pp, prompts = _served()
    with _auto_mesh() as mesh:
        want = RServeEngine(rm, params, max_len=S + NEW, mesh=mesh).generate(
            jnp.asarray(prompts), NEW)
    got = ServeEngine(pm, pp, max_len=S + NEW, mesh=_cpu_mesh((1, 1))).generate(prompts, NEW)
    np.testing.assert_array_equal(got["tokens"].numpy(), np.asarray(want["tokens"]))
    hot = ServeEngine(pm, pp, max_len=S + NEW, temperature=1.0).generate(prompts, NEW, seed=5)
    for shape in ((2, 1), (4, 1)):
        on = ServeEngine(pm, pp, max_len=S + NEW, temperature=1.0,
                         mesh=_cpu_mesh(shape)).generate(prompts, NEW, seed=5)
        assert torch.equal(on["tokens"], hot["tokens"])


def test_engine_places_parameters_once_and_replicates_a_batch_that_does_not_divide():
    _, _, pm, pp, prompts = _served()
    engine = ServeEngine(pm, pp, max_len=S + NEW, mesh=_cpu_mesh((4, 1)))
    leaf = engine.params["embed"]["embedding"]
    assert isinstance(leaf, Placed) and len(leaf.distinct()) == 1
    assert leaf.blocks.flat[0] is pp["embed"]["embedding"]
    want = ServeEngine(pm, pp, max_len=S + NEW).generate(prompts[:3], NEW)
    got = engine.generate(prompts[:3], NEW)  # 3 rows over data=4: replicated, run once
    assert torch.equal(got["tokens"], want["tokens"])


@pytest.mark.parametrize("arch", RCB.arch_ids())
def test_every_smoke_configuration_serves_and_trains_on_a_data_mesh(arch):
    """Every smoke configuration on a (2, 1) mesh: the engine's greedy
    tokens equal its one-device tokens (the encoder-decoder family is
    refused by the engine, as off the mesh); a train step matches the
    one-device step (MoE families train on (1, 1): their aux losses couple
    the rows, so (2, 1) is refused)."""
    bundle = _with(PCB.get_smoke_arch(arch), "float32")
    pm = p_build(bundle, device="cpu")
    pp = pm.init(torch.Generator().manual_seed(1))
    cfg = pm.cfg
    mesh = _cpu_mesh((1, 1) if cfg.moe is not None else (2, 1))
    if cfg.family != "encdec":
        prompts = np.random.default_rng(3).integers(1, cfg.vocab, (2, 8))
        want = ServeEngine(pm, pp, max_len=12).generate(prompts, 4)
        got = ServeEngine(pm, pp, max_len=12, mesh=_cpu_mesh((2, 1))).generate(prompts, 4)
        assert torch.equal(got["tokens"], want["tokens"])
    opt = popt.get_optimizer(bundle.partition.optimizer)
    lr = popt.cosine_warmup(1e-3, 1, 4)
    batch = _batch(pm, 2, 16)
    one = make_train_step(pm, opt, lr, donate=False)(pp, opt.init(pp), batch, 1)
    dp = make_train_step(pm, opt, lr, mesh=mesh, donate=False)(pp, opt.init(pp), batch, 1)
    _step_close(dp, one, pp)


# --------------------------------------------------------------------------- #
# training                                                                     #
# --------------------------------------------------------------------------- #


def _batch(pm, b, s, valid=False):
    cfg = pm.cfg
    n_pre = cfg.n_prefix_tokens if cfg.modality == "vision" else 0
    data = SyntheticLM(cfg.vocab, s + n_pre, b, seed=2, n_prefix_tokens=n_pre,
                       frontend_dim=cfg.frontend_dim, family=cfg.family,
                       dec_ratio=cfg.dec_ratio, mean_doc_len=8, device="cpu")
    batch = data(0)
    if valid:  # rows of unequal valid counts: a wrong shard weighting shows
        counts = np.array([s, 3, s // 2, 1][:b])
        batch["valid"] = torch.from_numpy(np.arange(s)[None, :] < counts[:, None]).to(
            torch.float32)
    return batch


def _step_close(got, want, start, loss_rtol=2e-5):
    """The loss by rtol; the first moments, the square roots of the second
    moments (linear in the gradients, as the tolerance's gradients) and
    the parameters by relative L2 a leaf (a parameter that started at zero
    holds only its first update, ±lr where its gradient is near zero in
    either step: its moments are compared instead)."""
    (gp, go, gm), (wp, wo, wm) = got, want
    np.testing.assert_allclose(read_metrics(gm)["loss"], _loss(wm), rtol=loss_rtol)
    for key in go:  # AdamW's mu is linear in the gradients; nu, Adafactor's v quadratic
        root = (lambda x: np.sqrt(_np(x))) if key != "mu" else _np
        for g, w in zip(tree_leaves(go[key]), _leaves(wo[key])):
            assert _rel(root(g), root(w)) < BF16_GRAD, key
    for g, w, p0 in zip(tree_leaves(gp), _leaves(wp), tree_leaves(start)):
        if p0.any():
            assert _rel(g, w) < BF16_GRAD


def _loss(metrics):
    return read_metrics(metrics)["loss"] if isinstance(metrics["loss"], torch.Tensor) \
        else float(metrics["loss"])


def _leaves(tree):
    return tree_leaves(tree) if not isinstance(tree_leaves(tree)[0], jax.Array) \
        else jax.tree_util.tree_leaves(tree)


@pytest.mark.parametrize("shape,mb,valid", [((1, 1), 1, False), ((2, 1), 1, False),
                                            ((4, 1), 1, False), ((2, 1), 2, True),
                                            ((4, 1), 2, True)])
def test_train_step_on_a_cpu_mesh_equals_the_one_device_step(shape, mb, valid):
    """The data-parallel step (placed params and AdamW state, shard
    losses weighted by the global denominator, bf16 gradients reduced
    across shards) against the one-device step on the whole batch; with
    ``microbatches=2`` and a ``valid`` mask of unequal rows each shard's
    rows are weighted by their chunk's valid count."""
    pm = p_build(_with(PCB.get_smoke_arch(ARCH), microbatches=mb), device="cpu")
    pp = pm.init(torch.Generator().manual_seed(2))
    opt = popt.adamw()
    lr = popt.cosine_warmup(1e-3, 1, 4)
    batch = _batch(pm, B, S_TRAIN, valid)
    want = make_train_step(pm, opt, lr, donate=False)(pp, opt.init(pp), batch, 1)
    mesh = _cpu_mesh(shape)
    got = make_train_step(pm, opt, lr, mesh=mesh, donate=False)(pp, opt.init(pp), batch, 1)
    _step_close(got, want, pp)
    assert all(isinstance(x, Placed) for x in tree_leaves(got[:2]))
    # the replicas stay equal: one copy a distinct device, here the one CPU
    assert all(len(x.distinct()) == 1 for x in tree_leaves(got[:2]))
    if valid and shape == (4, 1):  # the weighting matters: the shards' mean loss is off
        naive = np.mean([float(pm.train_loss(pp, tree_map(lambda x: x[s.rows], batch))[0])
                         for s in PS.data_shards(mesh, B)])
        assert abs(naive - read_metrics(got[2])["loss"]) > 1e-3


def test_train_step_on_the_unit_mesh_matches_reference_on_an_auto_mesh():
    """The reference's own mesh step (its loss through ``_xent_sharded``)
    against the port's on (1, 1): loss, parameters, moments."""
    rm = r_build(RCB.get_smoke_arch(ARCH))
    params = _ref_params()
    pm = p_build(PCB.get_smoke_arch(ARCH), device="cpu")
    pp = lm_params_from_arrays(jax.tree_util.tree_map(np.asarray, params), "cpu")
    batch = _batch(pm, B, S_TRAIN)
    with _auto_mesh() as mesh:
        ropt_ = ropt.adamw()
        rstep = r_make_train_step(rm, ropt_, ropt.cosine_warmup(1e-3, 1, 4), mesh=mesh,
                                  donate=False)
        rp, ro, rmet = rstep(params, ropt_.init(params),
                             {k: jnp.asarray(v.numpy()) for k, v in batch.items()}, 1)
    opt = popt.adamw()
    gp, go, gm = make_train_step(pm, opt, popt.cosine_warmup(1e-3, 1, 4), mesh=_cpu_mesh((1, 1)),
                                 donate=False)(pp, opt.init(pp), batch, 1)
    _step_close((gp, go, gm), (rp, ro, rmet), pp, loss_rtol=BF16_GRAD)


def test_reshard_restored_round_trips_across_meshes(tmp_path):
    """A checkpoint written off the mesh, restored onto (2, 1), written
    there (one replica a leaf), restored onto (4, 1), written again and
    restored off the mesh: every leaf equal to the start, exactly."""
    pm = p_build(PCB.get_smoke_arch(ARCH), device="cpu")
    opt = popt.adamw()
    pp = pm.init(torch.Generator().manual_seed(3))
    po = tree_map(lambda t: t + 0.5, opt.init(pp))
    pckpt.save_pytree(str(tmp_path / "a"), (pp, po), 7)
    like = (pp, po)
    for i, shape in enumerate(((2, 1), (4, 1))):
        mesh = _cpu_mesh(shape)
        like = (PS.place_tree(pp, pm.param_shardings(mesh)),
                PS.place_tree(po, _opt_shardings(pm, opt, mesh)))
        params, opt_state, step = pckpt.reshard_restored(str(tmp_path / "ab"[i]), *like)
        assert step == 7 and all(isinstance(x, Placed) for x in tree_leaves(params))
        assert all(x.sharding.mesh == mesh for x in tree_leaves(opt_state))
        pckpt.save_pytree(str(tmp_path / "bc"[i]), (params, opt_state), 7)
    params, opt_state, _ = pckpt.reshard_restored(str(tmp_path / "c"), pp, po)
    for g, w in zip(tree_leaves((params, opt_state)), tree_leaves((pp, po))):
        assert torch.equal(g, w)


def test_train_runs_on_a_mesh_and_the_launcher_takes_mesh_host(tmp_path, capsys):
    """``train(mesh=)`` with a checkpoint: the same losses as off the mesh;
    ``launch/train.py --mesh host --smoke --device cpu`` runs."""
    from repro_torch.data import make_data_iter
    from repro_torch.launch.train import main

    pm = p_build(PCB.get_smoke_arch(ARCH), device="cpu")
    shape = dataclasses.replace(PCB.SHAPES["train_4k"], seq_len=S_TRAIN, global_batch=B)
    kw = dict(steps=3, lr=1e-3, warmup=1, seed=4)
    off = train(pm, make_data_iter(pm, shape), **kw)
    on = train(pm, make_data_iter(pm, shape), mesh=_cpu_mesh((2, 1)),
               checkpoint_dir=str(tmp_path / "ck"), checkpoint_every=2, log_every=1, **kw)
    np.testing.assert_allclose([h["loss"] for h in on["history"]][:1],
                               [h["loss"] for h in off["history"]][:1], rtol=2e-5)
    assert on["final_step"] == 3 and isinstance(tree_leaves(on["params"])[0], Placed)
    main(["--arch", ARCH, "--smoke", "--device", "cpu", "--mesh", "host", "--steps", "2",
          "--seq-len", "16", "--warmup", "1"])


# --------------------------------------------------------------------------- #
# flash_decode_sharded                                                         #
# --------------------------------------------------------------------------- #


def _decode_inputs():
    rng = np.random.default_rng(11)
    Bq, H, KV, D, Sc = 4, 8, 2, 16, 64
    q = rng.standard_normal((Bq, H, D)).astype(np.float32)
    k = rng.standard_normal((Bq, Sc, KV, D)).astype(np.float32)
    v = rng.standard_normal((Bq, Sc, KV, D)).astype(np.float32)
    lo = np.array([0, 0, 5, 0], np.int32)
    hi = np.array([Sc - 3, 17, 40, 1], np.int32)  # partially filled caches
    return q, k, v, lo, hi


@pytest.mark.parametrize("shape", [(1, 1), (1, 2), (1, 4), (2, 2), (4, 1)])
def test_flash_decode_sharded_matches_reference_masked_decode(shape):
    q, k, v, lo, hi = _decode_inputs()
    want = np.asarray(r_masked_decode(*map(jnp.asarray, (q, k, v, lo, hi)), 0.0))
    got = PA.flash_decode_sharded(*map(torch.from_numpy, (q, k, v, lo, hi)), 0.0,
                                  _cpu_mesh(shape), ("pod", "data"))
    np.testing.assert_allclose(got.numpy(), want, **FLASH)
    with _auto_mesh() as mesh:
        ref = np.asarray(r_flash_decode(*map(jnp.asarray, (q, k, v, lo, hi)), 0.0, mesh,
                                        ("data",)))
    if shape == (1, 1):
        np.testing.assert_allclose(got.numpy(), ref, **FLASH)


def test_decode_on_a_model_mesh_takes_the_flash_decode(monkeypatch):
    """``self_attention_decode(mesh=)`` routes to ``flash_decode_sharded``
    when the partition asks for it and the mesh has a ``model`` axis."""
    seen = []
    real = PA.flash_decode_sharded
    monkeypatch.setattr(PA, "flash_decode_sharded",
                        lambda *a: seen.append(a[6]) or real(*a))
    _, _, pm, pp, prompts = _served()
    mesh = _cpu_mesh((1, 1))
    caches = pm.init_cache(B, S + 1)
    with torch.inference_mode():
        pm.prefill(pp, {"tokens": torch.from_numpy(prompts)}, caches, mesh=mesh)
        pm.decode_step(pp, torch.from_numpy(prompts[:, :1]), torch.full((B,), S, dtype=torch.int32),
                       caches, mesh=mesh)
    assert seen == [mesh] * pm.cfg.n_layers


# --------------------------------------------------------------------------- #
# declared refusals (item 9b.3), raised before anything is allocated           #
# --------------------------------------------------------------------------- #


def _tp():
    return _cpu_mesh((1, 2))


def _smoke(arch):
    return p_build(PCB.get_smoke_arch(arch), device="cpu")


REFUSALS = {
    # tensor-parallel serving runs attention, MLP and MoE
    # (tests/test_torch_lm_tp.py); MLA, Mamba, xLSTM and the
    # encoder-decoder family over model wait for item 9b.3d
    "engine_mla_over_model": lambda pm: ServeEngine(_smoke("deepseek_v2_lite_16b"), None,
                                                    max_len=8, mesh=_tp()),
    "engine_mamba_over_model": lambda pm: ServeEngine(_smoke("jamba_v0_1_52b"), None,
                                                      max_len=8, mesh=_tp()),
    "step_tensor_parallel": lambda pm: make_train_step(pm, popt.adamw(), lambda s: 0.0,
                                                       mesh=_tp()),
    "step_fsdp": lambda pm: make_train_step(
        p_build(_with(PCB.get_smoke_arch(ARCH), fsdp=True), device="cpu"), popt.adamw(),
        lambda s: 0.0, mesh=_cpu_mesh((2, 1))),
    "step_zero1": lambda pm: make_train_step(
        p_build(_with(PCB.get_smoke_arch(ARCH), fsdp=True, zero_stage=1), device="cpu"),
        popt.adamw(), lambda s: 0.0, mesh=_cpu_mesh((2, 1))),
    "step_moe_data_parallel": lambda pm: make_train_step(
        p_build(PCB.get_smoke_arch("qwen3_moe_30b_a3b"), device="cpu"), popt.adamw(),
        lambda s: 0.0, mesh=_cpu_mesh((2, 1))),
    "xent_sharded": lambda pm: PT.softmax_xent(torch.zeros(1, 1, 4),
                                               torch.zeros(1, 1, dtype=torch.int32), mesh=_tp()),
    "engine_xlstm_over_model": lambda pm: ServeEngine(_smoke("xlstm_350m"), None, max_len=8,
                                                      mesh=_tp()),
    "prefill_encdec_over_model": lambda pm: _smoke("seamless_m4t_large_v2").prefill(
        None, {}, None, mesh=_tp()),
    "constrain_seq_shard": lambda pm: PM.constrain(torch.zeros(2, 4, 8), _tp(), None,
                                                   ("batch", "seq_shard", None)),
    "train_tensor_parallel": lambda pm: train(pm, None, steps=1, mesh=_tp()),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_declared_refusals_name_item_9b3(case):
    pm = p_build(PCB.get_smoke_arch(ARCH), device="cpu")
    with pytest.raises(NotImplementedError, match=r"item 9b\.3"):
        REFUSALS[case](pm)


def test_fsdp_on_a_data_mesh_runs_with_embed_unsharded():
    """An fsdp configuration on data > 1 runs with ``rules={"embed": None}``."""
    pm = p_build(_with(PCB.get_smoke_arch(ARCH), fsdp=True), device="cpu")
    pp = pm.init(torch.Generator().manual_seed(5))
    opt, lr = popt.adamw(), popt.cosine_warmup(1e-3, 1, 4)
    batch = _batch(pm, B, S_TRAIN)
    want = make_train_step(pm, opt, lr, donate=False)(pp, opt.init(pp), batch, 1)
    got = make_train_step(pm, opt, lr, mesh=_cpu_mesh((2, 1)), rules={"embed": None},
                          donate=False)(pp, opt.init(pp), batch, 1)
    _step_close(got, want, pp)


def test_meshes_of_another_kind_are_refused():
    pm = p_build(PCB.get_smoke_arch(ARCH), device="cpu")
    with pytest.raises(TypeError, match="parallel.Mesh"):
        ServeEngine(pm, None, max_len=8, mesh=object())
    with pytest.raises(ValueError, match=r"Number of devices \d+"):
        make_production_mesh()
    from repro_torch.launch.train import main

    with pytest.raises(ValueError, match=r"Number of devices \d+"):
        main(["--arch", ARCH, "--smoke", "--device", "cpu", "--mesh", "single"])
    with pytest.raises(NotImplementedError, match=r"item 9b\.3"):
        main(["--arch", ARCH, "--smoke", "--device", "cpu", "--distributed"])
