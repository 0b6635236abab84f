"""Tensor-parallel serving held against the reference: ``ServeEngine(mesh=)``
and ``Model.prefill``/``decode_step(mesh=)`` with heads, KV heads, ff, vocab
and experts split over a ``model`` axis above 1, on CPU meshes whose cells
repeat ``cpu`` — (1, 2), (1, 4) and (2, 2) — for the smoke qwen2.5-3b
(tied embeddings, QKV biases, 4 heads over 2 KV heads), gemma3-12b (sliding
window rings, sandwich norms, qk-norm, embed scale) and qwen3-moe-30b-a3b
(8 experts, top 2).

The oracle is the reference off the mesh (its GSPMD result on a mesh is
mathematically the same): its greedy engine, its prefill logits and its
first decode step's logits, on the same numpy prompts and the converted
parameters.  Caches hold 22 positions, so at ``model`` = 2 the cache is
split on its sequence (the flash decode's partials, LSE-merged) and at 4
it is whole (22 does not divide, and 2 KV heads do not either); 23
positions at 2 split the KV heads.  At (1, 4) the query heads split and
the KV heads stay whole: query head h reads KV head h // 2.

Stated tolerances (the repo's): ``FP32`` (rtol 1e-5) for float32 prefill
logits, ``FP32_CACHED`` (1e-2) for decode logits read through bf16
caches, ``BF16`` (rtol 5e-2, atol 1e-1) for bf16 compute; greedy float32
tokens equal, or at a near-tie the mesh's token is a maximum of the
reference's logits within ``FP32_CACHED``; collective counts, placements
and two calls of one engine exact.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs.base as RCB
from repro.models.model_zoo import build as r_build
from repro.serve import ServeEngine as RServeEngine
import repro_torch.configs.base as PCB
import repro_torch.models.common as PM
import repro_torch.models.transformer as PT
from repro_torch.convert import lm_params_from_arrays
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import build as p_build
from repro_torch.parallel import collectives, sharding
from repro_torch.parallel.placement import Placed
from repro_torch.serve import ServeEngine
from repro_torch.train import optimizer as popt
from repro_torch.train.train_loop import make_train_step
from repro_torch.train.tree import tree_leaves

torch.set_num_threads(1)

FP32 = dict(rtol=1e-5, atol=1e-5)
FP32_CACHED = dict(rtol=1e-2, atol=1e-2)
BF16 = dict(rtol=5e-2, atol=1e-1)
B, S, NEW = 4, 16, 6
ML = S + NEW  # 22: divides over model=2, not over 4
ARCHS = ("qwen2_5_3b", "gemma3_12b", "qwen3_moe_30b_a3b")
MESHES = ((1, 2), (1, 4), (2, 2))


def _mesh(shape):
    return make_mesh(shape, ("data", "model"), devices=["cpu"] * int(np.prod(shape)))


def _with(bundle, compute_dtype):
    return dataclasses.replace(bundle, model=dataclasses.replace(bundle.model,
                                                                 compute_dtype=compute_dtype))


@functools.lru_cache(maxsize=None)
def _pair(arch, compute_dtype="float32"):
    """(reference model, its params, port model, port params, prompts)."""
    rm = r_build(_with(RCB.get_smoke_arch(arch), compute_dtype))
    params = jax.jit(rm.init)(jax.random.PRNGKey(0))
    pm = p_build(_with(PCB.get_smoke_arch(arch), compute_dtype), device="cpu")
    pp = lm_params_from_arrays(jax.tree_util.tree_map(np.asarray, params), "cpu")
    prompts = np.random.default_rng(7).integers(1, rm.cfg.vocab, (B, S)).astype(np.int32)
    return rm, params, pm, pp, prompts


@functools.lru_cache(maxsize=None)
def _ref(arch, compute_dtype="float32", max_len=ML):
    """The reference off the mesh: engine tokens, prefill logits, and the
    first decode step's logits (the prefill's greedy tokens fed back)."""
    rm, params, _, _, prompts = _pair(arch, compute_dtype)
    engine = RServeEngine(rm, params, max_len=max_len)
    out = engine.generate(jnp.asarray(prompts), NEW)
    # its jitted prefill and decode step (compiled by the generate)
    logits, caches = engine._prefill(params, {"tokens": jnp.asarray(prompts)},
                                     rm.init_cache(B, max_len))
    tok = jnp.argmax(logits, -1).astype(jnp.int32)[:, None]
    step, _ = engine._decode(params, tok, jnp.full((B,), S, jnp.int32), caches)
    return np.asarray(out["tokens"]), np.asarray(logits), np.asarray(step)


REF_ON_MESH = """
import dataclasses, functools, sys
import jax, jax.numpy as jnp, numpy as np
import repro.configs.base as RCB
from repro.models.model_zoo import build
B, S, ML = {B}, {S}, {ML}
out = {{}}
mesh = jax.sharding.Mesh(np.array(jax.devices()[:2]).reshape(1, 2), ("data", "model"))
for arch in {archs!r}:
    b = RCB.get_smoke_arch(arch)
    rm = build(dataclasses.replace(b, model=dataclasses.replace(b.model, compute_dtype="float32")))
    params = jax.jit(rm.init)(jax.random.PRNGKey(0))
    prompts = np.random.default_rng(7).integers(1, rm.cfg.vocab, (B, S)).astype(np.int32)
    with mesh:
        caches = rm.init_cache(B, ML)
        logits, caches = jax.jit(functools.partial(rm.prefill, mesh=mesh))(
            params, {{"tokens": jnp.asarray(prompts)}}, caches)
        tok = jnp.argmax(logits, -1).astype(jnp.int32)[:, None]
        step, _ = jax.jit(functools.partial(rm.decode_step, mesh=mesh))(
            params, tok, jnp.full((B,), S, jnp.int32), caches)
    out[arch] = np.asarray(step)
np.savez(sys.argv[1], **out)
"""


@functools.lru_cache(maxsize=None)
def _ref_on_mesh():
    """The reference's own decode step on a (1, 2) Auto mesh of two forced
    host devices (a process of its own): its flash decode over two
    sequence shards, the numerics of a cache split on sequence (unnormalized
    probabilities rounded to the bf16 caches' dtype, then merged), which
    sit up to ~2e-2 from its masked decode off the mesh at these sizes."""
    import os
    import subprocess
    import sys
    import tempfile
    from pathlib import Path

    src = Path(__file__).resolve().parents[1] / "src"
    env = {**os.environ, "PYTHONPATH": str(src), "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=2"}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "ref.npz")
        code = REF_ON_MESH.format(B=B, S=S, ML=ML, archs=ARCHS)
        proc = subprocess.run([sys.executable, "-c", code, path], env=env, capture_output=True,
                              text=True, timeout=300)
        assert proc.returncode == 0, proc.stderr[-2000:]
        with np.load(path) as z:
            return {k: z[k] for k in z.files}


def _np(x):
    return x.detach().float().numpy()


def _steps(pm, pp, prompts, mesh, max_len=ML, rules=None):
    """The port's prefill logits and first decode step's logits on
    ``mesh`` (placed parameters, placed caches)."""
    caches = pm.init_cache(B, max_len, mesh=mesh, rules=rules)
    placed = sharding.place_tree(pp, pm.param_shardings(mesh, rules))
    with torch.inference_mode():
        logits, _ = pm.prefill(placed, {"tokens": torch.from_numpy(prompts)}, caches, mesh=mesh,
                               rules=rules)
        tok = torch.argmax(logits, -1).to(torch.int32)[:, None]
        step, _ = pm.decode_step(placed, tok, torch.full((B,), S, dtype=torch.int32), caches,
                                 mesh=mesh, rules=rules)
    return logits, step, caches


def _tokens_match(pm, pp, prompts, got, want):
    """Greedy tokens equal, or at each row's first difference the mesh's
    token is a maximum of the one-device logits within FP32_CACHED."""
    for r in range(B):
        diff = np.nonzero(got[r] != want[r])[0]
        if not len(diff):
            continue
        t = int(diff[0])
        seq = torch.from_numpy(np.concatenate([prompts[r], want[r, :t]]).astype(np.int64))[None]
        with torch.inference_mode():
            logits, _ = pm.prefill(pp, {"tokens": seq}, pm.init_cache(1, seq.shape[1]))
        top = float(logits.max())
        assert top - float(logits[0, int(got[r, t])]) <= \
            FP32_CACHED["atol"] + FP32_CACHED["rtol"] * abs(top), (r, t)


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_tensor_parallel_serving_matches_reference_off_the_mesh(arch, shape):
    """Engine tokens, prefill logits (float32) and the first decode step's
    logits (bf16 caches) on the mesh against the reference off it."""
    _, _, pm, pp, prompts = _pair(arch)
    want_tok, want_logits, want_step = _ref(arch)
    mesh = _mesh(shape)
    out = ServeEngine(pm, pp, max_len=ML, mesh=mesh).generate(prompts, NEW)
    _tokens_match(pm, pp, prompts, out["tokens"].numpy(), want_tok)
    logits, step, caches = _steps(pm, pp, prompts, mesh)
    np.testing.assert_allclose(_np(logits), want_logits, **FP32)
    if PT._cache_split(caches["p0"] if arch != "gemma3_12b" else caches["p5"]) == "seq":
        want_step = _ref_on_mesh()[arch]  # the flash decode: the reference on a mesh
    np.testing.assert_allclose(_np(step), want_step, **FP32_CACHED)
    assert all(isinstance(c, Placed) for c in tree_leaves(caches))


def test_bf16_compute_on_a_mesh_matches_reference():
    """bf16 compute (the served dtype) at (1, 2): bf16 partial products of
    ``wo`` and ``down`` summed across the shards, held to the bf16
    tolerance."""
    _, _, pm, pp, prompts = _pair("qwen2_5_3b", "bfloat16")
    _, want_logits, want_step = _ref("qwen2_5_3b", "bfloat16")
    logits, step, _ = _steps(pm, pp, prompts, _mesh((1, 2)))
    np.testing.assert_allclose(_np(logits), want_logits, **BF16)
    np.testing.assert_allclose(_np(step), want_step, **BF16)


CACHES = {  # (mesh, cache positions, rules): the cache's placement
    "seq": ((1, 2), ML, None),
    "kv": ((1, 2), ML + 1, None),
    "whole": ((1, 4), ML + 1, None),
    # the parameters whole (their model rules dropped), the cache split on
    # its sequence by the flash decode's kv_seq rule
    "seq_params_whole": ((1, 2), ML, {k: None for k, v in PM.DEFAULT_RULES.items()
                                      if v == "model"}),
}


@pytest.mark.parametrize("case", sorted(CACHES))
def test_each_cache_placement_is_served(case):
    """The KV cache follows ``cache_shardings``: split on sequence, on KV
    heads, or whole; each is served, and its decode logits match the
    reference's for the same cache length: off the mesh, or on a (1, 2)
    mesh where the cache is split on sequence (its flash decode)."""
    shape, max_len, rules = CACHES[case]
    _, _, pm, pp, prompts = _pair("qwen2_5_3b")
    _, want_logits, want_step = _ref("qwen2_5_3b", max_len=max_len)
    mesh = _mesh(shape)
    k = pm.cache_shardings(mesh, B, max_len, rules)["p0"]["k"]
    split = PT._cache_split({"k": Placed(k, None, (), None)})
    assert split == {"seq_params_whole": "seq", "whole": None}.get(case, case)
    logits, step, caches = _steps(pm, pp, prompts, mesh, max_len, rules)
    blk = caches["p0"]["k"].block((0, 1)).shape
    assert blk == k.shard_shape(caches["p0"]["k"].shape)
    np.testing.assert_allclose(_np(logits), want_logits, **FP32)
    if split == "seq":
        want_step = _ref_on_mesh()["qwen2_5_3b"]
    np.testing.assert_allclose(_np(step), want_step, **FP32_CACHED)


def test_kv_heads_that_do_not_divide_stay_whole():
    """qwen2.5's 2 KV heads at model=4: ``wq``/``wo`` split (1 head a
    shard), ``wk``/``wv`` whole, their biases likewise; ``wo`` is summed
    across the shards and nothing whole is (a sum would count it 4 times:
    the logits above would be off)."""
    _, _, pm, _, _ = _pair("qwen2_5_3b")
    sh = pm.param_shardings(_mesh((1, 4)))["blocks"]["p0"]["mixer"]
    assert sh["wq"]["kernel"].pieces(2) == 4 and sh["wq"]["bias"].pieces(1) == 4
    assert sh["wk"]["kernel"].is_replicated and sh["wv"]["bias"].is_replicated
    assert sh["wo"]["kernel"].pieces(1) == 4


def _count_decode(pm, pp, prompts, mesh, max_len=ML):
    caches = pm.init_cache(B, max_len, mesh=mesh)
    placed = sharding.place_tree(pp, pm.param_shardings(mesh))
    with torch.inference_mode():
        logits, _ = pm.prefill(placed, {"tokens": torch.from_numpy(prompts)}, caches, mesh=mesh)
        tok = torch.argmax(logits, -1).to(torch.int32)[:, None]
        collectives.calls.clear()
        pm.decode_step(placed, tok, torch.full((B,), S, dtype=torch.int32), caches, mesh=mesh)
    got = dict(collectives.calls)
    dp = sharding.data_parallel_size(mesh)
    got["gather"] -= dp > 1  # decode_step's gather of the rows across data shards
    return {k: v for k, v in got.items() if v}


# (arch, mesh, cache positions) -> the collective calls of one decode step,
# by hand from the placements: a broadcast of tokens and positions a data
# shard; the vocab-split lookup's all_reduce and the logits' gather; per
# layer (2 in each model) wo's and down's all_reduce, and with a cache split
# on sequence the gather of q (and k, v) and of the partials; MoE: the
# router's columns and the experts' outputs gathered, no MLP
DECODE_CALLS = {
    ("qwen2_5_3b", (1, 2), ML): dict(broadcast=1, all_reduce=1 + 2 * 2, all_gather=2 * 2,
                                     gather=1),
    ("qwen2_5_3b", (1, 4), ML): dict(broadcast=1, all_reduce=1 + 2 * 2, gather=1),
    ("qwen2_5_3b", (2, 2), ML): dict(broadcast=2, all_reduce=2 * 5, all_gather=2 * 4,
                                     gather=2),
    ("qwen2_5_3b", (1, 2), ML + 1): dict(broadcast=1, all_reduce=5, gather=1),
    ("qwen3_moe_30b_a3b", (1, 2), ML): dict(broadcast=1, all_reduce=1 + 2, all_gather=2 * 4,
                                            gather=1),
    # gemma3: 5 ring layers and 1 global layer (its cache split on
    # sequence) in its one group
    ("gemma3_12b", (1, 2), ML): dict(broadcast=1, all_reduce=1 + 6 * 2, all_gather=2, gather=1),
}


@pytest.mark.parametrize("case", sorted(DECODE_CALLS, key=str))
def test_collective_calls_a_decode_step_equal_the_formula(case):
    arch, shape, max_len = case
    _, _, pm, pp, prompts = _pair(arch)
    mesh = _mesh(shape)
    want = DECODE_CALLS[case]
    formula = {k: v for k, v in pm.decode_collective_calls(mesh, B, max_len).items() if v}
    assert formula == want
    assert _count_decode(pm, pp, prompts, mesh, max_len) == want


def test_two_calls_are_bit_equal_and_sampling_follows_the_seed():
    """Two ``generate`` calls of one MoE engine give the same bits; at a
    temperature the mesh's tokens are the one-device engine's for a seed."""
    _, _, pm, pp, prompts = _pair("qwen3_moe_30b_a3b")
    engine = ServeEngine(pm, pp, max_len=ML, mesh=_mesh((2, 2)))
    a, b = engine.generate(prompts, NEW), engine.generate(prompts, NEW)
    assert torch.equal(a["tokens"], b["tokens"]) and torch.equal(a["done"], b["done"])
    hot = ServeEngine(pm, pp, max_len=ML, temperature=1.0).generate(prompts, NEW, seed=5)
    on = ServeEngine(pm, pp, max_len=ML, temperature=1.0, mesh=_mesh((1, 4))).generate(
        prompts, NEW, seed=5)
    assert torch.equal(on["tokens"], hot["tokens"])


def test_placement_holds_no_second_copy():
    """``place_tree(consume=True)`` replaces each whole leaf in the caller's
    dicts by its blocks as it goes; ``init_on_mesh`` draws each block on
    its device (a replicated leaf's copies equal); ``init_cache(mesh=)``
    makes blocks only; the engine takes a placed tree as it is."""
    _, _, pm, pp, prompts = _pair("qwen3_moe_30b_a3b")
    mesh = _mesh((1, 2))
    tree = {k: dict(v) if isinstance(v, dict) else v for k, v in pp.items()}
    tree["blocks"] = {k: {kk: vv for kk, vv in v.items()} for k, v in pp["blocks"].items()}
    leaf = pp["blocks"]["p0"]["ffn"]["gate"]["kernel"]
    placed = sharding.place_tree(tree, pm.param_shardings(mesh), consume=True)
    assert placed is tree and all(isinstance(x, Placed) for x in tree_leaves(tree))
    assert torch.equal(placed["blocks"]["p0"]["ffn"]["gate"]["kernel"].gather(), leaf)
    drawn = pm.init_on_mesh(mesh, seed=3)
    gate = drawn["blocks"]["p0"]["ffn"]["gate"]["kernel"]
    assert gate.block((0, 0)).shape[1] == pm.cfg.moe.n_experts // 2
    norm = drawn["final_norm"]["scale"]
    assert norm.block((0, 0)) is norm.block((0, 1))
    engine = ServeEngine(pm, drawn, max_len=ML, mesh=mesh)
    assert engine.params["blocks"]["p0"]["ffn"]["gate"]["kernel"] is gate
    out = engine.generate(prompts, 3)["tokens"]
    assert out.shape == (B, 3) and int(out.max()) < pm.cfg.vocab


def _smoke(arch, **part):
    bundle = PCB.get_smoke_arch(arch)
    if part:
        bundle = dataclasses.replace(bundle, partition=dataclasses.replace(bundle.partition,
                                                                           **part))
    return p_build(bundle, device="cpu")


def _tp():
    return _mesh((1, 2))


REFUSALS = {  # case -> (call, sub-item of 9b.3); nothing is allocated first
    "engine_mla": (lambda: ServeEngine(_smoke("deepseek_v2_lite_16b"), None, max_len=8,
                                       mesh=_tp()), "9b.3d"),
    "engine_mamba": (lambda: ServeEngine(_smoke("jamba_v0_1_52b"), None, max_len=8,
                                         mesh=_tp()), "9b.3d"),
    "engine_xlstm": (lambda: ServeEngine(_smoke("xlstm_350m"), None, max_len=8, mesh=_tp()),
                     "9b.3d"),
    "prefill_encdec": (lambda: _smoke("seamless_m4t_large_v2").prefill(None, {}, None,
                                                                        mesh=_tp()), "9b.3d"),
    "decode_mla": (lambda: _smoke("deepseek_v2_lite_16b").decode_step(
        None, None, None, None, mesh=_tp()), "9b.3d"),
    "train_tensor_parallel": (lambda: make_train_step(_smoke("qwen2_5_3b"), popt.adamw(),
                                                      lambda s: 0.0, mesh=_tp()), "9b.3b"),
    "train_loss_tensor_parallel": (lambda: _smoke("qwen2_5_3b").train_loss(None, {}, mesh=_tp()),
                                   "9b.3b"),
    "xent_sharded": (lambda: PT.softmax_xent(torch.zeros(1, 1, 4),
                                             torch.zeros(1, 1, dtype=torch.int32), mesh=_tp()),
                     "9b.3b"),
    "seq_shard_activations": (lambda: ServeEngine(
        _smoke("qwen2_5_3b", seq_shard_activations=True), None, max_len=8, mesh=_tp()),
        "9b.3b"),
    "train_fsdp": (lambda: make_train_step(_smoke("qwen2_5_3b", fsdp=True), popt.adamw(),
                                           lambda s: 0.0, mesh=_mesh((2, 1))), "9b.3c"),
    "serve_fsdp": (lambda: ServeEngine(_smoke("qwen2_5_3b", fsdp=True), None, max_len=8,
                                       mesh=_mesh((2, 2))), "9b.3c"),
    "moe_data_parallel_step": (lambda: make_train_step(
        _smoke("qwen3_moe_30b_a3b"), popt.adamw(), lambda s: 0.0, mesh=_mesh((2, 1))), "9b.3e"),
    "distributed": (lambda: _train_main("--distributed"), "9b.3f"),
}


def _train_main(*flags):
    from repro_torch.launch.train import main

    return main(["--arch", "qwen2_5_3b", "--smoke", "--device", "cpu", *flags])


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_refusals_name_their_sub_item(case):
    call, item = REFUSALS[case]
    with pytest.raises(NotImplementedError, match=rf"item {item.replace('.', '[.]')}\b"):
        call()


def test_tensor_parallel_prefill_takes_placed_caches():
    """Over ``model`` the caches must be ``init_cache(mesh=)``'s placed
    blocks: whole caches would not be written where the decode reads."""
    _, _, pm, pp, prompts = _pair("qwen2_5_3b")
    with pytest.raises(TypeError, match=r"init_cache\(B, S, mesh=mesh\)"):
        pm.prefill(pp, {"tokens": torch.from_numpy(prompts)}, pm.init_cache(B, ML), mesh=_tp())
