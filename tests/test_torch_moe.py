"""The port's MoE ffn, MLA mixer, abstract-parameter helpers and the paper's
cycle model, held against the reference on identical inputs.

* ``route`` (top-k, ties to the lower expert index) and the per-row
  dispatch plan (slots, source tokens) exactly; ``moe_apply``'s output and
  both aux losses in float32 (``FP32``, rtol 1e-5), with ample capacity,
  with capacity overflow (every token routed to experts 0 and 1: the
  dropped tokens' output is exactly zero), with a zero router (every token
  ties: experts 0..k-1), with shared experts, and at S = 1; a mesh raises
  naming item 9b.
* ``mla_attention`` (the expanded prefill) and ``mla_attention_decode``
  (the absorbed form) and the two cache tensors they write, in float32
  compute (the caches are bf16: ``ONE_BF16_ULP``; decode outputs read them,
  ``FP32_CACHED``).
* ``abstract_params``/``abstract_cache`` against the reference's
  ``ShapeDtypeStruct`` trees, leaf by leaf, for every configuration
  ``build`` accepts, at full width (``meta`` tensors: nothing allocated).
* ``tools/paper_model.py``'s Tables III-V, Fig. 3's cycle rows and Fig. 4's
  processor rows equal ``benchmarks/paper_model`` and the published numbers.
* One train step (AdamW, remat "full") of each new family in float32
  compute against the reference's: the loss, with its aux terms, by
  ``FP32_GRAD``; the updated weights by ``STEP`` (below).

The families' prefill, decode, greedy tokens, loss and gradients are held
by the ``SERVED`` parametrization of ``test_torch_models.py`` and
``test_torch_train.py``.  Every input is made with numpy; weights are the
reference's ``init`` carried over by ``lm_params_from_arrays``.
"""
import dataclasses
import functools
import importlib.util
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs.base as RCB
import repro.models.common as RM
import repro.models.mla as RMLA
import repro.models.moe as RMOE
from repro.models.model_zoo import build as r_build
from repro.train import optimizer as ropt
from repro.train.train_loop import make_train_step as r_make_train_step
import repro_torch.configs.base as PCB
import repro_torch.models.common as PM
import repro_torch.models.mla as PMLA
import repro_torch.models.moe as PMOE
from repro_torch.convert import lm_params_from_arrays
from repro_torch.models import build as p_build
from repro_torch.train import optimizer as popt
from repro_torch.train.train_loop import make_train_step, read_metrics
from repro_torch.train.tree import tree_leaves
from test_torch_models import FP32, FP32_CACHED, ONE_BF16_ULP, _close, _np
from test_torch_train import FP32_GRAD, _np_batch, _port_batch, _ref_batch, _rel

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
NEW_FAMILIES = ("qwen3_moe_30b_a3b", "deepseek_v2_lite_16b")
#: one AdamW step from the same weights on the same batch, float32 compute,
#: relative L2 error of each updated weight leaf.  The step differentiates a
#: bf16 copy (bf16 gradients in both packages), and AdamW's first update is
#: lr * g / (|g| + eps) an element: where a gradient element is within a bf16
#: ulp of zero its sign (and so its +-lr move) may differ between the two
#: packages' rounding orders
STEP = 1e-4


def _cfg(compute_dtype="float32", **moe):
    base = RCB.get_smoke_arch("qwen3_moe_30b_a3b").model
    base = dataclasses.replace(base, compute_dtype=compute_dtype,
                               moe=dataclasses.replace(base.moe, **moe))
    port = dataclasses.replace(PCB.get_smoke_arch("qwen3_moe_30b_a3b").model,
                               compute_dtype=compute_dtype,
                               moe=dataclasses.replace(PCB.get_smoke_arch(
                                   "qwen3_moe_30b_a3b").model.moe, **moe))
    assert dataclasses.asdict(base) == dataclasses.asdict(port)
    return base, port


@functools.lru_cache(maxsize=None)
def _r_jit(fn, *static):
    """The reference's ``fn`` jitted with its config arguments static (one
    compile instead of its eager ops one by one)."""
    return jax.jit(fn, static_argnums=static)


def _moe_params(rcfg, seed):
    params = RM.init_params(RMOE.moe_specs(rcfg, 0), jax.random.PRNGKey(seed))
    return jax.tree_util.tree_map(np.asarray, params)


# --------------------------------------------------------------------------- #
# routing and dispatch                                                         #
# --------------------------------------------------------------------------- #


def test_route_breaks_ties_toward_the_lower_expert_index():
    """Rows with exact ties (equal probabilities at the top, in the middle,
    everywhere) and random rows: values and indices equal ``top_k``'s."""
    rng = np.random.default_rng(0)
    probs = rng.random((5, 7, 8)).astype(np.float32)
    probs[0, 0] = 0.125  # every expert ties: 0..k-1
    probs[0, 1, [2, 5, 6]] = 2.0  # three-way tie at the top
    probs[0, 2, [1, 3]] = probs[0, 2].max() / 2 + 0.5  # a tie around the k-th
    probs[1] = np.round(probs[1] * 4) / 4  # many ties
    for k in (1, 2, 3, 8):
        want_v, want_i = jax.lax.top_k(jnp.asarray(probs), k)
        got_v, got_i = PMOE.route(torch.from_numpy(probs), k)
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
        np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    _, got_i = PMOE.route(torch.from_numpy(probs), 2)
    assert got_i[0, 0].tolist() == [0, 1] and got_i[0, 1].tolist() == [2, 5]


@pytest.mark.parametrize("C", [1, 3, 64])
def test_dispatch_plan_equals_reference(C):
    """Slots (with the drop bin E*C) and source tokens of every pick, in
    sorted order, exactly; C = 1 and 3 overflow, 64 keeps every pick."""
    E, k, S = 8, 2, 24
    rng = np.random.default_rng(C)
    idx = np.stack([rng.permutation(E)[:k] for _ in range(2 * S)]).reshape(2, S, k)
    idx[1, :12] = [0, 1]  # a row crowding two experts
    idx = idx.astype(np.int32)
    gates = rng.random((2, S, k)).astype(np.float32)
    x = rng.standard_normal((2, S, 4)).astype(np.float32)
    _, r_slot, r_tok, r_keep, _ = RMOE._dispatch_batch(
        jnp.asarray(x), jnp.asarray(idx), jnp.asarray(gates), E, C, k, jnp.float32)
    slot, tok, _ = PMOE.dispatch_slots(torch.from_numpy(idx).long(), E, C)
    np.testing.assert_array_equal(slot.numpy(), np.asarray(r_slot))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(r_tok))
    assert (slot.numpy() < E * C).tolist() == np.asarray(r_keep).tolist()


def _moe_case(name):
    """(reference cfg, port cfg, params, x) of one ``moe_apply`` case."""
    rng = np.random.default_rng(len(name))
    S = 1 if name == "single_token" else 16
    moe = {"ample": dict(capacity_factor=8.0), "overflow": {}, "zero_router": {},
           "shared": dict(n_shared=2), "single_token": {}, "published": {}}[name]
    rcfg, pcfg = _cfg(**moe)
    params = _moe_params(rcfg, seed=len(name))
    x = rng.standard_normal((2, S, rcfg.d_model)).astype(np.float32)
    if name == "overflow":
        # experts 0 and 1 win every token, with unequal gates
        router = rng.standard_normal(params["router"]["kernel"].shape).astype(np.float32) * 0.01
        router[0, 0], router[0, 1] = 5.0, 4.0
        params["router"]["kernel"] = router
        x[..., 0] = 1.0 + np.abs(x[..., 0])
    if name == "zero_router":
        params["router"]["kernel"] = np.zeros_like(params["router"]["kernel"])
    return rcfg, pcfg, params, x


MOE_CASES = ("published", "ample", "overflow", "zero_router", "shared", "single_token")


@pytest.mark.parametrize("name", MOE_CASES)
def test_moe_apply_matches_reference(name):
    rcfg, pcfg, params, x = _moe_case(name)
    want_y, want_aux = _r_jit(RMOE.moe_apply, 1)(jax.tree_util.tree_map(jnp.asarray, params),
                                                  rcfg, jnp.asarray(x))
    got_y, got_aux = PMOE.moe_apply(lm_params_from_arrays(params, "cpu"), pcfg,
                                    torch.from_numpy(x))
    assert got_y.dtype == torch.float32 and got_y.shape == x.shape
    _close(got_y, want_y, FP32)
    assert set(got_aux) == {"load_balance_loss", "router_z_loss"}
    for key in got_aux:
        assert got_aux[key].dtype == torch.float32 and got_aux[key].shape == ()
        np.testing.assert_allclose(got_aux[key].item(), float(want_aux[key]), rtol=1e-5)
    # the routes: the expert ids of both packages' routers, exactly
    rlogits = RM.dense(jax.tree_util.tree_map(jnp.asarray, params["router"]), jnp.asarray(x),
                       "bsd,de->bse", jnp.float32)
    _, want_ids = jax.lax.top_k(jax.nn.softmax(rlogits, axis=-1), rcfg.moe.top_k)
    *_, got_ids = PMOE.router(lm_params_from_arrays(params, "cpu"), pcfg, torch.from_numpy(x))
    np.testing.assert_array_equal(got_ids.numpy(), np.asarray(want_ids))
    if name == "zero_router":
        assert (got_ids == torch.arange(pcfg.moe.top_k)).all()
    if name == "overflow":
        S, k, E = x.shape[1], pcfg.moe.top_k, pcfg.moe.n_experts
        C = PMOE.capacity(S, k, E, pcfg.moe.capacity_factor)
        assert (got_ids.sort(-1).values == torch.tensor([0, 1])).all() and C < S
        # tokens past capacity in both experts contribute exactly zero
        assert (got_y[:, C:] == 0).all() and (got_y[:, :C].abs().sum(-1) > 0).all()


def test_moe_apply_bf16_matches_reference():
    """The served compute dtype on the published smoke config: bf16
    products and a bf16 combine (``BF16`` of test_torch_models)."""
    rcfg, pcfg = _cfg("bfloat16")
    params = _moe_params(rcfg, 3)
    x = np.random.default_rng(3).standard_normal((2, 16, rcfg.d_model)).astype(np.float32)
    want, _ = _r_jit(RMOE.moe_apply, 1)(jax.tree_util.tree_map(jnp.asarray, params), rcfg,
                                        jnp.asarray(x, jnp.bfloat16))
    got, _ = PMOE.moe_apply(lm_params_from_arrays(params, "cpu"), pcfg,
                            torch.from_numpy(x).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    _close(got, want, dict(rtol=5e-2, atol=1e-1))


def test_moe_apply_on_a_mesh_raises_naming_item_9b():
    _, pcfg = _cfg()
    with pytest.raises(NotImplementedError, match="item 9b"):
        PMOE.moe_apply({}, pcfg, torch.zeros((1, 2, pcfg.d_model)), mesh=object())


# --------------------------------------------------------------------------- #
# MLA                                                                          #
# --------------------------------------------------------------------------- #


def test_mla_prefill_and_absorbed_decode_match_reference():
    """Prefill of 12 tokens into a 16-slot cache, then two decode steps at
    positions 12 and 13 (rows fed different tokens), float32 compute."""
    rb, pb = RCB.get_smoke_arch("deepseek_v2_lite_16b"), PCB.get_smoke_arch("deepseek_v2_lite_16b")
    rcfg = dataclasses.replace(rb.model, compute_dtype="float32")
    pcfg = dataclasses.replace(pb.model, compute_dtype="float32")
    params = jax.tree_util.tree_map(
        np.asarray, RM.init_params(RMLA.mla_specs(rcfg, 0), jax.random.PRNGKey(7)))
    rparams, pparams = jax.tree_util.tree_map(jnp.asarray, params), lm_params_from_arrays(
        params, "cpu")
    rng = np.random.default_rng(7)
    B, S, S_max = 2, 12, 16
    x = rng.standard_normal((B, S, rcfg.d_model)).astype(np.float32)
    m = rcfg.mla
    rcache = {"c_kv": jnp.zeros((B, S_max, m.kv_lora_rank), jnp.bfloat16),
              "k_rope": jnp.zeros((B, S_max, m.rope_head_dim), jnp.bfloat16)}
    pcache = {k: torch.zeros(v.shape, dtype=torch.bfloat16) for k, v in rcache.items()}
    r_prefill = _r_jit(lambda p, c, part, x, cache: RMLA.mla_attention(p, c, part, x,
                                                                       cache=cache), 1, 2)
    r_decode = _r_jit(lambda p, c, part, x, pos, cache: RMLA.mla_attention_decode(
        p, c, part, x, positions=pos, cache=cache), 1, 2)
    want, rcache = r_prefill(rparams, rcfg, rb.partition, jnp.asarray(x), rcache)
    got, same = PMLA.mla_attention(pparams, pcfg, pb.partition, torch.from_numpy(x),
                                   cache=pcache)
    assert same is pcache  # written in place
    _close(got, want, FP32)
    _close(pcache, rcache, ONE_BF16_ULP)
    for i in range(2):
        x1 = rng.standard_normal((B, 1, rcfg.d_model)).astype(np.float32)
        pos = np.array([S + i, S + i], np.int32)
        want, rcache = r_decode(rparams, rcfg, rb.partition, jnp.asarray(x1), jnp.asarray(pos),
                                rcache)
        got, pcache = PMLA.mla_attention_decode(pparams, pcfg, pb.partition,
                                                torch.from_numpy(x1),
                                                positions=torch.from_numpy(pos), cache=pcache)
        _close(got, want, FP32_CACHED)
        _close(pcache, rcache, ONE_BF16_ULP)
    # the expanded prefill's output without a cache is the same
    alone, none = PMLA.mla_attention(pparams, pcfg, pb.partition, torch.from_numpy(x))
    assert none is None
    np.testing.assert_allclose(alone.numpy(), _np(
        r_prefill(rparams, rcfg, rb.partition, jnp.asarray(x), None)[0]), **FP32)


# --------------------------------------------------------------------------- #
# the abstract-parameter helpers                                               #
# --------------------------------------------------------------------------- #


def _buildable():
    out = []
    for arch in RCB.arch_ids():
        bundle = PCB.get_arch(arch)
        if not hasattr(bundle, "model"):
            continue
        try:
            p_build(bundle, device="cpu")
        except NotImplementedError:
            continue
        out.append(arch)
    return out


def _shape_dtype(leaf):
    return tuple(leaf.shape), str(leaf.dtype).replace("torch.", "")


#: every configuration ``build`` accepts (the LM configs but jamba, xlstm and
#: seamless)
BUILDABLE = ("deepseek_v2_lite_16b", "gemma3_12b", "internvl2_26b", "qwen1_5_110b",
             "qwen2_5_3b", "qwen3_4b", "qwen3_moe_30b_a3b")


def test_every_buildable_config_is_the_served_set():
    assert tuple(sorted(_buildable())) == BUILDABLE


@pytest.mark.parametrize("arch", BUILDABLE)
def test_abstract_params_and_cache_match_reference(arch):
    """Full width, leaf by leaf in the reference's order: shape and dtype;
    every leaf a ``meta`` tensor."""
    rm, pm = r_build(RCB.get_arch(arch)), p_build(PCB.get_arch(arch), device="cpu")
    for want, got in ((rm.abstract_params(), pm.abstract_params()),
                      (rm.abstract_cache(4, 4096), pm.abstract_cache(4, 4096))):
        want, got = jax.tree_util.tree_leaves(want), tree_leaves(got)
        assert len(got) == len(want) > 0
        assert all(t.device.type == "meta" for t in got)
        assert [_shape_dtype(t) for t in got] == [(tuple(w.shape), str(w.dtype)) for w in want]
    leaves, structure = PM.tree_leaves_with_specs(pm.param_specs)
    assert [(s.shape, s.dtype) for s in leaves] == [(t.shape, t.dtype)
                                                    for t in tree_leaves(pm.abstract_params())]
    assert structure is pm.param_specs


# --------------------------------------------------------------------------- #
# the paper's cycle model                                                      #
# --------------------------------------------------------------------------- #


@functools.lru_cache(maxsize=None)
def _tool():
    spec = importlib.util.spec_from_file_location("paper_model_tool",
                                                  ROOT / "tools" / "paper_model.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod  # its dataclasses look their module up
    spec.loader.exec_module(mod)
    return mod


def test_paper_model_tables_equal_reference_and_paper():
    from benchmarks import fig3_scaling, fig4_trend
    from benchmarks import paper_model as rpm

    tool = _tool()
    assert tool.table3() == rpm.table3() and tool.table4() == rpm.table4()
    assert tool.table5() == rpm.table5()
    assert (tool.PAPER_TABLE3, tool.PAPER_TABLE4, tool.PAPER_TABLE5) == (
        rpm.PAPER_TABLE3, rpm.PAPER_TABLE4, rpm.PAPER_TABLE5)
    out = tool.run()
    assert out["matches_paper"] == {"table3": True, "table4": True, "table5": True}
    assert out["fig3_cycle_model"] == fig3_scaling.cycle_model_sweep()
    want = fig4_trend.run()["improvement_pct"]
    assert out["fig4_improvement_pct"] == {k: v for k, v in want.items() if k in
                                           out["fig4_improvement_pct"]}
    assert len(out["fig4_improvement_pct"]) == len(want) - 1  # the TPU op-count row
    assert [tool.calls_for_bits(b) for b in tool.FIG3_BITS] == [
        rpm.calls_for_bits(b) for b in tool.FIG3_BITS]
    # a table off by one cycle is caught
    bad = dict(tool.table3(), texpand_total_cycles=7677)
    assert not tool.matches_paper(bad, tool.PAPER_TABLE3)


# --------------------------------------------------------------------------- #
# one train step of each new family                                            #
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("arch", NEW_FAMILIES)
def test_one_train_step_matches_reference(arch):
    """AdamW, remat "full", float32 compute, from the reference's weights:
    the loss (cross-entropy plus the aux terms), the aux metrics and the
    updated weights."""
    from test_torch_models import _ref_params

    rb = dataclasses.replace(RCB.get_smoke_arch(arch), model=dataclasses.replace(
        RCB.get_smoke_arch(arch).model, compute_dtype="float32"))
    rb = dataclasses.replace(rb, partition=dataclasses.replace(rb.partition, remat="full"))
    pb = dataclasses.replace(PCB.get_smoke_arch(arch), model=dataclasses.replace(
        PCB.get_smoke_arch(arch).model, compute_dtype="float32"))
    pb = dataclasses.replace(pb, partition=dataclasses.replace(pb.partition, remat="full"))
    np_batch = _np_batch(arch)
    rparams = _ref_params(arch)
    r_opt, p_opt = ropt.adamw(), popt.adamw()
    r_step = r_make_train_step(r_build(rb), r_opt, ropt.cosine_warmup(1e-3, 0, 10),
                               donate=False)
    want_p, _, want_m = r_step(rparams, r_opt.init(rparams), _ref_batch(np_batch), 0)
    pm = p_build(pb, device="cpu")
    pparams = lm_params_from_arrays(jax.tree_util.tree_map(np.asarray, rparams), "cpu")
    got_p, _, got_m = make_train_step(pm, p_opt, popt.cosine_warmup(1e-3, 0, 10))(
        pparams, p_opt.init(pparams), _port_batch(np_batch), 0)
    got_m = read_metrics(got_m)
    for key in ("loss", "load_balance_loss", "router_z_loss"):
        np.testing.assert_allclose(got_m[key], float(want_m[key]), rtol=FP32_GRAD, err_msg=key)
    assert got_m["load_balance_loss"] > 0 and got_m["router_z_loss"] > 0
    errs = [_rel(g, w) for g, w in zip(tree_leaves(got_p), jax.tree_util.tree_leaves(want_p))]
    assert len(errs) == len(jax.tree_util.tree_leaves(want_p)) and max(errs) < STEP, errs


# --------------------------------------------------------------------------- #
# the launchers                                                                #
# --------------------------------------------------------------------------- #


LAUNCH = {
    "serve": ["repro_torch.launch.serve", "--arch", "qwen3_moe_30b_a3b", "--smoke",
              "--device", "cpu", "--tokens", "8"],
    "train": ["repro_torch.launch.train", "--arch", "deepseek_v2_lite_16b", "--smoke",
              "--device", "cpu", "--steps", "2", "--warmup", "1", "--seq-len", "32",
              "--global-batch", "2"],
}


@pytest.mark.parametrize("which", sorted(LAUNCH))
def test_launchers_take_the_new_families(which):
    """``launch/serve.py`` serves the MoE family and ``launch/train.py``
    trains the MLA + MoE one on the CPU; each logs its report as JSON."""
    import json
    import os
    import subprocess

    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    proc = subprocess.run([sys.executable, "-m", *LAUNCH[which]], env=env, capture_output=True,
                          text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    out = json.loads("\n".join(lines[max(i for i, x in enumerate(lines) if x == "{"):]))
    if which == "serve":
        assert out["arch"] == "qwen3-moe-smoke" and out["new_tokens"] == 8
    else:
        assert out["arch"] == "deepseek-v2-lite-smoke" and out["steps"] == 2
        assert np.isfinite(out["final_metrics"]["loss"])
        assert out["final_metrics"]["router_z_loss"] > 0
