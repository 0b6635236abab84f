"""The port's LM serving path held against the reference on identical
inputs: the configs (field for field, ``param_count``, the spec trees), the
model substrate's pieces (norms, RoPE, ``dense``, the MLP, chunked
attention at several chunk splits, the decode attention, the cache
writes), the seven buildable smoke architectures' prefill logits and caches
and three decode steps' logits (the MoE qwen3-moe and the MLA + MoE
deepseek-v2-lite among them), ``ServeEngine``'s greedy tokens, the serving
scenario (LM tokens -> bits -> K=3 code -> BSC -> Viterbi),
``cache_bytes``, the refusals, and the launcher's two paths.

Weights are the reference's ``model.init`` carried over by
``lm_params_from_arrays``; every other input is made with numpy.

Stated tolerances (each comparison names the one it uses):

* ``FP32`` (rtol 1e-5): float32 compute without a bf16 cache read — the
  two packages' float32 products sum in different orders.
* ``FP32_CACHED`` (1e-2): decode logits in float32 compute.  The caches
  are bf16 (the reference's layout), and a K/V value within float32 noise
  of a bf16 rounding boundary rounds the other way in one package: one
  bf16 ulp (2^-8 relative) in a cache entry, ~1e-3 in a logit.
* ``ONE_BF16_ULP`` (rtol 2^-7): bf16 values rounded from float32 values
  that agree to float32 noise (caches in float32 compute, norms).
* ``BF16`` (rtol 5e-2, atol 1e-1; ~6 bf16 ulps at |x| in [2, 4)): bf16
  compute.  XLA fuses elementwise chains and rounds once where eager
  torch rounds after every op.
* Greedy tokens are compared in float32 compute.  In bf16 they meet
  near-ties: on the qwen1.5 smoke model the port's logits for tokens 316
  and 49 tie at 2.78125 where the reference's read 2.765625 and 2.75.
"""
import dataclasses
import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs.base as RCB
import repro.models.attention as RA
import repro.models.common as RM
import repro.models.mlp as RMLP
from repro.decode import DecodeRequest as RDecodeRequest
from repro.decode import decode as r_decode
from repro.configs.paper_viterbi import DECODE_SPEC as R_SPEC
from repro.models.model_zoo import build as r_build
from repro.serve import ServeEngine as RServeEngine
from repro.serve.kv_cache import cache_bytes as r_cache_bytes
import repro_torch.configs.base as PCB
import repro_torch.models.attention as PA
import repro_torch.models.common as PM
import repro_torch.models.mlp as PMLP
import repro_torch.models.transformer as PT
from repro_torch.configs.paper_viterbi import DECODE_SPEC as P_SPEC
from repro_torch.convert import lm_params_from_arrays
from repro_torch.decode import DecodeContext, DecodeRequest, decode
from repro_torch.models import build as p_build
from repro_torch.serve import ServeEngine, bits_to_tokens, cache_bytes, tokens_to_bits

torch.set_num_threads(1)

SRC = Path(__file__).resolve().parents[1] / "src"

FP32 = dict(rtol=1e-5, atol=1e-5)
FP32_CACHED = dict(rtol=1e-2, atol=1e-2)
ONE_BF16_ULP = dict(rtol=2 ** -7, atol=1e-6)
BF16 = dict(rtol=5e-2, atol=1e-1)

SERVED = ("qwen2_5_3b", "qwen3_4b", "qwen1_5_110b", "gemma3_12b", "internvl2_26b",
          "qwen3_moe_30b_a3b", "deepseek_v2_lite_16b")
REFUSED = ("jamba_v0_1_52b", "xlstm_350m", "seamless_m4t_large_v2")
#: the families of ROADMAP item 11: the two built since the MoE and MLA port
#: (their dry-run inputs still wait), then the three still refused
ITEM_11 = ("qwen3_moe_30b_a3b", "deepseek_v2_lite_16b") + REFUSED
B, S = 2, 16  # gemma3's smoke window is 16: its ring wraps from the first decode step
NEW = 12  # tokens generated; the caches hold S + NEW


def _np(x) -> np.ndarray:
    """A reference or port array as float32 numpy (bf16 widened exactly)."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy() if x.is_floating_point() else x.numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype.kind == "V" or str(x.dtype) == "bfloat16" else x


def _close(got, want, tol, path=""):
    """Leaf by leaf over two trees of the same keys."""
    if isinstance(want, dict):
        assert set(got) == set(want), (path, set(got) ^ set(want))
        for k in want:
            _close(got[k], want[k], tol, f"{path}/{k}")
        return
    g, w = _np(got), _np(want)
    assert g.shape == w.shape, (path, g.shape, w.shape)
    np.testing.assert_allclose(g, w, err_msg=path, **tol)


def _both(x: np.ndarray, dtype: str):
    """One numpy array as a reference and a port array of ``dtype``
    (float32 -> bf16 rounds to nearest even in both)."""
    return jnp.asarray(x).astype(dtype), torch.from_numpy(x).to(getattr(torch, dtype))


def _bundles(arch: str, compute_dtype=None):
    rb, pb = RCB.get_smoke_arch(arch), PCB.get_smoke_arch(arch)
    if compute_dtype:
        rb = dataclasses.replace(rb, model=dataclasses.replace(rb.model,
                                                               compute_dtype=compute_dtype))
        pb = dataclasses.replace(pb, model=dataclasses.replace(pb.model,
                                                               compute_dtype=compute_dtype))
    return rb, pb


@functools.lru_cache(maxsize=None)
def _ref_params(arch: str):
    """The reference's smoke parameters (jitted: the same numbers as its
    eager ``init``; they do not depend on the compute dtype)."""
    return jax.jit(r_build(RCB.get_smoke_arch(arch)).init)(jax.random.PRNGKey(0))


@functools.lru_cache(maxsize=None)
def _pair(arch: str, compute_dtype: str):
    """(reference model, its params, jitted prefill, jitted decode, port
    model, port params) at smoke size; the port's params are the
    reference's."""
    rb, pb = _bundles(arch, compute_dtype)
    rm = r_build(rb)
    params = _ref_params(arch)
    pm = p_build(pb, device="cpu")
    pp = lm_params_from_arrays(jax.tree_util.tree_map(np.asarray, params), "cpu")
    return rm, params, jax.jit(rm.prefill), jax.jit(rm.decode_step), pm, pp


# --------------------------------------------------------------------------- #
# configs                                                                      #
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("arch", RCB.arch_ids())
def test_config_equals_reference_field_for_field(arch):
    for get in ("get_arch", "get_smoke_arch"):
        want, got = getattr(RCB, get)(arch), getattr(PCB, get)(arch)
        assert dataclasses.asdict(got) == dataclasses.asdict(want), (arch, get)
        assert got.model.param_count() == want.model.param_count(), (arch, get)
        for shape in RCB.SHAPES:
            assert got.skips(shape) == want.skips(shape)


def test_registry_and_shapes_equal_reference():
    assert PCB.arch_ids() == RCB.arch_ids()
    assert {k: dataclasses.asdict(v) for k, v in PCB.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in RCB.SHAPES.items()}
    assert dataclasses.asdict(PCB.PartitionConfig()) == dataclasses.asdict(RCB.PartitionConfig())
    assert PCB.get_arch("qwen2.5-3b").model.name == "qwen2.5-3b"
    assert PCB.get_arch("paper_viterbi").code.constraint == 3
    with pytest.raises(KeyError, match="unknown arch"):
        PCB.get_arch("gpt5")


def _spec_fields(tree):
    if isinstance(tree, dict):
        return {k: _spec_fields(v) for k, v in tree.items()}
    d = tree.dtype
    name = str(d).replace("torch.", "") if isinstance(d, torch.dtype) else np.dtype(d).name
    return (tuple(tree.shape), tuple(tree.axes), tree.init, tree.scale, tree.fan_in, name)


@pytest.mark.parametrize("arch", SERVED)
def test_param_and_cache_specs_equal_reference(arch):
    """Full width and smoke: the same keys, shapes, axes and init (no
    allocation) — what makes ``lm_params_from_arrays`` a copy."""
    for get in ("get_arch", "get_smoke_arch"):
        rm, pm = r_build(getattr(RCB, get)(arch)), p_build(getattr(PCB, get)(arch), device="cpu")
        assert _spec_fields(pm.param_specs) == _spec_fields(rm.param_specs)
        assert _spec_fields(pm.cache_specs(4, 48)) == _spec_fields(rm.cache_specs(4, 48))


# --------------------------------------------------------------------------- #
# model substrate                                                              #
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_norms_and_rope_match_reference(dtype):
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((B, S, 4, 16)) * 3).astype(np.float32)
    scale = rng.standard_normal(16).astype(np.float32)
    rx, px = _both(x, dtype)
    tol = FP32 if dtype == "float32" else ONE_BF16_ULP
    cd = getattr(jnp, dtype)
    for gemma in (False, True):
        want = RM.rmsnorm({"scale": jnp.asarray(scale)}, rx, 1e-6, gemma, cd)
        got = PM.rmsnorm({"scale": torch.from_numpy(scale)}, px, 1e-6, gemma,
                         getattr(torch, dtype))
        _close(got, want, tol)
    _close(PM.headwise_rmsnorm(torch.from_numpy(scale), px),
           RM.headwise_rmsnorm(jnp.asarray(scale), rx), tol)
    ln = {"scale": scale, "bias": scale[::-1].copy()}
    _close(PM.layernorm(lm_params_from_arrays(ln, "cpu"), px, 1e-6, getattr(torch, dtype)),
           RM.layernorm(jax.tree_util.tree_map(jnp.asarray, ln), rx, 1e-6, cd), tol)
    pos = rng.integers(0, 4096, (B, S)).astype(np.int32)
    for theta in (1e4, 1e6):
        rc, rs = RM.rope_angles(jnp.asarray(pos), 16, theta)
        pc, ps = PM.rope_angles(torch.from_numpy(pos), 16, theta)
        _close(pc, rc, FP32)
        _close(ps, rs, FP32)
        _close(PM.apply_rope(px, pc, ps), RM.apply_rope(rx, rc, rs),
               FP32 if dtype == "float32" else BF16)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dense_with_bias_matches_reference(dtype):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((B, S, 32)).astype(np.float32)
    params = {"kernel": rng.standard_normal((32, 4, 8)).astype(np.float32) / 6,
              "bias": rng.standard_normal((4, 8)).astype(np.float32)}
    want = RM.dense(jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(x),
                    "...d,dhk->...hk", getattr(jnp, dtype))
    got = PM.dense(lm_params_from_arrays(params, "cpu"), torch.from_numpy(x),
                   "...d,dhk->...hk", getattr(torch, dtype))
    assert got.dtype == getattr(torch, dtype)
    _close(got, want, FP32 if dtype == "float32" else BF16)


@pytest.mark.parametrize("arch,act", [("qwen2_5_3b", "silu"), ("gemma3_12b", "gelu")])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlp_apply_matches_reference(arch, act, dtype):
    rb, pb = _bundles(arch, dtype)
    assert rb.model.act == act
    params = RM.init_params(RMLP.mlp_specs(rb.model, 0), jax.random.PRNGKey(5))
    x = np.random.default_rng(5).standard_normal((B, S, rb.model.d_model)).astype(np.float32)
    rx, px = _both(x, dtype)
    want = RMLP.mlp_apply(params, rb.model, rx)
    got = PMLP.mlp_apply(lm_params_from_arrays(jax.tree_util.tree_map(np.asarray, params), "cpu"),
                         pb.model, px)
    _close(got, want, FP32 if dtype == "float32" else BF16)


#: (Sq, H, KV, causal, window, chunk_q, chunk_kv, softcap): one block; q and
#: kv splits both ways (several online-softmax steps); GQA 4:1 and 1:1; the
#: banded window with its clipped start, one block and several; softcap;
#: bidirectional
ATTN_CASES = [
    (16, 4, 2, True, 0, 2048, 2048, 0.0),
    (16, 4, 2, True, 0, 8, 4, 0.0),
    (16, 4, 1, True, 0, 4, 8, 0.0),
    (12, 4, 4, True, 0, 5, 5, 0.0),
    (16, 4, 2, True, 5, 4, 4, 0.0),
    (16, 4, 2, True, 6, 16, 16, 0.0),
    (16, 4, 2, True, 0, 8, 8, 5.0),
    (16, 4, 2, False, 0, 8, 4, 0.0),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ATTN_CASES, ids=lambda c: "-".join(map(str, c)))
def test_chunked_attention_matches_reference(case, dtype):
    Sq, H, KV, causal, window, cq, ck, softcap = case
    rng = np.random.default_rng(Sq * 31 + cq * 7 + ck + window)
    q = rng.standard_normal((B, Sq, H, 16)).astype(np.float32)
    k = rng.standard_normal((B, Sq, KV, 16)).astype(np.float32)
    v = rng.standard_normal((B, Sq, KV, 16)).astype(np.float32)
    kw = dict(causal=causal, window=window, chunk_q=cq, chunk_kv=ck, softcap=softcap)
    (rq, pq), (rk, pk), (rv, pv) = (_both(a, dtype) for a in (q, k, v))
    want = RA.chunked_attention(rq, rk, rv, **kw)
    got = PA.chunked_attention(pq, pk, pv, **kw)
    assert got.dtype == pq.dtype
    _close(got, want, FP32 if dtype == "float32" else BF16)


@pytest.mark.parametrize("softcap", [0.0, 3.0])
def test_masked_decode_matches_reference(softcap):
    rng = np.random.default_rng(6)
    q = rng.standard_normal((3, 4, 16)).astype(np.float32)
    kc = rng.standard_normal((3, 10, 2, 16)).astype(np.float32)
    vc = rng.standard_normal((3, 10, 2, 16)).astype(np.float32)
    lo, hi = np.array([0, 2, 0], np.int32), np.array([1, 7, 10], np.int32)
    rq, pq = _both(q, "bfloat16")
    (rk, pk), (rv, pv) = _both(kc, "bfloat16"), _both(vc, "bfloat16")
    want = RA._masked_decode(rq, rk, rv, jnp.asarray(lo), jnp.asarray(hi), softcap)
    got = PA._masked_decode(pq, pk, pv, torch.from_numpy(lo), torch.from_numpy(hi), softcap)
    _close(got, want, BF16)
    # float32 queries against the bf16 cache promote as jnp.einsum does
    want = RA._masked_decode(jnp.asarray(q), rk, rv, jnp.asarray(lo), jnp.asarray(hi), softcap)
    got = PA._masked_decode(torch.from_numpy(q), pk, pv, torch.from_numpy(lo),
                            torch.from_numpy(hi), softcap)
    _close(got, want, ONE_BF16_ULP)


def test_scatter_cache_matches_reference_exactly():
    rng = np.random.default_rng(7)
    cache = rng.standard_normal((3, 9, 2, 8)).astype(np.float32)
    new = rng.standard_normal((3, 1, 2, 8)).astype(np.float32)
    pos = np.array([0, 8, 4], np.int32)
    rc, pc = _both(cache, "bfloat16")
    want = RA._scatter_cache(rc, jnp.asarray(new), jnp.asarray(pos))
    got = PA._scatter_cache(pc, torch.from_numpy(new), torch.from_numpy(pos))
    np.testing.assert_array_equal(_np(got), _np(want))


@pytest.mark.parametrize("S_pre", [5, 8, 13])
def test_ring_from_prefill_matches_reference_exactly(S_pre):
    """S < W, S = W and S > W for a ring of W = 8."""
    W = 8
    rng = np.random.default_rng(S_pre)
    k = rng.standard_normal((2, S_pre, 2, 4)).astype(np.float32)
    v = rng.standard_normal((2, S_pre, 2, 4)).astype(np.float32)
    rcache = {"k": jnp.zeros((2, W, 2, 4), jnp.bfloat16),
              "v": jnp.zeros((2, W, 2, 4), jnp.bfloat16),
              "pos": jnp.full((2, W), -1, jnp.int32)}
    pcache = {"k": torch.zeros((2, W, 2, 4), dtype=torch.bfloat16),
              "v": torch.zeros((2, W, 2, 4), dtype=torch.bfloat16),
              "pos": torch.full((2, W), -1, dtype=torch.int32)}
    want = RA._ring_from_prefill(rcache, jnp.asarray(k), jnp.asarray(v))
    got = PA._ring_from_prefill(pcache, torch.from_numpy(k), torch.from_numpy(v))
    for name in ("k", "v", "pos"):
        assert got[name].dtype == pcache[name].dtype
        np.testing.assert_array_equal(_np(got[name]), _np(want[name]), err_msg=name)


# --------------------------------------------------------------------------- #
# models                                                                       #
# --------------------------------------------------------------------------- #


def _prefill_inputs(cfg, rng):
    batch = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    if cfg.modality == "vision":
        batch["patches"] = rng.standard_normal(
            (B, cfg.n_prefix_tokens, cfg.frontend_dim)).astype(np.float32)
    return batch, S + (cfg.n_prefix_tokens if cfg.modality == "vision" else 0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", SERVED)
def test_prefill_and_decode_match_reference(arch, dtype):
    """Prefill logits and caches, then three decode steps' logits (each
    package on its own caches, fed the same tokens)."""
    rm, params, r_prefill, r_decode_step, pm, pp = _pair(arch, dtype)
    rng = np.random.default_rng(8)
    batch, S0 = _prefill_inputs(rm.cfg, rng)
    steps = rng.integers(0, rm.cfg.vocab, (B, 3)).astype(np.int32)
    rc, pc = rm.init_cache(B, S0 + NEW), pm.init_cache(B, S0 + NEW)
    want, rc = r_prefill(params, jax.tree_util.tree_map(jnp.asarray, batch), rc)
    got, pc = pm.prefill(pp, {k: torch.from_numpy(v) for k, v in batch.items()}, pc)
    _close(got, want, FP32 if dtype == "float32" else BF16)
    _close(pc, rc, ONE_BF16_ULP if dtype == "float32" else BF16)
    for i in range(3):
        tok, pos = steps[:, i:i + 1], np.full((B,), S0 + i, np.int32)
        want, rc = r_decode_step(params, jnp.asarray(tok), jnp.asarray(pos), rc)
        got, pc = pm.decode_step(pp, torch.from_numpy(tok), torch.from_numpy(pos), pc)
        assert got.shape == (B, rm.cfg.vocab)
        _close(got, want, FP32_CACHED if dtype == "float32" else BF16)


def _ref_engine(arch: str, **kw):
    """The reference's engine on the float32 smoke model, its jitted steps
    swapped for the ones the model test compiled (the engine's own jits of
    the same two model methods; a prompt of S tokens and ``max_len`` S + NEW
    keep the shapes, so nothing compiles twice)."""
    rm, params, r_prefill, r_decode_step, _, _ = _pair(arch, "float32")
    engine = RServeEngine(rm, params, max_len=S + NEW, **kw)
    engine._prefill, engine._decode = r_prefill, r_decode_step
    return engine


@pytest.mark.parametrize("arch", SERVED)
def test_engine_greedy_tokens_equal_reference(arch):
    rm, params, _, _, pm, pp = _pair(arch, "float32")
    prompts = np.random.default_rng(9).integers(1, rm.cfg.vocab, (B, S)).astype(np.int32)
    want = _ref_engine(arch).generate(jnp.asarray(prompts), NEW)
    got = ServeEngine(pm, pp, max_len=S + NEW).generate(torch.from_numpy(prompts), NEW)
    assert got["tokens"].dtype == torch.int32 and got["tokens"].shape == (B, NEW)
    np.testing.assert_array_equal(got["tokens"].numpy(), np.asarray(want["tokens"]))
    np.testing.assert_array_equal(got["done"].numpy(), np.asarray(want["done"]))


def test_engine_stops_rows_at_eos_as_reference():
    """A row whose token is ``eos`` emits ``eos`` from then on; ``done``
    marks it (set from the token before the last, as the reference's)."""
    rm, params, _, _, pm, pp = _pair("qwen2_5_3b", "float32")
    prompts = np.random.default_rng(10).integers(1, rm.cfg.vocab, (B, S)).astype(np.int32)
    engine = ServeEngine(pm, pp, max_len=S + NEW)
    eos = int(engine.generate(torch.from_numpy(prompts), NEW)["tokens"][0, 2])
    want = _ref_engine("qwen2_5_3b", eos=eos).generate(jnp.asarray(prompts), NEW)
    got = ServeEngine(pm, pp, max_len=S + NEW, eos=eos).generate(torch.from_numpy(prompts), NEW)
    np.testing.assert_array_equal(got["tokens"].numpy(), np.asarray(want["tokens"]))
    np.testing.assert_array_equal(got["done"].numpy(), np.asarray(want["done"]))
    assert bool(got["done"][0]) and (got["tokens"][0, 2:] == eos).all()


def test_engine_temperature_sampling_is_seeded():
    """Sampled tokens come from torch's generator (not the reference's
    stream): the same seed repeats them, another seed moves them."""
    _, _, _, _, pm, pp = _pair("qwen2_5_3b", "float32")
    prompts = torch.from_numpy(np.random.default_rng(11).integers(1, 512, (B, 8)))
    engine = ServeEngine(pm, pp, max_len=40, temperature=1.0, eos=-1)
    a, b = engine.generate(prompts, 24, seed=3), engine.generate(prompts, 24, seed=3)
    assert torch.equal(a["tokens"], b["tokens"])
    assert not torch.equal(a["tokens"], engine.generate(prompts, 24, seed=4)["tokens"])


# --------------------------------------------------------------------------- #
# the serving scenario, cache accounting, refusals                             #
# --------------------------------------------------------------------------- #


def test_lm_to_viterbi_pipeline_matches_reference():
    """The paper's serving scenario at smoke size: the port's greedy tokens
    (vocab 512: 9 bits a token) -> bits -> the K=3 code -> a BSC at flip
    0, 0.01, 0.03 (one numpy flip mask fed to both) -> the planned decode.
    Both packages decode the same bits; at flip 0 the tokens come back."""
    _, _, _, _, pm, pp = _pair("qwen2_5_3b", "bfloat16")
    prompts = np.random.default_rng(12).integers(1, 512, (B, 8)).astype(np.int32)
    toks = ServeEngine(pm, pp, max_len=16).generate(torch.from_numpy(prompts), 8)["tokens"]
    bits = tokens_to_bits(toks, 9)
    coded = P_SPEC.encode(bits)
    np.testing.assert_array_equal(coded.numpy(),
                                  np.asarray(R_SPEC.encode(jnp.asarray(bits.numpy()))))
    rng = np.random.default_rng(13)
    for flip in (0.0, 0.01, 0.03):
        rx = (coded.numpy() ^ (rng.random(coded.shape) < flip)).astype(np.float32)
        got = decode(DecodeRequest(P_SPEC, received=torch.from_numpy(rx)),
                     ctx=DecodeContext(device="cpu"))
        want = r_decode(RDecodeRequest(R_SPEC, received=jnp.asarray(rx)))
        assert got.plan.backend == want.plan.backend
        np.testing.assert_array_equal(got.info_bits.numpy(), np.asarray(want.info_bits))
        if flip == 0.0:
            assert torch.equal(got.info_bits, bits)
            assert torch.equal(bits_to_tokens(got.info_bits, 9), toks)


@pytest.mark.parametrize("arch", ["qwen2_5_3b", "gemma3_12b", "internvl2_26b",
                                  "qwen3_moe_30b_a3b", "deepseek_v2_lite_16b"])
def test_cache_bytes_equal_reference(arch):
    """Full width (no allocation): the attention caches, gemma3's rings at
    S past the window, MLA's compressed cache."""
    rm, pm = r_build(RCB.get_arch(arch)), p_build(PCB.get_arch(arch), device="cpu")
    for Bc, Sc in ((4, 48), (2, 4096)):
        assert cache_bytes(pm, Bc, Sc) == r_cache_bytes(rm, Bc, Sc) > 0


@pytest.mark.parametrize("arch", ITEM_11)
def test_refused_families_raise_naming_item_11(arch):
    """What of item 11 still waits for each of its families: jamba, xlstm
    and seamless are refused before any allocation; the MoE and MLA families
    build, and their dry-run inputs (``input_specs``) raise."""
    if arch in REFUSED:
        with pytest.raises(NotImplementedError, match="item 11"):
            p_build(PCB.get_smoke_arch(arch), device="cpu")
        return
    model = p_build(PCB.get_smoke_arch(arch), device="cpu")
    with pytest.raises(NotImplementedError, match="item 11"):
        model.input_specs(PCB.SHAPES["decode_32k"])


MESH_CALLS = {
    "engine": lambda pm, pp: ServeEngine(pm, pp, max_len=8, mesh=object()),
    "prefill": lambda pm, pp: pm.prefill(pp, {"tokens": torch.zeros((1, 4), dtype=torch.int64)},
                                         pm.init_cache(1, 8), mesh=object()),
    "decode_step": lambda pm, pp: pm.decode_step(
        pp, torch.zeros((1, 1), dtype=torch.int64), torch.zeros(1, dtype=torch.int32),
        pm.init_cache(1, 8), mesh=object()),
    "param_shardings": lambda pm, pp: pm.param_shardings(object()),
    "constrain": lambda pm, pp: PM.constrain(torch.zeros(1), object(), None, ("batch",)),
}


@pytest.mark.parametrize("call", sorted(MESH_CALLS))
def test_mesh_raises_naming_item_9b(call):
    _, _, _, _, pm, pp = _pair("qwen2_5_3b", "float32")
    with pytest.raises(NotImplementedError, match="item 9b"):
        MESH_CALLS[call](pm, pp)


def test_training_waits_for_item_11():
    """Training is ported (``tests/test_torch_train.py``); of item 11's LM
    pieces the dry run's ``input_specs`` still waits, and training on a mesh
    waits for item 9b."""
    _, _, _, _, pm, pp = _pair("qwen2_5_3b", "float32")
    with pytest.raises(NotImplementedError, match="item 11"):
        pm.input_specs(None)
    for call in (lambda: pm.train_loss(pp, {}, mesh=object()),
                 lambda: PT.softmax_xent(None, None, mesh=object())):
        with pytest.raises(NotImplementedError, match="item 9b"):
            call()
    x = torch.ones(2)
    assert PM.constrain(x, None, None, ("batch",)) is x


# --------------------------------------------------------------------------- #
# the launcher                                                                 #
# --------------------------------------------------------------------------- #


def _launch(*flags):
    env = {**os.environ, "PYTHONPATH": str(SRC)}
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.serve", *flags], env=env,
                          capture_output=True, text=True, timeout=240)


def _logged_json(stdout: str) -> dict:
    lines = stdout.splitlines()
    start = max(i for i, line in enumerate(lines) if line == "{")
    return json.loads("\n".join(lines[start:]))


def test_launcher_lm_path_on_cpu():
    proc = _launch("--device", "cpu", "--smoke")
    assert proc.returncode == 0, proc.stderr
    out = _logged_json(proc.stdout)
    assert out["arch"] == "qwen2.5-smoke" and out["device"] == "cpu"
    assert out["new_tokens"] == 32 and len(out["sample"]) == 8 and out["tokens_per_s"] > 0


def test_launcher_viterbi_path_on_cpu():
    proc = _launch("--device", "cpu", "--viterbi", "--batch", "8", "--bits", "64")
    assert proc.returncode == 0, proc.stderr
    out = _logged_json(proc.stdout)
    assert out["backend"] == "fused_packed" and out["device"] == "cpu"
    assert out["batch"] == 8 and out["bits"] == 64 and 0.0 <= out["ber"] < 0.1
    assert "plan: backend='fused_packed'" in proc.stdout
    assert "cost: no cost model yet" in proc.stdout and "flops" not in proc.stdout


def test_launcher_defaults_to_the_card():
    """Without ``--device`` the launcher asks for the card; here there is
    none, so it fails instead of running the CPU."""
    from repro_torch.launch.serve import main

    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--smoke"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--viterbi"])
