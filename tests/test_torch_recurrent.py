"""The port's recurrent LM families held against the reference on identical
inputs: the Mamba mixer (``models/ssm.py``) of jamba and the mLSTM and
sLSTM mixers (``models/xlstm.py``) of xlstm, then both smoke families
end to end.

* ``softplus`` against ``jax.nn.softplus`` (value and gradient, past
  ``F.softplus``'s threshold of 20 too) and the pair form of the
  associative scan against ``jax.lax.associative_scan``.
* ``ssm_apply`` without and with a cache (the scan starting from the
  cache's state; the state and conv window it writes), at S where the chunk
  rule takes ``chunk`` itself, two chunks, and a divisor below ``chunk``
  (S=12 at chunk 16 -> 12, S=14 at chunk 4 -> 2); ``ssm_decode`` for three
  steps from a random cache.
* ``mlstm_apply``/``mlstm_decode`` and ``slstm_apply``/``slstm_decode``
  the same way; the mLSTM's gradients at a chunk of 256, where the
  reference's are NaN (it exponentiates masked weights past float32's range
  before masking them) and the port's finite.
* Both smoke families: the param and cache specs (full width and smoke),
  ``init_cache``, prefill logits and caches and three decode steps' logits
  in float32 and bf16 compute, ``ServeEngine``'s greedy tokens, and the
  loss and every gradient leaf of ``train_loss`` (remat "full" in the
  port, so the chunk checkpoints nest inside the block's).

Weights are the reference's ``init`` carried over by
``lm_params_from_arrays``; every other input is made with numpy.

Stated tolerances (from ``test_torch_models``/``test_torch_train``):

* ``FP32`` (rtol 1e-5): the mixers' outputs and float32 states in float32
  compute.
* ``ONE_BF16_ULP`` (rtol 2^-7): where a bf16 rounding sits between the two
  packages' float32 values — the reference rounds the mLSTM chunk's and the
  sLSTM scan's ``h`` to bf16 whatever the compute dtype (those mixers'
  outputs), and the conv windows are bf16 caches.
* ``FP32_CACHED`` (1e-2): decode logits read the models' bf16 caches.
* ``BF16`` (rtol 5e-2, atol 1e-1): bf16 compute, one block on identical
  inputs (each block's own drift: at most 0.0625 seen, xlstm's second
  mLSTM).  XLA fuses elementwise chains and rounds once where eager torch
  rounds after every op.
* ``BF16_STACK`` (rtol 1e-1, atol 2e-1, the reference's own tolerance for
  these families' teacher forcing): bf16 logits end to end, where each
  block's drift enters the next block's recurrent state (0.156 seen,
  xlstm's decode; BF16 failed 2 of 1024 logits there).
* ``FP32_GRAD`` (2e-5): the loss by rtol, each gradient leaf by its
  relative L2 error: jamba's model, and each xLSTM mixer alone.
* ``BF16_GRAD`` (3e-2, relative L2 error a leaf): xlstm's gradients in
  float32 compute, with its loss by ``ONE_BF16_ULP``'s rtol.  The
  reference rounds ``h`` to bf16 inside the float32 model, so where one
  ``h`` element rounds the other way in one package the activations after
  it move by O(1e-3), and the later sLSTM recurrences carry that forward in
  time (seen: the loss 2.6e-5 apart, gradient leaves up to 1.4e-2, w_if's
  bias of norm 0.06; with that rounding taken out of both packages the
  loss agrees to 1.4e-7).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs.base as RCB
import repro.models.common as RM
import repro.models.ssm as RSSM
import repro.models.transformer as RT
import repro.models.xlstm as RX
from repro.models.model_zoo import build as r_build
import repro_torch.configs.base as PCB
import repro_torch.models.common as PM
import repro_torch.models.ssm as PSSM
import repro_torch.models.transformer as PT
import repro_torch.models.xlstm as PX
import test_torch_models as TM
from repro_torch.convert import lm_params_from_arrays
from repro_torch.core.viterbi import _associative_scan
from repro_torch.models import build as p_build
from repro_torch.serve import ServeEngine, cache_bytes
from repro_torch.train.tree import tree_leaves, tree_map, tree_unflatten
from test_torch_models import BF16, FP32, ONE_BF16_ULP, _close, _spec_fields
from test_torch_train import (BF16_GRAD, FP32_GRAD, _np_batch, _port_batch, _port_loss_grads,
                              _port_params, _ref_loss_grads, _rel, _with)

torch.set_num_threads(1)

FAMILIES = ("jamba_v0_1_52b", "xlstm_350m")
B = 2
#: bf16 compute end to end (the reference's own tolerance for these
#: families' teacher forcing, tests/test_models_smoke.py)
BF16_STACK = dict(rtol=1e-1, atol=2e-1)


def _f32(arch):
    """The smoke config in float32 compute."""
    return (dataclasses.replace(RCB.get_smoke_arch(arch).model, compute_dtype="float32"),
            dataclasses.replace(PCB.get_smoke_arch(arch).model, compute_dtype="float32"))


def _mixer_params(specs_fn, cfg, seed):
    """The reference's init of one unstacked mixer, and the port's copy."""
    params = RM.init_params(specs_fn(cfg, 0), jax.random.PRNGKey(seed))
    return params, lm_params_from_arrays(jax.tree_util.tree_map(np.asarray, params), "cpu")


def _pair_np(tree):
    """A numpy tree as (reference tree, port tree); bf16 leaves are given as
    (float32 array, "bfloat16")."""
    if isinstance(tree, dict):
        pairs = {k: _pair_np(v) for k, v in tree.items()}
        return {k: p[0] for k, p in pairs.items()}, {k: p[1] for k, p in pairs.items()}
    x, dtype = tree if isinstance(tree, tuple) else (tree, "float32")
    # copies: the port writes its caches in place, and a reference array
    # may share the numpy buffer
    return jnp.array(x).astype(dtype), torch.tensor(x).to(getattr(torch, dtype))


def _jit(fn, cfg):
    """The reference's mixer function ``fn(params, cfg, x, cache=...)``,
    jitted over the config."""
    return jax.jit(lambda p, x, cache=None: fn(p, cfg, x, cache=cache))


def _x(rng, S, d):
    return rng.standard_normal((B, S, d)).astype(np.float32)


# --------------------------------------------------------------------------- #
# softplus, the pair scan                                                      #
# --------------------------------------------------------------------------- #


def test_softplus_is_jax_softplus():
    """``logaddexp(x, 0)`` at every x, its gradient too (``F.softplus``
    returns x past 20); the xLSTM gates' ``F.logsigmoid`` is
    ``jax.nn.log_sigmoid``."""
    x = np.concatenate([np.linspace(-60, 60, 241), [0.0, 19.99, 20.0, 20.01, 35.5]])
    x = x.astype(np.float32)
    want, want_g = jax.value_and_grad(lambda v: jax.nn.softplus(v).sum())(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    got = PSSM.softplus(xt)
    got.sum().backward()
    _close(got, jax.nn.softplus(jnp.asarray(x)), FP32)
    _close(xt.grad, want_g, FP32)
    _close(torch.nn.functional.logsigmoid(torch.from_numpy(x)),
           jax.nn.log_sigmoid(jnp.asarray(x)), FP32)


def _ref_combine(x, y):  # the reference's combine (a closure inside its scan)
    ax, bx = x
    ay, by = y
    return ax * ay, ay * bx + by


@pytest.mark.parametrize("n", [1, 2, 5, 12, 16])
def test_pair_associative_scan_matches_jax(n):
    rng = np.random.default_rng(n)
    a = rng.uniform(0.5, 1.0, (2, n, 3)).astype(np.float32)
    b = rng.standard_normal((2, n, 3)).astype(np.float32)
    want = jax.lax.associative_scan(_ref_combine, (jnp.asarray(a), jnp.asarray(b)), axis=1)
    got = _associative_scan(PSSM._combine, (torch.from_numpy(a), torch.from_numpy(b)), axis=1)
    for g, w in zip(got, want):
        _close(g, w, FP32)


# --------------------------------------------------------------------------- #
# the mixers                                                                   #
# --------------------------------------------------------------------------- #


def _ssm_cache(cfg, rng):
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    return {"ssm": rng.standard_normal((B, d_in, s.d_state)).astype(np.float32),
            "conv": (rng.standard_normal((B, s.d_conv - 1, d_in)).astype(np.float32),
                     "bfloat16")}


#: (S, chunk, with cache): one chunk, two, a divisor below the chunk (12 of
#: 16; 2 of 4 for S=14: seven chunks)
SSM_CASES = [(16, 16, False), (32, 16, False), (12, 16, True), (14, 4, True)]


@pytest.mark.parametrize("S,chunk,cached", SSM_CASES)
def test_ssm_apply_matches_reference(S, chunk, cached):
    rcfg, pcfg = _f32("jamba_v0_1_52b")
    rcfg = dataclasses.replace(rcfg, ssm=dataclasses.replace(rcfg.ssm, chunk=chunk))
    pcfg = dataclasses.replace(pcfg, ssm=dataclasses.replace(pcfg.ssm, chunk=chunk))
    rp, pp = _mixer_params(RSSM.ssm_specs, rcfg, S)
    rng = np.random.default_rng(S)
    rx, px = TM._both(_x(rng, S, rcfg.d_model), "float32")
    rc, pc = _pair_np(_ssm_cache(rcfg, rng)) if cached else (None, None)
    want, want_c = _jit(RSSM.ssm_apply, rcfg)(rp, rx, cache=rc)
    got, got_c = PSSM.ssm_apply(pp, pcfg, px, cache=pc)
    _close(got, want, FP32)
    if cached:
        assert got_c is pc and got_c["conv"].dtype == torch.bfloat16
        _close(got_c["ssm"], want_c["ssm"], FP32)
        _close(got_c["conv"], want_c["conv"], ONE_BF16_ULP)


def test_ssm_decode_matches_reference():
    rcfg, pcfg = _f32("jamba_v0_1_52b")
    rp, pp = _mixer_params(RSSM.ssm_specs, rcfg, 1)
    rng = np.random.default_rng(1)
    rc, pc = _pair_np(_ssm_cache(rcfg, rng))
    r_decode = _jit(RSSM.ssm_decode, rcfg)
    for _ in range(3):
        rx, px = TM._both(_x(rng, 1, rcfg.d_model), "float32")
        want, rc = r_decode(rp, rx, cache=rc)
        got, pc = PSSM.ssm_decode(pp, pcfg, px, cache=pc)
        _close(got, want, FP32)
        _close(pc["ssm"], rc["ssm"], FP32)
        _close(pc["conv"], rc["conv"], ONE_BF16_ULP)


def _mlstm_cache(cfg, rng):
    x = cfg.xlstm
    d_in = int(x.mlstm_proj_factor * cfg.d_model)
    H = cfg.n_heads
    dh = d_in // H
    return {"C": rng.standard_normal((B, H, dh, dh)).astype(np.float32),
            "n": rng.standard_normal((B, H, dh)).astype(np.float32),
            "m": rng.standard_normal((B, H)).astype(np.float32),
            "conv": (rng.standard_normal((B, x.conv_kernel - 1, d_in)).astype(np.float32),
                     "bfloat16")}


def _slstm_cache(cfg, rng):
    d = cfg.d_model
    st = {k: rng.standard_normal((B, d)).astype(np.float32) for k in ("c", "h", "m")}
    st["n"] = rng.uniform(0.5, 2.0, (B, d)).astype(np.float32)
    return {"state": st}


MIXERS = {
    "mlstm": (RX.mlstm_specs, RX.mlstm_apply, RX.mlstm_decode, PX.mlstm_apply,
              PX.mlstm_decode, _mlstm_cache),
    "slstm": (RX.slstm_specs, RX.slstm_apply, RX.slstm_decode, PX.slstm_apply,
              PX.slstm_decode, _slstm_cache),
}


def _close_state(got, want):
    """A mixer's written cache: float32 states by FP32, the bf16 conv window
    by ONE_BF16_ULP."""
    for k in want:
        if isinstance(want[k], dict):
            _close_state(got[k], want[k])
        else:
            _close(got[k], want[k], ONE_BF16_ULP if k == "conv" else FP32, k)


@pytest.mark.parametrize("S,cached", [(16, False), (32, False), (12, True)])
def test_mlstm_chunk_matches_reference(S, cached):
    """The chunkwise scan itself at chunk 16 (one chunk, two, and 12): its
    bf16 ``h`` by ONE_BF16_ULP, the final state by FP32."""
    rcfg, _ = _f32("xlstm_350m")
    H, dh = rcfg.n_heads, int(rcfg.xlstm.mlstm_proj_factor * rcfg.d_model) // rcfg.n_heads
    rng = np.random.default_rng(S)
    qkv = [rng.standard_normal((B, S, H, dh)).astype(np.float32) for _ in range(3)]
    gates = [rng.standard_normal((B, S, H)).astype(np.float32) for _ in range(2)]
    gates[1] = -np.logaddexp(0, -gates[1])  # log_f <= 0
    if cached:
        c = _mlstm_cache(rcfg, rng)
        state = [c["C"], c["n"], c["m"]]
    else:
        state = [np.zeros((B, H, dh, dh), np.float32), np.zeros((B, H, dh), np.float32),
                 np.full((B, H), -1e30, np.float32)]
    ref = [jnp.asarray(x) for x in qkv + gates]
    want_h, want_s = RX._mlstm_chunk(*ref, tuple(jnp.asarray(x) for x in state), 16)
    got_h, got_s = PX._mlstm_chunk(*(torch.from_numpy(x) for x in qkv + gates),
                                   tuple(torch.from_numpy(x) for x in state), 16)
    assert got_h.dtype == torch.bfloat16
    _close(got_h, want_h, ONE_BF16_ULP)
    for g, w in zip(got_s, want_s):
        _close(g, w, FP32)


@pytest.mark.parametrize("S,cached", [(32, False), (12, True)])
@pytest.mark.parametrize("mixer", sorted(MIXERS))
def test_xlstm_apply_matches_reference(mixer, S, cached):
    """The states by FP32.  The outputs lie downstream of the reference's
    bf16 ``h``: where one ``h`` element rounds the other way in one package
    an output element near zero moves by much more than its own ulp, so the
    output is held by its relative L2 error, within ONE_BF16_ULP's rtol.
    mLSTM at chunk 16: two chunks, and 12 (one chunk of 16: the model's
    prefill)."""
    specs, r_apply, _, p_apply, _, make_cache = MIXERS[mixer]
    rcfg, pcfg = _f32("xlstm_350m")
    rp, pp = _mixer_params(specs, rcfg, S)
    rng = np.random.default_rng(S)
    rx, px = TM._both(_x(rng, S, rcfg.d_model), "float32")
    rc, pc = _pair_np(make_cache(rcfg, rng)) if cached else (None, None)
    want, want_c = _jit(r_apply, rcfg)(rp, rx, cache=rc)
    got, got_c = p_apply(pp, pcfg, px, cache=pc)
    assert _rel(got, want) < ONE_BF16_ULP["rtol"]
    if cached:
        assert got_c is pc
        _close_state(got_c, want_c)


@pytest.mark.parametrize("mixer", sorted(MIXERS))
def test_xlstm_decode_matches_reference(mixer):
    """Three steps from a random cache (decode keeps ``h`` in float32)."""
    specs, _, r_decode, _, p_decode, make_cache = MIXERS[mixer]
    rcfg, pcfg = _f32("xlstm_350m")
    rp, pp = _mixer_params(specs, rcfg, 2)
    rng = np.random.default_rng(2)
    rc, pc = _pair_np(make_cache(rcfg, rng))
    r_decode = _jit(r_decode, rcfg)
    for _ in range(3):
        rx, px = TM._both(_x(rng, 1, rcfg.d_model), "float32")
        want, rc = r_decode(rp, rx, cache=rc)
        got, pc = p_decode(pp, pcfg, px, cache=pc)
        _close(got, want, FP32)
        _close_state(pc, rc)


def test_mlstm_grads_stay_finite_where_the_reference_overflows():
    """A chunk of 256 (xlstm-350m's): a masked weight's exponent passes ~88,
    and the reference's ``where(tri, exp(logD), 0)`` has a NaN gradient
    (0 * inf).  The port masks before the exp: the same forward, finite
    gradients, within ONE_BF16_ULP's rtol (relative L2) of its own at chunk
    64 (the same function chunked otherwise; chunk 16 is held against the
    reference by FP32_GRAD above)."""
    rcfg, pcfg = _f32("xlstm_350m")
    rcfg = dataclasses.replace(rcfg, xlstm=dataclasses.replace(rcfg.xlstm, chunk=256))
    rp, pp = _mixer_params(RX.mlstm_specs, rcfg, 4)
    x = _x(np.random.default_rng(4), 256, rcfg.d_model)
    want = jax.jit(jax.grad(lambda p, v: RX.mlstm_apply(p, rcfg, v)[0].sum()))(
        rp, jnp.asarray(x))
    assert not all(bool(jnp.isfinite(g).all()) for g in jax.tree_util.tree_leaves(want))

    def grads(chunk):
        cfg = dataclasses.replace(pcfg, xlstm=dataclasses.replace(pcfg.xlstm, chunk=chunk))
        leaves = [t.clone().requires_grad_() for t in tree_leaves(pp)]
        out = PX.mlstm_apply(tree_unflatten(pp, leaves), cfg, torch.from_numpy(x))[0]
        return torch.autograd.grad(out.sum(), leaves)

    got = grads(256)
    assert all(bool(torch.isfinite(g).all()) for g in got)
    errs = [_rel(g, w) for g, w in zip(got, grads(64))]
    assert max(errs) < ONE_BF16_ULP["rtol"], errs


# --------------------------------------------------------------------------- #
# the two families                                                             #
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("arch", FAMILIES)
def test_specs_caches_and_cache_bytes_equal_reference(arch):
    """Full width and smoke: the same param and cache spec trees (no
    allocation); ``init_cache`` equal to the reference's (the mLSTM's ``m``
    and the sLSTM's ``state.m`` at -1e30), and its bytes; the reference's
    parameters through ``lm_params_from_arrays``, key for key."""
    for get in ("get_arch", "get_smoke_arch"):
        rm, pm = r_build(getattr(RCB, get)(arch)), p_build(getattr(PCB, get)(arch), device="cpu")
        assert _spec_fields(pm.param_specs) == _spec_fields(rm.param_specs)
        assert _spec_fields(pm.cache_specs(4, 48)) == _spec_fields(rm.cache_specs(4, 48))
    want, got = rm.init_cache(B, 8), pm.init_cache(B, 8)
    _close(got, want, dict(rtol=0, atol=0))
    assert cache_bytes(pm, B, 8) == sum(t.nbytes for t in tree_leaves(got))
    # the reference's smoke parameters carry over key for key
    pp = lm_params_from_arrays(jax.tree_util.tree_map(np.asarray, TM._ref_params(arch)), "cpu")
    assert tree_map(lambda t: tuple(t.shape), pp) == PM.map_specs(lambda s: s.shape,
                                                                  pm.param_specs)


@pytest.mark.parametrize("arch", FAMILIES)
def test_prefill_and_decode_match_reference_fp32(arch):
    """Prefill logits and caches, then three decode steps' logits, in
    float32 compute at the tolerances ``test_torch_models`` holds the served
    families to (FP32, ONE_BF16_ULP, FP32_CACHED)."""
    TM.test_prefill_and_decode_match_reference(arch, "float32")


@functools.lru_cache(maxsize=None)
def _ref_block(arch, mixer, ffn):
    rm = TM._pair(arch, "bfloat16")[0]
    return jax.jit(lambda bp, x: RT.apply_block_full(bp, rm.cfg, rm.part, mixer, ffn, x))


@pytest.mark.parametrize("arch", FAMILIES)
def test_bf16_blocks_and_logits_match_reference(arch):
    """bf16 compute.  Each block of the stack, fed the port's input in both
    packages, by BF16; then prefill and three decode steps' logits end to
    end by BF16_STACK (the drift compounds through the recurrent states)."""
    rm, params, r_prefill, r_decode_step, pm, pp = TM._pair(arch, "bfloat16")
    rng = np.random.default_rng(8)
    toks = rng.integers(0, rm.cfg.vocab, (B, TM.S)).astype(np.int32)
    px = PT.embed_tokens(pp, pm.cfg, torch.from_numpy(toks))
    for g in range(pm.cfg.n_groups):
        for i, (mixer, ffn) in enumerate(pm.cfg.pattern):
            rbp = jax.tree_util.tree_map(lambda t: t[g], params["blocks"][f"p{i}"])
            want, _, _ = _ref_block(arch, mixer, ffn)(rbp, TM._both(px.float().numpy(),
                                                                    "bfloat16")[0])
            px, _, _ = PT.apply_block_full(PT._group(pp["blocks"][f"p{i}"], g), pm.cfg, pm.part,
                                           mixer, ffn, px)
            _close(px, want, BF16, f"group {g} block {i}")
    rc, pc = rm.init_cache(B, TM.S + 3), pm.init_cache(B, TM.S + 3)
    want, rc = r_prefill(params, {"tokens": jnp.asarray(toks)}, rc)
    got, pc = pm.prefill(pp, {"tokens": torch.from_numpy(toks)}, pc)
    _close(got, want, BF16_STACK)
    for i in range(3):
        tok, pos = rng.integers(0, rm.cfg.vocab, (B, 1)).astype(np.int32), np.full((B,), TM.S + i)
        want, rc = r_decode_step(params, jnp.asarray(tok), jnp.asarray(pos, np.int32), rc)
        got, pc = pm.decode_step(pp, torch.from_numpy(tok), torch.from_numpy(pos).int(), pc)
        _close(got, want, BF16_STACK)


@pytest.mark.parametrize("arch", FAMILIES)
def test_engine_greedy_tokens_equal_reference(arch):
    rm, params, _, _, pm, pp = TM._pair(arch, "float32")
    prompts = np.random.default_rng(9).integers(1, rm.cfg.vocab, (B, TM.S)).astype(np.int32)
    want = TM._ref_engine(arch).generate(jnp.asarray(prompts), TM.NEW)
    got = ServeEngine(pm, pp, max_len=TM.S + TM.NEW).generate(torch.from_numpy(prompts), TM.NEW)
    np.testing.assert_array_equal(got["tokens"].numpy(), np.asarray(want["tokens"]))
    np.testing.assert_array_equal(got["done"].numpy(), np.asarray(want["done"]))


#: the loss's rtol and each gradient leaf's relative L2 error bound, in
#: float32 compute: jamba by FP32_GRAD; xlstm's forward rounds ``h`` to bf16
#: in both packages, so its loss by ONE_BF16_ULP's rtol and its gradients by
#: BF16_GRAD (see the module docstring)
TRAIN_TOL = {"jamba_v0_1_52b": (FP32_GRAD, FP32_GRAD),
             "xlstm_350m": (ONE_BF16_ULP["rtol"], BF16_GRAD)}


@pytest.mark.parametrize("arch", FAMILIES)
def test_train_loss_and_grads_match_reference_fp32(arch):
    """The loss (jamba's with its MoE aux terms) and every gradient leaf;
    the port runs remat "full"."""
    loss_tol, grad_tol = TRAIN_TOL[arch]
    want_loss, want, want_m = _ref_loss_grads(arch, "float32", False, with_metrics=True)
    pm = p_build(_with(PCB.get_smoke_arch(arch), "float32", remat="full"), device="cpu")
    loss, metrics, grads = _port_loss_grads(pm, _port_params(arch),
                                            _port_batch(_np_batch(arch)))
    np.testing.assert_allclose(loss.item(), want_loss, rtol=loss_tol)
    for k in want_m:
        np.testing.assert_allclose(metrics[k].item(), want_m[k], rtol=loss_tol, err_msg=k)
    want = jax.tree_util.tree_leaves(want)
    assert len(grads) == len(want)
    errs = [_rel(g, w) for g, w in zip(grads, want)]
    assert max(errs) < grad_tol, errs


@pytest.mark.parametrize("mixer", sorted(MIXERS))
def test_xlstm_mixer_grads_match_reference(mixer):
    """One mixer alone (S=32, float32 compute): the gradients of a random
    projection of its output with respect to its parameters and input, each
    leaf by FP32_GRAD — without the stack behind it no rounding of ``h``
    differs between the packages' forward passes here."""
    specs, r_apply, _, p_apply, _, _ = MIXERS[mixer]
    rcfg, pcfg = _f32("xlstm_350m")
    rp, pp = _mixer_params(specs, rcfg, 3)
    rng = np.random.default_rng(3)
    x, proj = _x(rng, 32, rcfg.d_model), _x(rng, 32, rcfg.d_model)
    want = jax.grad(lambda p, v: (r_apply(p, rcfg, v)[0] * proj).sum(), argnums=(0, 1))(
        rp, jnp.asarray(x))
    leaves = [t.clone().requires_grad_() for t in tree_leaves(pp)]
    xt = torch.from_numpy(x).requires_grad_()
    out = p_apply(tree_unflatten(pp, leaves), pcfg, xt)[0]
    got = torch.autograd.grad((out * torch.from_numpy(proj)).sum(), leaves + [xt])
    want = jax.tree_util.tree_leaves(want[0]) + [want[1]]
    assert len(got) == len(want)
    errs = [_rel(g, w) for g, w in zip(got, want)]
    assert max(errs) < FP32_GRAD, errs
