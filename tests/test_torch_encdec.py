"""The port's encoder-decoder family (``models/encdec.py``, seamless-m4t)
and the dry-run inputs (``Model.input_specs``) held against the reference
on identical inputs.

* The specs (``encdec_specs``, its caches, ``block_specs(cross=True)``)
  at full width and smoke, and the reference's smoke parameters carried
  over by ``lm_params_from_arrays`` key for key.
* ``cross_kv`` and ``cross_attention`` (full and decode, with and without
  qk-norm) in float32; ``encode_frames`` in float32 and bf16.
* Prefill logits and both caches, then two decode steps, with a cache as
  long as the frames and one twice as long: the decode's cross-attention
  spans the whole cross cache, zero rows past the frames included, in both
  packages.
* ``train_loss`` and every gradient leaf (4 + 4 layers under remat
  "full", so ``remat_scan`` factors both stacks), one AdamW
  ``make_train_step`` step, and teacher forcing (prefill + one decode step
  against the full decoder pass).
* ``input_specs`` for all ten configurations at full width and the four
  ``SHAPES``; ``ServeEngine`` and the serving launcher refuse the family;
  the training launcher runs it.

Weights are the reference's ``init`` carried over by
``lm_params_from_arrays``; every other input is made with numpy.

Stated tolerances (from ``test_torch_models``/``test_torch_train``):
``FP32`` (rtol 1e-5) float32 compute without a bf16 cache read;
``ONE_BF16_ULP`` bf16 caches written from float32 values; ``FP32_CACHED``
(1e-2) decode logits over the bf16 caches; ``BF16`` bf16 compute;
``FP32_GRAD`` (2e-5) and ``BF16_GRAD`` (3e-2) the gradients' relative L2
error a leaf; ``STEP`` (1e-4, ``test_torch_moe``) one AdamW step.
``TEACHER`` (rtol 2e-2, atol 2e-2, ``tests/test_models_smoke.py``'s for
dense models): prefill + decode against the full decoder pass in float32.
The full pass computes the cross K/V from the encoder output in float32;
the decode reads them from the bf16 cross cache, so the two part by more
than ``FP32_CACHED`` (the reference's own gap: 0.0134 at these shapes).
"""
import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs.base as RCB
import repro.models.attention as RA
import repro.models.common as RM
import repro.models.encdec as RED
import repro.models.transformer as RT
from repro.models.model_zoo import build as r_build
from repro.train import optimizer as ropt
from repro.train.train_loop import make_train_step as r_make_train_step
import repro_torch.configs.base as PCB
import repro_torch.models.attention as PA
import repro_torch.models.common as PM
import repro_torch.models.encdec as PED
import repro_torch.models.transformer as PT
from repro_torch.convert import lm_params_from_arrays
from repro_torch.models import build as p_build
from repro_torch.serve import ServeEngine, cache_bytes
from repro_torch.train import optimizer as popt
from repro_torch.train.train_loop import make_train_step, read_metrics
from repro_torch.train.tree import tree_leaves, tree_map
from test_torch_models import (BF16, FP32, FP32_CACHED, ONE_BF16_ULP, _both, _close,
                               _input_leaves, _spec_fields)
from test_torch_train import BF16_GRAD, FP32_GRAD, _rel, _with

torch.set_num_threads(1)

ARCH = "seamless_m4t_large_v2"
B, S_ENC, S_DEC = 2, 16, 8  # frames, prompt tokens (prefill and decode)
S_TRAIN = 32  # train frames: S_TRAIN // dec_ratio = 8 decoder tokens
STEP = 1e-4
TEACHER = dict(rtol=2e-2, atol=2e-2)


def _bundles(compute_dtype="float32", layers=None, **part):
    """The smoke bundle of both packages in ``compute_dtype`` (``layers``
    encoder and decoder layers when given; partition fields ``part``)."""
    out = []
    for base in (RCB, PCB):
        b = _with(base.get_smoke_arch(ARCH), compute_dtype, **part)
        if layers:
            b = dataclasses.replace(b, model=dataclasses.replace(
                b.model, n_layers=layers, enc_layers=layers))
        out.append(b)
    assert dataclasses.asdict(out[0]) == dataclasses.asdict(out[1])
    return out


@functools.lru_cache(maxsize=None)
def _ref_params(layers=None):
    return jax.jit(r_build(_bundles(layers=layers)[0]).init)(jax.random.PRNGKey(0))


def _port_params(layers=None):
    return lm_params_from_arrays(jax.tree_util.tree_map(np.asarray, _ref_params(layers)), "cpu")


@functools.lru_cache(maxsize=None)
def _models(compute_dtype="float32", layers=None, **part):
    rb, pb = _bundles(compute_dtype, layers, **part)
    return r_build(rb), p_build(pb, device="cpu")


def _frames(rng, S):
    return rng.standard_normal((B, S, PCB.get_smoke_arch(ARCH).model.frontend_dim)).astype(
        np.float32)


def _tokens(rng, S):
    return rng.integers(0, PCB.get_smoke_arch(ARCH).model.vocab, (B, S)).astype(np.int32)


def _batches(np_batch):
    """A numpy batch as (reference batch, port batch); frames in bf16."""
    ref = {k: jnp.asarray(v, jnp.bfloat16 if k == "frames" else None)
           for k, v in np_batch.items()}
    port = {k: torch.from_numpy(v).to(torch.bfloat16 if k == "frames" else None)
            for k, v in np_batch.items()}
    return ref, port


def _train_batch(seed=1):
    rng = np.random.default_rng(seed)
    S = S_TRAIN // PCB.get_smoke_arch(ARCH).model.dec_ratio
    return {"frames": _frames(rng, S_TRAIN), "tokens": _tokens(rng, S),
            "labels": _tokens(rng, S)}


# --------------------------------------------------------------------------- #
# specs and parameters                                                         #
# --------------------------------------------------------------------------- #


def test_specs_and_params_equal_reference():
    """Full width and smoke: the param and cache spec trees (keys, shapes,
    axes, init); ``block_specs(cross=True)`` in the reference's key order;
    ``init_cache`` (zeros) and its bytes; the reference's smoke parameters
    through ``lm_params_from_arrays``, key for key."""
    for get in ("get_arch", "get_smoke_arch"):
        rm, pm = r_build(getattr(RCB, get)(ARCH)), p_build(getattr(PCB, get)(ARCH), device="cpu")
        assert _spec_fields(pm.param_specs) == _spec_fields(rm.param_specs)
        assert _spec_fields(pm.cache_specs(4, 48)) == _spec_fields(rm.cache_specs(4, 48))
        want = RT.block_specs(rm.cfg, "attn", "mlp", 3, cross=True)
        got = PT.block_specs(pm.cfg, "attn", "mlp", 3, cross=True)
        assert list(got) == list(want) == ["ln1", "mixer", "ln_cross", "cross", "ln2", "ffn"]
        assert _spec_fields(got) == _spec_fields(want)
    assert list(pm.param_specs["decoder"]) == ["ln1", "self", "ln_cross", "cross", "ln2", "mlp"]
    _close(pm.init_cache(B, 8), rm.init_cache(B, 8), dict(rtol=0, atol=0))
    assert cache_bytes(pm, B, 8) == sum(t.nbytes for t in tree_leaves(pm.init_cache(B, 8)))
    pp = _port_params()
    assert tree_map(lambda t: (tuple(t.shape), t.dtype), pp) == PM.map_specs(
        lambda s: (s.shape, s.dtype), pm.param_specs)
    _close(pp, _ref_params(), dict(rtol=0, atol=0))


# --------------------------------------------------------------------------- #
# cross-attention and the encoder                                              #
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("qk_norm", [False, True])
def test_cross_attention_and_kv_match_reference(qk_norm):
    """``cross_kv``, the full cross-attention and the decode one (over a
    cross cache twice the frames, its second half zero) in float32."""
    rcfg, pcfg = (dataclasses.replace(b.model, qk_norm=qk_norm) for b in _bundles())
    rp = RM.init_params(RA.attention_specs(rcfg, 0), jax.random.PRNGKey(3))
    pp = lm_params_from_arrays(jax.tree_util.tree_map(np.asarray, rp), "cpu")
    part = _bundles()[0].partition
    rng = np.random.default_rng(3)
    d = rcfg.d_model
    enc = rng.standard_normal((B, S_ENC, d)).astype(np.float32)
    x = rng.standard_normal((B, S_DEC, d)).astype(np.float32)
    want_kv = jax.jit(lambda p, e: RA.cross_kv(p, rcfg, e))(rp, jnp.asarray(enc))
    got_kv = PA.cross_kv(pp, pcfg, torch.from_numpy(enc))
    _close(got_kv, want_kv, FP32)
    want = jax.jit(lambda p, h, kv: RA.cross_attention(p, rcfg, part, h, enc_kv=kv))(
        rp, jnp.asarray(x), want_kv)
    _close(PA.cross_attention(pp, pcfg, part, torch.from_numpy(x), enc_kv=got_kv), want, FP32)
    # decode: one token over a cache of 2 S_ENC rows, the last S_ENC zero
    kv = {k: np.concatenate([np.asarray(v), np.zeros_like(v)], axis=1)
          for k, v in want_kv.items()}
    want = jax.jit(lambda p, h, kv: RA.cross_attention(p, rcfg, part, h, enc_kv=kv,
                                                       decode=True))(
        rp, jnp.asarray(x[:, :1]), tree_map(jnp.asarray, kv))
    got = PA.cross_attention(pp, pcfg, part, torch.from_numpy(x[:, :1]),
                             enc_kv=tree_map(torch.from_numpy, kv), decode=True)
    _close(got, want, FP32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encode_frames_matches_reference(dtype):
    rm, pm = _models(dtype)
    rf, pf = _both(_frames(np.random.default_rng(4), S_ENC), "bfloat16")
    want = jax.jit(lambda p, f: RED.encode_frames(p, rm.cfg, rm.part, f))(_ref_params(), rf)
    got = PED.encode_frames(_port_params(), pm.cfg, pm.part, pf)
    assert got.dtype == getattr(torch, dtype) and tuple(got.shape) == (B, S_ENC, pm.cfg.d_model)
    _close(got, want, FP32 if dtype == "float32" else BF16)


# --------------------------------------------------------------------------- #
# prefill and decode                                                           #
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("cache_len", [S_ENC, 2 * S_ENC])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_match_reference(dtype, cache_len):
    """Prefill logits and both caches (the cross cache holds the frames'
    K/V in its first S_ENC rows), then two decode steps' logits and caches.
    At ``cache_len`` 2 S_ENC both packages' decodes attend over the zero
    cross rows too (the reference's quirk, kept)."""
    rm, pm = _models(dtype)
    rparams, pparams = _ref_params(), _port_params()
    rng = np.random.default_rng(5)
    rb, pb = _batches({"frames": _frames(rng, S_ENC), "tokens": _tokens(rng, S_DEC)})
    steps = _tokens(rng, 2)
    rc, pc = rm.init_cache(B, cache_len), pm.init_cache(B, cache_len)
    want, rc = jax.jit(rm.prefill)(rparams, rb, rc)
    got, pc = pm.prefill(pparams, pb, pc)
    exact, cached = (FP32, FP32_CACHED) if dtype == "float32" else (BF16, BF16)
    _close(got, want, exact)
    _close(pc, rc, ONE_BF16_ULP if dtype == "float32" else BF16)
    assert not pc["cross"]["k"][:, :, S_ENC:].any()
    cross = tree_map(torch.clone, pc["cross"])
    r_decode = jax.jit(rm.decode_step)
    for i in range(2):
        pos = np.full((B,), S_DEC + i, np.int32)
        want, rc = r_decode(rparams, jnp.asarray(steps[:, i:i + 1]), jnp.asarray(pos), rc)
        got, pc = pm.decode_step(pparams, torch.from_numpy(steps[:, i:i + 1]),
                                 torch.from_numpy(pos), pc)
        _close(got, want, cached)
    # the decoded rows come from activations that read the bf16 caches
    _close(pc, rc, cached)
    assert all(torch.equal(pc["cross"][k], cross[k]) for k in cross)


def test_decode_attends_over_the_whole_cross_cache():
    """The same prefill and token at cache lengths S_ENC and 2 S_ENC give
    different decode logits in both packages (the zero rows take softmax
    weight), by the same amount."""
    rm, pm = _models()
    rparams, pparams = _ref_params(), _port_params()
    rng = np.random.default_rng(6)
    rb, pb = _batches({"frames": _frames(rng, S_ENC), "tokens": _tokens(rng, S_DEC)})
    tok, pos = _tokens(rng, 1), np.full((B,), S_DEC, np.int32)
    gaps = []
    for pkg in ("ref", "port"):
        out = []
        for n in (S_ENC, 2 * S_ENC):
            if pkg == "ref":
                c = jax.jit(rm.prefill)(rparams, rb, rm.init_cache(B, n))[1]
                out.append(np.asarray(jax.jit(rm.decode_step)(
                    rparams, jnp.asarray(tok), jnp.asarray(pos), c)[0]))
            else:
                c = pm.prefill(pparams, pb, pm.init_cache(B, n))[1]
                out.append(pm.decode_step(pparams, torch.from_numpy(tok),
                                          torch.from_numpy(pos), c)[0].numpy())
        gaps.append(np.abs(out[1] - out[0]).max())
    assert gaps[0] > 0.05 and gaps[1] > 0.05
    np.testing.assert_allclose(gaps[1], gaps[0], **FP32_CACHED)


def test_teacher_forcing_fp32():
    """prefill(S_DEC) + decode(token S_DEC) against the full decoder pass
    over S_DEC + 1 tokens at position S_DEC, in float32 compute: TEACHER
    and the same argmax in every row; the full pass itself equals the
    reference's by FP32."""
    rm, pm = _models()
    rparams, pparams = _ref_params(), _port_params()
    rng = np.random.default_rng(7)
    frames, toks = _frames(rng, S_ENC), _tokens(rng, S_DEC + 1)
    rb, pb = _batches({"frames": frames, "tokens": toks})
    with torch.no_grad():
        enc = PED.encode_frames(pparams, pm.cfg, pm.part, pb["frames"])
        x, _ = PED.decoder_forward(pparams, pm.cfg, pm.part, pb["tokens"], enc)
        full = PT.lm_head(pparams, pm.cfg, x)[:, S_DEC]
        caches = pm.init_cache(B, S_ENC)
        _, caches = pm.prefill(pparams, {"frames": pb["frames"], "tokens": pb["tokens"][:, :S_DEC]},
                               caches)
        dec, _ = pm.decode_step(pparams, pb["tokens"][:, S_DEC:],
                                torch.full((B,), S_DEC, dtype=torch.int32), caches)

    def ref_full(p, b):
        enc = RED.encode_frames(p, rm.cfg, rm.part, b["frames"])
        x, _ = RED.decoder_forward(p, rm.cfg, rm.part, b["tokens"], enc)
        return RT.lm_head(p, rm.cfg, x)[:, S_DEC]

    _close(full, jax.jit(ref_full)(rparams, rb), FP32)
    _close(dec, full, TEACHER)
    assert torch.equal(dec.argmax(-1), full.argmax(-1))


# --------------------------------------------------------------------------- #
# training                                                                     #
# --------------------------------------------------------------------------- #


#: (compute dtype, layers a stack): float32 at 4 + 4 layers, where
#: ``remat_scan`` factors each stack into checkpointed chunks; bf16 at the
#: smoke depth (2 + 2), where BF16_GRAD was set (``test_torch_train``'s bf16
#: test; at 4 + 4 the bf16 drift reaches 0.0303 relative L2 in one leaf)
TRAIN_CASES = [("float32", 4), ("bfloat16", None)]


@pytest.mark.parametrize("dtype,layers", TRAIN_CASES)
def test_train_loss_and_grads_match_reference(dtype, layers):
    """Remat "full" in both packages: the loss and every gradient leaf,
    float32 compute by FP32_GRAD; bf16 (the step's bf16 weight copy) by
    BF16_GRAD."""
    rm, pm = _models(dtype, layers, remat="full")
    rb, pb = _batches(_train_batch())
    rparams, pparams = _ref_params(layers), _port_params(layers)
    bf16 = dtype == "bfloat16"
    if bf16:
        rparams = jax.tree_util.tree_map(lambda p: p.astype(jnp.bfloat16), rparams)
    (want_loss, want_m), want = jax.jit(jax.value_and_grad(rm.train_loss, has_aux=True))(
        rparams, rb)
    copies = [(p.to(torch.bfloat16) if bf16 else p.clone()).requires_grad_()
              for p in tree_leaves(pparams)]
    it = iter(copies)
    loss, metrics = pm.train_loss(tree_map(lambda _: next(it), pparams), pb)
    grads = torch.autograd.grad(loss, copies)
    assert set(metrics) == set(want_m) == {"loss"}
    tol = BF16_GRAD if bf16 else FP32_GRAD
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=tol)
    want = jax.tree_util.tree_leaves(want)
    assert len(grads) == len(want)
    errs = [_rel(g, w) for g, w in zip(grads, want)]
    assert max(errs) < tol, errs


def test_adamw_train_step_matches_reference():
    """One ``make_train_step`` AdamW step (float32 compute, remat "full")
    from the same weights and batch: the loss by FP32_GRAD, every updated
    weight leaf by STEP."""
    (rb, pb), np_batch = _bundles("float32", remat="full"), _train_batch(2)
    r_opt, p_opt = ropt.adamw(), popt.adamw()
    rparams = _ref_params()
    r_step = r_make_train_step(r_build(rb), r_opt, ropt.cosine_warmup(1e-3, 0, 10),
                               donate=False)
    rbatch, pbatch = _batches(np_batch)
    want_p, _, want_m = r_step(rparams, r_opt.init(rparams), rbatch, 0)
    pparams = _port_params()
    got_p, _, got_m = make_train_step(p_build(pb, device="cpu"), p_opt,
                                      popt.cosine_warmup(1e-3, 0, 10))(
        pparams, p_opt.init(pparams), pbatch, 0)
    got_m = read_metrics(got_m)
    np.testing.assert_allclose(got_m["loss"], float(want_m["loss"]), rtol=FP32_GRAD)
    errs = [_rel(g, w) for g, w in zip(tree_leaves(got_p), jax.tree_util.tree_leaves(want_p))]
    assert len(errs) == len(jax.tree_util.tree_leaves(want_p)) and max(errs) < STEP, errs


# --------------------------------------------------------------------------- #
# the dry-run inputs                                                           #
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("arch", RCB.arch_ids())
def test_input_specs_equal_reference(arch):
    """Full width, every shape: the same keys, and leaf by leaf the same
    shape and dtype; every port leaf a ``meta`` tensor (nothing
    allocated)."""
    rm, pm = r_build(RCB.get_arch(arch)), p_build(PCB.get_arch(arch), device="cpu")
    for name, shape in PCB.SHAPES.items():
        want, got = rm.input_specs(RCB.SHAPES[name]), pm.input_specs(shape)
        assert jax.tree_util.tree_structure(tree_map(lambda _: 0, got)) == \
            jax.tree_util.tree_structure(jax.tree_util.tree_map(lambda _: 0, want)), name
        got_leaves, want_leaves = _input_leaves(got, want)
        assert got_leaves == want_leaves, name


# --------------------------------------------------------------------------- #
# serving and the launchers                                                    #
# --------------------------------------------------------------------------- #


def test_serve_engine_and_launcher_refuse_the_family():
    """``ServeEngine`` prefills from tokens alone: it refuses the
    encoder-decoder family with ``ValueError`` before any allocation (the
    reference fails inside its prefill with ``KeyError: 'frames'``), and
    the serving launcher reaches that refusal."""
    from repro_torch.launch.serve import main

    _, pm = _models()
    with pytest.raises(ValueError, match="Model.prefill and Model.decode_step"):
        ServeEngine(pm, _port_params(), max_len=16)
    with pytest.raises(ValueError, match="encoder-decoder"):
        main(["--arch", ARCH, "--smoke", "--device", "cpu", "--tokens", "2"])


def test_train_launcher_runs_the_family(monkeypatch):
    """``launch/train --arch seamless_m4t_large_v2 --smoke --device cpu``:
    SyntheticLM's frames and tokens through three steps, a finite loss."""
    import repro_torch.launch.train as launcher

    logged = []
    monkeypatch.setattr(launcher.log, "info", logged.append)
    launcher.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--steps", "3",
                   "--seq-len", "32", "--global-batch", "2"])
    report = json.loads(logged[-1])
    assert report["arch"] == "seamless-smoke" and report["steps"] == 3
    assert np.isfinite(report["final_metrics"]["loss"])
