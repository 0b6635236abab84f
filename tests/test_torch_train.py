"""The port's training path held against the reference on identical inputs:
``train_loss`` (loss and gradients) for the seven served smoke architectures
(the MoE families' losses with their aux terms),
the bf16 step's gradients, remat ``full``/``dots``/``none``, ``softmax_xent``
with ``valid`` and ``z_weight``, AdamW and Adafactor updates, the schedule
and clipping, microbatching, an 8-step overfit run's losses, crash ->
restore -> resume, checkpoints cross-loaded between the two packages,
``SyntheticLM`` and ``ViterbiStream``, the launcher and the refusals.

Weights are the reference's ``model.init`` carried over by
``lm_params_from_arrays``; every other input is made with numpy.

Stated tolerances (each comparison names the one it uses):

* ``FP32_GRAD`` (2e-5): float32 compute — the loss by rtol, each gradient
  leaf by its relative L2 error ``|got - want| / |want|`` (at most 2.9e-6
  seen, gemma3).  The products and reductions sum in different orders in
  the two packages.
* ``BF16_GRAD`` (3e-2, relative L2 error a leaf): the bf16 step's
  gradients, taken with respect to the bf16 copy (the gradients are bf16;
  at most 1.8e-2 seen).  XLA fuses elementwise chains and rounds once where
  eager torch rounds after every op: a few bf16 ulps (2^-8 each) over a
  leaf.
* ``OPT`` (1e-5): optimizer updates fed identical gradients — the global
  norm by rtol, each parameter and state leaf by its relative L2 error.
  The arithmetic is the reference's, but the norm's float32 sum over
  ~10^5 squares runs in another order (1.6e-6 apart at smoke size), which
  moves the clip scale, so ``nu`` (quadratic in it) by ~3e-6.
* ``SCHEDULE`` (rtol 1e-6): ``cosine_warmup`` and clipping on a few
  elements (XLA's and torch's ``cos`` may differ in the last ulp).
* ``OVERFIT`` (rtol 3e-3): the loss history of 8 bf16 steps at lr 5e-3
  (the bf16 rounding differences above, compounded over the steps; 8e-4
  seen).
* Everything else is exact: remat against no remat (the same ops
  recomputed), microbatching (the reference's own rtol 1e-4), crash ->
  restore -> resume, checkpoints, ``SyntheticLM`` batches.
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
import repro.models.transformer as RT
from repro.core.encoder import encode as r_encode
from repro.core.trellis import ConvCode as RConvCode
from repro.data.pipeline import SyntheticLM as RSyntheticLM
from repro.data.pipeline import ViterbiStream as RViterbiStream
from repro.models.model_zoo import build as r_build
from repro.train import checkpoint as rckpt
from repro.train import optimizer as ropt
from repro.train.train_loop import train as r_train
import repro_torch.configs.base as PCB
import repro_torch.models.attention as PA
import repro_torch.models.transformer as PT
from repro_torch.convert import lm_params_from_arrays
from repro_torch.core import CODE_K3_STD
from repro_torch.core.viterbi import viterbi_decode
from repro_torch.data import SyntheticLM, ViterbiStream, make_data_iter
from repro_torch.models import build as p_build
from repro_torch.train import checkpoint as pckpt
from repro_torch.train import optimizer as popt
from repro_torch.train.train_loop import build_step_fn, make_train_step, read_metrics, train
from repro_torch.train.tree import tree_leaves, tree_map
from test_torch_models import SERVED, _np, _ref_params, _spec_fields

torch.set_num_threads(1)

SRC = Path(__file__).resolve().parents[1] / "src"

FP32_GRAD = 2e-5
BF16_GRAD = 3e-2
OPT = 1e-5
SCHEDULE = dict(rtol=1e-6, atol=1e-12)
OVERFIT = dict(rtol=3e-3)
B, S = 2, 32


def _rel(got, want) -> float:
    g, w = _np(got).astype(np.float64), _np(want).astype(np.float64)
    assert g.shape == w.shape
    return float(np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30))


def _leaves_close(got, want, **tol):
    got, want = tree_leaves(got), jax.tree_util.tree_leaves(want)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(_np(g), _np(w), err_msg=f"leaf {i}", **tol)


def _with(bundle, compute_dtype=None, **part):
    if compute_dtype:
        bundle = dataclasses.replace(bundle, model=dataclasses.replace(
            bundle.model, compute_dtype=compute_dtype))
    if part:
        bundle = dataclasses.replace(bundle, partition=dataclasses.replace(
            bundle.partition, **part))
    return bundle


def _np_params(arch):
    return jax.tree_util.tree_map(np.asarray, _ref_params(arch))


def _port_params(arch):
    return lm_params_from_arrays(_np_params(arch), "cpu")


@functools.lru_cache(maxsize=None)
def _np_batch(arch, step=0):
    """A training batch of the arch's smoke config, as numpy (the port's
    ``SyntheticLM``; test_synthetic_lm_equals_reference holds it bit for bit
    against the reference's)."""
    cfg = PCB.get_smoke_arch(arch).model
    n_pre = cfg.n_prefix_tokens if cfg.modality == "vision" else 0
    data = SyntheticLM(cfg.vocab, S + n_pre, B, seed=1, n_prefix_tokens=n_pre,
                       frontend_dim=cfg.frontend_dim, mean_doc_len=8, device="cpu")
    return {k: v.float().numpy() if v.dtype == torch.bfloat16 else v.numpy()
            for k, v in data(step).items()}


def _ref_batch(np_batch):
    return {k: jnp.asarray(v, jnp.bfloat16 if k == "patches" else None)
            for k, v in np_batch.items()}


def _port_batch(np_batch):
    return {k: torch.from_numpy(v).to(torch.bfloat16 if k == "patches" else None)
            for k, v in np_batch.items()}


def _bf16_tree(tree):
    return jax.tree_util.tree_map(lambda p: p.astype(jnp.bfloat16), tree)


@functools.lru_cache(maxsize=None)
def _ref_loss_grads(arch, compute_dtype, bf16_params, with_metrics=False):
    rm = r_build(_with(RCB.get_smoke_arch(arch), compute_dtype))
    params = _ref_params(arch)
    if bf16_params:
        params = _bf16_tree(params)
    fn = jax.jit(jax.value_and_grad(rm.train_loss, has_aux=True))
    (loss, metrics), grads = fn(params, _ref_batch(_np_batch(arch)))
    if with_metrics:
        return float(loss), grads, {k: float(v) for k, v in metrics.items()}
    return float(loss), grads


def _port_loss_grads(model, params, batch, bf16_params=False):
    leaves = tree_leaves(params)
    copies = [(p.to(torch.bfloat16) if bf16_params else p.clone()).requires_grad_()
              for p in leaves]
    it = iter(copies)
    loss, metrics = model.train_loss(tree_map(lambda _: next(it), params), batch)
    return loss, metrics, torch.autograd.grad(loss, copies)


# --------------------------------------------------------------------------- #
# the loss and its gradients                                                   #
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("arch", SERVED)
def test_train_loss_and_grads_match_reference_fp32(arch):
    """The loss (for the MoE families the cross-entropy plus the aux
    terms), its metrics and every gradient leaf."""
    want_loss, want, want_m = _ref_loss_grads(arch, "float32", False, with_metrics=True)
    pm = p_build(_with(PCB.get_smoke_arch(arch), "float32"), device="cpu")
    loss, metrics, grads = _port_loss_grads(pm, _port_params(arch),
                                            _port_batch(_np_batch(arch)))
    np.testing.assert_allclose(loss.item(), want_loss, rtol=FP32_GRAD)
    assert set(metrics) == set(want_m) == {"loss", "load_balance_loss", "router_z_loss"}
    for k in want_m:
        np.testing.assert_allclose(metrics[k].item(), want_m[k], rtol=FP32_GRAD, err_msg=k)
    if pm.cfg.moe is None:
        assert metrics["load_balance_loss"].item() == 0.0 == metrics["router_z_loss"].item()
    else:
        assert loss.item() > metrics["loss"].item() and metrics["router_z_loss"].item() > 0
    want = jax.tree_util.tree_leaves(want)
    assert len(grads) == len(want)
    errs = [_rel(g, w) for g, w in zip(grads, want)]
    assert max(errs) < FP32_GRAD, errs


def test_bf16_step_grads_match_reference():
    """qwen2.5 in its served bf16 compute: gradients with respect to the
    bf16 copy of the weights, bf16 like the reference's."""
    arch = "qwen2_5_3b"
    want_loss, want = _ref_loss_grads(arch, None, True)
    pm = p_build(PCB.get_smoke_arch(arch), device="cpu")
    loss, _, grads = _port_loss_grads(pm, _port_params(arch), _port_batch(_np_batch(arch)),
                                      bf16_params=True)
    assert all(g.dtype == torch.bfloat16 for g in grads)
    np.testing.assert_allclose(loss.item(), want_loss, rtol=BF16_GRAD)
    errs = [_rel(g, w) for g, w in zip(grads, jax.tree_util.tree_leaves(want))]
    assert max(errs) < BF16_GRAD, errs


def test_softmax_xent_valid_and_z_weight_match_reference():
    rng = np.random.default_rng(2)
    logits = (rng.standard_normal((B, 6, 50)) * 4).astype(np.float32)
    labels = rng.integers(0, 50, (B, 6)).astype(np.int32)
    valid = (rng.random((B, 6)) < 0.7).astype(np.int32)
    for v, z in ((None, 0.0), (valid, 1e-4)):
        f = functools.partial(RT.softmax_xent, valid=None if v is None else jnp.asarray(v),
                              z_weight=z)
        want, want_g = jax.value_and_grad(lambda x: f(x, jnp.asarray(labels)))(
            jnp.asarray(logits))
        x = torch.from_numpy(logits).requires_grad_()
        got = PT.softmax_xent(x, torch.from_numpy(labels),
                              None if v is None else torch.from_numpy(v), z_weight=z)
        got.backward()
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
        assert _rel(x.grad, want_g) < 1e-6


def _count_checkpoints(monkeypatch):
    """Counts of ``torch.utils.checkpoint.checkpoint`` calls made by the
    block stack and by attention's key-block loop."""
    counts = {"transformer": 0, "attention": 0}
    for name, mod in (("transformer", PT), ("attention", PA)):
        real = mod.checkpoint

        def counted(*args, _name=name, _real=real, **kw):
            counts[_name] += 1
            return _real(*args, **kw)

        monkeypatch.setattr(mod, "checkpoint", counted)
    return counts


@pytest.mark.parametrize("remat,scan", [("full", True), ("dots", True), ("full", False)])
def test_remat_policies_give_the_grads_of_no_remat(remat, scan, monkeypatch):
    """qwen2.5's smoke model at 4 layers: with ``scan_layers`` the 4 groups
    run as 2 checkpointed chunks of 2 around the block checkpoints (the
    sqrt(L) factorisation); without, a plain loop of block checkpoints.
    Gradients equal ``remat="none"``'s exactly."""
    base = PCB.get_smoke_arch("qwen2_5_3b")
    base = dataclasses.replace(base, model=dataclasses.replace(base.model, n_layers=4))
    plain = p_build(_with(base, remat="none"), device="cpu")
    params = plain.init(torch.Generator().manual_seed(3))
    batch = _port_batch(_np_batch("qwen2_5_3b"))
    counts = _count_checkpoints(monkeypatch)
    want_loss, _, want = _port_loss_grads(plain, params, batch, bf16_params=True)
    assert counts["transformer"] == 0 and counts["attention"] > 0
    counts["attention"] = 0
    model = p_build(_with(base, remat=remat, scan_layers=scan), device="cpu")
    loss, _, grads = _port_loss_grads(model, params, batch, bf16_params=True)
    # forward: the 2 chunks and the 4 blocks; backward: each chunk recomputed
    # runs its 2 block checkpoints again
    assert counts["transformer"] == (2 + 4 + 4 if scan else 4)
    assert loss.item() == want_loss.item()
    for g, w in zip(grads, want):
        assert torch.equal(g, w)


def test_inference_runs_no_checkpoint(monkeypatch):
    """The serving path (prefill and decode under ``inference_mode``)
    checkpoints nothing, whatever the remat policy."""
    pm = p_build(_with(PCB.get_smoke_arch("qwen2_5_3b"), remat="full"), device="cpu")
    params = _port_params("qwen2_5_3b")
    counts = _count_checkpoints(monkeypatch)
    with torch.inference_mode():
        caches = pm.init_cache(B, S + 1)
        tokens = torch.from_numpy(_np_batch("qwen2_5_3b")["tokens"])
        pm.prefill(params, {"tokens": tokens}, caches)
        pm.decode_step(params, tokens[:, :1], torch.full((B,), S, dtype=torch.int32), caches)
    assert counts == {"transformer": 0, "attention": 0}


# --------------------------------------------------------------------------- #
# optimizers, schedule, clipping                                               #
# --------------------------------------------------------------------------- #


OPTIMIZERS = {
    "adamw": {},
    "adafactor": {},
    "adafactor_factored": {"min_dim_size_to_factor": 8},
    "adafactor_decay": {"min_dim_size_to_factor": 8, "weight_decay": 0.1},
}


def _leaves_rel(got, want, tol):
    errs = [_rel(g, w) for g, w in zip(tree_leaves(got), jax.tree_util.tree_leaves(want))]
    assert len(errs) == len(jax.tree_util.tree_leaves(want)) and max(errs) < tol, errs


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizer_updates_match_reference(name):
    """Three updates, each fed the same bf16 gradients (as the step hands
    them over; the first is clipped), held after the first and the third."""
    factory = name.split("_")[0]
    r = getattr(ropt, factory)(**OPTIMIZERS[name])
    p = getattr(popt, factory)(**OPTIMIZERS[name])
    rparams, pparams = _ref_params("qwen2_5_3b"), _port_params("qwen2_5_3b")
    rstate, pstate = r.init(rparams), p.init(pparams)
    rupdate = jax.jit(r.update)
    rng = np.random.default_rng(3)
    rlr, plr = ropt.cosine_warmup(1e-2, 0, 10), popt.cosine_warmup(1e-2, 0, 10)
    for step in range(3):
        scale = 10.0 if step == 0 else 0.01
        g_np = jax.tree_util.tree_map(
            lambda x: (rng.standard_normal(x.shape) * scale).astype(np.float32), rparams)
        rg = jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.bfloat16), g_np)
        pg = tree_map(lambda x: torch.from_numpy(x).to(torch.bfloat16), g_np)
        rparams, rstate, rnorm = rupdate(rg, rstate, rparams, step, rlr(step))
        same, pstate, pnorm = p.update(pg, pstate, pparams, step, plr(step))
        assert same is pparams  # in place
        np.testing.assert_allclose(pnorm.item(), float(rnorm), rtol=OPT)
        if step in (0, 2):
            _leaves_rel(pparams, rparams, OPT)
            _leaves_rel(pstate, rstate, OPT)
    assert _spec_fields(p.state_specs(p_build(PCB.get_arch("qwen2_5_3b"),
                                              device="cpu").param_specs)) == \
        _spec_fields(r.state_specs(r_build(RCB.get_arch("qwen2_5_3b")).param_specs))


def test_adafactor_state_is_factored():
    pm = p_build(PCB.get_smoke_arch("qwen2_5_3b"), device="cpu")
    params = pm.init(torch.Generator().manual_seed(0))
    state = popt.adafactor(min_dim_size_to_factor=8).init(params)
    p_bytes = sum(x.numel() * 4 for x in tree_leaves(params))
    s_bytes = sum(x.numel() * x.element_size() for x in tree_leaves(state))
    assert s_bytes < 0.8 * p_bytes


def test_cosine_warmup_and_clipping_match_reference():
    for args in ((3e-4, 5, 20), (1e-3, 0, 10), (5e-3, 2, 8, 0.3)):
        r, p = ropt.cosine_warmup(*args), popt.cosine_warmup(*args)
        for step in range(25):
            got = p(step)
            assert got.dtype == torch.float32 and got.device.type == "cpu"
            np.testing.assert_allclose(got.item(), float(r(step)), **SCHEDULE)
    rng = np.random.default_rng(4)
    tree = {"a": rng.standard_normal((3, 4)).astype(np.float32),
            "b": {"c": rng.standard_normal(7).astype(np.float32) * 5}}
    for dtype in ("float32", "bfloat16"):
        rtree = jax.tree_util.tree_map(lambda x: jnp.asarray(x, dtype), tree)
        ptree = tree_map(lambda x: torch.from_numpy(x).to(getattr(torch, dtype)), tree)
        for max_norm in (1.0, 1e3):
            want, want_n = ropt.clip_by_global_norm(rtree, max_norm)
            got, got_n = popt.clip_by_global_norm(ptree, max_norm)
            np.testing.assert_allclose(got_n.item(), float(want_n), **SCHEDULE)
            assert all(g.dtype == torch.float32 for g in tree_leaves(got))
            _leaves_close(got, want, **SCHEDULE)


# --------------------------------------------------------------------------- #
# the step and the loop                                                        #
# --------------------------------------------------------------------------- #


def test_microbatch_equals_full_batch():
    """Gradient accumulation is exact: mb=2 and mb=1 produce the same
    updated params on the same batch (the reference's test and rtol)."""
    base = PCB.get_smoke_arch("qwen2_5_3b")
    opt = popt.adamw()
    lr_fn = popt.cosine_warmup(1e-3, 1, 10)
    batch = _port_batch(_np_batch("qwen2_5_3b"))
    out = []
    for mb in (1, 2):
        m = p_build(_with(base, microbatches=mb), device="cpu")
        params = _port_params("qwen2_5_3b")
        p, _, met = build_step_fn(m, opt, lr_fn)(params, opt.init(params), batch, 0)
        out.append((p, read_metrics(met)))
    (p1, met1), (p2, met2) = out
    np.testing.assert_allclose(met1["loss"], met2["loss"], rtol=1e-4)
    for a, b in zip(tree_leaves(p1), tree_leaves(p2)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4, atol=1e-5)


def test_donate_false_leaves_the_inputs_alone():
    m = p_build(PCB.get_smoke_arch("qwen2_5_3b"), device="cpu")
    opt = popt.adamw()
    params = _port_params("qwen2_5_3b")
    state = opt.init(params)
    before = [t.clone() for t in tree_leaves((params, state))]
    batch = _port_batch(_np_batch("qwen2_5_3b"))
    new_p, new_s, _ = make_train_step(m, opt, popt.cosine_warmup(1e-3, 0, 10), donate=False)(
        params, state, batch, 0)
    assert all(torch.equal(a, b) for a, b in zip(before, tree_leaves((params, state))))
    assert not torch.equal(tree_leaves(new_p)[0], tree_leaves(params)[0])


def _overfit(report):
    return [h["loss"] for h in report["history"]]


def test_overfit_loss_history_matches_reference():
    """8 steps on one fixed batch (the reference's test_loss_decreases_overfit)
    from the same initial weights."""
    arch = "qwen2_5_3b"
    rm = r_build(RCB.get_smoke_arch(arch))
    fixed = _np_batch(arch)
    rb, pb = _ref_batch(fixed), _port_batch(fixed)
    want = _overfit(r_train(rm, lambda step: rb, steps=8, lr=5e-3, warmup=2, log_every=1))
    pm = p_build(PCB.get_smoke_arch(arch), device="cpu")
    pm.init = lambda gen: _port_params(arch)  # the reference's initial weights
    report = train(pm, lambda step: pb, steps=8, lr=5e-3, warmup=2, log_every=1)
    got = _overfit(report)
    assert got[-1] < got[0] * 0.9, got
    np.testing.assert_allclose(got, want, **OVERFIT)
    assert [h["step"] for h in report["history"]] == list(range(8))
    assert set(report["history"][0]) == {"step", "time_s", "loss", "grad_norm", "lr",
                                         "load_balance_loss", "router_z_loss"}


def test_crash_restore_resume_equals_uninterrupted_run(tmp_path):
    """A simulated node failure after step 5 restores the step-6 checkpoint
    and resumes: the final weights, optimizer state and loss history equal
    an uninterrupted run's exactly."""
    pm = p_build(PCB.get_smoke_arch("qwen2_5_3b"), device="cpu")
    data = make_data_iter(pm, dataclasses.replace(PCB.SHAPES["train_4k"], seq_len=S,
                                                  global_batch=B))
    kw = dict(steps=8, lr=1e-3, warmup=1, log_every=1)
    clean = train(pm, data, **kw)
    crashed = {"done": False}

    def fail_hook(step):
        if step == 5 and not crashed["done"]:
            crashed["done"] = True
            raise pckpt.SimulatedFailure("node lost")

    report = train(pm, data, checkpoint_dir=str(tmp_path), checkpoint_every=2,
                   fail_hook=fail_hook, **kw)
    assert report["restarts"] == 1 and report["final_step"] == 8 and crashed["done"]
    assert _overfit(report) == _overfit(clean)
    for a, b in zip(tree_leaves((report["params"], report["opt_state"])),
                    tree_leaves((clean["params"], clean["opt_state"]))):
        assert torch.equal(a, b)
    assert sorted(os.listdir(tmp_path)) == ["step_00000004", "step_00000006",
                                            "step_00000008"]


def test_checkpoint_gc_keeps_newest(tmp_path):
    params = _port_params("qwen2_5_3b")
    state = popt.adamw().init(params)
    saver = pckpt.AsyncCheckpointer(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        saver.save(s, params, state)
    saver.wait()
    assert sorted(os.listdir(tmp_path)) == ["step_00000003", "step_00000004"]
    assert saver.latest_path().endswith("step_00000004")


def test_checkpoints_cross_load_between_the_packages(tmp_path):
    """The reference's checkpoint loads in the port and the port's in the
    reference: every array equal, the manifests alike."""
    rparams = _ref_params("qwen2_5_3b")
    rstate = ropt.adamw().init(rparams)
    rstate = jax.tree_util.tree_map(lambda x: x + 0.5, rstate)
    pparams = _port_params("qwen2_5_3b")
    pstate = tree_map(lambda x: x + 0.5, popt.adamw().init(pparams))
    rsaver = rckpt.AsyncCheckpointer(str(tmp_path / "ref"))
    rsaver.save(5, rparams, rstate)
    rsaver.wait()
    got_p, got_s, step = pckpt.reshard_restored(rsaver.latest_path(), pparams, pstate)
    assert step == 5
    _leaves_close((got_p, got_s), (rparams, rstate), rtol=0, atol=0)
    assert all(t.dtype == torch.float32 and t.device.type == "cpu"
               for t in tree_leaves((got_p, got_s)))

    psaver = pckpt.AsyncCheckpointer(str(tmp_path / "port"))
    psaver.save(7, pparams, pstate)
    psaver.wait()
    want_p, want_s, step = rckpt.reshard_restored(psaver.latest_path(), rparams, rstate)
    assert step == 7
    _leaves_close((pparams, pstate), (want_p, want_s), rtol=0, atol=0)
    manifests = [json.loads((Path(s.latest_path()) / "manifest.json").read_text())
                 for s in (rsaver, psaver)]
    assert manifests[0]["treedef"] == manifests[1]["treedef"]
    assert manifests[0]["n_leaves"] == manifests[1]["n_leaves"]


# --------------------------------------------------------------------------- #
# data                                                                         #
# --------------------------------------------------------------------------- #


SYNTHETIC = {
    "lm": dict(vocab=512, seq_len=64, global_batch=4, seed=3, mean_doc_len=16),
    "vision": dict(vocab=300, seq_len=40, global_batch=2, n_prefix_tokens=8, frontend_dim=12),
    "encdec": dict(vocab=300, seq_len=48, global_batch=2, frontend_dim=16, family="encdec",
                   dec_ratio=4, seed=5),
}


@pytest.mark.parametrize("family", sorted(SYNTHETIC))
def test_synthetic_lm_equals_reference(family):
    kw = SYNTHETIC[family]
    r, p = RSyntheticLM(**kw), SyntheticLM(**kw, device="cpu")
    for step in (0, 7):
        want, got = r(step), p(step)
        assert set(got) == set(want)
        for k in want:
            w = np.asarray(want[k])
            g = got[k]
            assert str(g.dtype).replace("torch.", "") == str(w.dtype), k
            if g.dtype == torch.bfloat16:
                g, w = g.view(torch.int16).numpy(), w.view(np.int16)
            np.testing.assert_array_equal(g, w, err_msg=k)


def test_viterbi_stream_shapes_noiseless_decode_and_coding():
    rcode = RConvCode(3, (0b111, 0b101))
    want = RViterbiStream(rcode, 40, 3, seed=2)(0)
    stream = ViterbiStream(CODE_K3_STD, 40, 3, seed=2, device="cpu")
    got = stream(0)
    for k in want:
        assert tuple(got[k].shape) == tuple(want[k].shape), k
        assert str(got[k].dtype).replace("torch.", "") == str(want[k].dtype), k
    np.testing.assert_array_equal(got["coded"].numpy(),
                                  np.asarray(r_encode(rcode, jnp.asarray(got["info_bits"].numpy()))))
    assert torch.equal(stream(0)["received"], got["received"])  # a function of (seed, step)
    assert not torch.equal(stream(1)["info_bits"], got["info_bits"])
    clean = ViterbiStream(CODE_K3_STD, 40, 3, flip_prob=0.0, seed=2, device="cpu")(4)
    assert torch.equal(clean["received"], clean["coded"])
    bits, metric = viterbi_decode(CODE_K3_STD, clean["bm_tables"])
    assert torch.equal(bits[:, :40], clean["info_bits"]) and (metric == 0).all()


# --------------------------------------------------------------------------- #
# launcher and refusals                                                        #
# --------------------------------------------------------------------------- #


def _logged_json(stdout: str) -> dict:
    lines = stdout.splitlines()
    start = max(i for i, line in enumerate(lines) if line == "{")
    return json.loads("\n".join(lines[start:]))


def test_launcher_smoke_on_cpu(tmp_path):
    env = {**os.environ, "PYTHONPATH": str(SRC)}
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", "qwen2_5_3b", "--smoke",
         "--device", "cpu", "--steps", "3", "--warmup", "1", "--seq-len", "32",
         "--checkpoint-dir", str(tmp_path), "--checkpoint-every", "2"],
        env=env, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr
    assert "training qwen2.5-smoke on cpu" in proc.stdout
    out = _logged_json(proc.stdout)
    assert set(out) == {"arch", "steps", "restarts", "straggler_events", "final_metrics"}
    assert out["arch"] == "qwen2.5-smoke" and out["steps"] == 3 and out["restarts"] == 0
    assert np.isfinite(out["final_metrics"]["loss"])
    assert os.listdir(tmp_path) == ["step_00000002"]


@pytest.mark.parametrize("flags", [["--distributed", "--mesh", "single"],
                                   ["--distributed", "--mesh", "host"], ["--distributed"]])
def test_launcher_refuses_a_mesh_naming_item_9b(flags):
    """``--distributed`` (multi-process) waits for item 9b.3 with any mesh;
    ``--mesh host`` runs data-parallel (``tests/test_torch_lm_mesh.py``)."""
    from repro_torch.launch.train import main

    with pytest.raises(NotImplementedError, match="item 9b"):
        main(["--arch", "qwen2_5_3b", "--smoke", "--device", "cpu", *flags])


def test_launcher_defaults_to_the_card():
    """Without ``--device`` the launcher asks for the card; here there is
    none, so it fails instead of running the CPU."""
    from repro_torch.launch.train import main

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--arch", "qwen2_5_3b", "--smoke", "--steps", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SyntheticLM(64, 8, 2)(0)


def _mesh(shape):
    from repro_torch.launch.mesh import make_mesh

    return make_mesh(shape, ("data", "model"), devices=["cpu"] * int(np.prod(shape)))


# tensor parallelism (a (1, 2) mesh splits heads, ff and vocab) and FSDP (the
# embed dim over data) raise naming item 9b.3; data parallelism runs
# (tests/test_torch_lm_mesh.py), and so do ``rules`` off the mesh
MESH_CALLS = {
    "train_loss": lambda pm, pp, opt: pm.train_loss(pp, {}, mesh=_mesh((1, 2))),
    "softmax_xent": lambda pm, pp, opt: PT.softmax_xent(torch.zeros(1, 1, 4),
                                                         torch.zeros(1, 1, dtype=torch.int32),
                                                         mesh=_mesh((1, 2))),
    "build_step_fn": lambda pm, pp, opt: build_step_fn(pm, opt, lambda s: 0.0,
                                                       mesh=_mesh((1, 2))),
    "make_train_step": lambda pm, pp, opt: make_train_step(pm, opt, lambda s: 0.0,
                                                           mesh=_mesh((2, 1)),
                                                           rules={"embed": "data"}),
    "train": lambda pm, pp, opt: train(pm, None, steps=1, mesh=_mesh((1, 2))),
}


@pytest.mark.parametrize("call", sorted(MESH_CALLS))
def test_training_mesh_raises_naming_item_9b(call):
    pm = p_build(PCB.get_smoke_arch("qwen2_5_3b"), device="cpu")
    with pytest.raises(NotImplementedError, match="item 9b"):
        MESH_CALLS[call](pm, None, popt.adamw())
