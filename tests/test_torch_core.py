"""The PyTorch port's numeric core (repro_torch.core) held against the JAX
reference (repro.core) on identical numpy inputs, plus the port's import
isolation: repro_torch never imports jax or the reference package."""
import ast
import os
import subprocess
import sys
import zlib
from pathlib import Path

import jax  # noqa: F401  (both frameworks in one process; JAX stays on the CPU)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as R
from repro.core import puncture as R_punct
from repro_torch import core as P
from repro_torch.core import puncture as P_punct

torch.set_num_threads(1)

SRC = Path(__file__).resolve().parents[1] / "src"

#: (constraint, polys) of every named code plus a rate-1/3 and a K=2 code
CODES = {
    "k2": (2, (0b11, 0b10)),
    "k3": (3, (0b111, 0b101)),
    "k3paper": (3, (0b110, 0b010)),
    "k5": (5, (0b10011, 0b11101)),
    "k4r13": (4, (0o15, 0o13, 0o17)),
    "k7": (7, (0o171, 0o133)),
}
TABLES = (
    "branch_code", "next_state", "butterfly_code", "butterfly_onehot",
    "select_matrices", "branch_onehot_pair", "hamming_table", "symbol_bits",
)


def _pair(name):
    K, polys = CODES[name]
    return R.ConvCode(K, polys), P.ConvCode(K, polys)


def _eq(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# --------------------------------------------------------------------------- #
# trellis tables                                                               #
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("name", sorted(CODES))
def test_conv_code_tables_match(name):
    rc, pc = _pair(name)
    assert (pc.n_out, pc.n_states, pc.n_symbols) == (rc.n_out, rc.n_states, rc.n_symbols)
    for table in TABLES:
        ra, pa = getattr(rc, table), getattr(pc, table)
        if isinstance(ra, tuple):
            assert len(ra) == len(pa)
            for x, y in zip(ra, pa):
                assert x.dtype == y.dtype
                _eq(x, y)
        else:
            assert ra.dtype == pa.dtype, table
            _eq(ra, pa)


def test_named_codes_and_unreachable_match():
    for rname in ("CODE_K3_STD", "CODE_K3_PAPER", "CODE_K5_GSM", "CODE_K7_NASA"):
        rc, pc = getattr(R, rname), getattr(P, rname)
        assert (rc.constraint, rc.polys) == (pc.constraint, pc.polys)
    from repro.core.trellis import NEG_UNREACHABLE

    assert P.NEG_UNREACHABLE == NEG_UNREACHABLE
    assert np.float32(P.NEG_UNREACHABLE) == np.float32(NEG_UNREACHABLE)


@pytest.mark.parametrize("args", [(1, (1,)), (3, (0b1000,)), (3, (-1,))])
def test_conv_code_validation_matches(args):
    with pytest.raises(ValueError):
        R.ConvCode(*args)
    with pytest.raises(ValueError):
        P.ConvCode(*args)


# --------------------------------------------------------------------------- #
# encoder                                                                      #
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("name", ["k2", "k3", "k4r13", "k7"])
@pytest.mark.parametrize("terminate", [True, False], ids=["term", "open"])
def test_encode_matches(name, terminate):
    rc, pc = _pair(name)
    bits = np.random.default_rng(7).integers(0, 2, (3, 41)).astype(np.int32)
    ref = R.encode(rc, jnp.asarray(bits), terminate=terminate)
    out = P.encode(pc, torch.from_numpy(bits), terminate=terminate)
    assert out.dtype == torch.int32
    _eq(out, ref)


@pytest.mark.parametrize("name", ["k3", "k4r13"])
def test_pack_unpack_symbols_match(name):
    rc, pc = _pair(name)
    coded = np.random.default_rng(1).integers(0, 2, (2, 9, pc.n_out)).astype(np.int32)
    rsym = R.pack_symbols(rc, jnp.asarray(coded))
    psym = P.pack_symbols(pc, torch.from_numpy(coded))
    _eq(psym, rsym)
    _eq(P.unpack_symbols(pc, psym), R.unpack_symbols(rc, rsym))
    _eq(P.unpack_symbols(pc, psym), coded)


# --------------------------------------------------------------------------- #
# channels and branch metrics                                                  #
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("name", ["k3", "k4r13", "k7"])
def test_hard_and_soft_branch_metrics_match(name):
    rc, pc = _pair(name)
    rng = np.random.default_rng(3)
    hard = rng.integers(0, 2, (2, 17, pc.n_out)).astype(np.int32)
    soft = rng.standard_normal((2, 17, pc.n_out)).astype(np.float32)
    _eq(P.hard_branch_metrics(pc, torch.from_numpy(hard)),
        R.hard_branch_metrics(rc, jnp.asarray(hard)))
    # each entry is a sum of n_out terms x*(+-1): exact in float32 whatever
    # the order for n_out = 2; n_out = 3 may round in either order
    np.testing.assert_allclose(
        P.soft_branch_metrics(pc, torch.from_numpy(soft)).numpy(),
        np.asarray(R.soft_branch_metrics(rc, jnp.asarray(soft))), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("pattern_name", ["PUNCTURE_2_3", "PUNCTURE_3_4", "PUNCTURE_5_6"])
def test_punctured_metrics_and_mask_match(pattern_name):
    rc, pc = _pair("k7")
    pattern = getattr(R_punct, pattern_name)
    _eq(getattr(P_punct, pattern_name), pattern)
    for T in (1, 7, 30):
        _eq(P_punct.pattern_mask(pc, T, pattern), R_punct.pattern_mask(rc, T, pattern))
    rx = np.random.default_rng(5).integers(0, 2, (3, 23, 2)).astype(np.int32)
    _eq(P.punctured_hard_metrics(pc, torch.from_numpy(rx), pattern),
        R.punctured_hard_metrics(rc, jnp.asarray(rx), pattern))


def test_bpsk_and_channel_helpers():
    coded = np.random.default_rng(2).integers(0, 2, (4, 50, 2)).astype(np.int32)
    tc = torch.from_numpy(coded)
    _eq(P.bpsk_modulate(tc), R.bpsk_modulate(jnp.asarray(coded)))
    gen = torch.Generator().manual_seed(11)
    _eq(P.bsc(gen, tc, 0.0), coded)
    _eq(P.bsc(gen, tc, 1.0), 1 - coded)
    a = P.bsc(torch.Generator().manual_seed(5), tc, 0.3)
    b = P.bsc(torch.Generator().manual_seed(5), tc, 0.3)
    _eq(a, b)  # same seed, same flips
    assert 0.2 < float((a != tc).float().mean()) < 0.4
    sym = P.bpsk_modulate(torch.zeros((20000,)))
    y = P.awgn(torch.Generator().manual_seed(3), sym, snr_db=0.0)
    sigma = np.sqrt(1.0 / 2.0)
    assert abs(float((y - sym).mean())) < 0.03
    assert abs(float((y - sym).std()) - sigma) < 0.03


# --------------------------------------------------------------------------- #
# ACS step and the sequential oracle                                           #
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("name", ["k2", "k3", "k5", "k7"])
def test_acs_step_matches(name):
    rc, pc = _pair(name)
    rng = np.random.default_rng(4)
    S, M = pc.n_states, pc.n_symbols
    # integer metrics make ties common; a few unreachable states ride along
    pm = rng.integers(0, 4, (6, S)).astype(np.float32)
    pm[:, 1::3] = P.NEG_UNREACHABLE
    bm = rng.integers(0, 3, (6, M)).astype(np.float32)
    rpm, rbp = R.acs_step(rc, jnp.asarray(pm), jnp.asarray(bm))
    ppm, pbp = P.acs_step(pc, torch.from_numpy(pm), torch.from_numpy(bm))
    _eq(ppm, rpm)
    _eq(pbp, rbp)
    assert pbp.dtype == torch.int32


@pytest.mark.parametrize("name", ["k3", "k5", "k7"])
@pytest.mark.parametrize("metric", ["hard", "soft"])
@pytest.mark.parametrize("terminated", [True, False], ids=["term", "open"])
def test_viterbi_decode_matches(name, metric, terminated):
    rc, pc = _pair(name)
    rng = np.random.default_rng(zlib.crc32(f"{name}/{metric}/{terminated}".encode()))
    bits = rng.integers(0, 2, (4, 40)).astype(np.int32)
    coded = np.asarray(R.encode(rc, jnp.asarray(bits), terminate=terminated))
    if metric == "hard":
        rx = (coded ^ (rng.random(coded.shape) < 0.05)).astype(np.int32)
        bm = np.array(R.hard_branch_metrics(rc, jnp.asarray(rx)))
    else:
        rx = ((1.0 - 2.0 * coded) + 0.7 * rng.standard_normal(coded.shape)).astype(np.float32)
        bm = np.array(R.soft_branch_metrics(rc, jnp.asarray(rx)))
    ref_bits, ref_metric = R.viterbi_decode(rc, jnp.asarray(bm), terminated=terminated)
    bits_p, metric_p = P.viterbi_decode(pc, torch.from_numpy(bm), terminated=terminated)
    _eq(bits_p, ref_bits)
    # same tables, same adds in the same order: the metric is exact for both
    # metric kinds
    _eq(metric_p, ref_metric)


def test_viterbi_decode_tie_heavy_open_trellis():
    """All-zero tables: every state ties at every step, so the open-trellis
    frontier and every select exercise the lowest-index rule."""
    rc, pc = _pair("k5")
    bm = np.zeros((3, 25, pc.n_symbols), np.float32)
    ref_bits, ref_metric = R.viterbi_decode(rc, jnp.asarray(bm), terminated=False)
    bits_p, metric_p = P.viterbi_decode(pc, torch.from_numpy(bm), terminated=False)
    _eq(bits_p, ref_bits)
    _eq(metric_p, ref_metric)


# --------------------------------------------------------------------------- #
# isolation: the port never imports jax or the reference                       #
# --------------------------------------------------------------------------- #


def test_import_loads_neither_jax_nor_reference():
    code = (
        "import sys, repro_torch, repro_torch.decode, repro_torch.kernels, "
        "repro_torch.convert, repro_torch.stream, repro_torch.obs, repro_torch.siso, "
        "repro_torch.stream.scheduler, repro_torch.configs, repro_torch.serve, "
        "repro_torch.serve.bits, repro_torch.train, repro_torch.analysis, "
        "repro_torch.analysis.hotpaths, repro_torch.analysis.__main__, "
        "repro_torch.models, repro_torch.models.moe, repro_torch.models.mla, "
        "repro_torch.serve.engine, repro_torch.launch.serve, "
        "repro_torch.train.optimizer, repro_torch.train.train_loop, "
        "repro_torch.train.checkpoint, repro_torch.data, repro_torch.launch.train, "
        "repro_torch.parallel, repro_torch.parallel.collectives, repro_torch.launch.mesh, "
        "repro_torch.parallel.sharding, repro_torch.parallel.placement, "
        "repro_torch.models.common, repro_torch.models.attention, repro_torch.models.encdec, "
        "repro_torch.models.transformer, repro_torch.models.model_zoo\n"
        "bad = [k for k in sys.modules if k.startswith('jax') or k == 'repro' "
        "or k.startswith('repro.')]\n"
        "assert not bad, bad\n"
    )
    env = {**os.environ, "PYTHONPATH": str(SRC)}
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_source_has_no_jax_or_reference_imports():
    files = sorted((SRC / "repro_torch").rglob("*.py"))
    assert len(files) > 15
    offenders = []
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            for name in names:
                root = name.split(".")[0]
                if root in ("jax", "jaxlib", "repro"):
                    offenders.append(f"{path}:{node.lineno}: {name}")
    assert not offenders, offenders


ROOT = SRC.parent
SCRIPTS = ["chip_smoke.py"] + sorted(p.relative_to(ROOT).as_posix()
                                     for p in (ROOT / "tools").glob("*.py"))


def _imported_roots(tree):
    """(line, module) of each import of ``tree``, and of each
    ``importlib.import_module`` / ``__import__`` of a constant name."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from ((node.lineno, a.name) for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield node.lineno, node.module or ""
        elif isinstance(node, ast.Call) and node.args and \
                isinstance(node.args[0], ast.Constant) and isinstance(node.args[0].value, str):
            fn = node.func
            name = fn.attr if isinstance(fn, ast.Attribute) else getattr(fn, "id", "")
            if name in ("import_module", "__import__"):
                yield node.lineno, node.args[0].value


@pytest.mark.parametrize("script", SCRIPTS)
def test_chip_smoke_and_tools_import_neither_jax_nor_reference(script):
    """``chip_smoke.py`` and every ``tools/*.py`` run on the card without
    JAX: none of them imports jax, jaxlib or the reference package."""
    tree = ast.parse((ROOT / script).read_text())
    offenders = [f"{script}:{line}: {name}" for line, name in _imported_roots(tree)
                 if name.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not offenders, offenders
    assert len(SCRIPTS) > 5
