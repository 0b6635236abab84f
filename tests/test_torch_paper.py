"""The paper's comparison pieces and the small API gaps of the port, held
against the reference on identical numpy inputs: ``acs_step_unfused`` (the
"without custom instruction" baseline) output for output, exactly, hard and
soft, with ties; ``paper_expansion_calls``; ``puncture`` (values and dtype);
``DecodeRequest.metrics()``; and the serving pipeline's token <-> bit
packing.  Every comparison here is exact: the metrics are single float32
adds of the same operands in both packages."""
import jax  # noqa: F401  (both frameworks in one process; JAX stays on the CPU)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as RC
import repro.decode as RD
import repro.serve.bits as RB
import repro_torch.core as PC
import repro_torch.decode as PD
from repro_torch.core.puncture import puncture as p_puncture
from repro_torch.serve import bits_to_tokens, tokens_to_bits

torch.set_num_threads(1)

#: (constraint, polys): the paper's own 4-state code, the textbook K=3, GSM
#: K=5 and NASA K=7 (one step only on the CPU: 128 transitions a step)
CODES = {
    "k3-paper": (3, (0b110, 0b010)),
    "k3": (3, (0b111, 0b101)),
    "k5": (5, (0b10011, 0b11101)),
    "k7": (7, (0o171, 0o133)),
}


def _pm_bm(code, metric: str, seed: int, batch=(3,)):
    """Path metrics and one step's bm table, made with numpy: small integers
    (hard: many ties) or float32 normals (soft); a 1e30 entry stands for an
    unreachable state."""
    rng = np.random.default_rng(seed)
    S, M = code.n_states, code.n_symbols
    if metric == "hard":
        pm = rng.integers(0, 3, batch + (S,)).astype(np.float32)
        bm = rng.integers(0, 3, batch + (M,)).astype(np.float32)
    else:
        pm = rng.standard_normal(batch + (S,)).astype(np.float32)
        bm = rng.standard_normal(batch + (M,)).astype(np.float32)
    pm[..., -1] = 1e30
    return pm, bm


@pytest.mark.parametrize("metric", ["hard", "soft"])
@pytest.mark.parametrize("name", sorted(CODES))
def test_acs_step_unfused_matches_reference_exactly(name, metric):
    K, polys = CODES[name]
    rcode, pcode = RC.ConvCode(K, polys), PC.ConvCode(K, polys)
    pm, bm = _pm_bm(pcode, metric, seed=K * 7 + len(metric))
    want_pm, want_par = RC.acs_step_unfused(rcode, jnp.asarray(pm), jnp.asarray(bm))
    got_pm, got_par = PC.acs_step_unfused(pcode, torch.from_numpy(pm), torch.from_numpy(bm))
    assert got_pm.dtype == torch.float32 and got_par.dtype == torch.int32
    np.testing.assert_array_equal(got_pm.numpy(), np.asarray(want_pm))
    np.testing.assert_array_equal(got_par.numpy(), np.asarray(want_par))
    # semantically acs_step: the same metrics, and the survivor's
    # predecessor parity p & 1 is acs_step's select bit (ties to the lower
    # predecessor on both sides)
    fused_pm, fused_bp = PC.acs_step(pcode, torch.from_numpy(pm), torch.from_numpy(bm))
    assert torch.equal(got_pm, fused_pm)
    assert torch.equal(got_par, fused_bp)


def test_acs_step_unfused_ties_go_to_the_earlier_predecessor():
    code = PC.ConvCode(3, (0b111, 0b101))
    pm = torch.zeros((1, 4))
    bm = torch.zeros((1, 4))
    new_pm, par = PC.acs_step_unfused(code, pm, bm)
    assert torch.equal(new_pm, torch.zeros((1, 4)))
    assert torch.equal(par, torch.zeros((1, 4), dtype=torch.int32))
    # the 3.4e38 incumbent: every candidate at or above it leaves it standing
    big = torch.full((1, 4), 3.4e38)
    kept, par = PC.acs_step_unfused(code, big, bm)
    want, _ = RC.acs_step_unfused(RC.ConvCode(3, (0b111, 0b101)), jnp.asarray(big.numpy()),
                                  jnp.asarray(bm.numpy()))
    np.testing.assert_array_equal(kept.numpy(), np.asarray(want))


def test_paper_expansion_calls_matches_reference():
    assert PC.paper_expansion_calls(12) == 19  # the paper's own count (§V)
    for name, (K, polys) in CODES.items():
        for n in range(0, 41, 3):
            assert PC.paper_expansion_calls(n, PC.ConvCode(K, polys)) == \
                RC.paper_expansion_calls(n, RC.ConvCode(K, polys)), (name, n)


@pytest.mark.parametrize("pattern", ["PUNCTURE_2_3", "PUNCTURE_3_4", "PUNCTURE_5_6"])
def test_puncture_matches_reference_in_values_and_dtype(pattern):
    from repro.core.puncture import puncture as r_puncture

    rcode, pcode = RC.CODE_K7_NASA, PC.CODE_K7_NASA
    rng = np.random.default_rng(len(pattern))
    for coded in (rng.integers(0, 2, (2, 11, 2)).astype(np.int32),
                  rng.standard_normal((2, 11, 2)).astype(np.float32)):
        want = np.asarray(r_puncture(rcode, jnp.asarray(coded), getattr(RC, pattern)))
        got = p_puncture(pcode, torch.from_numpy(coded), getattr(PC, pattern))
        assert got.dtype == torch.float32 and want.dtype == np.float32
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("metric", ["hard", "soft"])
def test_decode_request_metrics_matches_reference(metric):
    kw = dict(metric=metric, puncture=RC.PUNCTURE_2_3, terminated=True)
    rspec = RD.CodecSpec(code=RC.CODE_K3_STD, **kw)
    pspec = PD.CodecSpec(code=PC.CODE_K3_STD, **kw)
    rng = np.random.default_rng(5)
    if metric == "hard":
        rx = rng.integers(0, 2, (2, 14, 2)).astype(np.int32)
    else:
        rx = rng.standard_normal((2, 14, 2)).astype(np.float32)
    want = np.asarray(RD.DecodeRequest(rspec, received=jnp.asarray(rx)).metrics())
    cpu = PD.DecodeContext(device="cpu")
    got = PD.DecodeRequest(pspec, received=torch.from_numpy(rx)).metrics(cpu)
    assert got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), want)
    # precomputed tables are handed back as they are
    tables = torch.from_numpy(want.copy())
    assert PD.DecodeRequest(pspec, bm_tables=tables).metrics(cpu) is tables
    with pytest.raises(ValueError, match="received or bm_tables") as ref_err:
        RD.DecodeRequest(rspec).metrics()
    with pytest.raises(ref_err.type, match="received or bm_tables"):
        PD.DecodeRequest(pspec).metrics(cpu)


def test_decode_request_metrics_default_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    req = PD.DecodeRequest(PD.CodecSpec(), received=torch.zeros((1, 4, 2), dtype=torch.int32))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        req.metrics()


@pytest.mark.parametrize("bits_per_token", [1, 9, 16])
def test_token_bit_packing_matches_reference_and_round_trips(bits_per_token):
    rng = np.random.default_rng(bits_per_token)
    tokens = rng.integers(0, 2 ** bits_per_token, (3, 7)).astype(np.int32)
    got = tokens_to_bits(torch.from_numpy(tokens), bits_per_token)
    want = np.asarray(RB.tokens_to_bits(jnp.asarray(tokens), bits_per_token))
    assert got.dtype == torch.int32 and got.shape == (3, 7 * bits_per_token)
    np.testing.assert_array_equal(got.numpy(), want)
    back = bits_to_tokens(got, bits_per_token)
    assert back.dtype == torch.int32
    np.testing.assert_array_equal(back.numpy(), tokens)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(RB.bits_to_tokens(jnp.asarray(want), bits_per_token)))
