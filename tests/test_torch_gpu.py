"""The port's CUDA kernels held against their plain PyTorch versions on the
card, and the decode path on the card against the same decode on the CPU.

Every test here is marked ``gpu`` and takes the ``card`` fixture, which
skips inside the test when no CUDA device is present (so every worker
collects the same tests).  This file imports neither jax nor the reference
package, so it runs on a machine that has only the port's requirements:

    python -m pytest -q --noconftest -m gpu tests/test_torch_gpu.py
"""
import pytest
import torch

from repro_torch.core import CODE_K7_NASA, PUNCTURE_2_3, ConvCode
from repro_torch.decode import CodecSpec, DecodeContext, DecodeRequest, decode
from repro_torch.kernels import ops, survivors, viterbi_scan
from repro_torch.kernels.common import launch_counts, plain_counts, reset_counts
from repro_torch.kernels.metrics import fused_metric_plan


@pytest.fixture
def card():
    """The CUDA device, or a skip when this machine has none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card with CUDA")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("K,polys,batch,T", [
    (2, (0b11, 0b10), 300, 33),
    (3, (0b111, 0b101), 37, 100),
    (7, (0o171, 0o133), 300, 70),
    (11, (0o3345, 0o3613), 9, 70),
    (13, (0o15621, 0o17363), 3, 45),
])
def test_kernels_match_plain_versions_on_card(card, K, polys, batch, T):
    code = ConvCode(K, polys)
    gen = torch.Generator(device=card).manual_seed(K)
    hard = fused_metric_plan(code, "hard")
    cases = [
        (hard.features(torch.randint(0, 2, (batch, T, code.n_out), generator=gen, device=card)),
         hard.folded(card)),
        (torch.randn((batch, T, code.n_out), generator=gen, device=card),
         fused_metric_plan(code, "soft").folded(card)),
        (torch.randint(0, 3, (batch, T, code.n_symbols), generator=gen, device=card).float(),
         viterbi_scan.table_weights(code, card)),
    ]
    for data, (b0, b1, rb) in cases:
        data = data.contiguous()
        pm, packed = viterbi_scan.viterbi_scan_packed(code, data, b0, b1, rb)
        pm_p, packed_p = viterbi_scan.viterbi_scan_packed_plain(code, data, b0, b1, rb)
        torch.cuda.synchronize()
        assert torch.equal(packed, packed_p)
        assert torch.equal(pm, pm_p)
        for terminated in (True, False):
            fs, _ = ops._frontier(pm, terminated)
            bits = survivors.traceback_packed(code, packed, fs, T)
            torch.cuda.synchronize()
            assert torch.equal(bits, survivors.traceback_packed_plain(code, packed, fs, T))


@pytest.mark.gpu
def test_card_wrappers_refuse_mixed_devices_and_count_launches(card):
    code = ConvCode(3, (0b111, 0b101))
    b0, b1, rb = fused_metric_plan(code, "hard").folded(card)
    with pytest.raises(ValueError, match="several devices"):
        viterbi_scan.viterbi_scan_packed(code, torch.zeros((2, 5, 2)), b0, b1, rb)
    reset_counts()
    viterbi_scan.viterbi_scan_packed(code, torch.zeros((2, 5, 2), device=card), b0, b1, rb)
    torch.cuda.synchronize()
    assert launch_counts["viterbi_scan_packed"] == 1 and not plain_counts


@pytest.mark.gpu
@pytest.mark.parametrize("metric,puncture,terminated", [
    ("hard", None, True), ("soft", None, False), ("hard", PUNCTURE_2_3, False),
    ("soft", PUNCTURE_2_3, True),
])
def test_decode_on_card_matches_cpu_decode(card, metric, puncture, terminated):
    spec = CodecSpec(code=CODE_K7_NASA, metric=metric, puncture=puncture,
                     terminated=terminated)
    gen = torch.Generator().manual_seed(5)
    coded = spec.encode(torch.randint(0, 2, (64, 200), generator=gen))
    if metric == "hard":
        rx = spec.channel(gen, coded, flip_prob=0.05)
    else:
        rx = spec.channel(gen, coded, snr_db=1.0)
    reset_counts()
    on_card = decode(DecodeRequest(spec, received=rx.to(card)))
    torch.cuda.synchronize()
    assert launch_counts["viterbi_scan_packed"] == 1
    assert launch_counts["traceback_packed"] == 1
    assert not plain_counts
    on_cpu = decode(DecodeRequest(spec, received=rx), ctx=DecodeContext(device="cpu"))
    assert on_card.plan.backend == on_cpu.plan.backend == "fused_packed"
    assert torch.equal(on_card.bits.cpu(), on_cpu.bits)
    assert torch.equal(on_card.path_metric.cpu(), on_cpu.path_metric)
