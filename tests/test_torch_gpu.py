"""The port's CUDA kernels held against their plain PyTorch versions on the
card, and the decode paths on the card (short blocks, tiled long blocks,
streaming) against the same decodes on the CPU.

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
from repro_torch.core.trellis import NEG_UNREACHABLE
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


def _seed_metrics(gen, B, S, card):
    """Carried metrics as a stream or a tile sees them: small non-negative
    values with some states unreachable (exactly 1e30)."""
    pm0 = torch.randint(0, 9, (B, S), generator=gen, device=card).float()
    return torch.where(torch.rand((B, S), generator=gen, device=card) < 0.3,
                       torch.full_like(pm0, NEG_UNREACHABLE), pm0)


@pytest.mark.gpu
@pytest.mark.parametrize("K,polys,batch,T", [
    (3, (0b111, 0b101), 37, 100),
    (7, (0o171, 0o133), 300, 70),
    (11, (0o3345, 0o3613), 9, 45),
])
def test_carried_windowed_and_unpacked_scans_match_plain_on_card(card, K, polys, batch, T):
    code = ConvCode(K, polys)
    S = code.n_states
    gen = torch.Generator(device=card).manual_seed(K + 100)
    pm0 = _seed_metrics(gen, batch, S, card)
    soft = torch.randn((batch, T, code.n_out), generator=gen, device=card)
    weights = fused_metric_plan(code, "soft").folded(card)
    tables = torch.randint(0, 3, (batch, T, code.n_symbols), generator=gen, device=card).float()
    lo = torch.randint(0, T // 2, (batch,), generator=gen, device=card).int()
    hi = torch.randint(T // 2, T + 3, (batch,), generator=gen, device=card).int()
    cases = [
        (viterbi_scan.viterbi_scan_packed_carry, viterbi_scan.viterbi_scan_packed_carry_plain,
         (code, pm0, soft, *weights)),
        (viterbi_scan.viterbi_scan_packed_window, viterbi_scan.viterbi_scan_packed_window_plain,
         (code, pm0, soft, *weights, lo, hi)),
        (viterbi_scan.viterbi_scan_carry, viterbi_scan.viterbi_scan_carry_plain,
         (code, pm0, tables)),
    ]
    reset_counts()
    for kernel, plain, args in cases:
        pm, surv = kernel(*args)
        pm_p, surv_p = plain(*args)
        torch.cuda.synchronize()
        assert torch.equal(surv, surv_p), kernel.__name__
        assert torch.equal(pm, pm_p), kernel.__name__
    assert all(launch_counts[k.__name__] == 1 for k, _, _ in cases) and not plain_counts


@pytest.mark.gpu
@pytest.mark.parametrize("K,polys,batch,T", [
    (3, (0b111, 0b101), 300, 100),
    (7, (0o171, 0o133), 200, 70),
    (11, (0o3345, 0o3613), 9, 45),
])
def test_windowed_traceback_matches_plain_on_card(card, K, polys, batch, T):
    code = ConvCode(K, polys)
    S = code.n_states
    gen = torch.Generator(device=card).manual_seed(K + 200)
    W = -(-T // 32)
    words = torch.randint(-2 ** 31, 2 ** 31 - 1, (W, batch, S), generator=gen, device=card,
                          dtype=torch.int32)
    fs = torch.randint(0, S, (batch,), generator=gen, device=card, dtype=torch.int32)
    lo = torch.randint(0, T // 2, (batch,), generator=gen, device=card).int()
    hi = torch.randint(T // 2, 32 * W + 1, (batch,), generator=gen, device=card).int()
    reset_counts()
    bits, entry = survivors.traceback_packed_window(code, words, fs, lo, hi)
    bits_p, entry_p = survivors.traceback_packed_window_plain(code, words, fs, lo, hi)
    torch.cuda.synchronize()
    assert bits.shape == (batch, 32 * W)
    assert torch.equal(bits, bits_p) and torch.equal(entry, entry_p)
    assert launch_counts["traceback_packed_window"] == 1 and not plain_counts


@pytest.mark.gpu
@pytest.mark.parametrize("metric,tiles,overlap", [
    ("hard", 4, None), ("soft", 3, None), ("hard", 4, 12),
])
def test_tiled_decode_on_card_matches_cpu_decode(card, metric, tiles, overlap):
    spec = CodecSpec(code=CODE_K7_NASA, metric=metric)
    gen = torch.Generator().manual_seed(7)
    coded = spec.encode(torch.randint(0, 2, (8, 1100), generator=gen))
    rx = spec.channel(gen, coded, **({"flip_prob": 0.04} if metric == "hard" else
                                     {"snr_db": 1.5}))
    ctx = DecodeContext(tiles=tiles, tile_overlap=overlap)
    reset_counts()
    on_card = decode(DecodeRequest(spec, received=rx.to(card)), ctx=ctx)
    torch.cuda.synchronize()
    assert on_card.plan.backend == "tiled"
    assert launch_counts["viterbi_scan_packed_window"] == (2 if overlap is None else 1)
    assert launch_counts["traceback_packed_window"] == 1 and not plain_counts
    on_cpu = decode(DecodeRequest(spec, received=rx),
                    ctx=DecodeContext(device="cpu", tiles=tiles, tile_overlap=overlap))
    assert torch.equal(on_card.bits.cpu(), on_cpu.bits)
    assert torch.equal(on_card.path_metric.cpu(), on_cpu.path_metric)


@pytest.mark.gpu
@pytest.mark.parametrize("backend,inputs", [
    ("fused", "bm"), ("fused_packed", "bm"), ("fused_packed", "received"),
])
def test_stream_session_on_card_matches_cpu_session(card, backend, inputs):
    from repro_torch.stream import StreamSession

    spec = CodecSpec(code=CODE_K7_NASA, metric="soft", puncture=PUNCTURE_2_3)
    gen = torch.Generator().manual_seed(11)
    rx = spec.channel(gen, spec.encode(torch.randint(0, 2, (16, 300), generator=gen)),
                      snr_db=2.0)
    data = rx if inputs == "received" else spec.branch_metrics(rx)
    kernel = {"fused": "viterbi_scan_carry"}.get(backend, "viterbi_scan_packed_carry")
    reset_counts()
    on_card = StreamSession(spec, batch=16, chunk=64, backend=backend, inputs=inputs)
    bits, metric = on_card.decode_all(data.to(card))
    torch.cuda.synchronize()
    assert launch_counts[kernel] == data.shape[1] // 64 and not plain_counts
    on_cpu = StreamSession(spec, batch=16, chunk=64, backend=backend, inputs=inputs,
                           device="cpu")
    want_bits, want_metric = on_cpu.decode_all(data)
    assert torch.equal(bits.cpu(), want_bits)
    assert torch.equal(metric.cpu(), want_metric)


@pytest.mark.gpu
def test_streaming_decode_on_card_matches_cpu_decode(card):
    spec = CodecSpec(code=CODE_K7_NASA, metric="hard")
    gen = torch.Generator().manual_seed(12)
    rx = spec.channel(gen, spec.encode(torch.randint(0, 2, (32, 500), generator=gen)),
                      flip_prob=0.04)
    reset_counts()
    on_card = decode(DecodeRequest(spec, received=rx.to(card)),
                     ctx=DecodeContext(streaming=True))
    torch.cuda.synchronize()
    assert on_card.plan.backend == "streaming"
    assert launch_counts["viterbi_scan_carry"] == rx.shape[1] // 64 and not plain_counts
    on_cpu = decode(DecodeRequest(spec, received=rx),
                    ctx=DecodeContext(device="cpu", streaming=True))
    assert torch.equal(on_card.bits.cpu(), on_cpu.bits)
    assert torch.equal(on_card.path_metric.cpu(), on_cpu.path_metric)
