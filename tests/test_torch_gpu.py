"""The port's CUDA kernels held against their plain PyTorch versions on the
card, and the decode paths on the card (short blocks, tiled long blocks,
streaming, the unpacked ``fused`` route, ``bcjr`` and turbo, the
block-parallel ``parallel`` route, the stream scheduler, every registered
backend) against the same decodes on the CPU; the scheduler's one
synchronizing call a tick; the analysis layer's hot-path catalog and
sanitizer on the card; the paper's unfused ACS step; the LM's serving and
training paths (a train step against its CPU run, its one host sync,
crash -> restore -> resume, the launchers).

Every test here is marked ``gpu`` and takes the ``card`` fixture, which
skips inside the test when no CUDA device is present (so every worker
collects the same tests).  This file imports neither jax nor the reference
package, so it runs on a machine that has only the port's requirements:

    python -m pytest -q --noconftest -m gpu tests/test_torch_gpu.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core import CODE_K7_NASA, PUNCTURE_2_3, ConvCode
from repro_torch.decode import CodecSpec, DecodeContext, DecodeRequest, decode
from repro_torch.core.trellis import NEG_UNREACHABLE
from repro_torch.kernels import minplus, ops, survivors, viterbi_scan
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


#: a rate-1/2 code of every trellis size in the chain kernel's launch table
CHAIN_CODES = [(2, (0b11, 0b10)), (3, (0b111, 0b101)), (4, (0o15, 0o17)), (5, (0o23, 0o35)),
               (6, (0o53, 0o75)), (7, (0o171, 0o133)), (8, (0o247, 0o371)),
               (9, (0o561, 0o753)), (10, (0o1167, 0o1545)), (11, (0o3345, 0o3613)),
               (12, (0o5723, 0o6265)), (13, (0o15621, 0o17363))]
#: (B, T): every B of 1, 31, 33, 128, 1000 and every T of 1, 31, 32, 33, 64, 512
CHAIN_SHAPES = [(1, 512), (31, 33), (33, 31), (128, 64), (1000, 32), (33, 1)]
SPECIALS = (float("nan"), float("inf"), -float("inf"), NEG_UNREACHABLE, -NEG_UNREACHABLE)


def _sprinkle(gen, x, card):
    """``x`` with NaN, +-inf and +-1e30 at 3% of the entries of every fourth
    lane (axis 0)."""
    x = x.clone()
    pick = torch.rand(x.shape, generator=gen, device=card)
    pick[1::4] = 1.0
    pick[2::4] = 1.0
    pick[3::4] = 1.0
    for i, v in enumerate(SPECIALS):
        x[(pick >= 0.006 * i) & (pick < 0.006 * (i + 1))] = v
    return x


def _chain_seeds(gen, B, S, card):
    """Carried metrics with 1e30 and its neighbours (one ulp below, and above,
    which the first step clamps)."""
    pm0 = _seed_metrics(gen, B, S, card)
    big = torch.tensor(NEG_UNREACHABLE, device=card)
    pick = torch.rand((B, S), generator=gen, device=card)
    pm0[pick < 0.05] = torch.nextafter(big, torch.tensor(0.0, device=card))
    pm0[pick > 0.95] = torch.nextafter(big, torch.tensor(float("inf"), device=card))
    return pm0


def _chain_operands(gen, code, kind, B, T, card):
    """(data, (b0, b1, rb)) of one weight kind: the folded hard, soft and
    punctured-hard plans, random weights with 2S distinct rows, and random
    weights whose b1 rows are b0's permuted (S distinct rows)."""
    S = code.n_states
    if kind in ("hard", "punctured"):
        plan = fused_metric_plan(code, "hard", PUNCTURE_2_3 if kind == "punctured" else None)
        bits = torch.randint(0, 2, (B, T, code.n_out), generator=gen, device=card)
        return plan.features(bits).contiguous(), plan.folded(card)
    data = _sprinkle(gen, torch.randn((B, T, 3), generator=gen, device=card), card)
    if kind == "soft":
        return data[..., :2].contiguous(), fused_metric_plan(code, "soft").folded(card)
    b0, rb0 = (torch.randn(shape, generator=gen, device=card) for shape in ((S, 3), (S, 1)))
    if kind == "random":
        b1, rb1 = (torch.randn(shape, generator=gen, device=card) for shape in ((S, 3), (S, 1)))
    else:
        perm = torch.randperm(S, generator=gen, device=card)
        b1, rb1 = b0[perm].contiguous(), rb0[perm]
    return data, (b0, b1, torch.cat([rb0, rb1], dim=1).contiguous())


@pytest.mark.gpu
@pytest.mark.parametrize("K,polys", CHAIN_CODES, ids=[f"S{2 ** (k - 1)}" for k, _ in CHAIN_CODES])
def test_chain_scans_match_plain_on_card(card, K, polys):
    """The carried chunk scans (the chain kernel) against their plain
    versions at one S of its launch table: B and T on and off the warp,
    tile and word sizes; folded hard, soft and punctured weights and random
    ones with 2S and S distinct rows; features and tables holding NaN,
    +-inf and +-1e30; ties (integer features); seeds at and beside 1e30.
    Metrics NaN-aware, survivors exact, one launch per call."""
    code = ConvCode(K, polys)
    S = code.n_states
    gen = torch.Generator(device=card).manual_seed(K + 500)
    reset_counts()
    calls = 0
    for B, T in CHAIN_SHAPES:
        pm0 = _chain_seeds(gen, B, S, card)
        cases = []
        for kind in ("hard", "soft", "punctured", "random", "shared"):
            data, weights = _chain_operands(gen, code, kind, B, T, card)
            cases.append((viterbi_scan.viterbi_scan_packed_carry,
                          viterbi_scan.viterbi_scan_packed_carry_plain,
                          (code, pm0, data, *weights)))
        tables = _sprinkle(gen, torch.randint(0, 3, (B, T, code.n_symbols), generator=gen,
                                              device=card).float(), card)
        cases.append((viterbi_scan.viterbi_scan_carry, viterbi_scan.viterbi_scan_carry_plain,
                      (code, pm0, tables)))
        for kernel, plain, args in cases:
            pm, surv = kernel(*args)
            torch.cuda.synchronize()
            calls += 1
            assert sum(launch_counts.values()) == calls and not plain_counts
            pm_p, surv_p = plain(*args)
            assert torch.equal(surv, surv_p), (kernel.__name__, B, T)
            _same_with_nan(pm, pm_p)


#: (B, T) of the state-0 and windowed scans: every B of 1, 31, 33, 1000 and
#: every T of 1, 31, 32, 33, 129
WIDE_SHAPES = [(1, 129), (31, 33), (33, 31), (1000, 32), (33, 1), (1000, 129)]


def _lane_windows(gen, B, T, shift, card):
    """(lo, hi) (B,) int32: lane b takes pattern b + shift of full, empty (at
    0 and mid-block), lo > 0, hi < T, edges on and beside the word boundaries
    32 and 64, and past the end; further lanes random pairs of those edges."""
    m = T // 2
    patterns = [(0, T), (m, m), (min(5, T), T), (0, max(T - 3, 0)), (31, 33), (32, 64),
                (33, 65), (0, 32), (63, 97), (1, T + 2), (0, 0), (64, 129)]
    edges = torch.tensor([0, 1, 31, 32, 33, 63, 64, 65, 96, 97, T - 1, T, T + 2], device=card)
    pairs = edges[torch.randint(0, len(edges), (B, 2), generator=gen, device=card)]
    lo, hi = pairs.min(dim=1).values, pairs.max(dim=1).values
    for b in range(min(B, len(patterns))):
        lo[b], hi[b] = patterns[(b + shift) % len(patterns)]
    return lo.clamp(0, T + 3).int().contiguous(), hi.clamp(0, T + 3).int().contiguous()


@pytest.mark.gpu
@pytest.mark.parametrize("K,polys", CHAIN_CODES, ids=[f"S{2 ** (k - 1)}" for k, _ in CHAIN_CODES])
def test_wide_scans_match_plain_on_card(card, K, polys):
    """The state-0 and windowed packed scans (#1, #4: the chain kernel's wide
    entries) against their plain versions at one S of the wide launch table:
    B and T on and off the warp, tile and word sizes; folded hard, soft and
    punctured weights and random ones with 2S and S distinct rows; features
    holding NaN, +-inf and +-1e30; ties (integer features); per-lane windows
    empty, full, lo > 0, hi < T, on and beside word boundaries and past the
    end; seeds at and beside 1e30.  Metrics NaN-aware, survivors exact, one
    launch per call."""
    code = ConvCode(K, polys)
    S = code.n_states
    gen = torch.Generator(device=card).manual_seed(K + 700)
    reset_counts()
    calls = 0
    for B, T in WIDE_SHAPES:
        pm0 = _chain_seeds(gen, B, S, card)
        for shift, kind in enumerate(("hard", "soft", "punctured", "random", "shared")):
            data, weights = _chain_operands(gen, code, kind, B, T, card)
            lo, hi = _lane_windows(gen, B, T, shift, card)
            for kernel, plain, args in (
                (viterbi_scan.viterbi_scan_packed, viterbi_scan.viterbi_scan_packed_plain,
                 (code, data, *weights)),
                (viterbi_scan.viterbi_scan_packed_window,
                 viterbi_scan.viterbi_scan_packed_window_plain,
                 (code, pm0, data, *weights, lo, hi)),
            ):
                pm, surv = kernel(*args)
                torch.cuda.synchronize()
                calls += 1
                assert sum(launch_counts.values()) == calls and not plain_counts
                pm_p, surv_p = plain(*args)
                assert torch.equal(surv, surv_p), (kernel.__name__, kind, B, T)
                _same_with_nan(pm, pm_p)


@pytest.mark.gpu
@pytest.mark.parametrize("backend,ctx", [
    ("fused_packed", {}), ("tiled", {"tiles": 8}), ("parallel", {"chunk": 64}), ("fused", {})])
def test_second_decode_on_card_builds_no_row_operands(card, backend, ctx):
    """A second decode of the same spec on the card uploads no weights and
    builds no row operands; no decode copies weights back to the host."""
    spec = CodecSpec(code=CODE_K7_NASA, metric="soft", puncture=PUNCTURE_2_3)
    gen = torch.Generator().manual_seed(19)
    rx = spec.channel(gen, spec.encode(torch.randint(0, 2, (4, 300), generator=gen)),
                      snr_db=2.0).to(card)
    builds = []
    for _ in range(2):
        before = dict(viterbi_scan.row_builds)
        decode(DecodeRequest(spec, received=rx), backend=backend, ctx=DecodeContext(**ctx))
        torch.cuda.synchronize()
        builds.append({k: viterbi_scan.row_builds[k] - before.get(k, 0) for k in ("host", "copy")})
    assert builds[0]["host"] <= 1 and builds[0]["copy"] == 0
    assert builds[1] == {"host": 0, "copy": 0}


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


#: a rate-1/2 code of every S of the windowed walk's launch table (staged,
#: csrc/survivors.cu: kStages, S <= 128) and of the direct walk
#: past it (S = 256, 512)
WALK_CODES = CHAIN_CODES[:9]
#: lanes (B) of the windowed walk: one, on and off a warp, about a thousand
WALK_LANES = (1, 31, 33, 1000)


def _walk_windows(gen, B, W, card):
    """(lo, hi) (B,) int32 over 32W steps: full, empty (lo == hi, at 0, on a
    word edge and at the end), lo > hi, lo < 0, hi past the end, edges on
    and one step either side of every word boundary, then random pairs of
    those edges."""
    n = 32 * W
    patterns = [(0, n), (0, 0), (32, 32), (n, n), (5, 3), (-3, 7), (1, n + 5), (31, 33),
                (32, 64), (33, 63), (0, 31), (n - 1, n), (n - 33, n - 31)]
    edges = sorted({e for w in range(W + 1) for e in (32 * w - 1, 32 * w, 32 * w + 1)}
                   | {-2, n + 3})
    table = torch.tensor(edges, device=card)
    pairs = table[torch.randint(0, len(edges), (B, 2), generator=gen, device=card)]
    lo, hi = pairs.min(dim=1).values, pairs.max(dim=1).values
    for b in range(min(B, len(patterns))):
        lo[b], hi[b] = patterns[b]
    return lo.int().contiguous(), hi.int().contiguous()


@pytest.mark.gpu
@pytest.mark.parametrize("K,polys", WALK_CODES, ids=[f"S{2 ** (k - 1)}" for k, _ in WALK_CODES])
def test_staged_windowed_traceback_matches_plain_on_card(card, K, polys):
    """The windowed walk (#5) against its plain version at one S of its
    launch table (S <= 128: the staged walk) or just past it (256, 512: the
    direct walk): lanes 1, 31, 33 and 1000, W = 1..8 words; windows full,
    empty, lo == hi, lo > hi, lo < 0, hi past the end, on and beside word
    boundaries; final states of every value, out-of-row ones among them
    (masked by & (S-1)).  Bits and entry states exact, one launch a call."""
    code = ConvCode(K, polys)
    S = code.n_states
    gen = torch.Generator(device=card).manual_seed(K + 900)
    reset_counts()
    calls = 0
    for B in WALK_LANES:
        for W in range(1, 9):
            words = torch.randint(-2 ** 31, 2 ** 31 - 1, (W, B, S), generator=gen, device=card,
                                  dtype=torch.int32)
            fs = torch.randint(-2 ** 31, 2 ** 31 - 1, (B,), generator=gen, device=card,
                               dtype=torch.int32)
            n = min(B, S)
            fs[:n] = torch.arange(n, device=card, dtype=torch.int32)
            lo, hi = _walk_windows(gen, B, W, card)
            bits, entry = survivors.traceback_packed_window(code, words, fs, lo, hi)
            torch.cuda.synchronize()
            calls += 1
            assert launch_counts["traceback_packed_window"] == calls and not plain_counts
            bits_p, entry_p = survivors.traceback_packed_window_plain(code, words, fs, lo, hi)
            assert torch.equal(bits, bits_p), (S, B, W)
            assert torch.equal(entry, entry_p), (S, B, W)


#: lanes (B) and steps (T) of the full walk: one lane, on and off a warp,
#: about a thousand and the short-block path's 8192; T on and off a word
#: (odd, 2 mod 4 and 0 mod 4 row strides), the short blocks' 1006 and the
#: NASA frame's 1030
FULL_WALK_LANES = (1, 31, 33, 1000, 8192)
FULL_WALK_STEPS = (1, 31, 32, 33, 1006, 1030)


@pytest.mark.gpu
@pytest.mark.parametrize("K,polys", CHAIN_CODES, ids=[f"S{2 ** (k - 1)}" for k, _ in CHAIN_CODES])
def test_full_traceback_matches_plain_on_card(card, K, polys):
    """The full walk (#2) against its plain version at one S: the staged walk
    (S <= 128) or the direct one past it; every B of FULL_WALK_LANES with
    every T of FULL_WALK_STEPS, except the pairs whose words pass 2^28 ints
    (B = 8192 at T > 33 from S = 1024); random words, bit 31 included; final
    states of every value, out-of-row ones among them (masked by & (S-1));
    and words one int off 16-byte alignment.  Bits exact, one launch a call,
    no plain call."""
    code = ConvCode(K, polys)
    S = code.n_states
    gen = torch.Generator(device=card).manual_seed(K + 1900)
    reset_counts()
    calls = 0
    for B in FULL_WALK_LANES:
        for T in FULL_WALK_STEPS:
            W = -(-T // 32)
            if W * B * S > 2 ** 28:
                continue
            words = torch.randint(-2 ** 31, 2 ** 31 - 1, (W, B, S), generator=gen, device=card,
                                  dtype=torch.int32)
            fs = torch.randint(-2 ** 31, 2 ** 31 - 1, (B,), generator=gen, device=card,
                               dtype=torch.int32)
            n = min(B, S)
            fs[:n] = torch.arange(n, device=card, dtype=torch.int32)
            bits = survivors.traceback_packed(code, words, fs, T)
            torch.cuda.synchronize()
            calls += 1
            assert launch_counts["traceback_packed"] == calls and not plain_counts
            assert torch.equal(bits, survivors.traceback_packed_plain(code, words, fs, T)), (B, T)
    # words one int off 16 bytes (a view into a larger buffer) take the direct walk
    B, T = 33, 70
    buf = torch.randint(-2 ** 31, 2 ** 31 - 1, (3 * B * S + 1,), generator=gen, device=card,
                        dtype=torch.int32)
    words = buf[1:].view(3, B, S)
    fs = torch.randint(0, S, (B,), generator=gen, device=card, dtype=torch.int32)
    bits = survivors.traceback_packed(code, words, fs, T)
    torch.cuda.synchronize()
    assert launch_counts["traceback_packed"] == calls + 1 and not plain_counts
    assert torch.equal(bits, survivors.traceback_packed_plain(code, words, fs, T))
    assert calls >= 24


#: (B, T) of the unpacked scan: the wide scans' shapes and a 1006-step block
UNPACKED_SHAPES = WIDE_SHAPES + [(3, 1006)]


@pytest.mark.gpu
@pytest.mark.parametrize("K,polys", CHAIN_CODES, ids=[f"S{2 ** (k - 1)}" for k, _ in CHAIN_CODES])
def test_unpacked_scan_matches_plain_on_card(card, K, polys):
    """The unpacked state-0 scan (#6, the wide kernel's unpacked entry)
    against its plain version at one S of its launch table: B = 1..1000,
    T = 1..129 and 1006; hard (integer: ties everywhere) and soft tables, the
    soft ones holding NaN, +-inf and +-1e30.  Selects exact, metrics
    NaN-aware, one launch a call."""
    code = ConvCode(K, polys)
    M = code.n_symbols
    gen = torch.Generator(device=card).manual_seed(K + 1100)
    reset_counts()
    calls = 0
    for B, T in UNPACKED_SHAPES:
        for tables in (torch.randint(0, 3, (B, T, M), generator=gen, device=card).float(),
                       _sprinkle(gen, torch.randn((B, T, M), generator=gen, device=card), card)):
            pm, bps = viterbi_scan.viterbi_scan(code, tables)
            torch.cuda.synchronize()
            calls += 1
            assert launch_counts["viterbi_scan"] == calls and not plain_counts
            pm_p, bps_p = viterbi_scan.viterbi_scan_plain(code, tables)
            assert torch.equal(bps, bps_p), (B, T)
            _same_with_nan(pm, pm_p)
            del bps, bps_p


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


@pytest.mark.gpu
@pytest.mark.parametrize("K,polys,batch,T", [
    (3, (0b111, 0b101), 37, 100),
    (7, (0o171, 0o133), 300, 70),
    (11, (0o3345, 0o3613), 9, 45),
])
def test_unpacked_scan_and_texpand_match_plain_on_card(card, K, polys, batch, T):
    from repro_torch.kernels import texpand

    code = ConvCode(K, polys)
    S, M = code.n_states, code.n_symbols
    gen = torch.Generator(device=card).manual_seed(K + 300)
    reset_counts()
    for tables in (torch.randint(0, 3, (batch, T, M), generator=gen, device=card).float(),
                   torch.randn((batch, T, M), generator=gen, device=card)):
        pm, bps = viterbi_scan.viterbi_scan(code, tables)
        pm_p, bps_p = viterbi_scan.viterbi_scan_plain(code, tables)
        torch.cuda.synchronize()
        assert torch.equal(bps, bps_p) and torch.equal(pm, pm_p)
    # one step from carried metrics holding 1e30, integer (tie-heavy) and soft
    for pm0, bm in ((_seed_metrics(gen, batch, S, card),
                     torch.randint(0, 2, (batch, M), generator=gen, device=card).float()),
                    (torch.randn((batch, S), generator=gen, device=card) * 10,
                     torch.randn((batch, M), generator=gen, device=card))):
        out = texpand.texpand(code, pm0, bm)
        want = texpand.texpand_plain(code, pm0, bm)
        torch.cuda.synchronize()
        assert torch.equal(out[0], want[0]) and torch.equal(out[1], want[1])
    assert launch_counts["viterbi_scan"] == 2 and launch_counts["texpand"] == 2
    assert not plain_counts


#: An RSC code of every trellis size the BCJR kernels take (S = 2 .. 64),
#: one-parity (R = 4) and two-parity (R = 8, F = 4) codes among them.
BCJR_CODES = [
    (2, 0b11, (0b10,)), (3, 0b111, (0b101,)), (4, 0o13, (0o15,)), (4, 0o13, (0o15, 0o17)),
    (5, 0o23, (0o35, 0o27)), (6, 0o43, (0o75,)), (7, 0o133, (0o171,)),
    (7, 0o133, (0o171, 0o165)),
]


def _bcjr_features(gen, code, T, B, kind, card):
    """(T, F, B) features: soft, integer (exact ties everywhere) or soft with
    +-1e30 and NaN entries in a few lanes."""
    shape = (T, code.n_features, B)
    if kind == "ties":
        return torch.randint(-2, 3, shape, generator=gen, device=card).float()
    feat = torch.randn(shape, generator=gen, device=card) * 2
    if kind == "extremes":
        pick = torch.rand(shape, generator=gen, device=card)
        feat[pick < 0.02] = NEG_UNREACHABLE
        feat[(pick >= 0.02) & (pick < 0.04)] = -NEG_UNREACHABLE
        feat[:, :, ::7][pick[:, :, ::7] > 0.995] = float("nan")
    return feat


def _bcjr_matches_plain(code, feat):
    """Both wrappers against the plain versions, NaN-aware; one launch per
    call."""
    from repro_torch.kernels import bcjr

    reset_counts()
    alphas, final_pm = bcjr.bcjr_alpha_scan(code, feat)
    torch.cuda.synchronize()
    assert launch_counts["bcjr_alpha_scan"] == 1
    alphas_p, final_p = bcjr.bcjr_alpha_scan_plain(code, feat)
    _same_with_nan(alphas, alphas_p)
    _same_with_nan(final_pm, final_p)
    for n, terminated in enumerate((True, False), start=1):
        llr = bcjr.bcjr_beta_llr_scan(code, alphas, feat, terminated)
        torch.cuda.synchronize()
        assert launch_counts["bcjr_beta_llr_scan"] == n
        _same_with_nan(llr, bcjr.bcjr_beta_llr_scan_plain(code, alphas, feat, terminated))
    assert not plain_counts


@pytest.mark.gpu
@pytest.mark.parametrize("params", BCJR_CODES, ids=lambda p: f"K{p[0]}-{len(p[2])}par")
def test_bcjr_scans_match_plain_on_card(card, params):
    """The wrappers at every S, one- and two-parity, at B off the block and
    group sizes (1, 33, 333, 1000) and on them (64), T = 1, T off the chunk
    size and on it (96), on soft, tie-heavy and +-1e30 / NaN features."""
    from repro_torch.siso import RSCCode

    code = RSCCode(*params)
    gen = torch.Generator(device=card).manual_seed(params[0] + 400)
    for B, T, kind in ((333, 90, "soft"), (1, 1, "soft"), (33, 45, "ties"),
                       (1000, 70, "extremes"), (1, 37, "extremes"), (64, 96, "soft")):
        _bcjr_matches_plain(code, _bcjr_features(gen, code, T, B, kind, card))


@pytest.mark.gpu
@pytest.mark.parametrize("metric,terminated", [("hard", True), ("soft", False)])
def test_fused_and_bcjr_decodes_on_card_match_cpu_decodes(card, metric, terminated):
    from repro_torch.siso import RSC_K4_LTE

    gen = torch.Generator().manual_seed(13)
    for spec, backend, kernels in (
        (CodecSpec(code=CODE_K7_NASA, metric=metric, terminated=terminated), "fused",
         {"viterbi_scan": 1}),
        (CodecSpec(code=RSC_K4_LTE, metric=metric, terminated=terminated), None,
         {"bcjr_alpha_scan": 1, "bcjr_beta_llr_scan": 1}),
    ):
        coded = spec.encode(torch.randint(0, 2, (40, 300), generator=gen))
        rx = (spec.channel(gen, coded, flip_prob=0.04) if metric == "hard"
              else spec.channel(gen, coded, snr_db=1.0))
        reset_counts()
        on_card = decode(DecodeRequest(spec, received=rx.to(card)), backend=backend)
        torch.cuda.synchronize()
        assert dict(launch_counts) == kernels and not plain_counts
        on_cpu = decode(DecodeRequest(spec, received=rx), backend=backend,
                        ctx=DecodeContext(device="cpu"))
        assert on_card.plan.backend == on_cpu.plan.backend
        assert torch.equal(on_card.bits.cpu(), on_cpu.bits)
        assert torch.equal(on_card.path_metric.cpu(), on_cpu.path_metric)


@pytest.mark.gpu
@pytest.mark.parametrize("early_exit", [True, False])
def test_turbo_decode_on_card_matches_cpu_decode(card, early_exit):
    from repro_torch.siso import RSC_K4_LTE, QPPInterleaver, TurboSpec, turbo_decode

    spec = TurboSpec(code=RSC_K4_LTE, interleaver=QPPInterleaver(512, 31, 64))
    gen = torch.Generator().manual_seed(14)
    rx = spec.channel(gen, spec.encode(torch.randint(0, 2, (24, 512), generator=gen)),
                      snr_db=-3.5)
    llrs = spec.channel_llrs(rx, snr_db=-3.5)
    reset_counts()
    on_card = turbo_decode(spec, llrs.to(card), early_exit=early_exit)
    torch.cuda.synchronize()
    n = on_card.iterations_run
    assert dict(launch_counts) == {"bcjr_alpha_scan": 2 * n, "bcjr_beta_llr_scan": 2 * n}
    assert not plain_counts
    on_cpu = turbo_decode(spec, llrs, early_exit=early_exit, device="cpu")
    assert n == on_cpu.iterations_run and on_card.agreement == on_cpu.agreement
    assert torch.equal(on_card.bits.cpu(), on_cpu.bits)
    assert torch.equal(on_card.llr.cpu(), on_cpu.llr)
    assert torch.equal(on_card.converged.cpu(), on_cpu.converged)


def _same_with_nan(got, want):
    """Equal values, NaN where the other has NaN."""
    assert got.shape == want.shape
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert torch.equal(torch.nan_to_num(got, nan=0.0), torch.nan_to_num(want, nan=0.0))


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(1, 4, 4, 4), (2, 8, 16, 8), (3, 130, 64, 70), (2, 5, 1, 3),
                                   (64, 64, 64, 64)])
@pytest.mark.parametrize("init", [NEG_UNREACHABLE, float("inf")], ids=["1e30", "inf"])
def test_minplus_matmul_matches_plain_on_card(card, shape, init):
    N, I, K, J = shape
    gen = torch.Generator(device=card).manual_seed(I + K)
    a = torch.randn((N, I, K), generator=gen, device=card) * 5
    b = torch.randn((N, K, J), generator=gen, device=card) * 5
    for x in (a, b):  # unreachable metrics as transfer matrices hold them, and a NaN
        x[torch.rand(x.shape, generator=gen, device=card) < 0.2] = NEG_UNREACHABLE
        x[torch.rand(x.shape, generator=gen, device=card) < 0.1] = 2 * NEG_UNREACHABLE
    a[0, 0, 0] = float("nan")
    reset_counts()
    got = minplus.minplus_matmul(a, b, init)
    torch.cuda.synchronize()
    _same_with_nan(got, minplus.minplus_matmul_plain(a, b, init))
    assert torch.isnan(got[0, 0]).all()
    # strided batch views, as the associative scan hands them over
    a4, b4 = a.reshape(N, 1, I, K).expand(N, 3, I, K), b.reshape(N, 1, K, J).expand(N, 3, K, J)
    got4 = minplus.minplus_matmul(a4[:, 0:-1:2], b4[:, 1::2], init)
    torch.cuda.synchronize()
    _same_with_nan(got4, minplus.minplus_matmul_plain(a4[:, 0:-1:2].contiguous(),
                                                      b4[:, 1::2].contiguous(), init))
    assert launch_counts["minplus_matmul"] == 2
    # an empty batch launches nothing
    assert minplus.minplus_matmul(a4[:, 0:0], b4[:, 0:0], init).shape == (N, 0, I, J)
    assert launch_counts["minplus_matmul"] == 2


#: the square kernel's S (csrc/minplus.cu: I = K = J = S, 2 to 128)
SQUARE_STATES = (2, 4, 8, 16, 32, 64, 128)


def _square_operands(gen, n, S, card):
    """(n, S, S) float32 pairs with 1e30, 2e30, +-inf and NaN entries."""
    a = torch.randn((n, S, S), generator=gen, device=card) * 5
    b = torch.randn((n, S, S), generator=gen, device=card) * 5
    for x in (a, b):
        pick = torch.rand(x.shape, generator=gen, device=card)
        x[pick < 0.2] = NEG_UNREACHABLE
        x[(pick >= 0.2) & (pick < 0.3)] = 2 * NEG_UNREACHABLE
        x[(pick >= 0.3) & (pick < 0.31)] = float("inf")
        x[(pick >= 0.31) & (pick < 0.32)] = -float("inf")
        x[(pick >= 0.32) & (pick < 0.33)] = float("nan")
    return a, b


@pytest.mark.gpu
@pytest.mark.parametrize("S", SQUARE_STATES)
@pytest.mark.parametrize("init", [NEG_UNREACHABLE, float("inf")], ids=["1e30", "inf"])
def test_square_minplus_matches_plain_on_card(card, S, init):
    """The square kernel at one S against the plain version: N products not a
    multiple of the products a block takes at once; contiguous, the
    associative scan's strided slices of a (1, 2N+1, S, S) stack and a
    stride-0 batch (all square), and operands one element off 16-byte
    alignment (the general kernel).  NaN where the plain version has NaN,
    every other entry equal; one launch a call, no plain call."""
    gen = torch.Generator(device=card).manual_seed(S + 1911)
    per_block = 256 // (min(S, 64) // min(S, 4)) ** 2
    N = 2 * per_block + 3
    a, b = _square_operands(gen, 2 * N + 1, S, card)
    stack_a, stack_b = a.reshape(1, 2 * N + 1, S, S), b.reshape(1, 2 * N + 1, S, S)
    flat = torch.empty((N * S * S + 1,), device=card)
    flat[1:] = a[:N].reshape(-1)
    cases = [
        ("square", a[:N], b[:N]),
        ("square", stack_a[:, 0:-1:2], stack_b[:, 1::2]),
        ("square", a[:1].expand(N, S, S), b[N:2 * N]),
        ("general", flat[1:].view(N, S, S), b[:N]),
    ]
    reset_counts()
    for calls, (variant, x, y) in enumerate(cases, start=1):
        assert minplus.kernel_variant(x, y) == (f"square S={S}" if variant == "square"
                                               else "general")
        got = minplus.minplus_matmul(x, y, init)
        torch.cuda.synchronize()
        assert launch_counts["minplus_matmul"] == calls and not plain_counts
        want = minplus.minplus_matmul_plain(x.contiguous(), y.contiguous(), init)
        _same_with_nan(got, want)
        assert torch.isnan(got).any()


@pytest.mark.gpu
@pytest.mark.parametrize("S", [64, 128])
def test_square_minplus_launches_on_every_card(card, S):
    """The square kernel's shared-memory limit (above 48 KB at S = 64 and
    128) is a per-device attribute: on each visible card in turn, made the
    current device, one launch that matches the plain version."""
    for d in range(torch.cuda.device_count()):
        dev = torch.device("cuda", d)
        with torch.cuda.device(dev):
            gen = torch.Generator(device=dev).manual_seed(S + d)
            a, b = _square_operands(gen, 9, S, dev)
            assert minplus.kernel_variant(a, b) == f"square S={S}"
            reset_counts()
            got = minplus.minplus_matmul(a, b, float("inf"))
            torch.cuda.synchronize(dev)
            assert launch_counts["minplus_matmul"] == 1 and not plain_counts
            _same_with_nan(got, minplus.minplus_matmul_plain(a, b, float("inf")))


@pytest.mark.gpu
def test_minplus_wrapper_refuses_mixed_devices_and_counts_launches(card):
    a = torch.zeros((2, 4, 3), device=card)
    with pytest.raises(ValueError, match="several devices"):
        minplus.minplus_matmul(a, torch.zeros((2, 3, 5)))
    with pytest.raises(ValueError, match="row-major"):
        minplus.minplus_matmul(a.transpose(1, 2), torch.zeros((2, 4, 5), device=card))
    reset_counts()
    minplus.minplus_matmul(a, torch.zeros((2, 3, 5), device=card))
    torch.cuda.synchronize()
    assert launch_counts["minplus_matmul"] == 1 and not plain_counts


@pytest.mark.gpu
@pytest.mark.parametrize("metric,terminated,chunk", [("hard", True, 16), ("soft", False, 64),
                                                     ("soft", True, 7)])
def test_parallel_decode_on_card_matches_cpu_decode(card, metric, terminated, chunk):
    spec = CodecSpec(code=CODE_K7_NASA, metric=metric, terminated=terminated)
    gen = torch.Generator().manual_seed(15)
    coded = spec.encode(torch.randint(0, 2, (24, 300), generator=gen))
    rx = (spec.channel(gen, coded, flip_prob=0.04) if metric == "hard"
          else spec.channel(gen, coded, snr_db=1.0))
    reset_counts()
    on_card = decode(DecodeRequest(spec, received=rx.to(card)), backend="parallel",
                     ctx=DecodeContext(chunk=chunk))
    torch.cuda.synchronize()
    assert {k: launch_counts[k] for k in ("viterbi_scan_packed_window", "viterbi_scan_carry",
                                          "traceback_packed")} == dict.fromkeys(
        ("viterbi_scan_packed_window", "viterbi_scan_carry", "traceback_packed"), 1)
    assert launch_counts["minplus_matmul"] >= 1 and not plain_counts
    on_cpu = decode(DecodeRequest(spec, received=rx), backend="parallel",
                    ctx=DecodeContext(chunk=chunk, device="cpu"))
    assert on_card.diagnostics == on_cpu.diagnostics == {"backend": "parallel", "chunk": chunk}
    assert torch.equal(on_card.bits.cpu(), on_cpu.bits)
    assert torch.equal(on_card.path_metric.cpu(), on_cpu.path_metric)


# --------------------------------------------------------------------------- #
# the stream scheduler on the card                                             #
# --------------------------------------------------------------------------- #

SCHED_KINDS = [  # backend, inputs, metric, punctured, terminated
    ("fused", "bm", "hard", False, True),
    ("fused", "bm", "soft", True, False),
    ("scan", "bm", "soft", False, True),
    ("fused_packed", "bm", "hard", False, False),
    ("fused_packed", "received", "hard", False, True),
    ("fused_packed", "received", "soft", True, False),
]
SCHED_KERNELS = {"fused": ("viterbi_scan_carry",),
                 "fused_packed": ("viterbi_scan_packed_carry", "traceback_packed")}


def _sched_rows(spec, inputs, n, seed):
    """Per-stream host rows (numpy arrays, as a caller hands them over):
    the channel output of random info bits, as raw symbols or bm tables."""
    gen = torch.Generator().manual_seed(seed)
    rows = {}
    for i in range(n):
        coded = spec.encode(torch.randint(0, 2, (1, (150, 211, 97, 260)[i % 4]), generator=gen))
        rx = (spec.channel(gen, coded, snr_db=2.0) if spec.soft
              else spec.channel(gen, coded, flip_prob=0.04))
        rows[f"s{i}"] = (rx if inputs == "received" else spec.branch_metrics(rx))[0].numpy()
    return rows


def _arrivals(table, sizes=(40, 24, 57)):
    i, k = 0, 0
    while i < len(table):
        yield table[i:i + sizes[k % len(sizes)]]
        i += sizes[k % len(sizes)]
        k += 1


def _scheduler(spec, backend, inputs, device, **kw):
    from repro_torch.stream import StreamScheduler

    return StreamScheduler(spec, n_slots=3, chunk=64 if backend == "fused_packed" else 32,
                           backend=backend, inputs=inputs, device=device, **kw)


def _drive(sched, rows):
    """Open every stream on a producer of uneven arrival chunks and tick to
    the end; returns each tick's emitted bits."""
    for sid, table in rows.items():
        sched.open_stream(sid, producer=_arrivals(table))
    ticks = []
    while sched.pending_work():
        ticks.append(sched.step())
    return ticks


def _same_schedulers(got, want, ticks_got, ticks_want):
    assert len(ticks_got) == len(ticks_want)
    for a, b in zip(ticks_got, ticks_want):
        assert a.keys() == b.keys() and all((a[k] == b[k]).all() for k in a)
    assert got.results.keys() == want.results.keys()
    for sid, (bits, metric) in want.results.items():
        assert (got.results[sid][0] == bits).all() and got.results[sid][1] == metric, sid
    stats, ref = got.stats.asdict(), want.stats.asdict()
    stats.pop("straggler_ticks"), ref.pop("straggler_ticks")  # wall-clock outliers
    assert stats == ref


@pytest.mark.gpu
@pytest.mark.parametrize("backend,inputs,metric,punctured,terminated", SCHED_KINDS)
def test_scheduler_on_card_matches_cpu_scheduler(card, backend, inputs, metric, punctured,
                                                 terminated):
    """Eight streams through three slots on uneven arrivals: every tick's
    bits, the results (metrics exactly) and the stats equal the CPU
    scheduler's; each tick launches the path's kernels once, no plain call."""
    from repro_torch.obs import Telemetry

    spec = CodecSpec(code=CODE_K7_NASA, metric=metric,
                     puncture=PUNCTURE_2_3 if punctured else None, terminated=terminated)
    rows = _sched_rows(spec, inputs, 8, 21)
    tele = lambda: Telemetry(device_counters=True)  # noqa: E731
    on_card = _scheduler(spec, backend, inputs, "cuda", telemetry=tele())
    reset_counts()
    ticks_card = _drive(on_card, rows)
    torch.cuda.synchronize()
    assert not plain_counts
    for k in SCHED_KERNELS.get(backend, ()):
        assert launch_counts[k] == on_card.stats.ticks > 0, k
    on_cpu = _scheduler(spec, backend, inputs, "cpu", telemetry=tele())
    _same_schedulers(on_card, on_cpu, ticks_card, _drive(on_cpu, rows))
    assert on_card.stats.streams_finished == 8 and on_card.stats.slot_claims == 8


@pytest.mark.gpu
def test_scheduler_on_card_one_gather_and_one_step_per_tick(card, monkeypatch):
    spec = CodecSpec(code=CODE_K7_NASA)
    sched = _scheduler(spec, "fused_packed", "received", "cuda")
    calls = {"gather": 0, "step": 0}
    gather, step_fn = sched._gather, sched._step_fn

    def counting_gather(*a):
        calls["gather"] += 1
        return gather(*a)

    def counting_step(*a, **k):
        calls["step"] += 1
        return step_fn(*a, **k)

    monkeypatch.setattr(sched, "_gather", counting_gather)
    monkeypatch.setattr(sched, "_step_fn", counting_step)
    _drive(sched, _sched_rows(spec, "received", 5, 22))
    assert calls["gather"] == calls["step"] == sched.stats.ticks > 0


def _syncs_per_tick(sched, n_ticks):
    """Synchronizing CUDA calls of each of ``n_ticks`` ticks, counted by
    ``torch.cuda.set_sync_debug_mode("warn")``."""
    import warnings

    counts = []
    torch.cuda.set_sync_debug_mode("warn")
    try:
        for _ in range(n_ticks):
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                sched.step()
            counts.append(sum("synchronizing" in str(w.message) for w in caught))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    return counts


@pytest.mark.gpu
@pytest.mark.parametrize("device_counters", [False, True])
@pytest.mark.parametrize("backend,inputs", [("fused_packed", "received"), ("fused", "bm")])
def test_scheduler_steady_tick_syncs_once(card, backend, inputs, device_counters):
    """The commit's copy of the bits is a steady-state tick's ONE
    synchronizing call, device counters on or off — also while producers
    feed rows every tick (their upload is staged, not blocking)."""
    from repro_torch.obs import Telemetry

    spec = CodecSpec(code=CODE_K7_NASA)
    sched = _scheduler(spec, backend, inputs, "cuda",
                       telemetry=Telemetry(device_counters=device_counters))
    for sid, table in _sched_rows(spec, inputs, 3, 23).items():
        # long streams, fed by producers every tick: far from their flush
        sched.open_stream(sid, producer=_arrivals(np.concatenate([table] * 8, axis=0)))
    sched.step()  # warm: builds and first launches land before the count
    sched.step()
    assert _syncs_per_tick(sched, 4) == [1, 1, 1, 1]
    assert len(sched.active) == 3 and sched.stats.ticks == 6


@pytest.mark.gpu
@pytest.mark.parametrize("backend,inputs", [("fused_packed", "received"), ("fused", "bm")])
def test_scheduler_snapshot_on_card_restores_on_card(card, backend, inputs):
    from repro_torch.stream import StreamScheduler

    spec = CodecSpec(code=CODE_K7_NASA, metric="soft")
    rows = _sched_rows(spec, inputs, 5, 24)
    whole = _scheduler(spec, backend, inputs, "cuda")
    for sid, table in rows.items():
        whole.submit(sid, table)
    want = whole.run()
    cut = _scheduler(spec, backend, inputs, "cuda")
    for sid, table in rows.items():
        cut.submit(sid, table)
    for _ in range(5):
        cut.step()
    snap = cut.snapshot()
    assert snap.active and all(im.packed == (backend == "fused_packed") for im in snap.active)
    restored = StreamScheduler.restore(snap)
    assert restored.device.type == "cuda" and restored.state.ring.is_cuda
    got = restored.run()
    assert got.keys() == want.keys()
    for sid in want:
        assert (got[sid][0] == want[sid][0]).all() and got[sid][1] == want[sid][1]


# --------------------------------------------------------------------------- #
# every backend on the card; the analysis layer; the paper's baseline         #
# --------------------------------------------------------------------------- #

#: every registered backend a card test decodes (the repo linter's RPR004
#: card leg); seqparallel and sharded_stream raise (ROADMAP item 9b) and are
#: exempt there
CARD_BACKENDS = ("bcjr", "fused", "fused_packed", "parallel", "sequential", "streaming",
                 "tiled", "turbo")
#: the kernels one decode of each backend launches on the card
CARD_BACKEND_KERNELS = {
    "bcjr": {"bcjr_alpha_scan", "bcjr_beta_llr_scan"},
    "fused": {"viterbi_scan"},
    "fused_packed": {"viterbi_scan_packed", "traceback_packed"},
    "parallel": {"viterbi_scan_packed_window", "minplus_matmul", "viterbi_scan_carry",
                 "traceback_packed"},
    "sequential": set(),
    "streaming": {"viterbi_scan_carry"},
    "tiled": {"viterbi_scan_packed_window", "traceback_packed_window"},
    "turbo": {"bcjr_alpha_scan", "bcjr_beta_llr_scan"},
}


@pytest.mark.gpu
@pytest.mark.parametrize("backend", CARD_BACKENDS)
def test_every_backend_decodes_on_card_as_on_cpu(card, backend):
    from repro_torch.siso import RSC_K4_LTE, QPPInterleaver, TurboSpec

    gen = torch.Generator().manual_seed(31)
    if backend == "turbo":
        spec = TurboSpec(code=RSC_K4_LTE, interleaver=QPPInterleaver(64, 7, 16))
        rx = spec.channel(gen, spec.encode(torch.randint(0, 2, (12, 64), generator=gen)),
                          snr_db=0.0)
    else:
        code = RSC_K4_LTE if backend == "bcjr" else CODE_K7_NASA
        spec = CodecSpec(code=code, metric="soft")
        rx = spec.channel(gen, spec.encode(torch.randint(0, 2, (12, 150), generator=gen)),
                          snr_db=2.0)
    kw = dict(chunk=32, tiles=4 if backend == "tiled" else None)
    reset_counts()
    on_card = decode(DecodeRequest(spec, received=rx.to(card)), backend=backend,
                     ctx=DecodeContext(**kw))
    torch.cuda.synchronize()
    assert set(launch_counts) == CARD_BACKEND_KERNELS[backend] and not plain_counts
    on_cpu = decode(DecodeRequest(spec, received=rx), backend=backend,
                    ctx=DecodeContext(device="cpu", **kw))
    assert on_card.plan.backend == on_cpu.plan.backend == backend
    assert torch.equal(on_card.bits.cpu(), on_cpu.bits)
    if backend == "turbo":
        # a float32 mean of |LLR|: the card's reduction adds in another
        # order (the port's stated turbo-metric tolerance)
        torch.testing.assert_close(on_card.path_metric.cpu(), on_cpu.path_metric,
                                   rtol=1e-6, atol=0)
    else:
        assert torch.equal(on_card.path_metric.cpu(), on_cpu.path_metric)


@pytest.mark.gpu
def test_hot_path_catalog_on_card_is_clean(card):
    from repro_torch.analysis import check_hot_paths, problems
    from repro_torch.decode import list_decoders

    report = check_hot_paths(device="cuda")
    assert {entry["backend"] for entry in report.values()} == set(list_decoders())
    for name, entry in report.items():
        assert problems(entry) == [], name
        assert entry["host_syncs"] <= entry["max_host_syncs"], (name, entry["sync_sites"])
    assert report["stream_tick"]["host_syncs"] == 1


@pytest.mark.gpu
def test_sanitized_on_card_counts_syncs_and_guards_transfers(card):
    from repro_torch.analysis import TransferError, sanitized

    x = torch.arange(8.0, device=card)
    # warm: the first use of an op in a process may synchronize once
    x.sum().item(), x.cpu(), torch.isnan(x).any().item(), (x - 2.0).log()
    torch.ones(4).pin_memory().to(card, non_blocking=True)
    torch.cuda.synchronize()
    with sanitized() as rep:
        x.sum().item()
        x.cpu()
        assert rep.host_syncs == 2, dict(rep.sync_sites)
        assert all("test_torch_gpu.py:" in site for site in rep.sync_sites)
        staged = torch.ones(4).pin_memory().to(card, non_blocking=True)
        assert rep.host_syncs == 2 and rep.uploads == 1  # staged: no sync
        with pytest.raises(TransferError):
            x[torch.tensor([0, 1])]  # a host index tensor in a card op
        assert rep.host_syncs > 2  # its implicit copy blocked, and was counted
        n = rep.host_syncs
        with pytest.raises(FloatingPointError):
            torch.log(staged - 2.0)
        assert rep.host_syncs == n  # the NaN check's reads are not counted
    assert torch.cuda.get_sync_debug_mode() == 0


@pytest.mark.gpu
@pytest.mark.parametrize("K,polys", [(3, (0b110, 0b010)), (3, (0b111, 0b101)),
                                     (7, (0o171, 0o133))])
def test_acs_step_unfused_on_card_equals_acs_step_and_cpu(card, K, polys):
    from repro_torch.core import acs_step, acs_step_unfused

    code = ConvCode(K, polys)
    gen = torch.Generator().manual_seed(K)
    pm = torch.randint(0, 4, (64, code.n_states), generator=gen).float()
    bm = torch.randint(0, 3, (64, code.n_symbols), generator=gen).float()
    got_pm, got_par = acs_step_unfused(code, pm.to(card), bm.to(card))
    want_pm, want_bp = acs_step(code, pm.to(card), bm.to(card))
    assert torch.equal(got_pm, want_pm) and torch.equal(got_par, want_bp)
    cpu_pm, cpu_par = acs_step_unfused(code, pm, bm)
    assert torch.equal(got_pm.cpu(), cpu_pm) and torch.equal(got_par.cpu(), cpu_par)


# --------------------------------------------------------------------------- #
# the LM serving path                                                          #
# --------------------------------------------------------------------------- #

LM_SERVED = ("qwen2_5_3b", "qwen3_4b", "qwen1_5_110b", "gemma3_12b", "internvl2_26b",
             "qwen3_moe_30b_a3b", "deepseek_v2_lite_16b")
#: float32 compute, card against CPU: the products sum in other orders
#: (prefill); decode reads the bf16 caches, where a value within float32
#: noise of a bf16 rounding boundary rounds the other way (one bf16 ulp)
LM_PREFILL_TOL = dict(rtol=1e-4, atol=1e-4)
LM_DECODE_TOL = dict(rtol=1e-2, atol=1e-2)


def _lm_models(arch, card, compute_dtype="float32"):
    """(CPU model, CPU params, card model, card params): the same smoke
    weights, drawn on the CPU and copied to the card."""
    import dataclasses

    from repro_torch.configs import get_smoke_arch
    from repro_torch.models import build

    bundle = get_smoke_arch(arch)
    bundle = dataclasses.replace(bundle, model=dataclasses.replace(
        bundle.model, compute_dtype=compute_dtype))
    cpu_model, card_model = build(bundle, device="cpu"), build(bundle, device=card)
    params = cpu_model.init(torch.Generator().manual_seed(0))

    def to_card(tree):
        return {k: to_card(v) for k, v in tree.items()} if isinstance(tree, dict) else tree.to(card)

    return cpu_model, params, card_model, to_card(params)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", LM_SERVED)
def test_lm_on_card_matches_cpu(card, arch):
    """Prefill logits and caches, three decode steps' logits and the greedy
    tokens of a smoke model on the card equal its CPU run (float32 compute,
    stated tolerances)."""
    from repro_torch.serve import ServeEngine

    cpu_model, params, card_model, card_params = _lm_models(arch, card)
    cfg = cpu_model.cfg
    gen = torch.Generator().manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab, (2, 16), generator=gen)}
    n_pre = 0
    if cfg.modality == "vision":
        n_pre = cfg.n_prefix_tokens
        batch["patches"] = torch.randn((2, n_pre, cfg.frontend_dim), generator=gen)
    steps = torch.randint(0, cfg.vocab, (2, 3), generator=gen)
    with torch.inference_mode():
        n_cache = 16 + n_pre + 3
        c_cpu, c_card = cpu_model.init_cache(2, n_cache), card_model.init_cache(2, n_cache)
        want, c_cpu = cpu_model.prefill(params, batch, c_cpu)
        got, c_card = card_model.prefill(card_params, {k: v.to(card) for k, v in batch.items()},
                                         c_card)
        torch.testing.assert_close(got.cpu(), want, **LM_PREFILL_TOL)
        for i in range(3):
            pos = torch.full((2,), 16 + n_pre + i, dtype=torch.int32)
            want, c_cpu = cpu_model.decode_step(params, steps[:, i:i + 1], pos, c_cpu)
            got, c_card = card_model.decode_step(card_params, steps[:, i:i + 1].to(card),
                                                 pos.to(card), c_card)
            torch.testing.assert_close(got.cpu(), want, **LM_DECODE_TOL)
    prompts = torch.randint(1, cfg.vocab, (2, 8), generator=gen)
    want = ServeEngine(cpu_model, params, max_len=20).generate(prompts, 12)
    got = ServeEngine(card_model, card_params, max_len=20).generate(prompts.to(card), 12)
    assert got["tokens"].device.type == "cuda"
    assert torch.equal(got["tokens"].cpu(), want["tokens"])
    assert torch.equal(got["done"].cpu(), want["done"])


#: MoE on the card against the CPU: bf16 compute (the served dtype), products
#: summed in other orders (``BF16`` of tests/test_torch_models.py)
LM_MOE_BF16_TOL = dict(rtol=5e-2, atol=1e-1)


def _moe_inputs(compute_dtype, zero_router=False, S=64):
    """(config, CPU params, x) of a smoke MoE layer (qwen3-moe's: 8 experts,
    top 2) with shared experts, from a seeded CPU generator."""
    import dataclasses

    from repro_torch.configs import get_smoke_arch
    from repro_torch.models import common as cm
    from repro_torch.models.moe import moe_specs

    cfg = get_smoke_arch("qwen3_moe_30b_a3b").model
    cfg = dataclasses.replace(cfg, compute_dtype=compute_dtype,
                              moe=dataclasses.replace(cfg.moe, n_shared=1))
    gen = torch.Generator().manual_seed(5)
    params = cm.init_params(moe_specs(cfg, 0), gen)
    if zero_router:
        params["router"]["kernel"].zero_()
    x = torch.randn((2, S, cfg.d_model), generator=gen).to(cm.dtype_of(compute_dtype))
    return cfg, params, x


def _to(tree, dev):
    return {k: _to(v, dev) for k, v in tree.items()} if isinstance(tree, dict) else tree.to(dev)


@pytest.mark.gpu
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_moe_apply_on_card_matches_cpu_and_repeats_bit_for_bit(card, compute_dtype):
    """The same routes as the CPU run (at the published capacity factor),
    the output within the dtype's tolerance, and two runs on the card
    bit-equal (the combine adds a token's contributions in expert order, no
    atomics)."""
    from repro_torch.models.moe import moe_apply, router

    cfg, params, x = _moe_inputs(compute_dtype)
    want_y, want_aux = moe_apply(params, cfg, x)
    card_params = _to(params, card)
    got_y, got_aux = moe_apply(card_params, cfg, x.to(card))
    again, _ = moe_apply(card_params, cfg, x.to(card))
    assert torch.equal(got_y, again)
    *_, want_ids = router(params, cfg, x)
    *_, got_ids = router(card_params, cfg, x.to(card))
    assert torch.equal(got_ids.cpu(), want_ids)
    tol = LM_PREFILL_TOL if compute_dtype == "float32" else LM_MOE_BF16_TOL
    torch.testing.assert_close(got_y.cpu(), want_y, **tol)
    for k in want_aux:
        torch.testing.assert_close(got_aux[k].cpu(), want_aux[k], rtol=1e-5, atol=1e-6)


@pytest.mark.gpu
def test_moe_zero_router_ties_to_the_lowest_experts_on_card(card):
    """Every probability ties: each token takes experts 0..k-1 on the card,
    as ``jax.lax.top_k`` orders ties, and the output equals the CPU's."""
    from repro_torch.models.moe import moe_apply, router

    cfg, params, x = _moe_inputs("float32", zero_router=True)
    card_params = _to(params, card)
    *_, ids = router(card_params, cfg, x.to(card))
    assert (ids.cpu() == torch.arange(cfg.moe.top_k)).all()
    want, _ = moe_apply(params, cfg, x)
    got, _ = moe_apply(card_params, cfg, x.to(card))
    torch.testing.assert_close(got.cpu(), want, **LM_PREFILL_TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["qwen3_moe_30b_a3b", "deepseek_v2_lite_16b"])
def test_moe_families_sync_once_a_train_step_and_never_in_generate(card, arch):
    """The MoE dispatch (sort, cummax, scatter, gather) and MLA make no host
    sync: a train step (bf16, remat "full") synchronizes only in reading its
    metrics, and generation nowhere."""
    import dataclasses
    import warnings

    from repro_torch.configs import get_smoke_arch
    from repro_torch.data import SyntheticLM
    from repro_torch.models import build
    from repro_torch.serve import ServeEngine
    from repro_torch.train.optimizer import adamw, cosine_warmup
    from repro_torch.train.train_loop import make_train_step, read_metrics

    bundle = get_smoke_arch(arch)
    bundle = dataclasses.replace(bundle, partition=dataclasses.replace(bundle.partition,
                                                                       remat="full"))
    model = build(bundle, device=card)
    params = model.init(torch.Generator(device=card).manual_seed(0))
    opt = adamw()
    state = opt.init(params)
    step = make_train_step(model, opt, cosine_warmup(1e-3, 1, 10))
    batch = SyntheticLM(model.cfg.vocab, 64, 2, seed=1)(0)
    params, state, met = step(params, state, batch, 0)  # warm
    read_metrics(met)
    engine = ServeEngine(model, params, max_len=24)
    prompts = torch.randint(1, model.cfg.vocab, (2, 8), device=card)
    engine.generate(prompts, 4)  # warm
    torch.cuda.synchronize()
    counts = []
    torch.cuda.set_sync_debug_mode("warn")
    try:
        for fn in (lambda: step(params, state, batch, 1),
                   lambda: read_metrics(step(params, state, batch, 2)[2]),
                   lambda: engine.generate(prompts, 16)):
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                fn()
            counts.append(sum("synchronizing" in str(w.message) for w in caught))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert counts == [0, 1, 0], counts
    a = engine.generate(prompts, 16)["tokens"]
    assert torch.equal(a, engine.generate(prompts, 16)["tokens"])


@pytest.mark.gpu
def test_lm_generate_makes_no_host_sync_per_token(card):
    """The decode loop keeps the tokens and ``done`` on the card: generate
    synchronizes nowhere (``set_sync_debug_mode("warn")``), at any length;
    the caller's one read of the tokens comes after it."""
    import warnings

    from repro_torch.serve import ServeEngine

    _, _, model, params = _lm_models("qwen2_5_3b", card, "bfloat16")
    engine = ServeEngine(model, params, max_len=40)
    prompts = torch.randint(1, model.cfg.vocab, (4, 8), device=card)
    engine.generate(prompts, 4)  # warm
    torch.cuda.synchronize()
    counts = []
    torch.cuda.set_sync_debug_mode("warn")
    try:
        for n in (8, 24):
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                engine.generate(prompts, n)
            counts.append(sum("synchronizing" in str(w.message) for w in caught))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert counts == [0, 0], counts


@pytest.mark.gpu
def test_serve_scenario_on_card_recovers_tokens_at_flip_0(card):
    """LM tokens (smoke vocab 512: 9 bits a token) -> bits -> K=3 -> BSC at
    flip 0 -> the planned decode on the card (#1 and #2): exact."""
    from repro_torch.configs import DECODE_SPEC, SERVE_BITS_PER_TOKEN
    from repro_torch.serve import ServeEngine, bits_to_tokens, tokens_to_bits

    _, _, model, params = _lm_models("qwen2_5_3b", card, "bfloat16")
    prompts = torch.randint(1, model.cfg.vocab, (4, 16), device=card)
    toks = ServeEngine(model, params, max_len=48).generate(prompts, 32)["tokens"]
    bits = tokens_to_bits(toks, SERVE_BITS_PER_TOKEN)
    rx = DECODE_SPEC.channel(torch.Generator(device=card).manual_seed(2),
                             DECODE_SPEC.encode(bits), flip_prob=0.0)
    reset_counts()
    res = decode(DecodeRequest(DECODE_SPEC, received=rx))
    torch.cuda.synchronize()
    assert res.plan.backend == "fused_packed"
    assert launch_counts["viterbi_scan_packed"] == 1 and launch_counts["traceback_packed"] == 1
    assert not plain_counts
    assert torch.equal(res.info_bits, bits)
    assert torch.equal(bits_to_tokens(res.info_bits, SERVE_BITS_PER_TOKEN), toks)


@pytest.mark.gpu
@pytest.mark.parametrize("path", ["lm", "viterbi"])
def test_launcher_runs_on_the_card_by_default(card, path):
    import json
    import os
    import subprocess
    import sys
    from pathlib import Path

    src = Path(__file__).resolve().parents[1] / "src"
    flags = ["--smoke"] if path == "lm" else ["--viterbi", "--batch", "16", "--bits", "128"]
    proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve", *flags],
                          env={**os.environ, "PYTHONPATH": str(src)}, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    out = json.loads("\n".join(lines[max(i for i, x in enumerate(lines) if x == "{"):]))
    assert out["device"].startswith("cuda")
    if path == "viterbi":
        assert out["backend"] == "fused_packed" and "cost: no cost model yet" in proc.stdout
    else:
        assert out["new_tokens"] == 32 and out["arch"] == "qwen2.5-smoke"


# --------------------------------------------------------------------------- #
# LM training                                                                  #
# --------------------------------------------------------------------------- #

#: a smoke train step, card against CPU, float32 compute: the gradients are
#: bf16 (taken with respect to the bf16 copy), so a product that sums in
#: another order can move a gradient by one bf16 ulp; AdamW's first steps
#: move each weight by ~lr whatever the gradient's size.  Losses by rtol,
#: grad norms by rtol, weights and moments by relative L2 error a leaf
LM_TRAIN_LOSS_RTOL = 1e-4
LM_TRAIN_NORM_RTOL = 1e-2
LM_TRAIN_LEAF_TOL = 1e-2


def _smoke_trainer(device, compute_dtype="float32", **part):
    import dataclasses

    from repro_torch.configs import get_smoke_arch
    from repro_torch.models import build

    bundle = get_smoke_arch("qwen2_5_3b")
    bundle = dataclasses.replace(
        bundle, model=dataclasses.replace(bundle.model, compute_dtype=compute_dtype),
        partition=dataclasses.replace(bundle.partition, **part))
    return build(bundle, device=device)


def _rel_l2(a, b) -> float:
    a, b = a.detach().double().cpu(), b.detach().double().cpu()
    return ((a - b).norm() / b.norm().clamp_min(1e-30)).item()


@pytest.mark.gpu
def test_lm_train_step_on_card_matches_cpu(card):
    from repro_torch.data import SyntheticLM
    from repro_torch.train.optimizer import adamw, cosine_warmup
    from repro_torch.train.train_loop import make_train_step, read_metrics
    from repro_torch.train.tree import tree_leaves, tree_map

    runs = {}
    for dev in ("cpu", card):
        model = _smoke_trainer(dev, remat="full")
        params = _smoke_trainer("cpu").init(torch.Generator().manual_seed(0))
        params = tree_map(lambda p: p.to(dev), params)
        opt = adamw()
        state = opt.init(params)
        step = make_train_step(model, opt, cosine_warmup(1e-3, 0, 10))
        batch = SyntheticLM(model.cfg.vocab, 64, 2, seed=1, device=str(dev))(0)
        mets = []
        for i in range(2):
            params, state, met = step(params, state, batch, i)
            mets.append(read_metrics(met))
        runs[torch.device(dev).type] = (mets, tree_leaves((params, state)))
    (want_m, want), (got_m, got) = runs["cpu"], runs["cuda"]
    assert all(t.device.type == "cuda" for t in got)
    for g, w in zip(got_m, want_m):
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=LM_TRAIN_LOSS_RTOL)
        np.testing.assert_allclose(g["grad_norm"], w["grad_norm"], rtol=LM_TRAIN_NORM_RTOL)
        assert g["lr"] == w["lr"]
    errs = [_rel_l2(g, w) for g, w in zip(got, want)]
    assert max(errs) < LM_TRAIN_LEAF_TOL, errs


@pytest.mark.gpu
def test_lm_train_step_makes_one_host_sync_and_generate_none(card):
    """A steady train step (bf16, remat "full" over 4 groups: nested
    checkpoints) synchronizes nowhere; reading its metrics is the one sync.
    Generation with the trained weights still makes none."""
    import dataclasses
    import warnings

    from repro_torch.configs import get_smoke_arch
    from repro_torch.data import SyntheticLM
    from repro_torch.models import build
    from repro_torch.serve import ServeEngine
    from repro_torch.train.optimizer import adamw, cosine_warmup
    from repro_torch.train.train_loop import make_train_step, read_metrics

    bundle = get_smoke_arch("qwen2_5_3b")
    bundle = dataclasses.replace(
        bundle, model=dataclasses.replace(bundle.model, n_layers=4),
        partition=dataclasses.replace(bundle.partition, remat="full"))
    model = build(bundle, device=card)
    params = model.init(torch.Generator(device=card).manual_seed(0))
    opt = adamw()
    state = opt.init(params)
    step = make_train_step(model, opt, cosine_warmup(1e-3, 1, 10))
    batch = SyntheticLM(model.cfg.vocab, 64, 2, seed=1)(0)
    params, state, met = step(params, state, batch, 0)  # warm
    read_metrics(met)
    engine = ServeEngine(model, params, max_len=24)
    prompts = torch.randint(1, model.cfg.vocab, (2, 8), device=card)
    engine.generate(prompts, 4)  # warm
    torch.cuda.synchronize()
    counts = []
    torch.cuda.set_sync_debug_mode("warn")
    try:
        for fn in (lambda: step(params, state, batch, 1),
                   lambda: read_metrics(step(params, state, batch, 2)[2]),
                   lambda: engine.generate(prompts, 16)):
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                fn()
            counts.append(sum("synchronizing" in str(w.message) for w in caught))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert counts == [0, 1, 0], counts


@pytest.mark.gpu
def test_lm_crash_restore_resume_on_card(card, tmp_path):
    """A simulated failure after step 3 restores the step-4 checkpoint onto
    the card and resumes: weights, optimizer state and losses equal an
    uninterrupted run on the card (deterministic algorithms: the embedding's
    scatter-add otherwise accumulates in an order the atomics decide)."""
    import dataclasses

    from repro_torch.configs import SHAPES
    from repro_torch.data import make_data_iter
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.train_loop import train
    from repro_torch.train.tree import tree_leaves

    model = _smoke_trainer(card, "bfloat16")
    data = make_data_iter(model, dataclasses.replace(SHAPES["train_4k"], seq_len=64,
                                                     global_batch=2))
    kw = dict(steps=6, lr=1e-3, warmup=1, log_every=1)
    crashed = []

    def fail_hook(step):
        if step == 3 and not crashed:
            crashed.append(step)
            raise ckpt.SimulatedFailure("node lost")

    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        clean = train(model, data, **kw)
        report = train(model, data, checkpoint_dir=str(tmp_path), checkpoint_every=2,
                       fail_hook=fail_hook, **kw)
    finally:
        torch.use_deterministic_algorithms(False)
    assert report["restarts"] == 1 and report["final_step"] == 6
    assert [h["loss"] for h in report["history"]] == [h["loss"] for h in clean["history"]]
    got = tree_leaves((report["params"], report["opt_state"]))
    assert all(t.device.type == "cuda" for t in got)
    for a, b in zip(got, tree_leaves((clean["params"], clean["opt_state"]))):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_train_launcher_runs_on_the_card_by_default(card):
    import os
    import subprocess
    import sys
    from pathlib import Path

    src = Path(__file__).resolve().parents[1] / "src"
    proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", "--arch",
                           "qwen2_5_3b", "--smoke", "--steps", "3", "--warmup", "1"],
                          env={**os.environ, "PYTHONPATH": str(src)}, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr
    assert "training qwen2.5-smoke on cuda" in proc.stdout
    assert '"steps": 3' in proc.stdout
