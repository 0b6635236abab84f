"""The port's CUDA kernels held against their plain PyTorch versions on the
card, and the decode paths on the card (short blocks, tiled long blocks,
streaming, the unpacked ``fused`` route, ``bcjr`` and turbo, the
block-parallel ``parallel`` route, the stream scheduler, every registered
backend) against the same decodes on the CPU; the scheduler's one
synchronizing call a tick; the analysis layer's hot-path catalog and
sanitizer on the card; the paper's unfused ACS step; the LM's serving and
training paths (a train step against its CPU run, its one host sync,
crash -> restore -> resume, the launchers), with the MoE, MLA,
recurrent (Mamba, xLSTM) and encoder-decoder (seamless-m4t) families, and
the LM on a mesh (data parallel, and tensor-parallel serving).

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
from repro_torch.launch.mesh import make_mesh


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
# the slot-sharded scheduler on meshes of the card                             #
# --------------------------------------------------------------------------- #


def _sharded(spec, backend, inputs, devices, **kw):
    """The ``_scheduler`` configuration over a (len(devices), 1) (data,
    model) mesh: 3 slots a shard."""
    from repro_torch.stream import StreamScheduler

    mesh = make_mesh((len(devices), 1), ("data", "model"), devices=devices)
    return StreamScheduler(spec, n_slots=3 * len(devices),
                           chunk=64 if backend == "fused_packed" else 32, backend=backend,
                           inputs=inputs, mesh=mesh, device="cuda", **kw)


@pytest.mark.gpu
@pytest.mark.parametrize("device_counters", [False, True])
@pytest.mark.parametrize("backend,inputs", [("fused_packed", "received"), ("fused", "bm")])
def test_sharded_scheduler_steady_tick_syncs_once(card, backend, inputs, device_counters):
    """Over a (2, 1) mesh of the card the tick still makes ONE synchronizing
    call — the copy of every shard's bits, gathered onto the mesh's first
    device — device counters on or off, producers feeding every tick."""
    from repro_torch.obs import Telemetry

    spec = CodecSpec(code=CODE_K7_NASA)
    sched = _sharded(spec, backend, inputs, [card, card],
                     telemetry=Telemetry(device_counters=device_counters))
    for sid, table in _sched_rows(spec, inputs, 6, 23).items():
        sched.open_stream(sid, producer=_arrivals(np.concatenate([table] * 8, axis=0)))
    sched.step()  # warm: builds and first launches land before the count
    sched.step()
    assert _syncs_per_tick(sched, 4) == [1, 1, 1, 1]
    assert len(sched.active) == 6 and sched.stats.ticks == 6


@pytest.mark.gpu
@pytest.mark.parametrize("backend,inputs,kernels", [
    ("fused_packed", "received", ("viterbi_scan_packed_carry", "traceback_packed")),
    ("fused", "bm", ("viterbi_scan_carry",)),
])
def test_sharded_scheduler_launches_per_shard_and_matches_one_device(card, backend, inputs,
                                                                     kernels):
    """Every tick launches the hot loop's kernels once per shard and no plain
    version; every stream equals a one-card scheduler's with the same 9
    slots, and the same sharded scheduler's on a CPU mesh (the plain
    versions)."""
    from repro_torch.stream import StreamScheduler

    spec = CodecSpec(code=CODE_K7_NASA, metric="soft")
    rows = _sched_rows(spec, inputs, 8, 25)
    reset_counts()
    sharded = _sharded(spec, backend, inputs, [card] * 3)
    _drive(sharded, rows)
    torch.cuda.synchronize()
    for k in kernels:
        assert launch_counts[k] == 3 * sharded.stats.ticks > 0, k
    assert not plain_counts
    one_card = StreamScheduler(spec, n_slots=9, chunk=sharded.chunk, backend=backend,
                               inputs=inputs, device="cuda")
    on_cpu = StreamScheduler(spec, n_slots=9, chunk=sharded.chunk, backend=backend,
                             inputs=inputs, device="cpu",
                             mesh=make_mesh((3, 1), ("data", "model"), devices=["cpu"] * 3))
    for other in (one_card, on_cpu):
        _drive(other, rows)
        assert other.results.keys() == sharded.results.keys()
        for sid, (bits, metric) in sharded.results.items():
            assert (bits == other.results[sid][0]).all() and metric == other.results[sid][1]


@pytest.mark.gpu
def test_sharded_scheduler_state_lives_on_its_shards_cards(card):
    """Over cuda:0 and cuda:1 each shard's pm, ring, offsets and arena slab
    lie on its own card; a snapshot restored over the two cards the other
    way round runs to the end there, every stream equal to a one-card
    scheduler's, and cuda:0 stays current.  Skips below two cards."""
    from repro_torch.stream import StreamScheduler

    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards")
    first, second = torch.device("cuda", 0), torch.device("cuda", 1)
    torch.cuda.set_device(first)
    spec = CodecSpec(code=CODE_K7_NASA)
    rows = _sched_rows(spec, "received", 6, 26)
    sched = _sharded(spec, "fused_packed", "received", [first, second])
    producers = {sid: _arrivals(table) for sid, table in rows.items()}
    for sid, prod in producers.items():
        sched.open_stream(sid, producer=prod)
    for _ in range(3):
        sched.step()
    for blocks in (sched.state.pm, sched.state.ring, sched.offset, sched._arena):
        assert [b.device for b in blocks] == [first, second]
    snap = sched.snapshot()
    restored = StreamScheduler.restore(
        snap, mesh=make_mesh((2, 1), ("data", "model"), devices=[second, first]))
    assert [b.device for b in restored.state.pm] == [second, first]
    for im in snap.active + snap.pending:
        if not im.closed:
            restored.attach_producer(im.stream_id, producers[im.stream_id])
    restored.run()
    assert torch.cuda.current_device() == 0
    one_card = StreamScheduler(spec, n_slots=6, chunk=64, backend="fused_packed",
                               inputs="received", device="cuda")
    _drive(one_card, rows)
    for sid, (bits, metric) in one_card.results.items():
        assert (restored.results[sid][0] == bits).all() and restored.results[sid][1] == metric


# --------------------------------------------------------------------------- #
# every backend on the card; the analysis layer; the paper's baseline         #
# --------------------------------------------------------------------------- #

#: every registered backend a card test decodes (the repo linter's RPR004
#: card leg)
CARD_BACKENDS = ("bcjr", "fused", "fused_packed", "parallel", "seqparallel", "sequential",
                 "sharded_stream", "streaming", "tiled", "turbo")
#: the kernels one decode of each backend launches on the card
CARD_BACKEND_KERNELS = {
    "bcjr": {"bcjr_alpha_scan", "bcjr_beta_llr_scan"},
    "fused": {"viterbi_scan"},
    "fused_packed": {"viterbi_scan_packed", "traceback_packed"},
    "parallel": {"viterbi_scan_packed_window", "minplus_matmul", "viterbi_scan_carry",
                 "traceback_packed"},
    # 2 shards of T = 156 steps: 78 a shard, so the unpacked re-scan
    "seqparallel": {"viterbi_scan_packed_window", "minplus_matmul", "viterbi_scan_carry",
                    "traceback_packed"},
    "sequential": set(),
    # 12 streams over 2 slot shards, chunk 32: the packed tick
    "sharded_stream": {"viterbi_scan_packed_carry", "traceback_packed"},
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
    mesh = {"cuda": None, "cpu": None}
    if backend == "seqparallel":
        mesh = {d: make_mesh((2,), ("model",), devices=[d, d]) for d in ("cuda", "cpu")}
    if backend == "sharded_stream":
        mesh = {d: make_mesh((2, 1), ("data", "model"), devices=[d, d]) for d in ("cuda", "cpu")}
    reset_counts()
    on_card = decode(DecodeRequest(spec, received=rx.to(card)), backend=backend,
                     ctx=DecodeContext(mesh=mesh["cuda"], **kw))
    torch.cuda.synchronize()
    assert set(launch_counts) == CARD_BACKEND_KERNELS[backend] and not plain_counts
    on_cpu = decode(DecodeRequest(spec, received=rx), backend=backend,
                    ctx=DecodeContext(device="cpu", mesh=mesh["cpu"], **kw))
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
@pytest.mark.parametrize("n", [1, 2, 4])
def test_seqparallel_on_card_matches_cpu_mesh_and_parallel(card, n):
    """seqparallel over n shards on one card against the same decode on a
    CPU mesh (the plain versions) and against ``parallel`` at chunk T/n (the
    same transfer matrices).  T = 256 re-scans into packed words (#3), T =
    260 into unpacked selects (#7)."""
    code = ConvCode(7, (0o171, 0o133))
    gen = torch.Generator().manual_seed(40 + n)
    on_card_mesh = make_mesh((1, n), ("data", "model"), devices=[card] * n)
    cpu_mesh = make_mesh((1, n), ("data", "model"), devices=["cpu"] * n)
    for T in (256, 260):
        rescan = "viterbi_scan_packed_carry" if (T // n) % 32 == 0 else "viterbi_scan_carry"
        for metric in ("hard", "soft"):
            spec = CodecSpec(code=code, metric=metric)
            bits = torch.randint(0, 2, (6, T - spec.n_flush), generator=gen)
            rx = spec.channel(gen, spec.encode(bits), snr_db=2.0) if metric == "soft" else \
                spec.channel(gen, spec.encode(bits), flip_prob=0.03)
            reset_counts()
            got = decode(DecodeRequest(spec, received=rx.to(card)), backend="seqparallel",
                         ctx=DecodeContext(mesh=on_card_mesh))
            torch.cuda.synchronize()
            assert set(launch_counts) == {"viterbi_scan_packed_window", "minplus_matmul",
                                          rescan, "traceback_packed"} and not plain_counts
            assert got.diagnostics == {"backend": "seqparallel", "mesh_axis": "model",
                                       "mesh_size": n}
            want = decode(DecodeRequest(spec, received=rx), backend="seqparallel",
                          ctx=DecodeContext(device="cpu", mesh=cpu_mesh))
            assert got.bits.is_cuda and torch.equal(got.bits.cpu(), want.bits)
            assert torch.equal(got.path_metric.cpu(), want.path_metric)
            if metric == "hard":
                # the same transfer matrices; integer sums, so the prefix
                # tree of ``parallel`` and the fold agree exactly
                par = decode(DecodeRequest(spec, received=rx.to(card)), backend="parallel",
                             ctx=DecodeContext(chunk=T // n))
                assert torch.equal(got.bits, par.bits)
                assert torch.equal(got.path_metric, par.path_metric)


@pytest.mark.gpu
def test_decodes_on_a_second_card_run_there(card):
    """With cuda:0 current, meshes whose first card is cuda:1 decode there:
    a short block (``fused_packed``), a long block the mesh cannot shard
    (``tiled``), a turbo block, and ``seqparallel`` on cuda:1 alone and over
    cuda:1 and cuda:0.  Every kernel launches on the card its operands lie
    on, the results come back on cuda:1 equal to the CPU's, and cuda:0 stays
    current.  Skips below two cards."""
    from repro_torch.siso import RSC_K4_LTE, QPPInterleaver, TurboSpec

    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards")
    first, second = torch.device("cuda", 0), torch.device("cuda", 1)
    torch.cuda.set_device(first)
    gen = torch.Generator().manual_seed(52)
    conv = CodecSpec(code=CODE_K7_NASA, metric="soft")
    turbo = TurboSpec(code=RSC_K4_LTE, interleaver=QPPInterleaver(64, 7, 16))
    seq = {"viterbi_scan_packed_window", "minplus_matmul", "traceback_packed"}
    cases = (  # (spec, info bits, mesh devices, the planned backend, its kernels)
        (conv, 64, [second] * 2, "fused_packed", {"viterbi_scan_packed", "traceback_packed"}),
        (conv, 1024, [second] * 6, "tiled", {"viterbi_scan_packed_window",
                                              "traceback_packed_window"}),
        (turbo, 64, [second] * 2, "turbo", {"bcjr_alpha_scan", "bcjr_beta_llr_scan"}),
        (conv, 1024, [second] * 2, "seqparallel", seq | {"viterbi_scan_carry"}),
        (conv, 1146, [second, first], "seqparallel", seq | {"viterbi_scan_packed_carry"}),
    )
    for spec, n_info, devices, backend, kernels in cases:
        n = len(devices)
        bits = torch.randint(0, 2, (4, n_info), generator=gen)
        rx = spec.channel(gen, spec.encode(bits), snr_db=2.0 if spec is conv else 0.0)
        torch.cuda.synchronize(first), torch.cuda.synchronize(second)
        reset_counts()
        got = decode(DecodeRequest(spec, received=rx),
                     ctx=DecodeContext(mesh=make_mesh((n,), ("model",), devices=devices)))
        torch.cuda.synchronize(first), torch.cuda.synchronize(second)
        assert got.plan.backend == backend, (backend, got.plan.reason)
        assert set(launch_counts) == kernels and not plain_counts, (backend, dict(launch_counts))
        assert torch.cuda.current_device() == 0
        assert got.bits.device == got.path_metric.device == second, backend
        ctx = dict(device="cpu", tiles=got.plan.ctx.tiles)
        if backend == "seqparallel":
            ctx["mesh"] = make_mesh((n,), ("model",), devices=["cpu"] * n)
        want = decode(DecodeRequest(spec, received=rx), backend=backend,
                      ctx=DecodeContext(**ctx))
        assert torch.equal(got.bits.cpu(), want.bits), (backend, devices)
        # turbo's metric is a float32 mean (the port's stated tolerance)
        torch.testing.assert_close(got.path_metric.cpu(), want.path_metric,
                                   rtol=1e-6 if backend == "turbo" else 0, atol=0)


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
        assert out["backend"] == "fused_packed" and "cost: ~" in proc.stdout
        assert "flops/byte" in proc.stdout
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


def _smoke_trainer(device, compute_dtype="float32", arch="qwen2_5_3b", **part):
    import dataclasses

    from repro_torch.configs import get_smoke_arch
    from repro_torch.models import build

    bundle = get_smoke_arch(arch)
    bundle = dataclasses.replace(
        bundle, model=dataclasses.replace(bundle.model, compute_dtype=compute_dtype),
        partition=dataclasses.replace(bundle.partition, **part))
    return build(bundle, device=device)


def _rel_l2(a, b) -> float:
    a, b = a.detach().double().cpu(), b.detach().double().cpu()
    return ((a - b).norm() / b.norm().clamp_min(1e-30)).item()


@pytest.mark.gpu
def test_lm_train_step_on_card_matches_cpu(card):
    _train_steps_match(card, "qwen2_5_3b")


def _train_steps_on_card_match_cpu(card, arch, steps=2):
    """``steps`` AdamW steps (float32 compute, remat "full") of ``arch``'s
    smoke model on the card and on the CPU from the same weights and batch:
    (the card's metrics and params-and-state leaves, the CPU's)."""
    from repro_torch.data import SyntheticLM
    from repro_torch.train.optimizer import adamw, cosine_warmup
    from repro_torch.train.train_loop import make_train_step, read_metrics
    from repro_torch.train.tree import tree_leaves, tree_map

    runs = {}
    for dev in ("cpu", card):
        model = _smoke_trainer(dev, arch=arch, remat="full")
        params = _smoke_trainer("cpu", arch=arch).init(torch.Generator().manual_seed(0))
        params = tree_map(lambda p: p.to(dev), params)
        opt = adamw()
        state = opt.init(params)
        step = make_train_step(model, opt, cosine_warmup(1e-3, 0, 10))
        batch = SyntheticLM(model.cfg.vocab, 64, 2, seed=1, device=str(dev))(0)
        mets = []
        for i in range(steps):
            params, state, met = step(params, state, batch, i)
            mets.append(read_metrics(met))
        runs[torch.device(dev).type] = (mets, params, state)
    assert all(t.device.type == "cuda" for t in tree_leaves(runs["cuda"][1:]))
    return runs["cuda"], runs["cpu"]


def _train_steps_match(card, arch):
    from repro_torch.train.tree import tree_leaves

    (got_m, *got), (want_m, *want) = _train_steps_on_card_match_cpu(card, arch)
    for g, w in zip(got_m, want_m):
        runs = f"card {got_m}, cpu {want_m}"
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=LM_TRAIN_LOSS_RTOL, err_msg=runs)
        np.testing.assert_allclose(g["grad_norm"], w["grad_norm"], rtol=LM_TRAIN_NORM_RTOL,
                                   err_msg=runs)
        assert g["lr"] == w["lr"]
    errs = [_rel_l2(g, w) for g, w in zip(tree_leaves(got), tree_leaves(want))]
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


# --------------------------------------------------------------------------- #
# the recurrent families (jamba: Mamba + attention + MoE; xlstm)               #
# --------------------------------------------------------------------------- #

LM_RECURRENT = ("jamba_v0_1_52b", "xlstm_350m")


@pytest.mark.gpu
@pytest.mark.parametrize("arch", LM_RECURRENT)
def test_recurrent_families_sync_once_a_train_step_and_never_in_generate(card, arch):
    """The selective scan, the chunkwise mLSTM and the sLSTM loop make no
    host sync: a train step (bf16, remat "full") synchronizes only in
    reading its metrics, generation nowhere, and two generations are
    bit-equal."""
    test_moe_families_sync_once_a_train_step_and_never_in_generate(card, arch)


#: xlstm's float32 forward rounds ``h`` to bf16 (the reference's rounding),
#: so one ``h`` element may round the other way on the card: its loss by
#: 2^-7 and its gradients, read through AdamW's first moment (0.1 times the
#: clipped gradient after one step), by 3e-2 relative L2 a leaf — the CPU
#: suite's tolerances against the reference (tests/test_torch_recurrent.py).
#: Only one step: AdamW's first update moves every weight by +-lr, so a
#: near-zero gradient element of the other sign moves a zero-initialized
#: bias leaf by 2 lr (CPU, the port against the reference: 0.12 relative L2)
LM_XLSTM_LOSS_RTOL, LM_XLSTM_GRAD_TOL = 2 ** -7, 3e-2


@pytest.mark.gpu
def test_recurrent_train_steps_on_card_match_cpu_jamba(card):
    _train_steps_match(card, "jamba_v0_1_52b")


@pytest.mark.gpu
def test_recurrent_train_step_on_card_matches_cpu_xlstm(card):
    from repro_torch.train.tree import tree_leaves

    (got_m, _, got), (want_m, _, want) = _train_steps_on_card_match_cpu(card, "xlstm_350m", 1)
    runs = f"card {got_m}, cpu {want_m}"
    np.testing.assert_allclose(got_m[0]["loss"], want_m[0]["loss"], rtol=LM_XLSTM_LOSS_RTOL,
                               err_msg=runs)
    np.testing.assert_allclose(got_m[0]["grad_norm"], want_m[0]["grad_norm"],
                               rtol=LM_XLSTM_GRAD_TOL, err_msg=runs)
    errs = [_rel_l2(g, w) for g, w in zip(tree_leaves(got["mu"]), tree_leaves(want["mu"]))]
    assert max(errs) < LM_XLSTM_GRAD_TOL, errs


@pytest.mark.gpu
@pytest.mark.parametrize("arch", LM_RECURRENT)
def test_recurrent_decode_step_replays_in_a_cuda_graph(card, arch):
    """The mixers write their new states into the cache tensors they are
    given, in place, so a decode step captured in a CUDA graph replays: two
    replays give the logits and caches of two eager steps from the same
    caches (float32 compute, LM_PREFILL_TOL)."""
    from repro_torch.train.tree import tree_leaves, tree_map

    _, _, model, params = _lm_models(arch, card)
    B, P = 2, 8
    prompts = torch.randint(1, model.cfg.vocab, (B, P), device=card)
    with torch.inference_mode():
        start = model.init_cache(B, P + 4)
        model.prefill(params, {"tokens": prompts}, start)
        tok = prompts[:, -1:].clone()
        pos = torch.full((B,), P, dtype=torch.int32, device=card)
        eager, want = tree_map(torch.clone, start), []
        for i in range(2):
            want.append(model.decode_step(params, tok, pos + i, eager)[0].clone())
        caches, step_pos = tree_map(torch.clone, start), pos.clone()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):  # warm the libraries outside the capture
            model.decode_step(params, tok, step_pos, caches)
        torch.cuda.current_stream().wait_stream(side)
        tree_map(lambda c, s: c.copy_(s), caches, start)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            logits, _ = model.decode_step(params, tok, step_pos, caches)
        got = []
        for i in range(2):
            step_pos.copy_(pos + i)
            graph.replay()
            got.append(logits.clone())
        torch.cuda.synchronize()
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, **LM_PREFILL_TOL)
    for g, w in zip(tree_leaves(caches), tree_leaves(eager)):
        torch.testing.assert_close(g.float(), w.float(), **LM_PREFILL_TOL)


# --------------------------------------------------------------------------- #
# the encoder-decoder family (seamless-m4t)                                    #
# --------------------------------------------------------------------------- #

LM_ENCDEC = "seamless_m4t_large_v2"


def _encdec_batch(cfg, gen, S_enc, S_dec, device="cpu"):
    """bf16 frames and decoder tokens of the smoke config, from ``gen``."""
    frames = torch.randn((2, S_enc, cfg.frontend_dim), generator=gen).to(torch.bfloat16)
    tokens = torch.randint(0, cfg.vocab, (2, S_dec), generator=gen)
    return {"frames": frames.to(device), "tokens": tokens.to(device)}


@pytest.mark.gpu
@pytest.mark.parametrize("cache_len", [16, 32])
def test_encdec_on_card_matches_cpu(card, cache_len):
    """seamless's smoke model (float32 compute): prefill logits and both
    caches, then three decode steps' logits, on the card against the CPU,
    with a cross cache as long as the 16 frames and one twice as long (the
    decode attends over the zero rows too, on both devices)."""
    from repro_torch.train.tree import tree_leaves

    cpu_model, params, card_model, card_params = _lm_models(LM_ENCDEC, card)
    cfg = cpu_model.cfg
    gen = torch.Generator().manual_seed(1)
    batch = _encdec_batch(cfg, gen, 16, 8)
    steps = torch.randint(0, cfg.vocab, (2, 3), generator=gen)
    with torch.inference_mode():
        c_cpu, c_card = cpu_model.init_cache(2, cache_len), card_model.init_cache(2, cache_len)
        want, c_cpu = cpu_model.prefill(params, batch, c_cpu)
        got, c_card = card_model.prefill(card_params, {k: v.to(card) for k, v in batch.items()},
                                         c_card)
        torch.testing.assert_close(got.cpu(), want, **LM_PREFILL_TOL)
        for g, w in zip(tree_leaves(c_card), tree_leaves(c_cpu)):
            torch.testing.assert_close(g.cpu().float(), w.float(), **LM_DECODE_TOL)
        for i in range(3):
            pos = torch.full((2,), 8 + i, dtype=torch.int32)
            want, c_cpu = cpu_model.decode_step(params, steps[:, i:i + 1], pos, c_cpu)
            got, c_card = card_model.decode_step(card_params, steps[:, i:i + 1].to(card),
                                                 pos.to(card), c_card)
            torch.testing.assert_close(got.cpu(), want, **LM_DECODE_TOL)


@pytest.mark.gpu
def test_encdec_train_loss_and_grads_on_card_match_cpu(card):
    """``train_loss`` of seamless's smoke model (float32 compute, remat
    "full") and its gradients on the card against the CPU: the loss by
    LM_TRAIN_LOSS_RTOL, each gradient leaf by LM_TRAIN_LEAF_TOL (relative
    L2)."""
    from repro_torch.train.tree import tree_leaves, tree_map

    cpu_params = _smoke_trainer("cpu", arch=LM_ENCDEC).init(torch.Generator().manual_seed(0))
    batch = _encdec_batch(_smoke_trainer("cpu", arch=LM_ENCDEC).cfg,
                          torch.Generator().manual_seed(2), 32, 8)
    batch["labels"] = torch.roll(batch["tokens"], -1, dims=1)
    runs = {}
    for dev in ("cpu", card):
        model = _smoke_trainer(dev, arch=LM_ENCDEC, remat="full")
        params = tree_map(lambda p: p.detach().to(dev).requires_grad_(), cpu_params)
        loss, _ = model.train_loss(params, {k: v.to(dev) for k, v in batch.items()})
        runs[torch.device(dev).type] = (loss.item(),
                                        torch.autograd.grad(loss, tree_leaves(params)))
    (got, got_g), (want, want_g) = runs["cuda"], runs["cpu"]
    np.testing.assert_allclose(got, want, rtol=LM_TRAIN_LOSS_RTOL)
    assert all(g.device.type == "cuda" for g in got_g)
    errs = [_rel_l2(g, w) for g, w in zip(got_g, want_g)]
    assert max(errs) < LM_TRAIN_LEAF_TOL, errs


@pytest.mark.gpu
def test_encdec_decode_loop_makes_no_host_sync(card):
    """Greedy decoding of seamless's smoke model (bf16) through
    ``Model.prefill`` and ``decode_step``, the tokens fed back on the card:
    the loop of decode steps synchronizes nowhere
    (``set_sync_debug_mode("warn")``) and two runs are bit-equal."""
    import warnings

    _, _, model, params = _lm_models(LM_ENCDEC, card, "bfloat16")
    batch = _encdec_batch(model.cfg, torch.Generator().manual_seed(3), 16, 8, card)

    def run(syncs=None):
        with torch.inference_mode():
            caches = model.init_cache(2, 32)
            logits, caches = model.prefill(params, batch, caches)
            tok = logits.argmax(-1).to(torch.int32)[:, None]
            pos = torch.full((2,), 8, dtype=torch.int32, device=card)
            out = [tok]
            torch.cuda.synchronize()
            if syncs is not None:
                torch.cuda.set_sync_debug_mode("warn")
            try:
                with warnings.catch_warnings(record=True) as caught:
                    warnings.simplefilter("always")
                    for _ in range(12):
                        logits, caches = model.decode_step(params, tok, pos, caches)
                        tok = logits.argmax(-1).to(torch.int32)[:, None]
                        out.append(tok)
                        pos = pos + 1
            finally:
                torch.cuda.set_sync_debug_mode(0)
            if syncs is not None:
                syncs.extend(str(w.message) for w in caught if "synchronizing" in str(w.message))
            return torch.cat(out, dim=1)

    run()  # warm
    syncs = []
    first = run(syncs)
    assert syncs == [], syncs
    assert torch.equal(first, run())


# --------------------------------------------------------------------------- #
# the cost model: meta counts against card runs                                #
# --------------------------------------------------------------------------- #


@pytest.mark.gpu
@pytest.mark.parametrize("backend,shape,tiles", [
    ("fused_packed", (300, 70), None), ("tiled", (64, 1030), 4), ("tiled", (8, 1030), None)])
def test_predicted_costs_equal_the_card_run_count(card, backend, shape, tiles):
    """``predicted_costs()`` (counted on meta) equals the same decode
    counted on the card with real inputs; counting it launches no kernel,
    runs no plain version, makes no host sync and allocates nothing."""
    import warnings

    from repro_torch.decode import plan_decode
    from repro_torch.roofline import count_fn_costs

    spec = CodecSpec(code=CODE_K7_NASA, metric="soft")
    gen = torch.Generator(device=card).manual_seed(5)
    bm = torch.rand(shape + (spec.table_width,), generator=gen, device=card)
    plan = plan_decode(spec, shape, backend=backend, ctx=DecodeContext(tiles=tiles))
    torch.cuda.synchronize()
    reset_counts()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            pred = plan.predicted_costs()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert not [w for w in caught if "synchronizing" in str(w.message)]
    assert not launch_counts and not plain_counts
    assert torch.cuda.max_memory_allocated() == torch.cuda.memory_allocated() == base
    got = count_fn_costs(lambda t: plan.decoder(spec, t, ctx=plan.ctx).bits, bm)
    assert got == pred and pred["flops"] > 0
    assert sum(launch_counts.values()) >= 2 and not plain_counts


# --------------------------------------------------------------------------- #
# the LM's data-parallel mesh path (ServeEngine(mesh=), the train step)       #
# --------------------------------------------------------------------------- #


def _count_syncs(fn):
    """(fn(), the synchronizing CUDA calls it made)."""
    import warnings

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            out = fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    return out, sum("synchronizing" in str(w.message) for w in caught)


@pytest.mark.gpu
def test_lm_mesh_engine_makes_no_host_sync_and_equals_one_device(card):
    """``ServeEngine`` over a (2, 1) mesh of two cells on the card: no sync
    at any length, greedy tokens equal to the same engine on a (1, 1) mesh
    (the same flash-decode numerics a row), the first step's logits within
    phase 13's float32 tolerance of the one-device model's."""
    from repro_torch.serve import ServeEngine

    _, _, model, params = _lm_models("qwen2_5_3b", card, "float32")
    prompts = torch.randint(1, model.cfg.vocab, (4, 8), device=card)
    engine = ServeEngine(model, params, max_len=40, mesh=make_mesh(
        (2, 1), ("data", "model"), devices=[card] * 2))
    engine.generate(prompts, 4)  # warm
    counts = [_count_syncs(lambda n=n: engine.generate(prompts, n))[1] for n in (8, 24)]
    assert counts == [0, 0], counts
    unit = ServeEngine(model, params, max_len=40, mesh=make_mesh((1, 1), ("data", "model"),
                                                                 devices=[card]))
    got = engine.generate(prompts, 24)
    assert torch.equal(got["tokens"], unit.generate(prompts, 24)["tokens"])
    assert got["tokens"].device.type == "cuda"
    with torch.inference_mode():
        caches = model.init_cache(4, 9)
        want, _ = model.prefill(params, {"tokens": prompts}, caches)
        step_w, _ = model.decode_step(params, got["tokens"][:, :1], torch.full(
            (4,), 8, dtype=torch.int32, device=card), caches)
        caches = model.init_cache(4, 9)
        mesh = make_mesh((1, 1), ("data", "model"), devices=[card])
        model.prefill(params, {"tokens": prompts}, caches, mesh=mesh)
        step_m, _ = model.decode_step(params, got["tokens"][:, :1], torch.full(
            (4,), 8, dtype=torch.int32, device=card), caches, mesh=mesh)
    # the flash decode rounds unnormalized probabilities to the bf16 caches'
    # dtype where _masked_decode rounds normalized ones: chip_smoke.py phase
    # 13's float32 teacher-forcing tolerance
    np.testing.assert_allclose(step_m.cpu().numpy(), step_w.cpu().numpy(), rtol=2e-2, atol=5e-2)


def _mesh_step_runs(card, meshes, steps=2):
    """``steps`` AdamW steps of the bf16 smoke qwen2.5 (remat "full") on one
    device and over each mesh of ``meshes``, from the same weights and
    batch: [(metrics a step, params, state)] in that order, the second
    step's host syncs counted."""
    from repro_torch.data import SyntheticLM
    from repro_torch.train.optimizer import adamw, cosine_warmup
    from repro_torch.train.train_loop import make_train_step, read_metrics

    model = _smoke_trainer(card, compute_dtype="bfloat16", remat="full")
    batch = SyntheticLM(model.cfg.vocab, 64, 4, seed=1, device=str(card))(0)
    runs = []
    for mesh in (None,) + tuple(meshes):
        params = model.init(torch.Generator(device=card).manual_seed(0))
        opt = adamw()
        state = opt.init(params)
        step = make_train_step(model, opt, cosine_warmup(1e-3, 1, 10), mesh=mesh)
        mets, syncs = [], None
        for i in range(steps):
            (params, state, met), n = _count_syncs(lambda i=i: step(params, state, batch, i))
            syncs = n if i == 1 else syncs
            mets.append(read_metrics(met))
        runs.append((mets, params, state, syncs))
    return runs


def _mesh_runs_close(got, want, tol=3e-2):
    from repro_torch.parallel.sharding import gather_tree
    from repro_torch.train.tree import tree_leaves

    (gm, gp, gs, _), (wm, wp, ws, _) = got, want
    for g, w in zip(gm, wm):
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=1e-3)
    np.testing.assert_allclose(gm[0]["loss"], wm[0]["loss"], rtol=1e-5)
    for key in gs:  # AdamW's mu; nu by its square root (linear in the gradients)
        for g, w in zip(tree_leaves(gather_tree(gs[key])), tree_leaves(gather_tree(ws[key]))):
            g, w = (g, w) if key == "mu" else (g.sqrt(), w.sqrt())
            assert _rel_l2(g, w) < tol, key


@pytest.mark.gpu
def test_lm_mesh_train_step_on_two_cells_equals_one_cell(card):
    """The data-parallel step over two cells of the card (a row a shard)
    against the one-device step on the whole batch (bf16 gradients summed
    over the shards: 3e-2 relative L2 a moment leaf), no sync inside the
    step, and its parameters one replica shared by the two cells."""
    from repro_torch.parallel.placement import Placed
    from repro_torch.train.tree import tree_leaves

    two = make_mesh((2, 1), ("data", "model"), devices=[card] * 2)
    one, mesh_run = _mesh_step_runs(card, [two])
    _mesh_runs_close(mesh_run, one)
    assert mesh_run[3] == 0
    leaves = tree_leaves(mesh_run[1])
    assert all(isinstance(x, Placed) and len(x.distinct()) == 1 for x in leaves)
    assert all(x.blocks.flat[0].device.type == "cuda" for x in leaves)


@pytest.mark.gpu
def test_lm_mesh_over_two_cards_equals_two_cells_of_one(card):
    """Over cuda:0 and cuda:1 each replica lies on its own card, the
    served tokens equal two cells of one card's and the train step matches
    them (the tied embedding's bf16 scatter-add sums in no fixed order).
    Skips below two cards."""
    from repro_torch.serve import ServeEngine
    from repro_torch.train.tree import tree_leaves

    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards")
    first, second = torch.device("cuda", 0), torch.device("cuda", 1)
    torch.cuda.set_device(first)
    one_card = make_mesh((2, 1), ("data", "model"), devices=[first] * 2)
    two_cards = make_mesh((2, 1), ("data", "model"), devices=[first, second])
    _, _, model, params = _lm_models("qwen2_5_3b", first, "float32")
    prompts = torch.randint(1, model.cfg.vocab, (4, 8), device=first)
    want = ServeEngine(model, params, max_len=24, mesh=one_card).generate(prompts, 12)
    engine = ServeEngine(model, params, max_len=24, mesh=two_cards)
    got = engine.generate(prompts, 12)
    assert torch.equal(got["tokens"], want["tokens"]) and got["tokens"].device == first
    leaf = tree_leaves(engine.params)[0]
    assert [t.device for t in leaf.blocks.flat] == [first, second]
    _, on_one, on_two = _mesh_step_runs(first, [one_card, two_cards])
    _mesh_runs_close(on_two, on_one, tol=1e-2)
    assert [t.device for t in tree_leaves(on_two[1])[0].blocks.flat] == [first, second]
    assert torch.cuda.current_device() == 0


# --------------------------------------------------------------------------- #
# tensor-parallel serving (heads, ff, vocab and experts split over model)      #
# --------------------------------------------------------------------------- #


def _tp_step_logits(model, params, prompts, mesh, max_len):
    """Prefill logits and the next decode step's (the prefill's greedy
    tokens fed back) on ``mesh`` from placed ``params``."""
    from repro_torch.parallel.sharding import place_tree

    placed = place_tree(params, model.param_shardings(mesh))
    B, S = prompts.shape
    with torch.inference_mode():
        caches = model.init_cache(B, max_len, mesh=mesh)
        logits, _ = model.prefill(placed, {"tokens": prompts}, caches, mesh=mesh)
        tok = torch.argmax(logits, -1).to(torch.int32)[:, None]
        step, _ = model.decode_step(placed, tok, torch.full((B,), S, dtype=torch.int32,
                                                            device=tok.device), caches, mesh=mesh)
    return logits, step


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["qwen2_5_3b", "qwen3_moe_30b_a3b"])
def test_lm_tensor_parallel_on_two_cells_matches_cpu_and_makes_no_sync(card, arch):
    """``ServeEngine`` over a (1, 2) mesh of two cells on the card: heads,
    ff, vocab (and experts) split, the cache split on sequence; no sync at
    any length; its prefill logits within float32 tolerance of the same
    mesh on the CPU and the decode step's within the bf16 caches' (1e-2)."""
    from repro_torch.serve import ServeEngine

    cpu_model, cpu_params, model, params = _lm_models(arch, card, "float32")
    prompts = torch.randint(1, model.cfg.vocab, (4, 8), device=card)
    engine = ServeEngine(model, params, max_len=24, mesh=make_mesh((1, 2), ("data", "model"),
                                                                   devices=[card] * 2))
    engine.generate(prompts, 4)  # warm
    counts = [_count_syncs(lambda n=n: engine.generate(prompts, n))[1] for n in (6, 16)]
    assert counts == [0, 0], counts
    got = _tp_step_logits(model, params, prompts, engine.mesh, 24)
    want = _tp_step_logits(cpu_model, cpu_params, prompts.cpu(),
                           make_mesh((1, 2), ("data", "model"), devices=["cpu"] * 2), 24)
    np.testing.assert_allclose(got[0].cpu().numpy(), want[0].numpy(), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got[1].cpu().numpy(), want[1].numpy(), rtol=1e-2, atol=1e-2)


@pytest.mark.gpu
def test_lm_tensor_parallel_over_two_cards_equals_two_cells_of_one(card):
    """Over cuda:0 and cuda:1 each card holds its blocks (half the heads,
    ff and vocab), the served tokens equal two cells of one card's and the
    logits come to cuda:0.  Skips below two cards."""
    from repro_torch.serve import ServeEngine

    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards")
    first, second = torch.device("cuda", 0), torch.device("cuda", 1)
    torch.cuda.set_device(first)
    _, _, model, params = _lm_models("qwen2_5_3b", first, "float32")
    prompts = torch.randint(1, model.cfg.vocab, (4, 8), device=first)
    one_card = make_mesh((1, 2), ("data", "model"), devices=[first] * 2)
    two_cards = make_mesh((1, 2), ("data", "model"), devices=[first, second])
    want = ServeEngine(model, params, max_len=24, mesh=one_card).generate(prompts, 12)
    engine = ServeEngine(model, params, max_len=24, mesh=two_cards)
    got = engine.generate(prompts, 12)
    assert torch.equal(got["tokens"], want["tokens"]) and got["tokens"].device == first
    wq = engine.params["blocks"]["p0"]["mixer"]["wq"]["kernel"]
    assert [t.device for t in wq.blocks.flat] == [first, second]
    assert wq.blocks.flat[0].shape[2] == model.cfg.n_heads // 2
    logits = _tp_step_logits(model, params, prompts, two_cards, 24)[1]
    assert logits.device == first and torch.isfinite(logits).all()
    assert torch.cuda.current_device() == 0
