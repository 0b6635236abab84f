// Forward add-compare-select (ACS) scans for Hopper (sm_90a): two kernels of
// one design, five entry points.
//
// Replace the Pallas TPU kernels of src/repro/kernels/viterbi_scan.py built
// from the one parameterised body `_make_scan_kernel(carry, pack, windowed)`:
//   viterbi_scan_packed_launch         `viterbi_scan_packed`        (carry=False, pack=True)
//                                      the short-block decode path, the planned
//                                      long-block decode at P = 1        [wide]
//   viterbi_scan_packed_window_launch  `viterbi_scan_packed_window` (carry=True, pack=True,
//                                      windowed=True) both passes of the tiled decode,
//                                      `parallel`'s transfer matrices    [wide]
//   viterbi_scan_packed_carry_launch   `viterbi_scan_packed_carry`  (carry=True, pack=True)
//                                      the packed streaming session's chunk scan
//                                                                        [chain]
//   viterbi_scan_carry_launch          `viterbi_scan_carry`         (carry=True, pack=False)
//                                      the `streaming` backend's chunk scan and
//                                      `parallel`'s re-scan, bm tables in [chain]
//   viterbi_scan_launch                `viterbi_scan`               (carry=False, pack=False)
//                                      the `fused` backend's scan, bm tables in [wide]
//
// What they compute, for every stream (lane) b and trellis step t:
//   cand_j[s'] = (pm[2v + j] + sum_f b_j[s', f] * x[b, t, f]) + rb[s', j]
//   take1      = cand_1 < cand_0            (strict: ties go to j = 0)
//   pm'[s']    = min(take1 ? cand_1 : cand_0, 1e30)
// with s' = u*S/2 + v.  pm starts at [0, 1e30, ...] (state 0) or at the lane's
// row of pm0 (carried).  Windowed, a lane runs ACS only on its steps lo[b] <=
// t < hi[b] (t counts the steps of this launch, 0..T-1): elsewhere pm' = pm,
// untouched and unclamped, and the select bit is 0.  Select bits are packed 32
// steps per word (bit p of word w is step 32w + p, the tail bits of a partial
// last word stay 0) or stored one int32 per (step, lane, state) (unpacked).
//
// What the function needs on this card.  Per (lane, step) it must read F
// floats (4F bytes) and write S survivor bits (S/8 bytes packed, 4S bytes
// unpacked).  The folded rows b_j[s'] are only the M = 2^n rows of the
// metric weight re-indexed by each transition's output symbol, so it needs
// M*2F operations for the metrics plus 7 per state (four adds, compare,
// select, clamp): for K=7 rate 1/2 (S=64, F=2, M=4) that is 464 operations
// for 16 bytes packed, just above the card's ~20 float32 operations per byte
// of HBM.  Unpacked (bm tables in, F = M = 4) the 4S = 256 bytes of
// survivors a step make the stores the bound: 256 + 16 bytes against 7S +
// 2M^2 = 480 operations.  Each step also needs the whole previous metric
// vector of its lane, so a lane's steps run strictly in order: with few
// lanes (a stream chunk: 128) the time is T times one step's latency.
//
// The design keeps:
//   * The TPU grid's sequential time axis as a `for t` loop inside the
//     block (Hopper blocks run in no order); path metrics never leave the SM.
//   * Predecessors read directly at 2v and 2v+1 — the (S, S) one-hot
//     matmuls of the Pallas body exist only to avoid TPU gathers.
//   * A thread's 32-step survivor word in a register, stored once per 32
//     steps in the (W, B, S) layout; unpacked selects go out every step in
//     the (T, B, S) layout; a warp's stores are contiguous in both.
//   * Exactness: adds and multiplies use __fadd_rn / __fmul_rn, so the
//     compiler cannot contract them into FMAs and the float order is the
//     reference's: ((pm + (0 + b_0 x_0 + b_1 x_1 + ...)) + rb).  1e30 + m
//     rounds back to 1e30 for the carried unit-entry seeds as it does in the
//     reference.  Built without --use_fast_math.
//
// The chain design, two kernels for the five entries: `chain_kernel` for
// the carried entries #3 and #7, `wide_kernel` for #1, #4 and #6.  Both
// keep:
//   * Few threads a lane, no block barrier in the step.  A group of G
//     threads (a launch table below) runs one lane; each thread holds SPT =
//     S/G <= 8 states in registers.  Up to a warp (G <= 32) thread r holds
//     states r*SPT .. r*SPT + SPT-1, so the predecessors 2v + j of its
//     successors are all the states of threads 2(r mod G/2) and 2(r mod G/2)
//     + 1: 2*SPT __shfl_sync a step, with registers fixed at compile time,
//     and no barrier at all.  Past a warp thread r holds i*G + r, the
//     metrics go through shared memory (double-buffered, one float2 read of
//     both predecessors) and a named barrier of the lane's G threads
//     (`bar.sync 1 + g, G`) ends the step: never a barrier across lanes.
//   * Distinct rows.  The wrapper passes the (R, F + 1) distinct rows
//     (weights, bias) of b0 and b1 with rb and an (S, 2) state -> row map
//     (kernels/viterbi_scan.py:row_operands; R = M for every folded or
//     table weight, at most 2S for any).  Each (lane, step) gets its R dots
//     once, not 2S; a thread keeps its states' row indices and biases in
//     registers and reads two dots a state.  A dot is the same row times the
//     same features in the same order (f = 0 .. F-1 from 0) as the plain
//     version's, so the bits are its bits.
//   * Features and dots off the chain.  Per tile of Tc steps the group
//     copies tile c+2's features into shared memory with cp.async while the
//     tile's steps run, and after them computes tile c+1's R*Tc dots in one
//     batch of independent items; one group barrier ends the tile.  So no
//     global load sits between two steps, and a step reads its two dots a
//     state from shared memory (the next step's during this one).  Tc
//     halves while the block's shared memory would not fit (large R).
//     (Computing the next tile's dots one step at a time inside the step
//     loop, to fill the chain's stalls, was slower: one warp cannot overlap
//     that divergent block's loads with the chain, so every step paid them.)
//   * A packed word is stored after the run of steps that completes it, so
//     no branch sits between two steps.
//
// `chain_kernel` (#3, #7; VITERBI_CHOICES) is bound by one lane's step
// latency at the stream chunk's 128 lanes, by the survivor stores at the
// NASA re-scan's 17408 lanes.  Its step was not changed when the wide kernel
// came: whether the wide step would serve the carried shapes too is
// measured before the two kernels become one.
//
// `wide_kernel` (#1 from state 0, #4 windowed; VITERBI_WIDE_CHOICES, packed;
// #6 from state 0, unpacked, below) runs 512 to 1.1M lanes and, packed, is
// bound by the card's issue rate, so it
// cuts the instructions of a state-step from the carried kernel's 21 to 13
// (SASS of the S=64 kernels' step loops, `tools/scan_measure.py sass`: 4
// adds, 2 shuffles, 2 shared reads, compare, select, clamp, a predicated OR,
// and a fraction of the loop's own):
//   * A tile's dots are kept row by row (row j of tile c at j*(Tc+1), one
//     spare slot a row for the last step's read-ahead), so a step's reads are
//     a per-state base and the step as an offset: no address arithmetic a
//     state.
//   * One predicate (setp.lt) selects the metric (selp) and sets the state's
//     survivor bit (@p or with the step's bit), where the carried entries
//     spend a select, a shift and an OR on the bit.
//   * State 0 is a prologue branch: no seed tensor exists and pm0 is not read.
//   * The window is a compile-time flag (the state-0 entry pays nothing for
//     it): lo and hi in registers; each run of steps up to a word
//     boundary is skipped when no lane of the warp has a step in it (pm and
//     the bits stay; past a warp the metrics move to the buffer the next step
//     reads), run without checks when every lane has all of it, and run with
//     a per-step check otherwise.
// At #1's shape (8192 x 1006 x 64 states, 527M state-steps) 13.4 instructions
// a state-step are ~0.21 ms of issue at 1.98 GHz; the kernel takes 0.33 ms
// (cutting its feature staging, dots and stores together leaves 84%, so the
// step itself is the rest; how much of the gap to issue is the step's
// dependent chain of shuffle, adds, compare and clamp is not measured: there
// is no profiler on that machine).  The S-fold passes of #4 (4.3G and 4.6G
// state-steps) are bound the same way; their repeated features (1.14 GB at
// `parallel`'s) are 0.34 ms of HBM under it.  A planned one-frame pass (512
// lanes) is one lane's chain of 129 steps.  The windowed kernel's unchecked
// step still spends one address add a state-step (15 instructions).
//
// Unpacked (#6; PACK = false, a template flag, so the packed instances
// compile as they did) the wide kernel runs the state-0 step with the
// predicate selecting the metric and setting the state's select (selp 1/0),
// and each step's SPT selects of a thread go out as one vector store (16
// bytes at S = 64, G = 16: a lane's 256 bytes a step one contiguous run).  It
// takes the packed entries' launch table.  Its bound is the 2.1 GB of selects
// at the `fused` shape (0.67 ms at 3.35 TB/s); the step's issue (#1's 0.33 ms
// at that shape) runs under them.  Streaming stores (st.global.cs: the
// selects are read back only after the scan, far past L2) measured no faster
// on the H100 (0.9030 against 0.9063 ms at the `fused` shape,
// `tools/scan_measure.py split`), so the stores are plain.
//
// Launch choices (G threads a lane, L lanes a block, Tc steps a tile), one
// template per S, entry and PACK; each row the pick of a sweep on this
// source (an NVIDIA H100 80GB HBM3 at 700 W):
//   carried (VITERBI_CHOICES, `tools/scan_measure.py sweep`): S 2 4 8 16 32
//   64 128-256 512-1024 2048 4096 -> 2/16/64 4/8/64 8/8/64 16/4/64 32/4/64
//   32/2/64 128/1/64 256, 512/1/64 256/1/64 512/1/64: of every G with at
//   most 8 states a thread, blocks of 32, 64 or 128 threads (1 or 2 lanes
//   past a warp) and Tc of 8, 16, 32 or 64, the least sum over the stream
//   chunk's packed and unpacked shapes (128 x 64) and, at S = 64 and 4, the
//   `parallel` re-scans of its time over that shape's best.  ptxas (sm_90a,
//   CUDA 12.8), registers packed/unpacked: S=2 72/72, 4 72/72, 8 64/64, 16
//   64/64, 32 56/64, 64 72/72, 128 64/64, 256 64/48, 512 48/48, 1024 60/61,
//   2048 116/106, 4096 124/110; small spills (12-32 bytes stored, 12-64
//   loaded) unpacked at S = 2-32, 128 and 256, packed at S = 4-16, 64, 128
//   and 256.
//   wide (VITERBI_WIDE_CHOICES, `tools/scan_measure.py wide`): S 2 4 8 16 32
//   64 128 256 512 1024 2048 4096 -> 2/16/32 4/8/32 8/16/32 8/32/32 8/8/64
//   16/2/64 32/2/64 32/2/64 128/1/64 128/2/64 256/2/64 512/1/64: of every G
//   with at most 8 states a thread, blocks of 32 to 256 threads (1 or 2
//   lanes past a warp) and Tc of 32 or 64, the least sum of times over #1 at
//   8192 x 1006 and #4 at the pinned P=8 passes, `parallel`'s transfer
//   matrices and a planned one-frame pass (S = 64), or over #1 at 524288/S x
//   1006 and #4 at 4 x 524288/S x 129 (every other S).  ptxas registers
//   state-0/windowed: S=2 96/96, 4 96/96, 8 64/96, 16 48/60, 32 72/125, 64
//   64/127, 128 72/127, 256 115/117, 512 64/96, 1024 116/112, 2048 113/112,
//   4096 113/112; spills (36-48 bytes stored and loaded) only in the state-0
//   kernels at S = 16, 64 and 512.
//   #6 runs on the wide table: of the same candidates at #6's shape (8192 x
//   1006 bm tables, F = M = 4, S = 64; 524288/S x 1006 at every other S) the
//   table's rows were within 13% of the fastest at every S (S = 64: 0.8757
//   against 0.8638 ms, `tools/scan_measure.py wide`, which prints them beside
//   its picks).  ptxas registers unpacked: S=2 96, 4 80, 8 64, 16 48, 32 72,
//   64 85, 128 72, 256 96, 512 96, 1024 118, 2048 120, 4096 120; spills
//   (8-52 bytes stored, 8-76 loaded) at S = 4-32, 128 and 256.
// The groups of more than one warp use up to 16 named barriers.
#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

namespace {

constexpr float kUnreachable = 1e30f;
constexpr int kMaxSharedBytes = 232448;  // 227 KB opt-in per block on sm_90

}  // namespace

// ------------------------------------------------------------------------- //
// The chain design: #1, #3, #4, #6 and #7                                    //
// ------------------------------------------------------------------------- //

// Launch choices, one row per S = 2, 4, ..., 4096: {G threads a lane, L lanes
// a block, Tc steps a tile}.  VITERBI_CHOICES serves the carried chunk scans
// (#3, #7: a stream chunk's 128 lanes, bound by one lane's chain),
// VITERBI_WIDE_CHOICES the state-0 and windowed scans (#1, #4 and #6:
// thousands to a million lanes, bound by the card's issue or, #6, by its
// selects' stores).  A measurement build
// (tools/scan_measure.py) defines its own tables before it includes this file.
#ifndef VITERBI_CHOICES
#define VITERBI_CHOICES                                                         \
  {{2, 16, 64},  {4, 8, 64},   {8, 8, 64},   {16, 4, 64},  {32, 4, 64},        \
   {32, 2, 64},  {128, 1, 64}, {128, 1, 64}, {256, 1, 64}, {512, 1, 64},       \
   {256, 1, 64}, {512, 1, 64}}
#endif
#ifndef VITERBI_WIDE_CHOICES
#define VITERBI_WIDE_CHOICES                                                    \
  {{2, 16, 32},  {4, 8, 32},   {8, 16, 32},  {8, 32, 32},  {8, 8, 64},         \
   {16, 2, 64},  {32, 2, 64},  {32, 2, 64},  {128, 1, 64}, {128, 2, 64},       \
   {256, 2, 64}, {512, 1, 64}}
#endif
// A measurement build may also cut parts of the chain design's work, to time
// what is left (its outputs are then wrong): bit 0 the staging of the
// features, bit 1 the distinct-row dots, bit 2 the survivor stores; and it
// may define VITERBI_WIDE_ONLY to build the wide entries alone.
#ifndef VITERBI_CUT
#define VITERBI_CUT 0
#endif

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kCut = VITERBI_CUT;

// How a launch enters its lanes' metrics: carried from pm0 (#3, #7), the
// state-0 start (#1), or carried from pm0 through a per-lane step window (#4).
enum Entry { kCarried, kState0, kWindow };

struct Choice {
  int G, L, Tc;
};
constexpr Choice kChoices[12] = VITERBI_CHOICES;
constexpr Choice kWideChoices[12] = VITERBI_WIDE_CHOICES;

constexpr int log2i(int n) { return n > 1 ? 1 + log2i(n / 2) : 0; }
constexpr bool pow2(int n) { return n > 0 && (n & (n - 1)) == 0; }
constexpr Choice choice(int S, int entry) {
  return entry == kCarried ? kChoices[log2i(S) - 1] : kWideChoices[log2i(S) - 1];
}

// G a power of two up to S with at most 8 states a thread; whole warps; a
// group of more than one warp is whole warps and has its own named barrier
// (ids 1 .. L); 1 to 64 steps a tile.
constexpr bool valid(const Choice& c, int S) {
  return pow2(c.G) && c.G <= S && S / c.G <= 8 && pow2(c.L) && c.G * c.L <= 1024 &&
         (c.G * c.L) % 32 == 0 && (c.G <= 32 || c.L <= 8) && c.Tc >= 1 && c.Tc <= 64;
}

struct ChainArgs {
  const float* pm0;     // (B, S); unused by the state-0 entry
  const float* data;    // (B, T, F)
  const float* rows;    // (R, F + 1): distinct rows (weights, bias)
  const int32_t* maps;  // (S, 2): the row of (b_j[s], rb[s, j])
  float* final_pm;      // (B, S)
  int32_t* survivors;   // (W, B, S) words when PACK, else (T, B, S) selects
  int B, T, F, S, R;
  int Tc, feat_buf, dots_buf, lane_floats;  // tile and shared-memory plan (floats)
};

// The wide kernel's: the chain's and, windowed (#4), each lane's steps.
struct WideArgs {
  ChainArgs c;
  const int32_t* lo;  // (B,): lane b runs steps lo[b] <= t < hi[b]
  const int32_t* hi;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// every copy this thread issued has landed
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// named barrier `id` over `n` threads (whole warps)
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// Steps of tile c: [c Tc, min(T, (c+1) Tc)).
__device__ __forceinline__ int tile_len(int c, int T, int Tc) {
  return c * Tc < T ? min(Tc, T - c * Tc) : 0;
}

// N consecutive int32 at dst, 4N-byte aligned: vector stores where N allows.
template <int N>
__device__ __forceinline__ void store_run(int32_t* dst, const uint32_t (&v)[N]) {
  if constexpr (N == 2) {
    *reinterpret_cast<int2*>(dst) = make_int2(static_cast<int>(v[0]), static_cast<int>(v[1]));
  } else if constexpr (N % 4 == 0) {
#pragma unroll
    for (int q = 0; q < N; q += 4)
      *reinterpret_cast<int4*>(dst + q) =
          make_int4(static_cast<int>(v[q]), static_cast<int>(v[q + 1]),
                    static_cast<int>(v[q + 2]), static_cast<int>(v[q + 3]));
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) dst[i] = static_cast<int32_t>(v[i]);
  }
}

// Row w (F weights) times features x, summed f = 0 .. F-1 from 0.  FX is F
// when it is known at compile time (2, 3 or 4), else 0.
template <int FX>
__device__ __forceinline__ float row_dot(const float* __restrict__ w, const float* x, int F) {
  float m = 0.0f;
  if constexpr (FX > 0) {
#pragma unroll
    for (int f = 0; f < FX; ++f) m = __fadd_rn(m, __fmul_rn(__ldg(w + f), x[f]));
  } else {
    for (int f = 0; f < F; ++f) m = __fadd_rn(m, __fmul_rn(__ldg(w + f), x[f]));
  }
  return m;
}

// Tile dots: d[k * R + j] (ROWS: d[j * TcS + k]) = distinct row j times step
// k's features x[k * F ..] for k < n.  With R <= G thread r takes row j0 = r %
// R of steps k0 = r / R, k0 + per, ... (per = G / R), its weights in registers
// when F is known; with R > G rows r, r + G, ... of every step.  Independent
// items, so a batch costs about one item's latency.
template <int FX, bool ROWS>
__device__ __forceinline__ void tile_dots(float* d, const float* x,
                                          const float* __restrict__ rows, int n, int F,
                                          int R, int G, int per, int j0, int k0, int TcS) {
  const int F1 = F + 1;
  auto at = [&](int k, int j) -> float& { return ROWS ? d[j * TcS + k] : d[k * R + j]; };
  if (per == 0) {
#pragma unroll 4
    for (int k = 0; k < n; ++k)
      for (int j = j0; j < R; j += G) at(k, j) = row_dot<FX>(rows + j * F1, x + k * F, F);
    return;
  }
  if (k0 >= per) return;
  if constexpr (FX > 0) {
    float w[FX];
#pragma unroll
    for (int f = 0; f < FX; ++f) w[f] = __ldg(rows + j0 * F1 + f);
#pragma unroll 4
    for (int k = k0; k < n; k += per) {
      float m = 0.0f;
#pragma unroll
      for (int f = 0; f < FX; ++f) m = __fadd_rn(m, __fmul_rn(w[f], x[k * FX + f]));
      at(k, j0) = m;
    }
  } else {
    for (int k = k0; k < n; k += per) at(k, j0) = row_dot<0>(rows + j0 * F1, x + k * F, F);
  }
}

// The carried kernel (#3, #7).  One lane's T steps on G threads: thread r of a
// group holds SPT = S/G states, r*SPT .. r*SPT + SPT-1 when the group is one
// warp or less (G <= 32), i*G + r for i < SPT when it is more.  Per tile of
// Tc steps: the group copies tile c+2's features into shared memory
// (cp.async, into the buffer tile c's features left), runs the tile's steps,
// computes tile c+1's R distinct-row dots, and waits for its copies; one
// group barrier ends a tile.
template <int S, int G, int L, bool PACK>
__global__ void __launch_bounds__(G * L) chain_kernel(const ChainArgs a) {
  constexpr int SPT = S / G;
  constexpr bool kWarp = G <= 32;  // exchange by shuffles, else through shared memory
  extern __shared__ float4 chain_smem[];
  const int B = a.B, T = a.T, F = a.F, R = a.R, Tc = a.Tc, F1 = a.F + 1;
  const int g = threadIdx.x / G, r = threadIdx.x % G;
  const int b = blockIdx.x * L + g;
  const bool live = b < B;
  float* feat_s = reinterpret_cast<float*>(chain_smem) + g * a.lane_floats;  // [2][Tc*F]
  float* dots_s = feat_s + 2 * a.feat_buf;                                  // [2][Tc*R]
  float* pm_s = dots_s + 2 * a.dots_buf;                                    // [2][S], !kWarp
  const float* __restrict__ rows = a.rows;
  const float* __restrict__ x_lane = a.data + static_cast<size_t>(live ? b : 0) * T * F;
  int32_t* __restrict__ out = a.survivors;
  const int nt = (T + Tc - 1) / Tc;

  auto group_sync = [&]() {
    if constexpr (kWarp) {
      __syncwarp();
    } else {
      bar_sync(1 + g, G);
    }
  };
  // tile c's features into buffer c & 1 (asynchronous; committed by the caller)
  auto stage = [&](int c) {
    if constexpr (kCut & 1) return;
    const int n = tile_len(c, T, Tc) * F;
    float* dst = feat_s + (c & 1) * a.feat_buf;
    const float* src = x_lane + static_cast<size_t>(c) * Tc * F;
    if (live)
      for (int i = r; i < n; i += G) cp_async4(dst + i, src + i);
  };
  const int per = G >= R ? G / R : 0, j0 = G >= R ? r % R : r, k0 = G >= R ? r / R : 0;
  auto dots = [&](int c) {  // tile c's, into buffer c & 1
    if constexpr (kCut & 2) return;
    float* d = dots_s + (c & 1) * a.dots_buf;
    const float* x = feat_s + (c & 1) * a.feat_buf;
    const int n = tile_len(c, T, Tc);
    if (F == 2)
      tile_dots<2, false>(d, x, rows, n, F, R, G, per, j0, k0, 0);
    else if (F == 3)
      tile_dots<3, false>(d, x, rows, n, F, R, G, per, j0, k0, 0);
    else if (F == 4)
      tile_dots<4, false>(d, x, rows, n, F, R, G, per, j0, k0, 0);
    else
      tile_dots<0, false>(d, x, rows, n, F, R, G, per, j0, k0, 0);
  };
  auto state = [&](int i) { return kWarp ? r * SPT + i : i * G + r; };

  stage(0);
  stage(1);
  cp_async_commit();
  float pm[SPT], rb0[SPT], rb1[SPT];
  int o0[SPT], o1[SPT];
  uint32_t word[SPT];
#pragma unroll
  for (int i = 0; i < SPT; ++i) {
    const int s = state(i);
    o0[i] = __ldg(a.maps + 2 * s);
    o1[i] = __ldg(a.maps + 2 * s + 1);
    rb0[i] = __ldg(rows + o0[i] * F1 + F);
    rb1[i] = __ldg(rows + o1[i] * F1 + F);
    pm[i] = live ? __ldg(a.pm0 + static_cast<size_t>(b) * S + s) : kUnreachable;
    word[i] = 0u;
    if constexpr (!kWarp) pm_s[s] = pm[i];
  }
  cp_async_wait_all();
  group_sync();
  dots(0);
  group_sync();

  for (int c = 0; c < nt; ++c) {
    const int n = tile_len(c, T, Tc);
    stage(c + 2);
    cp_async_commit();
    const float* dc = dots_s + (c & 1) * a.dots_buf;
    float d0[SPT], d1[SPT];
#pragma unroll
    for (int i = 0; i < SPT; ++i) d0[i] = dc[o0[i]], d1[i] = dc[o1[i]];
    for (int k = 0; k < n;) {
      // the steps up to the next word boundary or the tile's end, with no
      // branch between them
      const int t0 = c * Tc + k;
      const int run = min(n - k, 32 - (t0 & 31));
      for (int q = 0; q < run; ++q, ++k) {
        const int t = t0 + q;
        // the next step's branch metrics, read while this step computes
        const float* dn = dc + min(k + 1, n - 1) * R;
        float e0[SPT], e1[SPT];
#pragma unroll
        for (int i = 0; i < SPT; ++i) e0[i] = dn[o0[i]], e1[i] = dn[o1[i]];
        // x[2i + j] = pm[2v + j] of successor i, v = s mod S/2
        float x[2 * SPT];
        if constexpr (kWarp) {
          if constexpr (G == 1) {
#pragma unroll
            for (int j = 0; j < 2 * SPT; ++j) x[j] = pm[j % SPT];
          } else {
            const int q0 = 2 * (r % (G / 2));
#pragma unroll
            for (int j = 0; j < 2 * SPT; ++j)
              x[j] = __shfl_sync(kFull, pm[j % SPT], q0 + j / SPT, G);
          }
        } else {
          const float* pc = pm_s + (t & 1) * S;
#pragma unroll
          for (int i = 0; i < SPT; ++i) {
            const float2 p2 =
                *reinterpret_cast<const float2*>(pc + 2 * (state(i) & (S / 2 - 1)));
            x[2 * i] = p2.x;
            x[2 * i + 1] = p2.y;
          }
        }
        uint32_t sel[SPT];
#pragma unroll
        for (int i = 0; i < SPT; ++i) {
          const float c0 = __fadd_rn(__fadd_rn(x[2 * i], d0[i]), rb0[i]);
          const float c1 = __fadd_rn(__fadd_rn(x[2 * i + 1], d1[i]), rb1[i]);
          const bool take1 = c1 < c0;  // ties go to j = 0
          const float nm = take1 ? c1 : c0;
          pm[i] = (nm > kUnreachable) ? kUnreachable : nm;  // NaN passes, as jnp.minimum
          sel[i] = static_cast<uint32_t>(take1);
          word[i] |= sel[i] << (t & 31);
        }
        if constexpr (!kWarp) {
          float* pn = pm_s + ((t + 1) & 1) * S;
#pragma unroll
          for (int i = 0; i < SPT; ++i) pn[state(i)] = pm[i];
        }
        if constexpr (!PACK && !(kCut & 4)) {
          if (live) {
            int32_t* dst = out + (static_cast<size_t>(t) * B + b) * S;
            if constexpr (kWarp) {
              store_run<SPT>(dst + r * SPT, sel);
            } else {
#pragma unroll
              for (int i = 0; i < SPT; ++i) dst[state(i)] = static_cast<int32_t>(sel[i]);
            }
          }
        }
#pragma unroll
        for (int i = 0; i < SPT; ++i) d0[i] = e0[i], d1[i] = e1[i];
        if constexpr (!kWarp) group_sync();  // this step's metrics for the next
      }
      const int t = t0 + run - 1;
      if (PACK && ((t & 31) == 31 || t == T - 1)) {  // a word is complete
        if (!(kCut & 4) && live) {
          int32_t* dst = out + (static_cast<size_t>(t >> 5) * B + b) * S;
          if constexpr (kWarp) {
            store_run<SPT>(dst + r * SPT, word);
          } else {
#pragma unroll
            for (int i = 0; i < SPT; ++i) dst[state(i)] = static_cast<int32_t>(word[i]);
          }
        }
#pragma unroll
        for (int i = 0; i < SPT; ++i) word[i] = 0u;
      }
    }
    dots(c + 1);
    cp_async_wait_all();
    group_sync();  // tile c ends: tile c+1's dots and tile c+2's features are in
  }

  if (live) {
#pragma unroll
    for (int i = 0; i < SPT; ++i) a.final_pm[static_cast<size_t>(b) * S + state(i)] = pm[i];
  }
}

// The wide kernel (#1 from state 0, #4 WINDOW, packed; #6 from state 0,
// !PACK): the carried kernel's lanes, groups, tiles and exchange, with a
// tile's dots kept row by row (row j at j * TcS, TcS = Tc + 1: a spare slot
// for the last step's read-ahead), so a step's reads take no address
// arithmetic, and one predicate that selects the metric and sets the
// survivor bit (PACK) or the select (!PACK).  WINDOW: on a step outside the
// lane's [lo, hi) pm and the bit stay.  !PACK: each step's selects go out as
// each thread's SPT ints in one vector store (a lane's S ints are one run).
template <int S, int G, int L, bool WINDOW, bool PACK>
__global__ void __launch_bounds__(G * L) wide_kernel(const WideArgs w) {
  static_assert(PACK || !WINDOW, "the unpacked wide entry starts from state 0");
  const ChainArgs& a = w.c;
  constexpr int SPT = S / G;
  constexpr bool kWarp = G <= 32;  // exchange by shuffles, else through shared memory
  extern __shared__ float4 chain_smem[];
  const int B = a.B, T = a.T, F = a.F, R = a.R, Tc = a.Tc, F1 = a.F + 1;
  const int g = threadIdx.x / G, r = threadIdx.x % G;
  const int b = blockIdx.x * L + g;
  const bool live = b < B;
  float* feat_s = reinterpret_cast<float*>(chain_smem) + g * a.lane_floats;  // [2][Tc*F]
  float* dots_s = feat_s + 2 * a.feat_buf;                                  // [2][R*TcS]
  float* pm_s = dots_s + 2 * a.dots_buf;                                    // [2][S], !kWarp
  const float* __restrict__ rows = a.rows;
  const float* __restrict__ x_lane = a.data + static_cast<size_t>(live ? b : 0) * T * F;
  int32_t* __restrict__ out = a.survivors;
  const int nt = (T + Tc - 1) / Tc, TcS = Tc + 1;

  auto group_sync = [&]() {
    if constexpr (kWarp) {
      __syncwarp();
    } else {
      bar_sync(1 + g, G);
    }
  };
  // tile c's features into buffer c & 1 (asynchronous; committed by the caller)
  auto stage = [&](int c) {
    if constexpr (kCut & 1) return;
    const int n = tile_len(c, T, Tc) * F;
    float* dst = feat_s + (c & 1) * a.feat_buf;
    const float* src = x_lane + static_cast<size_t>(c) * Tc * F;
    if (live)
      for (int i = r; i < n; i += G) cp_async4(dst + i, src + i);
  };
  const int per = G >= R ? G / R : 0, j0 = G >= R ? r % R : r, k0 = G >= R ? r / R : 0;
  auto dots = [&](int c) {  // tile c's, into buffer c & 1
    if constexpr (kCut & 2) return;
    float* d = dots_s + (c & 1) * a.dots_buf;
    const float* x = feat_s + (c & 1) * a.feat_buf;
    const int n = tile_len(c, T, Tc);
    if (F == 2)
      tile_dots<2, true>(d, x, rows, n, F, R, G, per, j0, k0, TcS);
    else if (F == 3)
      tile_dots<3, true>(d, x, rows, n, F, R, G, per, j0, k0, TcS);
    else if (F == 4)
      tile_dots<4, true>(d, x, rows, n, F, R, G, per, j0, k0, TcS);
    else
      tile_dots<0, true>(d, x, rows, n, F, R, G, per, j0, k0, TcS);
  };
  auto state = [&](int i) { return kWarp ? r * SPT + i : i * G + r; };

  stage(0);
  stage(1);
  cp_async_commit();
  float pm[SPT], rb0[SPT], rb1[SPT];
  int o0[SPT], o1[SPT];
  uint32_t word[SPT];
  int lo = 0, hi = T;  // the lane's steps (WINDOW); a lane past B has none
  if constexpr (WINDOW) {
    lo = live ? __ldg(w.lo + b) : 0;
    hi = live ? __ldg(w.hi + b) : 0;
  }
#pragma unroll
  for (int i = 0; i < SPT; ++i) {
    const int s = state(i);
    o0[i] = __ldg(a.maps + 2 * s);
    o1[i] = __ldg(a.maps + 2 * s + 1);
    rb0[i] = __ldg(rows + o0[i] * F1 + F);
    rb1[i] = __ldg(rows + o1[i] * F1 + F);
    if constexpr (WINDOW) {
      pm[i] = live ? __ldg(a.pm0 + static_cast<size_t>(b) * S + s) : kUnreachable;
    } else {
      pm[i] = s == 0 ? 0.0f : kUnreachable;  // paths start in state 0
    }
    word[i] = 0u;
    if constexpr (!kWarp) pm_s[s] = pm[i];
  }
  cp_async_wait_all();
  group_sync();
  dots(0);
  group_sync();

  for (int c = 0; c < nt; ++c) {
    const int n = tile_len(c, T, Tc);
    stage(c + 2);
    cp_async_commit();
    const float* dc = dots_s + (c & 1) * a.dots_buf;
    const float* q0[SPT];  // the dots of each state's rows
    const float* q1[SPT];
    float d0[SPT], d1[SPT];
#pragma unroll
    for (int i = 0; i < SPT; ++i) {
      q0[i] = dc + o0[i] * TcS, q1[i] = dc + o1[i] * TcS;
      d0[i] = q0[i][0], d1[i] = q1[i][0];
    }
    // steps k .. k + run - 1 of the tile (t0 = c Tc + k), with no branch
    // between them; `checked`: a step outside the lane's [lo, hi) leaves its
    // metrics untouched (unclamped) and its bit 0
    auto steps = [&](int& k, const int t0, const int run, auto checked) {
      constexpr bool kChecked = decltype(checked)::value;
      for (int q = 0; q < run; ++q, ++k) {
        const int t = t0 + q;
        // the next step's branch metrics, read while this step computes
        float e0[SPT], e1[SPT];
#pragma unroll
        for (int i = 0; i < SPT; ++i) e0[i] = q0[i][k + 1], e1[i] = q1[i][k + 1];
        // x[2i + j] = pm[2v + j] of successor i, v = s mod S/2
        float x[2 * SPT];
        if constexpr (kWarp) {
          if constexpr (G == 1) {
#pragma unroll
            for (int j = 0; j < 2 * SPT; ++j) x[j] = pm[j % SPT];
          } else {
            const int p0 = 2 * (r % (G / 2));
#pragma unroll
            for (int j = 0; j < 2 * SPT; ++j)
              x[j] = __shfl_sync(kFull, pm[j % SPT], p0 + j / SPT, G);
          }
        } else {
          const float* pc = pm_s + (t & 1) * S;
#pragma unroll
          for (int i = 0; i < SPT; ++i) {
            const float2 p2 =
                *reinterpret_cast<const float2*>(pc + 2 * (state(i) & (S / 2 - 1)));
            x[2 * i] = p2.x;
            x[2 * i + 1] = p2.y;
          }
        }
        const bool valid = !kChecked || (t >= lo && t < hi);
        const uint32_t bit = 1u << (t & 31);
        uint32_t sel[SPT];
#pragma unroll
        for (int i = 0; i < SPT; ++i) {
          const float c0 = __fadd_rn(__fadd_rn(x[2 * i], d0[i]), rb0[i]);
          const float c1 = __fadd_rn(__fadd_rn(x[2 * i + 1], d1[i]), rb1[i]);
          if constexpr (!kChecked && !PACK) {
            // take1 = c1 < c0 (ties and NaN go to j = 0) as a predicate that
            // selects the metric and the select
            float nm;
            asm("{\n\t.reg .pred p;\n\tsetp.lt.f32 p, %2, %3;\n\tselp.f32 %0, %2, %3, p;\n\t"
                "selp.u32 %1, 1, 0, p;\n\t}"
                : "=f"(nm), "=r"(sel[i])
                : "f"(c1), "f"(c0));
            pm[i] = (nm > kUnreachable) ? kUnreachable : nm;  // NaN passes
            continue;
          }
          if constexpr (!kChecked) {
            // take1 = c1 < c0 (ties and NaN go to j = 0) as a predicate that
            // selects the metric and sets the survivor bit
            float nm;
            asm("{\n\t.reg .pred p;\n\tsetp.lt.f32 p, %2, %3;\n\tselp.f32 %0, %2, %3, p;\n\t"
                "@p or.b32 %1, %1, %4;\n\t}"
                : "=f"(nm), "+r"(word[i])
                : "f"(c1), "f"(c0), "r"(bit));
            pm[i] = (nm > kUnreachable) ? kUnreachable : nm;  // NaN passes
            continue;
          }
          const bool take1 = c1 < c0;  // ties go to j = 0
          const float nm = take1 ? c1 : c0;
          const float clamped = (nm > kUnreachable) ? kUnreachable : nm;  // NaN passes
          pm[i] = valid ? clamped : pm[i];
          sel[i] = static_cast<uint32_t>(take1 && valid);
          word[i] |= sel[i] << (t & 31);
        }
        if constexpr (!kWarp) {
          float* pn = pm_s + ((t + 1) & 1) * S;
#pragma unroll
          for (int i = 0; i < SPT; ++i) pn[state(i)] = pm[i];
        }
        if constexpr (!PACK && !(kCut & 4)) {
          if (live) {
            int32_t* dst = out + (static_cast<size_t>(t) * B + b) * S;
            if constexpr (kWarp) {
              store_run<SPT>(dst + r * SPT, sel);
            } else {
#pragma unroll
              for (int i = 0; i < SPT; ++i) dst[state(i)] = static_cast<int32_t>(sel[i]);
            }
          }
        }
#pragma unroll
        for (int i = 0; i < SPT; ++i) d0[i] = e0[i], d1[i] = e1[i];
        if constexpr (!kWarp) group_sync();  // this step's metrics for the next
      }
    };
    for (int k = 0; k < n;) {
      // the steps up to the next word boundary or the tile's end
      const int t0 = c * Tc + k;
      const int run = min(n - k, 32 - (t0 & 31));
      if constexpr (WINDOW) {
        // the warp's lanes decide together: its shuffles span them all
        if (__all_sync(kFull, t0 + run <= lo || hi <= t0 || hi <= lo)) {
          // no step of the run exists for any lane of the warp: pm and the
          // bits stay; past a warp, the metrics move to the buffer the run's
          // next step reads
          if constexpr (!kWarp) {
            if (run & 1) {
              float* pn = pm_s + ((t0 + 1) & 1) * S;
#pragma unroll
              for (int i = 0; i < SPT; ++i) pn[state(i)] = pm[i];
              group_sync();
            }
          }
          k += run;
        } else {
#pragma unroll
          for (int i = 0; i < SPT; ++i) d0[i] = q0[i][k], d1[i] = q1[i][k];
          if (__all_sync(kFull, lo <= t0 && t0 + run <= hi))
            steps(k, t0, run, std::false_type{});
          else
            steps(k, t0, run, std::true_type{});
        }
      } else {
        steps(k, t0, run, std::false_type{});
      }
      const int t = t0 + run - 1;
      if (PACK && ((t & 31) == 31 || t == T - 1)) {  // a word is complete
        if (!(kCut & 4) && live) {
          int32_t* dst = out + (static_cast<size_t>(t >> 5) * B + b) * S;
          if constexpr (kWarp) {
            store_run<SPT>(dst + r * SPT, word);
          } else {
#pragma unroll
            for (int i = 0; i < SPT; ++i) dst[state(i)] = static_cast<int32_t>(word[i]);
          }
        }
#pragma unroll
        for (int i = 0; i < SPT; ++i) word[i] = 0u;
      }
    }
    dots(c + 1);
    cp_async_wait_all();
    group_sync();  // tile c ends: tile c+1's dots and tile c+2's features are in
  }

  if (live) {
#pragma unroll
    for (int i = 0; i < SPT; ++i) a.final_pm[static_cast<size_t>(b) * S + state(i)] = pm[i];
  }
}

int round4(int n) { return (n + 3) & ~3; }

// Launch `kernel` on `args` with `smem` bytes of dynamic shared memory.
template <typename Args>
int start(void (*kernel)(Args), const Args& args, int blocks, int threads, size_t smem,
          cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<blocks, threads, smem, stream>>>(args);
  return cudaGetLastError();
}

// Launch the one kernel built for (S, PACK, ENTRY) with its table's choice;
// Tc is halved while a block's shared memory would not fit.
template <int S, bool PACK, int ENTRY>
int chain_launch(ChainArgs a, const void* lo, const void* hi, cudaStream_t stream) {
  static_assert(PACK || ENTRY != kWindow, "the windowed entry is packed");
  constexpr Choice c = choice(S, ENTRY);
  static_assert(valid(c, S), "a launch choice outside what the chain kernels take");
  auto plan = [&](int Tc) {
    a.Tc = Tc;
    a.feat_buf = round4(Tc * a.F);
    a.dots_buf = round4((ENTRY == kCarried ? Tc : Tc + 1) * a.R);
    a.lane_floats = 2 * a.feat_buf + 2 * a.dots_buf + (c.G > 32 ? 2 * S : 0);
    return sizeof(float) * static_cast<size_t>(c.L) * a.lane_floats;
  };
  int Tc = c.Tc;
  size_t smem = plan(Tc);
  while (smem > static_cast<size_t>(kMaxSharedBytes) && Tc > 1) smem = plan(Tc /= 2);
  if (smem > static_cast<size_t>(kMaxSharedBytes)) return cudaErrorInvalidValue;
  const int blocks = (a.B + c.L - 1) / c.L;
  if constexpr (ENTRY == kCarried) {
    return start(chain_kernel<S, c.G, c.L, PACK>, a, blocks, c.G * c.L, smem, stream);
  } else {
    const WideArgs w{a, static_cast<const int32_t*>(lo), static_cast<const int32_t*>(hi)};
    return start(wide_kernel<S, c.G, c.L, ENTRY == kWindow, PACK>, w, blocks, c.G * c.L, smem,
                 stream);
  }
}

// S a power of two in [2, 4096]; R at most 2S (the distinct rows of b0, b1).
template <bool PACK, int ENTRY>
int chain_dispatch(const void* pm0, const void* data, const void* rows, const void* maps,
                   const void* lo, const void* hi, void* final_pm, void* survivors, int B,
                   int T, int F, int S, int R, void* stream) {
  if (B < 1 || T < 1 || F < 1 || S < 2 || S > 4096 || !pow2(S) || R < 1 || R > 2 * S)
    return cudaErrorInvalidValue;
  const ChainArgs a{static_cast<const float*>(pm0),  static_cast<const float*>(data),
                    static_cast<const float*>(rows), static_cast<const int32_t*>(maps),
                    static_cast<float*>(final_pm),   static_cast<int32_t*>(survivors),
                    B, T, F, S, R, 0, 0, 0, 0};
  auto st = static_cast<cudaStream_t>(stream);
  switch (S) {
    case 2: return chain_launch<2, PACK, ENTRY>(a, lo, hi, st);
    case 4: return chain_launch<4, PACK, ENTRY>(a, lo, hi, st);
    case 8: return chain_launch<8, PACK, ENTRY>(a, lo, hi, st);
    case 16: return chain_launch<16, PACK, ENTRY>(a, lo, hi, st);
    case 32: return chain_launch<32, PACK, ENTRY>(a, lo, hi, st);
    case 64: return chain_launch<64, PACK, ENTRY>(a, lo, hi, st);
    case 128: return chain_launch<128, PACK, ENTRY>(a, lo, hi, st);
    case 256: return chain_launch<256, PACK, ENTRY>(a, lo, hi, st);
    case 512: return chain_launch<512, PACK, ENTRY>(a, lo, hi, st);
    case 1024: return chain_launch<1024, PACK, ENTRY>(a, lo, hi, st);
    case 2048: return chain_launch<2048, PACK, ENTRY>(a, lo, hi, st);
    default: return chain_launch<4096, PACK, ENTRY>(a, lo, hi, st);
  }
}

}  // namespace

// Plain C entry points, loaded with ctypes.  Each returns the cudaError_t of
// its launch (0 = launched).  The chain design's entries take the (R, F + 1)
// distinct rows and (S, 2) row map of row_operands in place of the weights.

// `viterbi_scan_packed`: state-0 init, packed (W, B, S) words.
extern "C" int viterbi_scan_packed_launch(const void* data, const void* rows, const void* maps,
                                          void* final_pm, void* packed, int B, int T, int F,
                                          int S, int R, void* stream) {
  return chain_dispatch<true, kState0>(nullptr, data, rows, maps, nullptr, nullptr, final_pm,
                                       packed, B, T, F, S, R, stream);
}

// `viterbi_scan_packed_window`: seeded from pm0, per-lane [lo, hi) (B,)
// int32 windows, packed (W, B, S) words.
extern "C" int viterbi_scan_packed_window_launch(const void* pm0, const void* data,
                                                 const void* rows, const void* maps,
                                                 const void* lo, const void* hi,
                                                 void* final_pm, void* packed, int B, int T,
                                                 int F, int S, int R, void* stream) {
  return chain_dispatch<true, kWindow>(pm0, data, rows, maps, lo, hi, final_pm, packed, B, T,
                                       F, S, R, stream);
}

// `viterbi_scan`: state-0 init, one int32 select per (T, B, S).
extern "C" int viterbi_scan_launch(const void* data, const void* rows, const void* maps,
                                   void* final_pm, void* bps, int B, int T, int F, int S, int R,
                                   void* stream) {
  return chain_dispatch<false, kState0>(nullptr, data, rows, maps, nullptr, nullptr, final_pm,
                                        bps, B, T, F, S, R, stream);
}

#ifndef VITERBI_WIDE_ONLY
// `viterbi_scan_packed_carry`: seeded from pm0 (B, S), packed (W, B, S) words.
extern "C" int viterbi_scan_packed_carry_launch(const void* pm0, const void* data,
                                                const void* rows, const void* maps,
                                                void* final_pm, void* packed, int B, int T,
                                                int F, int S, int R, void* stream) {
  return chain_dispatch<true, kCarried>(pm0, data, rows, maps, nullptr, nullptr, final_pm,
                                        packed, B, T, F, S, R, stream);
}

// `viterbi_scan_carry`: seeded from pm0, one int32 select per (T, B, S).
extern "C" int viterbi_scan_carry_launch(const void* pm0, const void* data, const void* rows,
                                         const void* maps, void* final_pm, void* bps, int B,
                                         int T, int F, int S, int R, void* stream) {
  return chain_dispatch<false, kCarried>(pm0, data, rows, maps, nullptr, nullptr, final_pm,
                                         bps, B, T, F, S, R, stream);
}

#endif  // VITERBI_WIDE_ONLY

extern "C" const char* viterbi_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
