// Forward add-compare-select (ACS) scans for Hopper (sm_90a): two designs,
// five entry points.
//
// Replace the Pallas TPU kernels of src/repro/kernels/viterbi_scan.py built
// from the one parameterised body `_make_scan_kernel(carry, pack, windowed)`:
//   viterbi_scan_packed_launch         `viterbi_scan_packed`        (carry=False, pack=True)
//                                      the short-block decode path          [block design]
//   viterbi_scan_packed_window_launch  `viterbi_scan_packed_window` (carry=True, pack=True,
//                                      windowed=True) both passes of the tiled decode,
//                                      `parallel`'s transfer matrices       [block design]
//   viterbi_scan_launch                `viterbi_scan`               (carry=False, pack=False)
//                                      the `fused` backend's scan, bm tables in [block design]
//   viterbi_scan_packed_carry_launch   `viterbi_scan_packed_carry`  (carry=True, pack=True)
//                                      the packed streaming session's chunk scan [chain design]
//   viterbi_scan_carry_launch          `viterbi_scan_carry`         (carry=True, pack=False)
//                                      the `streaming` backend's chunk scan and
//                                      `parallel`'s re-scan, bm tables in  [chain design]
//
// What they compute, for every stream (lane) b and trellis step t:
//   cand_j[s'] = (pm[2v + j] + sum_f b_j[s', f] * x[b, t, f]) + rb[s', j]
//   take1      = cand_1 < cand_0            (strict: ties go to j = 0)
//   pm'[s']    = min(take1 ? cand_1 : cand_0, 1e30)
// with s' = u*S/2 + v.  pm starts at [0, 1e30, ...] (CARRY = false) or at the
// lane's row of pm0 (CARRY = true).  With WINDOW, a lane runs ACS only on its
// steps lo[b] <= t < hi[b] (t counts the steps of this launch, 0..T-1):
// elsewhere pm' = pm, untouched and unclamped, and the select bit is 0.
// Select bits are packed 32 steps per word (PACK: bit p of word w is step
// 32w + p, the tail bits of a partial last word stay 0) or stored one int32
// per (step, lane, state) (PACK = false).
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
// Both designs keep:
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
// The block design (`scan_kernel`: #1, #4, #6), bound by throughput at the
// shapes those paths give it (B*P*S tiled lanes, 8192 short blocks):
//   * One block holds G lanes; each thread owns SPT successor states of one
//     lane (G*S/SPT = 256 threads), metrics double-buffered in shared
//     memory, one block-wide barrier per step.
//   * Each thread evaluates the dot product of its states itself, S*(4F+5)
//     = 832 operations a lane-step at K=7 (1.8x what the function needs),
//     reading its weights through __ldg every step.
//   * The window is two compares and two selects per state on the lane's
//     [lo, hi), held in registers: the candidates are still computed on
//     invalid steps, so a block's threads never diverge on it.
//   * The next step's features are loaded into shared memory during the
//     current step, under the same barrier: a global load sits between two
//     steps.
//
// The chain design (`chain_kernel`: #3, #7), bound by one lane's step
// latency at the stream chunk's 128 lanes, by the survivor stores at the
// re-scan's 17408:
//   * Few threads a lane, no block barrier in the step.  A group of G
//     threads (the CHOICES table below) runs one lane; each thread holds
//     SPT = S/G <= 8 states in registers.  Up to a warp (G <= 32) thread r
//     holds states r*SPT .. r*SPT + SPT-1, so the predecessors 2v + j of its
//     successors are all the states of threads 2(r mod G/2) and 2(r mod G/2)
//     + 1: 2*SPT __shfl_sync a step, with registers fixed at compile time,
//     and no barrier at all.  Past a warp (S >= 128 choices) thread r holds
//     i*G + r, the metrics go through shared memory (double-buffered, one
//     float2 read of both predecessors) and a named barrier of the lane's G
//     threads (`bar.sync 1 + g, G`) ends the step: never a barrier across
//     lanes.  L lanes a block; at the stream chunk's 128 lanes the table's
//     choices spread the lanes' chains over the SMs.
//   * Distinct rows.  The wrapper passes the (R, F + 1) distinct rows
//     (weights, bias) of b0 and b1 with rb and an (S, 2) state -> row map
//     (kernels/viterbi_scan.py:row_operands; R = M for every folded or
//     table weight, at most 2S for any).  Each (lane, step) gets its R dots
//     once, where the block design computes 2S; a thread keeps its states'
//     row indices and biases in registers and reads two dots a state.  A dot
//     is the same row times the same features in the same order (f = 0 ..
//     F-1 from 0), so the bits are the block design's.
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
// Launch choices of the chain kernel (the VITERBI_CHOICES table below; G
// threads a lane, L lanes a block, Tc steps a tile), one template per S and
// PACK:
//   S         2       4      8      16      32      64      128-256  512-1024
//   G/L/Tc    2/16/64 4/8/64 8/8/64 16/4/64 32/4/64 32/2/64 128/1/64 256, 512/1/64
//   (S = 2048: 256/1/64; S = 4096: 512/1/64.)  They are the picks of
// `tools/scan_measure.py sweep` on this source (an NVIDIA H100 80GB HBM3 at
// 700 W): of every G with at most 8 states a thread, blocks of 32, 64 or 128
// threads (1 or 2 lanes past a warp) and Tc of 8, 16, 32 or 64, the one with
// the least sum over the stream chunk's packed and unpacked shapes (128 x
// 64) and, at S = 64 and 4, the `parallel` re-scans of its time over that
// shape's best.  Keying the table on the lane count too would gain 1% at S
// = 64 and 3% at S = 4, so it is keyed on S alone.  ptxas (sm_90a, CUDA
// 12.8, this source), registers packed/unpacked: S=2 72/72, 4 72/72, 8
// 64/64, 16 64/64, 32 56/64, 64 72/72, 128 64/64, 256 64/48, 512 48/48, 1024
// 60/61, 2048 116/106, 4096 124/110; small spills (16-32 bytes stored,
// 20-64 loaded, 8-32 byte stack frames) unpacked at S = 2-32, 128 and 256,
// packed at S = 4-16, 64, 128 and 256; none elsewhere.  The groups of more
// than one warp use all 16 named barriers.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr float kUnreachable = 1e30f;
constexpr int kThreads = 256;
constexpr int kMaxSharedBytes = 232448;  // 227 KB opt-in per block on sm_90

struct ScanArgs {
  const float* data;     // (B, T, F)
  const float* b0;       // (S, F)
  const float* b1;       // (S, F)
  const float* rb;       // (S, 2)
  const float* pm0;      // (B, S) when CARRY
  const int32_t* lo;     // (B,) when WINDOW
  const int32_t* hi;     // (B,) when WINDOW
  float* final_pm;       // (B, S)
  int32_t* survivors;    // (W, B, S) words when PACK, else (T, B, S) selects
  int B, T, F, S;
};

template <int SPT, bool CARRY, bool WINDOW, bool PACK>
__global__ void __launch_bounds__(kThreads) scan_kernel(const ScanArgs a) {
  const int B = a.B, T = a.T, F = a.F, S = a.S;
  const float* __restrict__ b0 = a.b0;
  const float* __restrict__ b1 = a.b1;
  const float* __restrict__ rb = a.rb;
  int32_t* __restrict__ out = a.survivors;
  const int tps = S / SPT;        // threads per lane
  const int G = kThreads / tps;   // lanes per block
  extern __shared__ float smem[];
  const int g = threadIdx.x / tps;
  const int lane = threadIdx.x % tps;
  const int b = blockIdx.x * G + g;
  const bool live = b < B;
  const int vmask = (S >> 1) - 1;  // 0 when S == 2

  float* pm_cur = smem + g * S;               // [2][G][S]
  float* pm_nxt = smem + (G + g) * S;
  float* x_base = smem + 2 * G * S + g * F;   // [2][G][F]
  const float* __restrict__ row = a.data + static_cast<size_t>(live ? b : 0) * T * F;

#pragma unroll
  for (int k = 0; k < SPT; ++k) {
    const int s = lane + k * tps;
    if constexpr (CARRY) {
      pm_cur[s] = live ? a.pm0[static_cast<size_t>(b) * S + s] : kUnreachable;
    } else {
      pm_cur[s] = (s == 0) ? 0.0f : kUnreachable;
    }
  }
  int lo = 0, hi = T;
  if constexpr (WINDOW) {
    if (live) {
      lo = a.lo[b];
      hi = a.hi[b];
    }
  }
  for (int f = lane; f < F; f += tps) x_base[f] = live ? row[f] : 0.0f;
  __syncthreads();

  uint32_t word[SPT];
#pragma unroll
  for (int k = 0; k < SPT; ++k) word[k] = 0u;

  for (int t = 0; t < T; ++t) {
    const float* x = x_base + (t & 1) * G * F;
    if (t + 1 < T) {
      float* x_next = x_base + ((t + 1) & 1) * G * F;
      for (int f = lane; f < F; f += tps)
        x_next[f] = live ? row[static_cast<size_t>(t + 1) * F + f] : 0.0f;
    }
    const int p = t & 31;
    const bool flush = (p == 31) || (t == T - 1);
    const bool valid = !WINDOW || (t >= lo && t < hi);
#pragma unroll
    for (int k = 0; k < SPT; ++k) {
      const int s = lane + k * tps;
      const int v = s & vmask;
      float m0 = 0.0f, m1 = 0.0f;
      for (int f = 0; f < F; ++f) {
        const float xf = x[f];
        m0 = __fadd_rn(m0, __fmul_rn(__ldg(b0 + s * F + f), xf));
        m1 = __fadd_rn(m1, __fmul_rn(__ldg(b1 + s * F + f), xf));
      }
      const float c0 = __fadd_rn(__fadd_rn(pm_cur[2 * v], m0), __ldg(rb + 2 * s));
      const float c1 = __fadd_rn(__fadd_rn(pm_cur[2 * v + 1], m1), __ldg(rb + 2 * s + 1));
      bool take1 = c1 < c0;
      float nm = take1 ? c1 : c0;
      nm = (nm > kUnreachable) ? kUnreachable : nm;  // NaN passes, as jnp.minimum
      if constexpr (WINDOW) {
        // outside [lo, hi) the step does not exist for this lane
        take1 = take1 && valid;
        nm = valid ? nm : pm_cur[s];
      }
      pm_nxt[s] = nm;
      if constexpr (PACK) {
        word[k] |= static_cast<uint32_t>(take1) << p;
        if (flush) {
          if (live)
            out[(static_cast<size_t>(t >> 5) * B + b) * S + s] = static_cast<int32_t>(word[k]);
          word[k] = 0u;
        }
      } else {
        if (live) out[(static_cast<size_t>(t) * B + b) * S + s] = static_cast<int32_t>(take1);
      }
    }
    __syncthreads();
    float* tmp = pm_cur;
    pm_cur = pm_nxt;
    pm_nxt = tmp;
  }

  if (live) {
#pragma unroll
    for (int k = 0; k < SPT; ++k) {
      const int s = lane + k * tps;
      a.final_pm[static_cast<size_t>(b) * S + s] = pm_cur[s];
    }
  }
}

template <int SPT, bool CARRY, bool WINDOW, bool PACK>
int launch(const ScanArgs& a, cudaStream_t stream) {
  const int G = kThreads / (a.S / SPT);
  const size_t smem = sizeof(float) * (2 * static_cast<size_t>(G) * a.S + 2 * G * a.F);
  if (smem > static_cast<size_t>(kMaxSharedBytes)) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        scan_kernel<SPT, CARRY, WINDOW, PACK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int blocks = (a.B + G - 1) / G;
  scan_kernel<SPT, CARRY, WINDOW, PACK><<<blocks, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// S must be a power of two in [2, 4096]; one thread owns S/256 states past 256.
template <bool CARRY, bool WINDOW, bool PACK>
int dispatch(const ScanArgs& a, void* stream) {
  const int S = a.S;
  if (a.B < 1 || a.T < 1 || a.F < 1 || S < 2 || S > 16 * kThreads || (S & (S - 1)))
    return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  switch (S > kThreads ? S / kThreads : 1) {
    case 1: return launch<1, CARRY, WINDOW, PACK>(a, st);
    case 2: return launch<2, CARRY, WINDOW, PACK>(a, st);
    case 4: return launch<4, CARRY, WINDOW, PACK>(a, st);
    case 8: return launch<8, CARRY, WINDOW, PACK>(a, st);
    case 16: return launch<16, CARRY, WINDOW, PACK>(a, st);
    default: return cudaErrorInvalidValue;
  }
}

ScanArgs args(const void* pm0, const void* data, const void* b0, const void* b1,
              const void* rb, const void* lo, const void* hi, void* final_pm,
              void* survivors, int B, int T, int F, int S) {
  return ScanArgs{static_cast<const float*>(data), static_cast<const float*>(b0),
                  static_cast<const float*>(b1),   static_cast<const float*>(rb),
                  static_cast<const float*>(pm0),  static_cast<const int32_t*>(lo),
                  static_cast<const int32_t*>(hi), static_cast<float*>(final_pm),
                  static_cast<int32_t*>(survivors), B, T, F, S};
}

}  // namespace

// ------------------------------------------------------------------------- //
// The chain design: the carried chunk scans #3 and #7                        //
// ------------------------------------------------------------------------- //

// Launch choices, one row per S = 2, 4, ..., 4096: {G threads a lane, L lanes
// a block, Tc steps a tile}.  A measurement build (tools/scan_measure.py)
// defines its own table before it includes this file.
#ifndef VITERBI_CHOICES
#define VITERBI_CHOICES                                                         \
  {{2, 16, 64},  {4, 8, 64},   {8, 8, 64},   {16, 4, 64},  {32, 4, 64},        \
   {32, 2, 64},  {128, 1, 64}, {128, 1, 64}, {256, 1, 64}, {512, 1, 64},       \
   {256, 1, 64}, {512, 1, 64}}
#endif
// A measurement build may also cut parts of the chain kernel's work, to time
// what is left (its outputs are then wrong): bit 0 the staging of the
// features, bit 1 the distinct-row dots, bit 2 the survivor stores.
#ifndef VITERBI_CUT
#define VITERBI_CUT 0
#endif

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kCut = VITERBI_CUT;

struct Choice {
  int G, L, Tc;
};
constexpr Choice kChoices[12] = VITERBI_CHOICES;

constexpr int log2i(int n) { return n > 1 ? 1 + log2i(n / 2) : 0; }
constexpr bool pow2(int n) { return n > 0 && (n & (n - 1)) == 0; }
constexpr Choice choice(int S) { return kChoices[log2i(S) - 1]; }

// G a power of two up to S with at most 8 states a thread; whole warps; a
// group of more than one warp is whole warps and has its own named barrier
// (ids 1 .. L); 1 to 64 steps a tile.
constexpr bool valid(const Choice& c, int S) {
  return pow2(c.G) && c.G <= S && S / c.G <= 8 && pow2(c.L) && c.G * c.L <= 1024 &&
         (c.G * c.L) % 32 == 0 && (c.G <= 32 || c.L <= 8) && c.Tc >= 1 && c.Tc <= 64;
}

struct ChainArgs {
  const float* pm0;     // (B, S)
  const float* data;    // (B, T, F)
  const float* rows;    // (R, F + 1): distinct rows (weights, bias)
  const int32_t* maps;  // (S, 2): the row of (b_j[s], rb[s, j])
  float* final_pm;      // (B, S)
  int32_t* survivors;   // (W, B, S) words when PACK, else (T, B, S) selects
  int B, T, F, S, R;
  int Tc, feat_buf, dots_buf, lane_floats;  // tile and shared-memory plan (floats)
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

// Tile dots: d[k * R + j] = distinct row j times step k's features x[k * F ..]
// for k < n.  With R <= G thread r takes row j0 = r % R of steps k0 = r / R,
// k0 + per, ... (per = G / R), its weights in registers when F is known;
// with R > G rows r, r + G, ... of every step.  Independent items, so a
// batch costs about one item's latency.
template <int FX>
__device__ __forceinline__ void tile_dots(float* d, const float* x,
                                          const float* __restrict__ rows, int n, int F,
                                          int R, int G, int per, int j0, int k0) {
  const int F1 = F + 1;
  if (per == 0) {
#pragma unroll 4
    for (int k = 0; k < n; ++k)
      for (int j = j0; j < R; j += G) d[k * R + j] = row_dot<FX>(rows + j * F1, x + k * F, F);
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
      d[k * R + j0] = m;
    }
  } else {
    for (int k = k0; k < n; k += per) d[k * R + j0] = row_dot<0>(rows + j0 * F1, x + k * F, F);
  }
}

// One lane's T steps on G threads: thread r of a group holds SPT = S/G states,
// r*SPT .. r*SPT + SPT-1 when the group is one warp or less (G <= 32), i*G + r
// for i < SPT when it is more.  Per tile of Tc steps: the group copies tile
// c+2's features into shared memory (cp.async, into the buffer tile c's
// features left), runs the tile's steps, computes tile c+1's R distinct-row
// dots, and waits for its copies; one group barrier ends a tile.
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
      tile_dots<2>(d, x, rows, n, F, R, G, per, j0, k0);
    else if (F == 3)
      tile_dots<3>(d, x, rows, n, F, R, G, per, j0, k0);
    else if (F == 4)
      tile_dots<4>(d, x, rows, n, F, R, G, per, j0, k0);
    else
      tile_dots<0>(d, x, rows, n, F, R, G, per, j0, k0);
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

int round4(int n) { return (n + 3) & ~3; }

// Launch the one kernel built for (S, PACK) with the table's choice; Tc is
// halved while a block's shared memory would not fit.
template <int S, bool PACK>
int chain_launch(ChainArgs a, cudaStream_t stream) {
  constexpr Choice c = choice(S);
  static_assert(valid(c, S), "a launch choice outside what the chain kernel takes");
  auto plan = [&](int Tc) {
    a.Tc = Tc;
    a.feat_buf = round4(Tc * a.F);
    a.dots_buf = round4(Tc * a.R);
    a.lane_floats = 2 * a.feat_buf + 2 * a.dots_buf + (c.G > 32 ? 2 * S : 0);
    return sizeof(float) * static_cast<size_t>(c.L) * a.lane_floats;
  };
  int Tc = c.Tc;
  size_t smem = plan(Tc);
  while (smem > static_cast<size_t>(kMaxSharedBytes) && Tc > 1) smem = plan(Tc /= 2);
  if (smem > static_cast<size_t>(kMaxSharedBytes)) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        chain_kernel<S, c.G, c.L, PACK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  chain_kernel<S, c.G, c.L, PACK><<<(a.B + c.L - 1) / c.L, c.G * c.L, smem, stream>>>(a);
  return cudaGetLastError();
}

// S a power of two in [2, 4096]; R at most 2S (the distinct rows of b0, b1).
template <bool PACK>
int chain_dispatch(const void* pm0, const void* data, const void* rows, const void* maps,
                   void* final_pm, void* survivors, int B, int T, int F, int S, int R,
                   void* stream) {
  if (B < 1 || T < 1 || F < 1 || S < 2 || S > 4096 || !pow2(S) || R < 1 || R > 2 * S)
    return cudaErrorInvalidValue;
  const ChainArgs a{static_cast<const float*>(pm0),   static_cast<const float*>(data),
                    static_cast<const float*>(rows),  static_cast<const int32_t*>(maps),
                    static_cast<float*>(final_pm),    static_cast<int32_t*>(survivors),
                    B, T, F, S, R, 0, 0, 0, 0};
  auto st = static_cast<cudaStream_t>(stream);
  switch (S) {
    case 2: return chain_launch<2, PACK>(a, st);
    case 4: return chain_launch<4, PACK>(a, st);
    case 8: return chain_launch<8, PACK>(a, st);
    case 16: return chain_launch<16, PACK>(a, st);
    case 32: return chain_launch<32, PACK>(a, st);
    case 64: return chain_launch<64, PACK>(a, st);
    case 128: return chain_launch<128, PACK>(a, st);
    case 256: return chain_launch<256, PACK>(a, st);
    case 512: return chain_launch<512, PACK>(a, st);
    case 1024: return chain_launch<1024, PACK>(a, st);
    case 2048: return chain_launch<2048, PACK>(a, st);
    default: return chain_launch<4096, PACK>(a, st);
  }
}

}  // namespace

// Plain C entry points, loaded with ctypes.  Each returns the cudaError_t of
// its launch (0 = launched).

// `viterbi_scan_packed`: state-0 init, packed (W, B, S) words.
extern "C" int viterbi_scan_packed_launch(const void* data, const void* b0,
                                          const void* b1, const void* rb,
                                          void* final_pm, void* packed, int B,
                                          int T, int F, int S, void* stream) {
  return dispatch<false, false, true>(
      args(nullptr, data, b0, b1, rb, nullptr, nullptr, final_pm, packed, B, T, F, S), stream);
}

// `viterbi_scan_packed_window`: seeded from pm0, per-lane [lo, hi) (B,)
// int32 windows, packed (W, B, S) words.
extern "C" int viterbi_scan_packed_window_launch(const void* pm0, const void* data,
                                                 const void* b0, const void* b1,
                                                 const void* rb, const void* lo,
                                                 const void* hi, void* final_pm,
                                                 void* packed, int B, int T, int F,
                                                 int S, void* stream) {
  return dispatch<true, true, true>(
      args(pm0, data, b0, b1, rb, lo, hi, final_pm, packed, B, T, F, S), stream);
}

// `viterbi_scan`: state-0 init, one int32 select per (T, B, S).
extern "C" int viterbi_scan_launch(const void* data, const void* b0, const void* b1,
                                   const void* rb, void* final_pm, void* bps, int B,
                                   int T, int F, int S, void* stream) {
  return dispatch<false, false, false>(
      args(nullptr, data, b0, b1, rb, nullptr, nullptr, final_pm, bps, B, T, F, S), stream);
}

// `viterbi_scan_packed_carry`: seeded from pm0 (B, S), packed (W, B, S)
// words; the (R, F + 1) distinct rows and (S, 2) row map of row_operands.
extern "C" int viterbi_scan_packed_carry_launch(const void* pm0, const void* data,
                                                const void* rows, const void* maps,
                                                void* final_pm, void* packed, int B, int T,
                                                int F, int S, int R, void* stream) {
  return chain_dispatch<true>(pm0, data, rows, maps, final_pm, packed, B, T, F, S, R, stream);
}

// `viterbi_scan_carry`: seeded from pm0, one int32 select per (T, B, S).
extern "C" int viterbi_scan_carry_launch(const void* pm0, const void* data, const void* rows,
                                         const void* maps, void* final_pm, void* bps, int B,
                                         int T, int F, int S, int R, void* stream) {
  return chain_dispatch<false>(pm0, data, rows, maps, final_pm, bps, B, T, F, S, R, stream);
}

extern "C" const char* viterbi_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
