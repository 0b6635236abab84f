// Forward add-compare-select (ACS) scans for Hopper (sm_90a): one kernel
// template, four entry points.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/viterbi_scan.py built
// from the one parameterised body `_make_scan_kernel(carry, pack, windowed)`:
//   viterbi_scan_packed_launch         `viterbi_scan_packed`        (carry=False, pack=True)
//                                      the short-block decode path
//   viterbi_scan_packed_carry_launch   `viterbi_scan_packed_carry`  (carry=True, pack=True)
//                                      the packed streaming session's chunk scan
//   viterbi_scan_packed_window_launch  `viterbi_scan_packed_window` (carry=True, pack=True,
//                                      windowed=True) both passes of the tiled decode
//   viterbi_scan_carry_launch          `viterbi_scan_carry`         (carry=True, pack=False)
//                                      the `streaming` backend's chunk scan, bm tables in
//
// What it computes, for every stream (lane) b and trellis step t:
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
// What bounds it on this card: float operations, narrowly, and the
// step-to-step dependence.  Per (lane, step) the function must read F floats
// (4F bytes) and write S survivor bits (S/8 bytes packed, 4S bytes
// unpacked).  The folded rows b_j[s'] are only the M = 2^n rows of the
// metric weight re-indexed by each transition's output symbol, so it needs
// M*2F operations for the metrics plus 7 per state (four adds, compare,
// select, clamp): for K=7 rate 1/2 (S=64, F=2, M=4) that is 464 operations
// for 16 bytes packed, just above the card's ~20 float32 operations per byte
// of HBM.  This kernel evaluates the dot product per state instead,
// S*(4F+5) = 832 operations, 1.8x what the function needs.  Unpacked (bm
// tables in, F = M = 4) the 4S = 256 bytes of survivors a step make the
// stores the bound: 256 + 16 bytes against 7S + 2M^2 = 480 operations.  A
// window's lanes do ACS work only on their valid steps.  Each step also
// needs the whole previous metric vector of its lane, so a lane's steps run
// strictly in order with a block-wide exchange between.
//
// How the design answers that:
//   * The TPU grid's sequential time axis becomes a `for t` loop inside the
//     block (Hopper blocks run in no order).  Path metrics never leave the
//     SM: they sit double-buffered in shared memory, one barrier per step.
//   * One block holds G lanes; each thread owns SPT successor states of one
//     lane (G*S/SPT = 256 threads).  Lanes are independent, so B/G blocks
//     fill the SMs — the tiled decode's B*P*S lanes give hundreds of
//     thousands of blocks, the stream chunk's 128 lanes only 32.
//   * Predecessors are read directly at 2v and 2v+1 — the (S, S) one-hot
//     matmuls of the Pallas body exist only to avoid TPU gathers.
//   * Each thread keeps its 32-step survivor word in a register and stores it
//     once per 32 steps, in the (W, B, S) layout; unpacked selects go out
//     every step in the (T, B, S) layout.  Consecutive threads hold
//     consecutive states of one lane, so a warp's stores are contiguous in
//     both layouts.
//   * The window is two compares and two selects per state on the lane's
//     [lo, hi), held in registers: the candidates are still computed on
//     invalid steps, so a block's threads never diverge on it.
//   * The next step's features are loaded into shared memory during the
//     current step, under the same barrier.
//   * Exactness: adds and multiplies use __fadd_rn / __fmul_rn, so the
//     compiler cannot contract them into FMAs and the float order is the
//     reference's: ((pm + (0 + b_0 x_0 + b_1 x_1 + ...)) + rb).  1e30 + m
//     rounds back to 1e30 for the carried unit-entry seeds as it does in the
//     reference.  Built without --use_fast_math.
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

// `viterbi_scan_packed_carry`: seeded from pm0 (B, S), packed (W, B, S) words.
extern "C" int viterbi_scan_packed_carry_launch(const void* pm0, const void* data,
                                                const void* b0, const void* b1,
                                                const void* rb, void* final_pm,
                                                void* packed, int B, int T, int F,
                                                int S, void* stream) {
  return dispatch<true, false, true>(
      args(pm0, data, b0, b1, rb, nullptr, nullptr, final_pm, packed, B, T, F, S), stream);
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

// `viterbi_scan_carry`: seeded from pm0, one int32 select per (T, B, S).
extern "C" int viterbi_scan_carry_launch(const void* pm0, const void* data,
                                         const void* b0, const void* b1,
                                         const void* rb, void* final_pm, void* bps,
                                         int B, int T, int F, int S, void* stream) {
  return dispatch<true, false, false>(
      args(pm0, data, b0, b1, rb, nullptr, nullptr, final_pm, bps, B, T, F, S), stream);
}

extern "C" const char* viterbi_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
