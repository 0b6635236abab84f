// Packed forward add-compare-select (ACS) scan for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/viterbi_scan.py `viterbi_scan_packed`
//   (`_scan_call` + `_make_scan_kernel(carry=False, pack=True)`), the Pallas
//   TPU kernel of the short-block decode path.
//
// What it computes, for every stream b and trellis step t:
//   cand_j[s'] = (pm[2v + j] + sum_f b_j[s', f] * x[b, t, f]) + rb[s', j]
//   take1      = cand_1 < cand_0            (strict: ties go to j = 0)
//   pm'[s']    = min(take1 ? cand_1 : cand_0, 1e30)
// with s' = u*S/2 + v, pm starting at [0, 1e30, ...], and the select bits
// packed 32 steps per word (bit p of word w is step 32w + p; the tail bits of
// a partial last word stay 0).
//
// What bounds it on this card: float operations, narrowly, and the
// step-to-step dependence.  Per (stream, step) the function must read F
// floats (4F bytes) and write S survivor bits (S/8 bytes).  The folded rows
// b_j[s'] are only the M = 2^n rows of the metric weight re-indexed by each
// transition's output symbol, so it needs M*2F operations for the metrics
// plus 7 per state (four adds, compare, select, clamp): for K=7 rate 1/2
// (S=64, F=2, M=4) that is 464 operations for 16 bytes, just above the
// card's ~20 float32 operations per byte of HBM.  This kernel evaluates the
// dot product per state instead, S*(4F+5) = 832 operations, 1.8x what the
// function needs.  Each step also needs the whole previous metric vector of
// its stream, so a stream's steps run strictly in order with a block-wide
// exchange between.
//
// How the design answers that:
//   * The TPU grid's sequential time axis becomes a `for t` loop inside the
//     block (Hopper blocks run in no order).  Path metrics never leave the
//     SM: they sit double-buffered in shared memory, one barrier per step.
//   * One block holds G streams; each thread owns SPT successor states of one
//     stream (G*S/SPT = 256 threads).  Streams are independent, so B/G blocks
//     fill the SMs.
//   * Predecessors are read directly at 2v and 2v+1 — the (S, S) one-hot
//     matmuls of the Pallas body exist only to avoid TPU gathers.
//   * Each thread keeps its 32-step survivor word in a register and stores it
//     once per 32 steps, in the (W, B, S) layout: consecutive threads hold
//     consecutive states of one stream, so a warp's stores are contiguous.
//   * The next step's features are loaded into shared memory during the
//     current step, under the same barrier.
//   * Exactness: adds and multiplies use __fadd_rn / __fmul_rn, so the
//     compiler cannot contract them into FMAs and the float order is the
//     reference's: ((pm + (0 + b_0 x_0 + b_1 x_1 + ...)) + rb).  Built
//     without --use_fast_math.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr float kUnreachable = 1e30f;
constexpr int kThreads = 256;
constexpr int kMaxSharedBytes = 232448;  // 227 KB opt-in per block on sm_90

template <int SPT>
__global__ void __launch_bounds__(kThreads)
scan_packed_kernel(const float* __restrict__ data,  // (B, T, F)
                   const float* __restrict__ b0,    // (S, F)
                   const float* __restrict__ b1,    // (S, F)
                   const float* __restrict__ rb,    // (S, 2)
                   float* __restrict__ final_pm,    // (B, S)
                   int32_t* __restrict__ packed,    // (W, B, S)
                   int B, int T, int F, int S) {
  const int tps = S / SPT;        // threads per stream
  const int G = kThreads / tps;   // streams per block
  extern __shared__ float smem[];
  const int g = threadIdx.x / tps;
  const int lane = threadIdx.x % tps;
  const int b = blockIdx.x * G + g;
  const bool live = b < B;
  const int vmask = (S >> 1) - 1;  // 0 when S == 2

  float* pm_cur = smem + g * S;               // [2][G][S]
  float* pm_nxt = smem + (G + g) * S;
  float* x_base = smem + 2 * G * S + g * F;   // [2][G][F]
  const float* row = data + static_cast<size_t>(live ? b : 0) * T * F;

#pragma unroll
  for (int k = 0; k < SPT; ++k) {
    const int s = lane + k * tps;
    pm_cur[s] = (s == 0) ? 0.0f : kUnreachable;
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
      const bool take1 = c1 < c0;
      float nm = take1 ? c1 : c0;
      nm = (nm > kUnreachable) ? kUnreachable : nm;  // NaN passes, as jnp.minimum
      pm_nxt[s] = nm;
      word[k] |= static_cast<uint32_t>(take1) << p;
      if (flush) {
        if (live)
          packed[(static_cast<size_t>(t >> 5) * B + b) * S + s] =
              static_cast<int32_t>(word[k]);
        word[k] = 0u;
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
      final_pm[static_cast<size_t>(b) * S + s] = pm_cur[s];
    }
  }
}

template <int SPT>
int launch(const float* data, const float* b0, const float* b1, const float* rb,
           float* final_pm, int32_t* packed, int B, int T, int F, int S,
           cudaStream_t stream) {
  const int G = kThreads / (S / SPT);
  const size_t smem = sizeof(float) * (2 * static_cast<size_t>(G) * S + 2 * G * F);
  if (smem > static_cast<size_t>(kMaxSharedBytes)) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        scan_packed_kernel<SPT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int blocks = (B + G - 1) / G;
  scan_packed_kernel<SPT><<<blocks, kThreads, smem, stream>>>(
      data, b0, b1, rb, final_pm, packed, B, T, F, S);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point, loaded with ctypes.  S must be a power of two in
// [2, 4096]; returns the cudaError_t of the launch (0 = launched).
extern "C" int viterbi_scan_packed_launch(const void* data, const void* b0,
                                          const void* b1, const void* rb,
                                          void* final_pm, void* packed, int B,
                                          int T, int F, int S, void* stream) {
  if (B < 1 || T < 1 || F < 1 || S < 2 || S > 16 * kThreads || (S & (S - 1)))
    return cudaErrorInvalidValue;
  const auto* d = static_cast<const float*>(data);
  const auto* w0 = static_cast<const float*>(b0);
  const auto* w1 = static_cast<const float*>(b1);
  const auto* r = static_cast<const float*>(rb);
  auto* pm = static_cast<float*>(final_pm);
  auto* pk = static_cast<int32_t*>(packed);
  auto st = static_cast<cudaStream_t>(stream);
  switch (S > kThreads ? S / kThreads : 1) {
    case 1: return launch<1>(d, w0, w1, r, pm, pk, B, T, F, S, st);
    case 2: return launch<2>(d, w0, w1, r, pm, pk, B, T, F, S, st);
    case 4: return launch<4>(d, w0, w1, r, pm, pk, B, T, F, S, st);
    case 8: return launch<8>(d, w0, w1, r, pm, pk, B, T, F, S, st);
    case 16: return launch<16>(d, w0, w1, r, pm, pk, B, T, F, S, st);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" const char* viterbi_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
