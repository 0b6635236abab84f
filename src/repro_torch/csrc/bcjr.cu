// Max-log-MAP BCJR scans over a recursive systematic (RSC) trellis for
// Hopper (sm_90a): the forward (alpha) recursion and the time-reversed beta
// recursion fused with the per-step LLR.
//
// Replaces the two Pallas TPU kernels of src/repro/kernels/bcjr.py:
//   bcjr_alpha_scan_launch     `bcjr_alpha_scan`    (`_alpha_kernel`)
//   bcjr_beta_llr_scan_launch  `bcjr_beta_llr_scan` (`_make_beta_kernel`)
// Both run behind ops.bcjr_llr_op: the `bcjr` backend once per decode, the
// turbo decoder twice per iteration.
//
// What they compute, for every lane b, with the butterfly of the RSC
// trellis: successor s' = a*S/2 + v has predecessors 2v and 2v+1, and state
// p moves under new register bit a to a*S/2 + (p >> 1).  Every metric is a
// min-domain cost; m = w . x_t is an F-term dot of a (S, F) weight row with
// the step's features, summed f = 0 .. F-1 from 0.
//   alpha   A_0 = [0, 1e30, ...]; for t = 0 .. T-1: emit A_t, then
//           new[s'] = min((A[2v] + b0[s'].x), (A[2v+1] + b1[s'].x))
//           shift = min_s' new;  A_{t+1} = min(new - shift, 1e30)
//           acc += shift;        final_pm = A_T + acc
//   beta    B_T = [0, 1e30, ...] (terminated) or 0 (open); for t = T-1 .. 0:
//           cost_u[p] = (A_t[p] + w_u[p].x) + B[next_state[p, u]]
//           llr_t = min_p cost_1 - min_p cost_0
//           new[p] = min((B[p >> 1] + c0[p].x), (B[S/2 + (p >> 1)] + c1[p].x))
//           B_t = min(new - min_p new, 1e30)
// The Pallas kernels gather through (S, S) one-hot matmuls (P_j, N_a, U_u)
// only to avoid gathers on the TPU; a one-hot dot is an exact selection, so
// the direct indices here give the same bits: P_j -> 2v + j,
// N_a -> a*S/2 + (p >> 1), U_u -> next_state[p, u], whose register bit
// a = u XOR f(p) is read from the next-state table.
//
// What bounds them on this card: bytes.  The alpha scan writes every A_t,
// (T, S, B) floats, and the beta scan reads them back with the features:
// at the turbo block N=512, S=8, B=8192 that is 134 MB each way, about 0.04
// ms at 3.35 TB/s, against a few dozen operations per (lane, state, step).
// A lane's steps are strictly sequential, so the scan is also bound by the
// latency of one step's dependent adds and mins.
//
// How the design answers that: one thread owns one lane and holds its S
// metrics in registers for all T steps (S <= 64, a template parameter, so
// every state index is a compile-time register name); the min over states
// is a register loop, with no shared memory and no barrier.  The reference's
// kernel layout is kept: features (T, F, B), alphas (T, S, B), llr (T, B),
// final metrics (S, B) — lane b is the fastest axis, so a warp's loads and
// stores of one step are contiguous.  The next step's features are loaded
// before the current step's arithmetic.  Small blocks (one warp) spread the
// lanes of a small batch over as many SMs as possible.  Exactness: adds,
// subtracts and multiplies use __fadd_rn / __fsub_rn / __fmul_rn, so the
// compiler cannot contract or reorder them, and every min propagates NaN as
// jnp.minimum does.  Built without --use_fast_math.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr float kUnreachable = 1e30f;
constexpr int kThreads = 32;
constexpr int kMaxFeatures = 8;

// jnp.minimum: NaN if either operand is NaN.
__device__ __forceinline__ float nan_min(float a, float b) {
  return (b < a || b != b) ? b : a;
}

// sum_f w[f] * x[f], f = 0 .. F-1, from 0, each op rounded on its own.  The
// loop runs to the compile-time bound so x stays in registers; F is the same
// for every thread, so the guard never diverges.
__device__ __forceinline__ float dot(const float* __restrict__ w, const float (&x)[kMaxFeatures],
                                     int F) {
  float m = 0.0f;
#pragma unroll
  for (int f = 0; f < kMaxFeatures; ++f)
    if (f < F) m = __fadd_rn(m, __fmul_rn(__ldg(w + f), x[f]));
  return m;
}

// x[f] = src[f * stride] for f < F (the step's features of one lane).
__device__ __forceinline__ void load_features(float (&x)[kMaxFeatures], const float* src,
                                              size_t stride, int F) {
#pragma unroll
  for (int f = 0; f < kMaxFeatures; ++f) x[f] = (f < F) ? src[f * stride] : 0.0f;
}

struct AlphaArgs {
  const float* b0;     // (S, F)
  const float* b1;     // (S, F)
  const float* feat;   // (T, F, B)
  float* alphas;       // (T, S, B)
  float* final_pm;     // (S, B)
  int B, T, F;
};

template <int S>
__global__ void __launch_bounds__(kThreads) alpha_kernel(const AlphaArgs a) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= a.B) return;
  const int B = a.B, T = a.T, F = a.F;
  constexpr int H = S / 2;
  float A[S];
#pragma unroll
  for (int s = 0; s < S; ++s) A[s] = (s == 0) ? 0.0f : kUnreachable;
  float acc = 0.0f;
  float x[kMaxFeatures], xn[kMaxFeatures];
  load_features(x, a.feat + b, B, F);
  for (int t = 0; t < T; ++t) {
    if (t + 1 < T) load_features(xn, a.feat + static_cast<size_t>(t + 1) * F * B + b, B, F);
    float* out = a.alphas + static_cast<size_t>(t) * S * B + b;
#pragma unroll
    for (int s = 0; s < S; ++s) out[static_cast<size_t>(s) * B] = A[s];  // pre-update A_t
    float nw[S];
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int v = s % H;
      const float c0 = __fadd_rn(A[2 * v], dot(a.b0 + s * F, x, F));
      const float c1 = __fadd_rn(A[2 * v + 1], dot(a.b1 + s * F, x, F));
      nw[s] = nan_min(c0, c1);
    }
    float shift = nw[0];
#pragma unroll
    for (int s = 1; s < S; ++s) shift = nan_min(shift, nw[s]);
#pragma unroll
    for (int s = 0; s < S; ++s) A[s] = nan_min(__fsub_rn(nw[s], shift), kUnreachable);
    acc = __fadd_rn(acc, shift);
#pragma unroll
    for (int f = 0; f < kMaxFeatures; ++f) x[f] = xn[f];
  }
#pragma unroll
  for (int s = 0; s < S; ++s) a.final_pm[static_cast<size_t>(s) * B + b] = __fadd_rn(A[s], acc);
}

struct BetaArgs {
  const int32_t* next_state;  // (S, 2)
  const float* c0;            // (S, F)
  const float* c1;            // (S, F)
  const float* w0;            // (S, F)
  const float* w1;            // (S, F)
  const float* alphas;        // (T, S, B)
  const float* feat;          // (T, F, B)
  float* llr;                 // (T, B)
  int B, T, F, terminated;
};

template <int S>
__global__ void __launch_bounds__(kThreads) beta_llr_kernel(const BetaArgs a) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= a.B) return;
  const int B = a.B, T = a.T, F = a.F;
  constexpr int H = S / 2;
  float Bt[S];
#pragma unroll
  for (int s = 0; s < S; ++s) Bt[s] = (a.terminated && s != 0) ? kUnreachable : 0.0f;
  float x[kMaxFeatures], xn[kMaxFeatures];
  load_features(x, a.feat + static_cast<size_t>(T - 1) * F * B + b, B, F);
  for (int t = T - 1; t >= 0; --t) {
    if (t > 0) load_features(xn, a.feat + static_cast<size_t>(t - 1) * F * B + b, B, F);
    const float* al = a.alphas + static_cast<size_t>(t) * S * B + b;
    // LLR of step t from A_t and B_{t+1}
    float mn0 = 0.0f, mn1 = 0.0f;
#pragma unroll
    for (int p = 0; p < S; ++p) {
      const float ap = al[static_cast<size_t>(p) * B];
      const float lo = Bt[p >> 1], hi = Bt[H + (p >> 1)];
      // register bit of the transition under input u: the top bit of its successor
      const bool a0 = __ldg(a.next_state + 2 * p) >= H;
      const bool a1 = __ldg(a.next_state + 2 * p + 1) >= H;
      const float cost0 = __fadd_rn(__fadd_rn(ap, dot(a.w0 + p * F, x, F)), a0 ? hi : lo);
      const float cost1 = __fadd_rn(__fadd_rn(ap, dot(a.w1 + p * F, x, F)), a1 ? hi : lo);
      mn0 = (p == 0) ? cost0 : nan_min(mn0, cost0);
      mn1 = (p == 0) ? cost1 : nan_min(mn1, cost1);
    }
    a.llr[static_cast<size_t>(t) * B + b] = __fsub_rn(mn1, mn0);
    // retire B_{t+1} -> B_t over the new-register-bit branches
    float nw[S];
#pragma unroll
    for (int p = 0; p < S; ++p) {
      const float n0 = __fadd_rn(Bt[p >> 1], dot(a.c0 + p * F, x, F));
      const float n1 = __fadd_rn(Bt[H + (p >> 1)], dot(a.c1 + p * F, x, F));
      nw[p] = nan_min(n0, n1);
    }
    float shift = nw[0];
#pragma unroll
    for (int p = 1; p < S; ++p) shift = nan_min(shift, nw[p]);
#pragma unroll
    for (int p = 0; p < S; ++p) Bt[p] = nan_min(__fsub_rn(nw[p], shift), kUnreachable);
#pragma unroll
    for (int f = 0; f < kMaxFeatures; ++f) x[f] = xn[f];
  }
}

int blocks_for(int B) { return (B + kThreads - 1) / kThreads; }

template <int S>
int launch_alpha(const AlphaArgs& a, cudaStream_t st) {
  alpha_kernel<S><<<blocks_for(a.B), kThreads, 0, st>>>(a);
  return cudaGetLastError();
}

template <int S>
int launch_beta(const BetaArgs& a, cudaStream_t st) {
  beta_llr_kernel<S><<<blocks_for(a.B), kThreads, 0, st>>>(a);
  return cudaGetLastError();
}

bool bad_shape(int B, int T, int F, int S) {
  return B < 1 || T < 1 || F < 1 || F > kMaxFeatures || S < 2 || S > 64 || (S & (S - 1));
}

}  // namespace

// Plain C entry points, loaded with ctypes.  Each returns the cudaError_t of
// its launch (0 = launched).  S must be a power of two in [2, 64] and F at
// most 8.

// `bcjr_alpha_scan`: feat (T, F, B) -> alphas (T, S, B), final_pm (S, B).
extern "C" int bcjr_alpha_scan_launch(const void* b0, const void* b1, const void* feat,
                                      void* alphas, void* final_pm, int B, int T, int F,
                                      int S, void* stream) {
  if (bad_shape(B, T, F, S)) return cudaErrorInvalidValue;
  const AlphaArgs a{static_cast<const float*>(b0), static_cast<const float*>(b1),
                    static_cast<const float*>(feat), static_cast<float*>(alphas),
                    static_cast<float*>(final_pm), B, T, F};
  auto st = static_cast<cudaStream_t>(stream);
  switch (S) {
    case 2: return launch_alpha<2>(a, st);
    case 4: return launch_alpha<4>(a, st);
    case 8: return launch_alpha<8>(a, st);
    case 16: return launch_alpha<16>(a, st);
    case 32: return launch_alpha<32>(a, st);
    case 64: return launch_alpha<64>(a, st);
    default: return cudaErrorInvalidValue;
  }
}

// `bcjr_beta_llr_scan`: alphas (T, S, B), feat (T, F, B) -> llr (T, B).
extern "C" int bcjr_beta_llr_scan_launch(const void* next_state, const void* c0,
                                         const void* c1, const void* w0, const void* w1,
                                         const void* alphas, const void* feat, void* llr,
                                         int B, int T, int F, int S, int terminated,
                                         void* stream) {
  if (bad_shape(B, T, F, S)) return cudaErrorInvalidValue;
  const BetaArgs a{static_cast<const int32_t*>(next_state), static_cast<const float*>(c0),
                   static_cast<const float*>(c1),           static_cast<const float*>(w0),
                   static_cast<const float*>(w1),           static_cast<const float*>(alphas),
                   static_cast<const float*>(feat),         static_cast<float*>(llr),
                   B, T, F, terminated};
  auto st = static_cast<cudaStream_t>(stream);
  switch (S) {
    case 2: return launch_beta<2>(a, st);
    case 4: return launch_beta<4>(a, st);
    case 8: return launch_beta<8>(a, st);
    case 16: return launch_beta<16>(a, st);
    case 32: return launch_beta<32>(a, st);
    case 64: return launch_beta<64>(a, st);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" const char* bcjr_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
