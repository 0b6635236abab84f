// Batched (min,+) matrix product for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `minplus_matmul` (`_minplus_kernel`) of
// src/repro/kernels/minplus.py.
//
// What it computes, for every batch entry n and output (i, j):
//   C[n, i, j] = min(init, min_k A[n, i, k] + B[n, k, j])
// with init = 1e30 (the Pallas function: its accumulator starts at
// NEG_UNREACHABLE) or +inf (the unclamped jnp product that the block-parallel
// decoder's associative scan combines chunk transfer matrices with).  Each
// candidate is ONE rounded add and the reduction is an exact min, so the
// result is bit-exact in any reduction order.  Every min propagates NaN as
// jnp.min / jnp.minimum do (fminf would drop it): PTX's `min.NaN.f32`
// (sm_80 and later) returns NaN when either operand is NaN.
//
// Batch layout: the batch is two levels (N0, N1) with an element stride per
// level and per operand, so the strided slices an associative scan takes
// along the chunk axis (mats[:, 0:-1:2], mats[:, 1::2], a view of
// (B, nc, S, S)) go to the kernel as they are — no copy.  Within a matrix
// the rows are contiguous (row stride K for A, J for B).  C is contiguous
// (N0, N1, I, J).
//
// What bounds it on this card: at the decoder's widest launch (K=7, S=64:
// thousands of 64 x 64 by 64 x 64 products) each product moves
// 4 (IK + KJ + IJ) = 48 KiB and does 2 IJK = 524288 operations, about 11 a
// byte, below the card's 20 (67 TFLOP/s over 3.35 TB/s): by the published
// peaks the bytes bound it.  But the add and the min are two fp32
// instructions, not one FMA, so at 33.5 T instructions/s the operations take
// about as long as the bytes — both limits are close.
//
// How the design answers that: one block per (batch entry, 64 x 64 output
// tile), 256 threads, each owning a 4 x 4 register tile of C.  A and B are
// staged in shared memory 16 k at a time (A transposed, so a thread reads
// its four rows of A and its four columns of B as two 16-byte loads per k);
// every A and B element is read from device memory once per output tile.
// The ragged edges are masked inside the kernel: rows and columns past I or
// J are loaded as 0 and never stored; the k loop of the last stage stops at
// K.  No padding, no extra pass.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 64;      // output rows and columns of one block
constexpr int kDepth = 16;     // k of one shared-memory stage
constexpr int kThreads = 256;  // 16 x 16 threads, 4 x 4 outputs each
constexpr int kPad = 4;        // keeps rows of the transposed A tile 16-byte aligned

// jnp.minimum: NaN if either operand is NaN.
__device__ __forceinline__ float min_nan(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

struct Args {
  const float* a;  // (N0, N1, I, K), batch strides sa0, sa1
  const float* b;  // (N0, N1, K, J), batch strides sb0, sb1
  float* c;        // (N0, N1, I, J) contiguous
  int64_t sa0, sa1, sb0, sb1;
  int N1, I, K, J;
  float init;
};

__global__ void __launch_bounds__(kThreads) minplus_kernel(const Args g) {
  __shared__ __align__(16) float As[kDepth][kTile + kPad];  // As[k][i] = A[i0 + i, k0 + k]
  __shared__ __align__(16) float Bs[kDepth][kTile];         // Bs[k][j] = B[k0 + k, j0 + j]
  const int n = blockIdx.x;
  const int n0 = n / g.N1, n1 = n % g.N1;
  const float* __restrict__ A = g.a + n0 * g.sa0 + n1 * g.sa1;
  const float* __restrict__ Bm = g.b + n0 * g.sb0 + n1 * g.sb1;
  const int i0 = blockIdx.y * kTile, j0 = blockIdx.z * kTile;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;  // columns 4tx.., rows 4ty..

  float acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[r][q] = g.init;

  for (int k0 = 0; k0 < g.K; k0 += kDepth) {
    // A tile: 16 consecutive k of one row per 16 threads (coalesced reads)
#pragma unroll
    for (int p = 0; p < kTile * kDepth / kThreads; ++p) {
      const int e = tid + p * kThreads;
      const int k = e % kDepth, i = e / kDepth;
      const int gi = i0 + i, gk = k0 + k;
      As[k][i] = (gi < g.I && gk < g.K) ? __ldg(A + static_cast<int64_t>(gi) * g.K + gk) : 0.f;
    }
    // B tile: 64 consecutive j of one row per 64 threads
#pragma unroll
    for (int p = 0; p < kTile * kDepth / kThreads; ++p) {
      const int e = tid + p * kThreads;
      const int j = e % kTile, k = e / kTile;
      const int gj = j0 + j, gk = k0 + k;
      Bs[k][j] = (gk < g.K && gj < g.J) ? __ldg(Bm + static_cast<int64_t>(gk) * g.J + gj) : 0.f;
    }
    __syncthreads();
    const int kmax = min(kDepth, g.K - k0);  // the same for every thread
    auto stage = [&](int k) {
      const float4 av = *reinterpret_cast<const float4*>(&As[k][4 * ty]);
      const float4 bv = *reinterpret_cast<const float4*>(&Bs[k][4 * tx]);
      const float ar[4] = {av.x, av.y, av.z, av.w};
      const float bc[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[r][q] = min_nan(acc[r][q], __fadd_rn(ar[r], bc[q]));
    };
    if (kmax == kDepth) {
#pragma unroll
      for (int k = 0; k < kDepth; ++k) stage(k);
    } else {
      for (int k = 0; k < kmax; ++k) stage(k);
    }
    __syncthreads();
  }

  float* C = g.c + static_cast<int64_t>(n) * g.I * g.J;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int gi = i0 + 4 * ty + r;
    if (gi >= g.I) continue;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int gj = j0 + 4 * tx + q;
      if (gj < g.J) C[static_cast<int64_t>(gi) * g.J + gj] = acc[r][q];
    }
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes.  Strides are in elements.  Returns
// the cudaError_t of its launch (0 = launched); an empty batch is the
// caller's to skip (a grid of 0 blocks is an invalid launch).
extern "C" int minplus_matmul_launch(const void* a, const void* b, void* c, int N0, int N1,
                                     long long sa0, long long sa1, long long sb0,
                                     long long sb1, int I, int K, int J, float init,
                                     void* stream) {
  if (N0 < 1 || N1 < 1 || I < 1 || K < 1 || J < 1) return cudaErrorInvalidValue;
  const long long n = static_cast<long long>(N0) * N1;
  const int ti = (I + kTile - 1) / kTile, tj = (J + kTile - 1) / kTile;
  if (n > 0x7fffffffLL || ti > 65535 || tj > 65535) return cudaErrorInvalidValue;
  Args g{static_cast<const float*>(a), static_cast<const float*>(b), static_cast<float*>(c),
         sa0, sa1, sb0, sb1, N1, I, K, J, init};
  minplus_kernel<<<dim3(static_cast<unsigned>(n), ti, tj), kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(g);
  return cudaGetLastError();
}

extern "C" const char* minplus_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
