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
// Two kernels; which one runs is decided from the shape and the alignment
// before the launch (`square_states`), never by retrying a launch.
//
// The square kernel (`minplus_square_kernel<S>`), for I = K = J = S a power
// of two from 2 to 128 with every matrix 16-byte aligned (the pointers and
// every batch stride a multiple of 4 elements) — what the associative scan
// multiplies.  The bound is two issued fp32 instructions a candidate (the
// rounded add and the min), so the inner loop holds nothing else but
// 128-bit shared-memory loads:
//   * Items.  An item is kProducts whole products (S <= 64; each thread owns
//     a kTR x 4 register tile of rows ty, ty + S/kTR, ..., 2 x 2 at S = 2,
//     so no thread computes padding) or one 64 x 64 quarter of a product
//     (S = 128).
//   * Persistent blocks.  The grid is as many blocks as fit on the card at
//     once (the occupancy API times the SMs); block x takes items x,
//     x + grid, ... in order.
//   * Copies ahead.  An item's A and B go into shared memory with 16-byte
//     cp.async copies, the next items' while the current one computes (a
//     ring of stages).  A rows are padded by 4 floats at S >= 8 and a warp's
//     threads own neighbouring rows, so their reads of A hit different
//     banks.
//   * Per four k: kTR 128-bit loads of A rows and 4 of B rows, then 16 kTR
//     adds and as many mins: 2.125 instructions a candidate at kTR = 4.
//   * Each thread stores its rows as 16-byte pieces (8 at S = 2).
//   * The launch choice (rows of a tile, threads a block, stages) is
//     MINPLUS_SQUARE_CHOICE below: 4, 256 and 2, the best of the choices
//     `tools/scan_measure.py square` times at the decoder's combines.
//
// The general kernel (`minplus_kernel`) takes every other shape, alignment
// or stride: one block per (batch entry, 64 x 64 output tile), 256 threads,
// each owning a 4 x 4 register tile of C.  A and B are staged in shared
// memory 16 k at a time (A transposed, so a thread reads its four rows of A
// and its four columns of B as two 16-byte loads per k); every A and B
// element is read from device memory once per output tile.  The ragged
// edges are masked inside the kernel: rows and columns past I or J are
// loaded as 0 and never stored; the k loop of the last stage stops at K.
// No padding, no extra pass.
#include <algorithm>
#include <atomic>
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

// ---------------------------------------------------------------------------
// the square kernel

// A measurement build may cut part of the square kernel's work, to time what
// is left (its outputs are then wrong): bit 0 the copies into shared memory,
// bit 1 the candidates (the stores write the init).
#ifndef MINPLUS_CUT
#define MINPLUS_CUT 0
#endif

// The square kernel's launch choice at S >= 8: rows of a thread's tile (its
// columns are 4), threads a block, stages of the copy ring.  S = 2 and 4
// take an S x S tile, 256 threads and two stages; S = 128 as many threads as
// a 64 x 64 quarter needs.  A measurement build may define another.
#ifndef MINPLUS_SQUARE_CHOICE
#define MINPLUS_SQUARE_CHOICE {4, 256, 2}
#endif
struct SquareChoice {
  int rows, threads, stages;
};
constexpr SquareChoice kSquareChoice = MINPLUS_SQUARE_CHOICE;

template <int S>
struct Square {
  static_assert(S >= 2 && S <= 128 && (S & (S - 1)) == 0, "a power of two from 2 to 128");
  static constexpr int kTC = S < 4 ? S : 4;                         // a thread's columns
  static constexpr int kSide = S < 64 ? S : 64;                     // an item's rows, columns
  static constexpr int kTR = S < 8 ? kTC : std::min(kSquareChoice.rows, kSide);  // rows
  static constexpr int kPerProduct = (kSide / kTR) * (kSide / kTC);  // threads a product
  static constexpr int kThreads = S < 8 ? 256 : S < 128 ? kSquareChoice.threads : kPerProduct;
  static constexpr int kProducts = kThreads / kPerProduct;          // products an item
  static constexpr int kQuarters = (S / kSide) * (S / kSide);       // items a product
  static constexpr int kRowA = S + (S >= 8 ? 4 : 0);  // floats a row of A in a stage
  static constexpr int kA = kProducts * kSide * kRowA;              // floats of A in a stage
  static constexpr int kStage = kA + kProducts * S * kSide;         // ... and of B after it
  static constexpr int kStages = S < 8 ? 2 : kSquareChoice.stages;
  static constexpr size_t kSmem = sizeof(float) * kStages * kStage;
  static_assert(kProducts >= 1 && kPerProduct * kProducts == kThreads && kThreads <= 1024 &&
                    (kQuarters == 1 || kProducts == 1) && kStages >= 2,
                "whole products (or one quarter) an item, no idle thread");
  static_assert(kSmem <= 227 * 1024, "the stages fit one block's shared memory");
  // blocks of this S that fit one SM's 228 KB (1 KB of it reserved a block),
  // at most 3
  static constexpr int kMinBlocks = std::min(3, static_cast<int>(228 * 1024 / (kSmem + 1024)));
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// every copy group this thread committed but the newest N has landed
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// N consecutive floats of shared memory (N = 4: one 128-bit load; N = 2: 64)
template <int N>
__device__ __forceinline__ void load_row(float (&v)[N], const float* src) {
  if constexpr (N == 4) {
    const float4 x = *reinterpret_cast<const float4*>(src);
    v[0] = x.x, v[1] = x.y, v[2] = x.z, v[3] = x.w;
  } else {
    const float2 x = *reinterpret_cast<const float2*>(src);
    v[0] = x.x, v[1] = x.y;
  }
}

template <int N>
__device__ __forceinline__ void store_row(float* dst, const float (&v)[N]) {
  if constexpr (N == 4)
    *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
  else
    *reinterpret_cast<float2*>(dst) = make_float2(v[0], v[1]);
}

// Item `it`'s A rows and B columns into `stage` (asynchronous; committed by
// the caller).  A product past N is not copied (its outputs are not stored).
template <int S>
__device__ __forceinline__ void copy_item(const Args& g, int N, int it, float* stage) {
  using Q = Square<S>;
  if constexpr (MINPLUS_CUT & 1) return;
  float* sA = stage;
  float* sB = stage + Q::kA;
  if constexpr (Q::kQuarters == 1) {
    // kProducts whole matrices, each S*S contiguous floats: chunk c of
    // product p is floats 4c .. 4c+3, row 4c / S
    constexpr int kChunks = S * S / 4;
    for (int e = threadIdx.x; e < Q::kProducts * kChunks; e += Q::kThreads) {
      const int p = e / kChunks, c = e % kChunks;
      const int n = it * Q::kProducts + p;
      if (n >= N) break;  // e only grows: so does n
      const int n0 = n / g.N1, n1 = n % g.N1;
      const float* A = g.a + n0 * g.sa0 + n1 * g.sa1;
      const float* Bm = g.b + n0 * g.sb0 + n1 * g.sb1;
      cp_async16(sA + (p * S + 4 * c / S) * Q::kRowA + 4 * c % S, A + 4 * c);
      cp_async16(sB + p * S * S + 4 * c, Bm + 4 * c);
    }
  } else {
    // a quarter (i0, j0) of one product: A rows i0 .. i0+63 (all S columns),
    // B columns j0 .. j0+63 of all S rows
    const int n = it / Q::kQuarters, quarter = it % Q::kQuarters;
    const int i0 = (quarter / 2) * Q::kSide, j0 = (quarter % 2) * Q::kSide;
    const int n0 = n / g.N1, n1 = n % g.N1;
    const float* A = g.a + n0 * g.sa0 + n1 * g.sa1 + static_cast<int64_t>(i0) * S;
    const float* Bm = g.b + n0 * g.sb0 + n1 * g.sb1 + j0;
    constexpr int kRowChunksA = S / 4, kRowChunksB = Q::kSide / 4;
    for (int e = threadIdx.x; e < Q::kSide * kRowChunksA; e += Q::kThreads) {
      const int r = e / kRowChunksA, c = e % kRowChunksA;
      cp_async16(sA + r * Q::kRowA + 4 * c, A + r * S + 4 * c);
    }
    for (int e = threadIdx.x; e < S * kRowChunksB; e += Q::kThreads) {
      const int k = e / kRowChunksB, c = e % kRowChunksB;
      cp_async16(sB + k * Q::kSide + 4 * c, Bm + k * S + 4 * c);
    }
  }
}

template <int S>
__global__ void __launch_bounds__(Square<S>::kThreads, Square<S>::kMinBlocks)
minplus_square_kernel(const Args g, int N, int n_items) {
  using Q = Square<S>;
  constexpr int kTR = Q::kTR, kTC = Q::kTC, kRowStep = Q::kSide / kTR;
  extern __shared__ __align__(16) float smem[];  // [kStages][kStage]
  // this thread's tile: product p of the item, rows ty + kRowStep r (so the
  // threads of a warp read neighbouring rows of A: different banks),
  // columns kTC tx ..
  const int p = threadIdx.x / Q::kPerProduct, l = threadIdx.x % Q::kPerProduct;
  const int tx = l % (Q::kSide / kTC), ty = l / (Q::kSide / kTC);
  const int a_off = (p * Q::kSide + ty) * Q::kRowA;
  const int b_off = Q::kA + p * S * Q::kSide + kTC * tx;

  const int grid = gridDim.x;
  int it = blockIdx.x, st = 0;
#pragma unroll
  for (int s = 0; s + 1 < Q::kStages; ++s) {
    if (static_cast<long long>(it) + s * grid < n_items)
      copy_item<S>(g, N, it + s * grid, smem + s * Q::kStage);
    cp_async_commit();
  }
  for (; it < n_items; it += grid, st = (st + 1) % Q::kStages) {
    // the item kStages-1 rounds ahead, into the stage the last round read
    const long long ahead = it + (Q::kStages - 1LL) * grid;
    if (ahead < n_items)
      copy_item<S>(g, N, static_cast<int>(ahead),
                   smem + ((st + Q::kStages - 1) % Q::kStages) * Q::kStage);
    cp_async_commit();
    cp_async_wait<Q::kStages - 1>();  // item it's group has landed (this thread's copies)
    __syncthreads();                  // ... and every thread's
    const float* sa = smem + st * Q::kStage + a_off;
    const float* sb = smem + st * Q::kStage + b_off;
    float acc[kTR][kTC];
#pragma unroll
    for (int r = 0; r < kTR; ++r)
#pragma unroll
      for (int q = 0; q < kTC; ++q) acc[r][q] = g.init;
#pragma unroll 4
    for (int k = 0; k < (MINPLUS_CUT & 2 ? 0 : S); k += kTC) {
      float a[kTR][kTC], b[kTC][kTC];  // a[r][kk] = A[row r, k + kk], b[kk][q] = B[k + kk, col q]
#pragma unroll
      for (int r = 0; r < kTR; ++r) load_row<kTC>(a[r], sa + r * kRowStep * Q::kRowA + k);
#pragma unroll
      for (int kk = 0; kk < kTC; ++kk) load_row<kTC>(b[kk], sb + (k + kk) * Q::kSide);
#pragma unroll
      for (int kk = 0; kk < kTC; ++kk)
#pragma unroll
        for (int r = 0; r < kTR; ++r)
#pragma unroll
          for (int q = 0; q < kTC; ++q)
            acc[r][q] = min_nan(acc[r][q], __fadd_rn(a[r][kk], b[kk][q]));
    }
    // the tile's rows into C (contiguous (N, S, S))
    int64_t n, row0, col0;
    if constexpr (Q::kQuarters == 1) {
      n = static_cast<int64_t>(it) * Q::kProducts + p, row0 = ty, col0 = kTC * tx;
    } else {
      const int quarter = it % Q::kQuarters;
      n = it / Q::kQuarters;
      row0 = (quarter / 2) * Q::kSide + ty, col0 = (quarter % 2) * Q::kSide + kTC * tx;
    }
    if (n < N) {
      float* C = g.c + (n * S + row0) * S + col0;
#pragma unroll
      for (int r = 0; r < kTR; ++r) store_row<kTC>(C + r * kRowStep * S, acc[r]);
    }
    __syncthreads();  // every thread is done with the stage before it is refilled
  }
}

// Blocks of the square kernel at S that fit an SM of device `dev`, 0 when it
// cannot launch.  The first call on each device (up to kMaxDevices; past
// them every call) raises the kernel's shared-memory limit to what its
// stages take and its carveout to as much as they can use: both are
// attributes of the device's context.
constexpr int kMaxDevices = 64;
template <int S>
int square_blocks_per_sm(int dev) {
  using Q = Square<S>;
  static std::atomic<int> known[kMaxDevices];  // 0: not yet set on the device
  const bool cached = dev >= 0 && dev < kMaxDevices;
  if (cached) {
    const int n = known[dev].load(std::memory_order_relaxed);
    if (n > 0) return n;
  }
  if (cudaFuncSetAttribute(minplus_square_kernel<S>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(Q::kSmem)) != cudaSuccess ||
      cudaFuncSetAttribute(minplus_square_kernel<S>,
                           cudaFuncAttributePreferredSharedMemoryCarveout,
                           cudaSharedmemCarveoutMaxShared) != cudaSuccess)
    return 0;
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, minplus_square_kernel<S>, Q::kThreads,
                                                    Q::kSmem) != cudaSuccess)
    return 0;
  if (cached && n > 0) known[dev].store(n, std::memory_order_relaxed);
  return n;
}

template <int S>
int square_launch(const Args& g, int N, cudaStream_t stream) {
  using Q = Square<S>;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int per_sm = square_blocks_per_sm<S>(dev);
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long items =
      Q::kQuarters == 1 ? (N + Q::kProducts - 1LL) / Q::kProducts : Q::kQuarters * 1LL * N;
  if (items > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int grid = static_cast<int>(std::min<long long>(items, 1LL * per_sm * sms));
  minplus_square_kernel<S><<<grid, Q::kThreads, Q::kSmem, stream>>>(g, N,
                                                                   static_cast<int>(items));
  return cudaGetLastError();
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

// S when the square kernel takes this product, else 0 (the general kernel)
int square_states(const void* a, const void* b, const void* c, int N0, int N1, long long sa0,
                  long long sa1, long long sb0, long long sb1, int I, int K, int J) {
  if (I != K || K != J || I < 2 || I > 128 || (I & (I - 1))) return 0;
  if (!aligned16(a) || !aligned16(b) || !aligned16(c)) return 0;
  // a batch level of one entry never moves the pointer
  for (const long long s : {N0 > 1 ? sa0 : 0, N1 > 1 ? sa1 : 0, N0 > 1 ? sb0 : 0,
                            N1 > 1 ? sb1 : 0})
    if (s % 4) return 0;
  return I;
}

}  // namespace

// Which kernel `minplus_matmul_launch` runs on these operands: S (the square
// kernel at I = K = J = S) or 0 (the general kernel).
extern "C" int minplus_matmul_variant(const void* a, const void* b, void* c, int N0, int N1,
                                      long long sa0, long long sa1, long long sb0,
                                      long long sb1, int I, int K, int J) {
  return square_states(a, b, c, N0, N1, sa0, sa1, sb0, sb1, I, K, J);
}

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
  const auto st = static_cast<cudaStream_t>(stream);
  switch (square_states(a, b, c, N0, N1, sa0, sa1, sb0, sb1, I, K, J)) {
    case 2: return square_launch<2>(g, static_cast<int>(n), st);
    case 4: return square_launch<4>(g, static_cast<int>(n), st);
    case 8: return square_launch<8>(g, static_cast<int>(n), st);
    case 16: return square_launch<16>(g, static_cast<int>(n), st);
    case 32: return square_launch<32>(g, static_cast<int>(n), st);
    case 64: return square_launch<64>(g, static_cast<int>(n), st);
    case 128: return square_launch<128>(g, static_cast<int>(n), st);
    default: break;
  }
  minplus_kernel<<<dim3(static_cast<unsigned>(n), ti, tj), kThreads, 0,
                   st>>>(g);
  return cudaGetLastError();
}

extern "C" const char* minplus_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
