// Packed-survivor tracebacks for Hopper (sm_90a).
//
// Replaces two Pallas TPU kernels of src/repro/kernels/survivors.py:
//   traceback_packed_launch         `traceback_packed` (`_make_traceback_kernel`),
//                                   the walk of the short-block decode path
//   traceback_packed_window_launch  `traceback_packed_window`
//                                   (`_make_traceback_window_kernel`), the tiled
//                                   decode's walk of every tile from every
//                                   candidate exit state
//
// What they compute, for every stream (lane) b, walking t = T-1 down to 0
// from s = final_state[b]:
//   bits[b, t] = s >> (K-2)                       (the input bit that made s)
//   s          = 2 * (s & (S/2 - 1)) + bit t of word (t/32, b, s)
// The full walk reads no tail bit t >= T of a partial last word.  The
// windowed walk covers all 32W steps of the words but takes a step only
// where lo[b] <= t < hi[b]: elsewhere the bit is 0 and s is left as it is.
// It also writes the state it ends on, the lane's state at step lo[b] — for
// a time tile, its entry state on the seam with the tile before.
//
// What bounds them on this card.  Every step reads one 32-bit word whose
// address depends on the state the previous step produced, so one lane's
// steps are a chain of dependent reads; the bytes the function must move
// are one word per step taken and one output int per step.  Read one
// 4-byte word at a time from device memory, every step costs a 32-byte
// sector (a warp's lanes read rows 4S bytes apart), and one 4-byte store a
// lane a step fills a sector of its own (rows 128W bytes apart).
//
// `traceback_packed` (one thread a lane, __ldg of each step's word, one
// store a step into the lane's row) is the design above; its redesign is
// later work.
//
// `traceback_packed_window` is the staged walk (S <= 128): a warp walks 32
// lanes, one thread each.
//   * Slabs, not words.  For each word w, from W-1 down, the warp copies its
//     lanes' slabs (w, lane, 0..S-1) — for 32 consecutive lanes one
//     contiguous run of 128S bytes — into shared memory with cp.async, a ring
//     of D stages ahead of the walk (the launch table below: about 17 KB a
//     warp, so the long stream's 17 words at S = 4 are all in flight before
//     the first step).  A slab no lane of the warp walks in word w (its
//     window misses the word) is not copied.  The 32 steps of the word then
//     read shared memory: the chain's dependent load is a shared-memory read.
//     State s of lane l sits at s*33 + l, so when the walks of a tile's exit
//     states have merged (every lane in the same state) the warp's reads
//     fall in 32 different banks.
//   * Bits, not ints.  A lane collects its 32 output bits of a word in one
//     register; the warp then writes the 32 rows' 128-byte pieces, four rows
//     a store instruction of 16 bytes a thread (the bits moved by shuffles),
//     so every store fills whole sectors.  A word outside a lane's window is
//     written as zeros the same way.
//   * Device-memory bytes: the slabs of the words the windows touch once,
//     the output once: at the pinned P=8 NASA walk (524,288 lanes, 5 words,
//     S = 64) about 4 x 134 MB of slabs (the first word lies before every
//     lane's window) and 335 MB of bits.
// Past S = 128 a warp's two stages take more than 64 KB of shared memory, so
// S >= 256 keeps the direct walk (`traceback_window_kernel`: one thread a
// lane, __ldg of each step's word, one store a step).  Which of the two runs
// is fixed per S when the library is built, by the table; nothing chooses at
// run time.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
traceback_packed_kernel(const int32_t* __restrict__ packed,       // (W, B, S)
                        const int32_t* __restrict__ final_state,  // (B,)
                        int32_t* __restrict__ bits,               // (B, T)
                        int B, int T, int S, int K) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int vmask = (S >> 1) - 1;  // 0 when S == 2 (K = 2)
  int s = final_state[b] & (S - 1);  // keeps a bad start state inside the row
  int32_t* out = bits + static_cast<size_t>(b) * T;
  for (int t = T - 1; t >= 0; --t) {
    const uint32_t word = static_cast<uint32_t>(
        __ldg(packed + (static_cast<size_t>(t >> 5) * B + b) * S + s));
    const int bit = static_cast<int>((word >> (t & 31)) & 1u);
    out[t] = s >> (K - 2);
    s = 2 * (s & vmask) + bit;
  }
}

__global__ void __launch_bounds__(kThreads)
traceback_window_kernel(const int32_t* __restrict__ packed,       // (W, B, S)
                        const int32_t* __restrict__ final_state,  // (B,)
                        const int32_t* __restrict__ lo,           // (B,)
                        const int32_t* __restrict__ hi,           // (B,)
                        int32_t* __restrict__ bits,               // (B, 32W)
                        int32_t* __restrict__ entry,              // (B,)
                        int B, int W, int S, int K) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int vmask = (S >> 1) - 1;
  const int steps = W * 32;
  const int l = lo[b], h = hi[b];
  int s = final_state[b] & (S - 1);
  int32_t* out = bits + static_cast<size_t>(b) * steps;
  for (int t = steps - 1; t >= 0; --t) {
    if (t >= l && t < h) {
      const uint32_t word = static_cast<uint32_t>(
          __ldg(packed + (static_cast<size_t>(t >> 5) * B + b) * S + s));
      out[t] = s >> (K - 2);
      s = 2 * (s & vmask) + static_cast<int>((word >> (t & 31)) & 1u);
    } else {
      out[t] = 0;
    }
  }
  entry[b] = s;
}

// A measurement build may also cut part of the staged walk's work, to time
// what is left (its outputs are then wrong): bit 0 the slab copies, bit 1
// the stores of the bits.
#ifndef TRACEBACK_CUT
#define TRACEBACK_CUT 0
#endif

constexpr unsigned kFull = 0xffffffffu;
constexpr int kStagedMaxS = 128;
// Launch table of the staged walk, one row per S = 2, 4, ..., 128: D, the
// stages of a warp's ring (D * 33 * S * 4 bytes of shared memory, about 17 KB
// and at least two stages).
constexpr int kStages[] = {32, 32, 16, 8, 4, 2, 2};
__host__ __device__ constexpr int log2i(int n) { return n > 1 ? 1 + log2i(n / 2) : 0; }
static_assert(sizeof(kStages) / sizeof(int) == log2i(kStagedMaxS),
              "one row of stages for every S of the staged walk");

__device__ __forceinline__ void cp_async4(int32_t* dst, const int32_t* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
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

// The staged windowed walk: a warp (one block) walks lanes b0 .. b0+31, one
// thread each, word by word from W-1 down, each word's slabs staged in
// shared memory D words ahead (D = kStages' row of S).
template <int S, int D>
__global__ void __launch_bounds__(32)
window_walk_kernel(const int32_t* __restrict__ packed,       // (W, B, S)
                   const int32_t* __restrict__ final_state,  // (B,)
                   const int32_t* __restrict__ lo,           // (B,)
                   const int32_t* __restrict__ hi,           // (B,)
                   int32_t* __restrict__ bits,               // (B, 32W)
                   int32_t* __restrict__ entry,              // (B,)
                   int B, int W) {
  constexpr int kStage = 33 * S;        // a stage: state s of lane l at s*33 + l
  constexpr int kTop = log2i(S) - 1;    // K - 2
  constexpr int kMask = S / 2 - 1;      // 0 when S == 2
  extern __shared__ int32_t ring[];     // [D][33 S]
  const int l = threadIdx.x;
  const int b0 = blockIdx.x * 32, b = b0 + l;
  const bool live = b < B;
  const int steps = 32 * W;
  const int wlo = live ? lo[b] : 0, whi = live ? hi[b] : 0;  // a lane past B walks nothing
  int s = live ? (final_state[b] & (S - 1)) : 0;

  // word w's slabs of the lanes whose window meets it, into stage `st`
  // (asynchronous; committed by the caller)
  auto copy = [&](int w, int st) {
    const bool walks = wlo < whi && wlo < 32 * w + 32 && whi > 32 * w;
    const unsigned need = __ballot_sync(kFull, walks);
    if constexpr (TRACEBACK_CUT & 1) return;
    int32_t* dst = ring + st * kStage;
    const int32_t* src = packed + (static_cast<size_t>(w) * B + b0) * S;
#pragma unroll 4
    for (int e = l; e < 32 * S; e += 32) {
      const int ln = e / S, x = e % S;  // lane ln's state x
      if ((need >> ln) & 1u) cp_async4(dst + x * 33 + ln, src + e);
    }
  };

#pragma unroll 1
  for (int i = 0; i < D; ++i) {
    if (i < W) copy(W - 1 - i, i);
    cp_async_commit();
  }
  for (int i = 0; i < W; ++i) {
    const int w = W - 1 - i, st = i % D;
    cp_async_wait<D - 1>();  // word w's group has landed (this thread's copies)
    __syncwarp();            // ... and every thread's
    const int32_t* slab = ring + st * kStage + l;
    const int tb = max(wlo, 32 * w), te = min(whi, 32 * w + 32);
    uint32_t m = 0;  // bit p: the lane's output at step 32w + p
    for (int t = te - 1; t >= tb; --t) {
      const uint32_t word = static_cast<uint32_t>(slab[s * 33]);
      m |= static_cast<uint32_t>(s >> kTop) << (t & 31);
      s = 2 * (s & kMask) + static_cast<int>((word >> (t & 31)) & 1u);
    }
    __syncwarp();  // every lane is done with the stage
    if (i + D < W) copy(w - D, st);
    cp_async_commit();
    // the 32 rows' ints of word w: rows 4j .. 4j+3, 8 threads a row, 16 bytes
    // a thread
    if constexpr (!(TRACEBACK_CUT & 2)) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int ln = 4 * j + (l >> 3), q = l & 7;
        const uint32_t mk = __shfl_sync(kFull, m, ln) >> (4 * q);
        if (b0 + ln < B)
          *reinterpret_cast<int4*>(bits + static_cast<size_t>(b0 + ln) * steps + 32 * w +
                                   4 * q) =
              make_int4(static_cast<int>(mk & 1u), static_cast<int>((mk >> 1) & 1u),
                        static_cast<int>((mk >> 2) & 1u), static_cast<int>((mk >> 3) & 1u));
      }
    }
  }
  if (live) entry[b] = s;
}

template <int S>
int window_walk_launch(const int32_t* packed, const int32_t* final_state, const int32_t* lo,
                       const int32_t* hi, int32_t* bits, int32_t* entry, int B, int W,
                       cudaStream_t stream) {
  constexpr int D = kStages[log2i(S) - 1];
  constexpr size_t smem = sizeof(int32_t) * D * 33 * S;
  static_assert(D >= 2 && smem <= 48 * 1024,
                "two stages or more, within the default shared-memory limit");
  static const cudaError_t carve = cudaFuncSetAttribute(
      window_walk_kernel<S, D>, cudaFuncAttributePreferredSharedMemoryCarveout,
      cudaSharedmemCarveoutMaxShared);  // once: as many warps an SM as the rings allow
  if (carve != cudaSuccess) return carve;
  window_walk_kernel<S, D><<<(B + 31) / 32, 32, smem, stream>>>(packed, final_state, lo, hi,
                                                              bits, entry, B, W);
  return cudaGetLastError();
}

bool bad_shape(int B, int W, int S, int K) {
  return B < 1 || W < 1 || S < 2 || (S & (S - 1)) || S != (1 << (K - 1));
}

}  // namespace

// Plain C entry points, loaded with ctypes.  Each returns the cudaError_t of
// its launch (0 = launched).
extern "C" int traceback_packed_launch(const void* packed, const void* final_state,
                                       void* bits, int B, int T, int S, int K,
                                       void* stream) {
  if (T < 1 || bad_shape(B, 1, S, K)) return cudaErrorInvalidValue;
  const int blocks = (B + kThreads - 1) / kThreads;
  traceback_packed_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(packed), static_cast<const int32_t*>(final_state),
      static_cast<int32_t*>(bits), B, T, S, K);
  return cudaGetLastError();
}

extern "C" int traceback_packed_window_launch(const void* packed, const void* final_state,
                                              const void* lo, const void* hi, void* bits,
                                              void* entry, int B, int W, int S, int K,
                                              void* stream) {
  if (bad_shape(B, W, S, K)) return cudaErrorInvalidValue;
  auto p = static_cast<const int32_t*>(packed);
  auto f = static_cast<const int32_t*>(final_state);
  auto l = static_cast<const int32_t*>(lo);
  auto h = static_cast<const int32_t*>(hi);
  auto o = static_cast<int32_t*>(bits);
  auto e = static_cast<int32_t*>(entry);
  auto st = static_cast<cudaStream_t>(stream);
  switch (S) {  // the staged walk up to kStagedMaxS, the direct walk past it
    case 2: return window_walk_launch<2>(p, f, l, h, o, e, B, W, st);
    case 4: return window_walk_launch<4>(p, f, l, h, o, e, B, W, st);
    case 8: return window_walk_launch<8>(p, f, l, h, o, e, B, W, st);
    case 16: return window_walk_launch<16>(p, f, l, h, o, e, B, W, st);
    case 32: return window_walk_launch<32>(p, f, l, h, o, e, B, W, st);
    case 64: return window_walk_launch<64>(p, f, l, h, o, e, B, W, st);
    case 128: return window_walk_launch<128>(p, f, l, h, o, e, B, W, st);
    default: break;
  }
  const int blocks = (B + kThreads - 1) / kThreads;
  traceback_window_kernel<<<blocks, kThreads, 0, st>>>(p, f, l, h, o, e, B, W, S, K);
  return cudaGetLastError();
}

extern "C" const char* survivors_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
