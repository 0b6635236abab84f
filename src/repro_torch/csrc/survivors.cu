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
// Both run the staged walk (S <= 128): a warp walks 32 lanes, one thread
// each.  `traceback_packed` is its full-row form (a compile-time flag: the
// window [0, T), no entry states; rows T ints long), `traceback_packed_window`
// its windowed form.
//   * Slabs, not words.  For each word w, from W-1 down, the warp copies its
//     lanes' slabs (w, lane, 0..S-1) — for 32 consecutive lanes one
//     contiguous run of 128S bytes — into shared memory with cp.async, a ring
//     of D stages ahead of the walk (the launch table below: about 17 KB a
//     warp, so the long stream's 17 words at S = 4 are all in flight before
//     the first step).  A slab no lane of the warp walks in word w (its
//     window misses the word) is not copied.  The 32 steps of the word then
//     read shared memory: the chain's dependent load is a shared-memory read.
//     In the windowed walk state s of lane l sits at s*33 + l, so when the
//     walks of a tile's exit states have merged (every lane in the same
//     state) the warp's reads fall in 32 different banks; the copies are 4
//     bytes each.  The full walk's lanes are separate streams, whose states
//     rarely meet, so it keeps lane l's slab whole in row l (S + 4 ints, S =
//     2: 4) and copies it 16 bytes at a time (8 at S = 2): a quarter of the
//     copy instructions, which with two warps an SM (8192 lanes) lie on the
//     walk's critical path.  Its words must then start 16-byte aligned (8 at
//     S = 2); words that do not (a view one int into a buffer) take the
//     direct walk.
//   * Bits, not ints.  A lane collects its 32 output bits of a word in one
//     register; the warp then writes the 32 rows' 128-byte pieces, four rows
//     a store instruction of 16 bytes a thread (the bits moved by shuffles),
//     so every store fills whole sectors.  A word outside a lane's window is
//     written as zeros the same way.  The full walk's rows are T ints long,
//     so a row starts only as aligned as 4T bytes: it stores V ints a thread
//     (V = 2 where T is even, else 1; 32/V rows a store instruction), and no
//     step t >= T of a partial last word is walked or written.
//   * Device-memory bytes: the slabs of the words the windows touch once,
//     the output once: at the pinned P=8 NASA walk (524,288 lanes, 5 words,
//     S = 64) about 4 x 134 MB of slabs (the first word lies before every
//     lane's window) and 335 MB of bits.
//   * At the short-block path's 8192 lanes x 1006 steps (S = 64) the full
//     walk copies all 32 words' slabs (67 MB) and writes 33 MB of bits;
//     one lane's 1006 dependent shared-memory steps are the other floor.
// Past S = 128 a warp's two stages take more than 64 KB of shared memory, so
// S >= 256 keeps the direct walks (`traceback_packed_kernel`,
// `traceback_window_kernel`: one thread a lane, __ldg of each step's word,
// one store a step).  Which of the two runs is fixed per S when the library
// is built, by the tables; nothing else chooses at run time.
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
// the stores of the bits (the full walk then keeps one store a lane that
// never happens, so the walk itself stays).
#ifndef TRACEBACK_CUT
#define TRACEBACK_CUT 0
#endif

constexpr unsigned kFull = 0xffffffffu;
constexpr int kStagedMaxS = 128;
// Launch table of the staged walk, one row per S = 2, 4, ..., 128: D, the
// stages of a warp's ring (D * 33 * S * 4 bytes of shared memory, about 17 KB
// and at least two stages).
constexpr int kStages[] = {32, 32, 16, 8, 4, 2, 2};
// ... and of the full walk (D * 32 * (S + 4) * 4 bytes, 32 to 48 KB; S = 2:
// rows of 4 ints)
constexpr int kFullStages[] = {32, 32, 32, 16, 8, 4, 2};
__host__ __device__ constexpr int log2i(int n) { return n > 1 ? 1 + log2i(n / 2) : 0; }
static_assert(sizeof(kStages) / sizeof(int) == log2i(kStagedMaxS) &&
                  sizeof(kFullStages) / sizeof(int) == log2i(kStagedMaxS),
              "one row of stages for every S of the staged walk");
// the full walk's ints a copy, and its stage's row of a lane
template <int S>
constexpr int kPiece = S < 4 ? S : 4;
template <int S>
constexpr int kRow = S + kPiece<S>;
// ints of a stage of the ring
template <int S, bool FULL>
constexpr int kStageInts = FULL ? 32 * kRow<S> : 33 * S;

__device__ __forceinline__ void cp_async4(int32_t* dst, const int32_t* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

// N ints (N = 2 or 4: 8 or 16 bytes, aligned to as many)
template <int N>
__device__ __forceinline__ void cp_async_ints(int32_t* dst, const int32_t* src) {
  const auto d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  if constexpr (N == 4)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// every copy group this thread committed but the newest N has landed
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The staged walk: a warp (one block) walks lanes b0 .. b0+31, one thread
// each, word by word from W-1 down, each word's slabs staged in shared memory
// D words ahead.  FULL: #2's walk of every step t < T (`n` is T; no lo, hi or
// entry; rows of T ints, stored V ints a thread; D from kFullStages; lane l's
// slab in row l of the stage, copied 16 bytes at a time).  Otherwise #5's
// windowed walk (`n` is W; rows of 32W ints; D from kStages; state s of lane
// l at s*33 + l, copied 4 bytes at a time).
template <int S, int D, bool FULL, int V>
__global__ void __launch_bounds__(32)
window_walk_kernel(const int32_t* __restrict__ packed,       // (W, B, S)
                   const int32_t* __restrict__ final_state,  // (B,)
                   const int32_t* __restrict__ lo,           // (B,)
                   const int32_t* __restrict__ hi,           // (B,)
                   int32_t* __restrict__ bits,               // (B, 32W) or (B, T)
                   int32_t* __restrict__ entry,              // (B,)
                   int B, int n) {
  constexpr int kStage = kStageInts<S, FULL>;
  constexpr int kTop = log2i(S) - 1;    // K - 2
  constexpr int kMask = S / 2 - 1;      // 0 when S == 2
  extern __shared__ int32_t ring[];     // [D][kStage]
  const int l = threadIdx.x;
  const int b0 = blockIdx.x * 32, b = b0 + l;
  const bool live = b < B;
  const int W = FULL ? (n + 31) / 32 : n;
  const int steps = FULL ? n : 32 * W;  // a row's ints
  // a lane past B walks nothing; the full walk's window is [0, T)
  const int wlo = live ? (FULL ? 0 : lo[b]) : 0, whi = live ? (FULL ? n : hi[b]) : 0;
  int s = live ? (final_state[b] & (S - 1)) : 0;
  [[maybe_unused]] uint32_t sink = 0;  // the cut full walk's bits

  // word w's slabs of the lanes whose window meets it, into stage `st`
  // (asynchronous; committed by the caller)
  auto copy = [&](int w, int st) {
    const bool walks = wlo < whi && wlo < 32 * w + 32 && whi > 32 * w;
    const unsigned need = __ballot_sync(kFull, walks);
    if constexpr (TRACEBACK_CUT & 1) return;
    int32_t* dst = ring + st * kStage;
    const int32_t* src = packed + (static_cast<size_t>(w) * B + b0) * S;
    if constexpr (FULL) {
#pragma unroll 4
      for (int e = kPiece<S> * l; e < 32 * S; e += kPiece<S> * 32) {
        const int ln = e / S, x = e % S;  // lane ln's states x ..
        if ((need >> ln) & 1u) cp_async_ints<kPiece<S>>(dst + ln * kRow<S> + x, src + e);
      }
    } else {
#pragma unroll 4
      for (int e = l; e < 32 * S; e += 32) {
        const int ln = e / S, x = e % S;  // lane ln's state x
        if ((need >> ln) & 1u) cp_async4(dst + x * 33 + ln, src + e);
      }
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
    const int32_t* slab = ring + st * kStage + (FULL ? l * kRow<S> : l);
    const int tb = max(wlo, 32 * w), te = min(whi, 32 * w + 32);
    uint32_t m = 0;  // bit p: the lane's output at step 32w + p
    for (int t = te - 1; t >= tb; --t) {
      const uint32_t word = static_cast<uint32_t>(slab[FULL ? s : s * 33]);
      m |= static_cast<uint32_t>(s >> kTop) << (t & 31);
      s = 2 * (s & kMask) + static_cast<int>((word >> (t & 31)) & 1u);
    }
    __syncwarp();  // every lane is done with the stage
    if (i + D < W) copy(w - D, st);
    cp_async_commit();
    if constexpr (FULL && (TRACEBACK_CUT & 2)) sink ^= m;
    if constexpr (FULL && !(TRACEBACK_CUT & 2)) {
      // the 32 rows' steps 32w .. min(32w + 32, T) - 1: rows Vj .. Vj+V-1,
      // 32/V threads a row, V ints a thread (T % V == 0, so a piece that
      // starts below T ends there)
      constexpr int kPer = 32 / V;  // threads a row
#pragma unroll
      for (int j = 0; j < 32 / V; ++j) {
        const int ln = V * j + l / kPer, q = l % kPer, t = 32 * w + V * q;
        const uint32_t mk = __shfl_sync(kFull, m, ln) >> (V * q);
        if (b0 + ln < B && t < n) {
          int32_t* dst = bits + static_cast<size_t>(b0 + ln) * n + t;
          if constexpr (V == 2)
            *reinterpret_cast<int2*>(dst) =
                make_int2(static_cast<int>(mk & 1u), static_cast<int>((mk >> 1) & 1u));
          else
            *dst = static_cast<int>(mk & 1u);
        }
      }
    }
    // the 32 rows' ints of word w: rows 4j .. 4j+3, 8 threads a row, 16 bytes
    // a thread
    if constexpr (!FULL && !(TRACEBACK_CUT & 2)) {
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
  if constexpr (!FULL)
    if (live) entry[b] = s;
  if constexpr (FULL && (TRACEBACK_CUT & 2))
    if (live && sink == 0x9e3779b9u) bits[static_cast<size_t>(b) * n] = s;
}

// n: W for the windowed walk, T for the full one
template <int S, bool FULL, int V>
int walk_launch(const int32_t* packed, const int32_t* final_state, const int32_t* lo,
                const int32_t* hi, int32_t* bits, int32_t* entry, int B, int n,
                cudaStream_t stream) {
  constexpr int D = FULL ? kFullStages[log2i(S) - 1] : kStages[log2i(S) - 1];
  constexpr size_t smem = sizeof(int32_t) * D * kStageInts<S, FULL>;
  static_assert(D >= 2 && smem <= 48 * 1024,
                "two stages or more, within the default shared-memory limit");
  static const cudaError_t carve = cudaFuncSetAttribute(
      window_walk_kernel<S, D, FULL, V>, cudaFuncAttributePreferredSharedMemoryCarveout,
      cudaSharedmemCarveoutMaxShared);  // once: as many warps an SM as the rings allow
  if (carve != cudaSuccess) return carve;
  window_walk_kernel<S, D, FULL, V><<<(B + 31) / 32, 32, smem, stream>>>(
      packed, final_state, lo, hi, bits, entry, B, n);
  return cudaGetLastError();
}

// the full walk, V ints a store: the widest piece every row start is aligned to
template <int S>
int full_walk_launch(const int32_t* packed, const int32_t* final_state, int32_t* bits, int B,
                     int T, cudaStream_t stream) {
  if (T % 2 == 0)
    return walk_launch<S, true, 2>(packed, final_state, nullptr, nullptr, bits, nullptr, B, T,
                                   stream);
  return walk_launch<S, true, 1>(packed, final_state, nullptr, nullptr, bits, nullptr, B, T,
                                 stream);
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
  auto p = static_cast<const int32_t*>(packed);
  auto f = static_cast<const int32_t*>(final_state);
  auto o = static_cast<int32_t*>(bits);
  auto st = static_cast<cudaStream_t>(stream);
  // the staged walk up to kStagedMaxS, the direct walk past it, and for
  // words that do not start on a copy's alignment (a view one int off)
  const bool aligned = reinterpret_cast<uintptr_t>(packed) % (S < 4 ? 8 : 16) == 0;
  switch (aligned ? S : 0) {
    case 2: return full_walk_launch<2>(p, f, o, B, T, st);
    case 4: return full_walk_launch<4>(p, f, o, B, T, st);
    case 8: return full_walk_launch<8>(p, f, o, B, T, st);
    case 16: return full_walk_launch<16>(p, f, o, B, T, st);
    case 32: return full_walk_launch<32>(p, f, o, B, T, st);
    case 64: return full_walk_launch<64>(p, f, o, B, T, st);
    case 128: return full_walk_launch<128>(p, f, o, B, T, st);
    default: break;
  }
  const int blocks = (B + kThreads - 1) / kThreads;
  traceback_packed_kernel<<<blocks, kThreads, 0, st>>>(p, f, o, B, T, S, K);
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
    case 2: return walk_launch<2, false, 4>(p, f, l, h, o, e, B, W, st);
    case 4: return walk_launch<4, false, 4>(p, f, l, h, o, e, B, W, st);
    case 8: return walk_launch<8, false, 4>(p, f, l, h, o, e, B, W, st);
    case 16: return walk_launch<16, false, 4>(p, f, l, h, o, e, B, W, st);
    case 32: return walk_launch<32, false, 4>(p, f, l, h, o, e, B, W, st);
    case 64: return walk_launch<64, false, 4>(p, f, l, h, o, e, B, W, st);
    case 128: return walk_launch<128, false, 4>(p, f, l, h, o, e, B, W, st);
    default: break;
  }
  const int blocks = (B + kThreads - 1) / kThreads;
  traceback_window_kernel<<<blocks, kThreads, 0, st>>>(p, f, l, h, o, e, B, W, S, K);
  return cudaGetLastError();
}

extern "C" const char* survivors_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
