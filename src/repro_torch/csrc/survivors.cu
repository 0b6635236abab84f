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
// What bounds them on this card: latency.  Every step reads one 32-bit word
// whose address depends on the state the previous step produced, so one
// stream's T steps are T dependent memory loads; the bytes it must move
// (one word per step, one output int per step) are small beside that.  The
// stores cost too: each thread writes its own row of bits, so a warp's
// stores of one step are T*4 bytes apart and each 4-byte store fills a
// 32-byte sector of its own.
//
// How the design answers that: one thread per stream, so B independent
// walks keep many loads in flight at once and hide each other's latency
// (the tiled traceback has B*P*S of them).  The words come through the
// read-only cache (__ldg): the states of one stream share words within a
// 32-step window.  The windowed walk reads no word outside its window, and
// a lane's window is two registers, so the only branch is per lane.  The
// decoded bits go straight to their row, so no unpack or transpose follows;
// staging 32 steps and storing them coalesced is left to the traceback's
// tuning.
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
  const int blocks = (B + kThreads - 1) / kThreads;
  traceback_window_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(packed), static_cast<const int32_t*>(final_state),
      static_cast<const int32_t*>(lo), static_cast<const int32_t*>(hi),
      static_cast<int32_t*>(bits), static_cast<int32_t*>(entry), B, W, S, K);
  return cudaGetLastError();
}

extern "C" const char* survivors_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
