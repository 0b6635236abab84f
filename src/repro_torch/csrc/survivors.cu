// Packed-survivor traceback for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/survivors.py `traceback_packed`
//   (`_make_traceback_kernel`), the Pallas TPU kernel that walks the packed
//   survivor words of the short-block decode path.
//
// What it computes, for every stream b, walking t = T-1 down to 0 from
// s = final_state[b]:
//   bits[b, t] = s >> (K-2)                       (the input bit that made s)
//   s          = 2 * (s & (S/2 - 1)) + bit t of word (t/32, b, s)
// The tail bits t >= T of a partial last word are never read.
//
// What bounds it on this card: latency.  Every step reads one 32-bit word
// whose address depends on the state the previous step produced, so one
// stream's T steps are T dependent memory loads; the bytes it must move
// (one word per step, one output int per step) are small beside that.  The
// stores cost too: each thread writes its own (B, T) row, so a warp's
// stores of one step are T*4 bytes apart and each 4-byte store fills a
// 32-byte sector of its own.
//
// How the design answers that: one thread per stream, so B independent
// walks keep many loads in flight at once and hide each other's latency.
// The words come through the read-only cache (__ldg): the states of one
// stream share words within a 32-step window.  The decoded bits go straight
// to their (B, T) place, so no unpack or transpose follows; staging 32
// steps and storing them coalesced is left to the traceback's tuning.
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

}  // namespace

// Plain C entry point, loaded with ctypes.  Returns the cudaError_t of the
// launch (0 = launched).
extern "C" int traceback_packed_launch(const void* packed, const void* final_state,
                                       void* bits, int B, int T, int S, int K,
                                       void* stream) {
  if (B < 1 || T < 1 || S < 2 || (S & (S - 1)) || S != (1 << (K - 1)))
    return cudaErrorInvalidValue;
  const int blocks = (B + kThreads - 1) / kThreads;
  traceback_packed_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(packed), static_cast<const int32_t*>(final_state),
      static_cast<int32_t*>(bits), B, T, S, K);
  return cudaGetLastError();
}

extern "C" const char* survivors_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
