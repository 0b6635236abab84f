// `Texpand`, the paper's custom instruction, for Hopper (sm_90a): ONE
// add-compare-select (ACS) step over every state of a batch of decoders.
//
// Replaces the Pallas TPU kernel `texpand` (`_texpand_kernel`) of
// src/repro/kernels/texpand.py.
//
// What it computes, for every lane b and successor state s' = u*S/2 + v:
//   cand_j = pm[b, 2v + j] + bm[b, sym[s', j]]     (j = 0, 1)
//   take1  = cand_1 < cand_0                      (strict: ties go to j = 0)
//   pm'    = take1 ? cand_1 : cand_0              (no clamp, as the reference)
//   bp     = take1
// sym[s', j] is the output symbol of the transition from predecessor 2v + j
// into s' — the column that the one-hot row OH_j[s'] of the Pallas kernel
// picks.  The Pallas kernel computes both terms as one-hot matmuls
// (P_j @ pm, OH_j @ bm) only to avoid gathers on the TPU; a one-hot dot is an
// exact selection, so the direct indices here give the same bits.
//
// What bounds it on this card: bytes, and above all the launch.  Per
// (lane, state) the step reads its two predecessor metrics and two table
// entries and writes one metric and one select: at K=7 (S=64, M=4) and
// B=8192 lanes that is about 6.4 MB a step, about 2 us at 3.35 TB/s, and 4
// operations per (lane, state).  One launch through ctypes costs more than
// that, so a decode driven one step per launch is bound by the launches —
// the paper's contrast between one instruction per trellis step and the
// whole loop on the chip (csrc/viterbi_scan.cu).
//
// How the design answers that: one thread per (lane, state), B*S threads in
// the (B, S) row-major order of the user layout, so a warp's loads of pm and
// its stores of pm' and bp are contiguous.  The predecessor metrics of a
// lane lie in the same 4S-byte row the warp is reading, and bm's M entries
// of a lane in one 4M-byte row, so the gathers hit the same lines.  The
// symbol table (S, 2) is read through the read-only cache.  Adds use
// __fadd_rn so nothing is contracted or reordered.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
texpand_kernel(const float* __restrict__ pm,      // (B, S)
               const float* __restrict__ bm,      // (B, M)
               const int32_t* __restrict__ sym,   // (S, 2)
               float* __restrict__ out_pm,        // (B, S)
               int32_t* __restrict__ out_bp,      // (B, S)
               int B, int S, int M) {
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= static_cast<size_t>(B) * S) return;
  const int b = static_cast<int>(i / S);
  const int s = static_cast<int>(i % S);
  const int v = s & ((S >> 1) - 1);  // 0 when S == 2
  const float* row = pm + static_cast<size_t>(b) * S;
  const float* tbl = bm + static_cast<size_t>(b) * M;
  const float c0 = __fadd_rn(row[2 * v], tbl[__ldg(sym + 2 * s)]);
  const float c1 = __fadd_rn(row[2 * v + 1], tbl[__ldg(sym + 2 * s + 1)]);
  const bool take1 = c1 < c0;
  out_pm[i] = take1 ? c1 : c0;
  out_bp[i] = static_cast<int32_t>(take1);
}

}  // namespace

// Plain C entry point, loaded with ctypes.  Returns the cudaError_t of its
// launch (0 = launched).
extern "C" int texpand_launch(const void* pm, const void* bm, const void* sym, void* out_pm,
                              void* out_bp, int B, int S, int M, void* stream) {
  if (B < 1 || S < 2 || M < 1 || (S & (S - 1))) return cudaErrorInvalidValue;
  const size_t n = static_cast<size_t>(B) * S;
  const size_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffULL) return cudaErrorInvalidValue;
  texpand_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pm), static_cast<const float*>(bm),
      static_cast<const int32_t*>(sym), static_cast<float*>(out_pm),
      static_cast<int32_t*>(out_bp), B, S, M);
  return cudaGetLastError();
}

extern "C" const char* texpand_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
