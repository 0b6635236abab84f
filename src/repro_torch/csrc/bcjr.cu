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
// min-domain cost; m = w . x_t is an F-term dot of a weight row with the
// step's features, summed f = 0 .. F-1 from 0.
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
// a = [next_state[p, u] >= S/2] comes from a table.
//
// What bounds them on this card: first the latency of one lane's step (a
// lane's T steps are strictly sequential: gather, add, min, a min over the
// states, subtract, clamp), then bytes.  The alpha scan writes every A_t,
// (T, S, B) floats, and the beta scan reads them back with the features:
// at the turbo block N=512, S=8, B=8192 that is 134 MB each way, ~0.04 ms
// at 3.35 TB/s; at LTE's N=6144, B=1024 the same bytes are spread over 6144
// steps of 1024 lanes, and one lane's step latency is all that is left.
//
// How the design answers that.
//  * Branch costs off the recurrence.  The six (S, F) weight tables hold
//    only R distinct rows (R = 4 with one parity, 8 with two: a row is a
//    function of the input bit and the parity bits).  The wrapper passes the
//    (R, F) row table, six (S,) int32 state -> row maps and an (S, 2) table
//    of register bits.  A block loads the rows into shared memory, and each
//    consumer thread its states' maps and bits into registers, once.  Each
//    (step, lane) gets its R dots computed once, a chunk ahead of the
//    recurrence, which then reads two (alpha) or four (beta) of them a
//    state.  A dot is the same row times the same features in the same
//    order (f = 0 .. F-1 from 0) as before, so the bits are too.
//  * Memory off the recurrence, warps specialised.  A block is `consumers`
//    threads that run the recurrence of its lanes and 128 producer threads
//    (four warps) that feed them.  During chunk c of Tc steps the producers
//    copy chunk c + 2's features (beta: and chunk c + 1's A_t) into shared
//    memory with cp.async (16 bytes a copy where B % 4 == 0 and the pointers
//    are aligned, 4 otherwise), double-buffered; compute chunk c + 1's dots;
//    and (alpha) write chunk c - 1's A_t, which the consumers left in shared
//    memory, out in rows of lanes.  One barrier ends a chunk.  So a DRAM
//    latency is paid once a chunk, off the recurrence, and the consumers
//    issue nothing but the recurrence and its shared-memory reads (each
//    step's read during the step before) and writes: the producers'
//    instructions fill the recurrence's stalls instead of lengthening it.
//    (`tools/bcjr_measure.py split` times the kernels with the producers'
//    parts cut out: what is left is the consumers' chain.)
//  * Parallelism inside a lane.  A group of G threads (2 <= G <= 32, inside
//    one warp) shares a lane; each thread holds SPT = S / G states.  The
//    alpha thread r holds states r*SPT .. r*SPT + SPT - 1, so the
//    predecessors 2v + j of its successors are all SPT states of threads
//    2(r mod G/2) and 2(r mod G/2) + 1: 2*SPT __shfl_sync a step.  The beta
//    thread r holds states i*G + r, so B[p >> 1] and B[S/2 + (p >> 1)] of
//    each of its states sit in a fixed register of thread
//    (i&1)*G/2 + (r >> 1) (resp. ((SPT + i)&1)*G/2 + (r >> 1)): again 2*SPT
//    shuffles, with the register fixed at compile time.  The renormalising
//    min and the two LLR mins reduce with __shfl_xor_sync over the group.
//    One thread a lane (G = 1) would leave a lane's step no parallelism at
//    all, and is not built.
//  * Exactness.  Adds, subtracts and multiplies use __fadd_rn / __fsub_rn /
//    __fmul_rn, so the compiler cannot contract or reorder them; the beta
//    costs keep the association (A_t[p] + dot) + B[next]; every min
//    propagates NaN as jnp.minimum does (PTX min.NaN.f32); the clamp to
//    1e30 follows every renorm and the shifts accumulate into final_pm.  A
//    min over states is exact in any order, except that it may return the
//    other sign of a zero where +0 and -0 tie; torch.equal treats them as
//    equal, and a zero's sign reaches no other value.  Built without
//    --use_fast_math.
//
// Launch choices (the BCJR_CHOICES table below; G threads a lane, C
// consumer threads a block, Tc steps a chunk), one template of each kernel
// built per S:
//   S              2         4         8         16        32        64
//   alpha  G/C/Tc  2/128/32  4/128/32  8/128/16  8/128/16  16/128/16 32/256/16
//   beta   G/C/Tc  2/128/32  4/128/32  4/128/16  8/128/16  16/128/16 16/128/8
// They are the picks of `tools/bcjr_measure.py sweep` on this source (an
// NVIDIA H100 80GB HBM3 at 700 W): of every G, C in {128, 256} and Tc in
// {8, 16, 32}, the one with the least sum over the turbo shapes N=512
// (B=8192) and N=6144 (B=1024) of its time over that shape's best.  S=32's
// alpha and S=64's beta won by under 0.5% of that sum, a tie.  ptxas
// (sm_90a, CUDA 12, this source): every alpha template 55-56 registers and
// every beta template 56, with no stack frame, but beta<64,16> (80
// registers, a 24-byte stack, 24 bytes spilled); dynamic shared memory at
// F=3, R=4: 36400 bytes (alpha, S=8), 72752 (beta, S=8), 107056 (alpha,
// S=64), 53552 (beta, S=64).
#include <atomic>
#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

// Launch choices, one row per S = 2, 4, 8, 16, 32, 64: {G threads a lane,
// consumer threads a block, Tc steps a chunk} of the alpha scan, then of the
// beta scan.  A measurement build (tools/bcjr_measure.py) defines its own
// table before it includes this file.
#ifndef BCJR_CHOICES
#define BCJR_CHOICES                                                            \
  {{{2, 128, 32}, {2, 128, 32}},   {{4, 128, 32}, {4, 128, 32}},               \
   {{8, 128, 16}, {4, 128, 16}},   {{8, 128, 16}, {8, 128, 16}},               \
   {{16, 128, 16}, {16, 128, 16}}, {{32, 256, 16}, {16, 128, 8}}}
#endif
// A measurement build may also cut parts of the producers' work, to time
// what is left (its outputs are then wrong): bit 0 the next chunk's dots,
// bit 1 the staging of later chunks, bit 2 the alpha scan's A_t stores.
#ifndef BCJR_CUT
#define BCJR_CUT 0
#endif

namespace {

constexpr float kUnreachable = 1e30f;
constexpr int kProducers = 128;  // threads (4 warps) that feed a block's consumers
constexpr int kMaxThreads = 256 + kProducers;
constexpr int kMaxFeatures = 8;
constexpr unsigned kFull = 0xffffffffu;
constexpr size_t kMaxSmem = 232448;  // bytes a block may use on sm_90
constexpr int kCut = BCJR_CUT;

struct Choice {
  int G, consumers, chunk;
};
constexpr Choice kChoices[6][2] = BCJR_CHOICES;

constexpr int log2i(int n) { return n > 1 ? 1 + log2i(n / 2) : 0; }
constexpr Choice choice(int S, bool beta) { return kChoices[log2i(S) - 1][beta ? 1 : 0]; }

// 2 <= G <= 32 threads a lane (one warp), 1 to 8 states a thread, at least
// 4 lanes a block (the 16-byte copies)
constexpr bool valid(const Choice& c, int S) {
  return c.G >= 2 && c.G <= 32 && c.G <= S && (c.G & (c.G - 1)) == 0 && S / c.G <= 8 &&
         (c.consumers == 128 || c.consumers == 256) && c.consumers / c.G >= 4 && c.chunk >= 1;
}

// jnp.minimum: NaN if either operand is NaN.
__device__ __forceinline__ float nan_min(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// every copy this thread issued has landed
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Shared-memory layout of one block, in floats (every region 16-byte
// aligned).  L lanes a block; a staged row of L lanes has stride Lp.
struct Plan {
  int L, Lp, log2L, consumers, chunk, vec;
  int rows_off, feat_off, alph_off, dots_off, out_off;
  int feat_buf, alph_buf, dots_buf, out_buf;  // floats of one buffer of each double buffer
  size_t bytes;
};

int round4(int n) { return (n + 3) & ~3; }

// Lp: a multiple of 4 floats (16-byte copies) at least L.  A group's G
// threads read G different states of one lane, G*Lp apart; with 32/G lanes
// a warp and Lp = (32/G) * odd those reads fall in 32 different banks.
Plan make_plan(int S, int G, int consumers, int chunk, int F, int R, bool beta, bool vec) {
  Plan p{};
  p.L = consumers / G;
  p.log2L = 0;
  while ((1 << p.log2L) < p.L) ++p.log2L;
  const int wg = 32 / G;
  p.Lp = p.L + (wg >= 4 ? wg : 4);
  p.consumers = consumers;
  p.chunk = chunk;
  p.vec = vec;
  int off = 0;
  p.rows_off = off;
  off += round4(R * F);
  p.feat_buf = chunk * F * p.Lp;
  p.feat_off = off;
  off += 2 * p.feat_buf;
  p.alph_buf = beta ? chunk * S * p.Lp : 0;
  p.alph_off = off;
  off += 2 * p.alph_buf;
  p.dots_buf = round4(chunk * R * p.L);
  p.dots_off = off;
  off += 2 * p.dots_buf;
  p.out_buf = beta ? 0 : chunk * S * p.Lp;
  p.out_off = off;
  off += 2 * p.out_buf;
  p.bytes = static_cast<size_t>(off) * sizeof(float);
  return p;
}

// Offset of row `row`, lane g inside one step of the dots buffer: rows
// fastest, as a group's threads read rows of one lane.
__device__ __forceinline__ int dot_offset(int row, int g, int R) { return g * R + row; }

// Steps of chunk c: [c Tc, min(T, (c+1) Tc)).  The beta scan walks chunks
// from the end, chunk c holding [max(0, T - (c+1) Tc), T - c Tc).
__device__ __forceinline__ int chunk_len(int c, int T, int Tc) {
  return c * Tc < T ? min(Tc, T - c * Tc) : 0;
}

// The producer warps' side: copies between global memory and the block's
// staged rows, and the branch costs.  `pt` of `np` producer threads.
struct Producer {
  int pt, np;

  // Copy `nrows` rows of this block's lanes, row q at src + q * B + b0, into
  // dst + q * Lp (asynchronous; the caller commits and waits).
  __device__ __forceinline__ void stage(float* dst, const float* src, int nrows, int B, int b0,
                                        const Plan& p) const {
    const int nb = min(p.L, B - b0);
    if (p.vec) {  // B % 4 == 0: a 4-lane vector is all in or all out
      const int sh = p.log2L - 2, per_row = p.L >> 2;
      for (int i = pt; i < nrows * per_row; i += np) {
        const int q = i >> sh, l = 4 * (i & (per_row - 1));
        if (l < nb) cp_async16(dst + q * p.Lp + l, src + static_cast<size_t>(q) * B + b0 + l);
      }
    } else {
      for (int i = pt; i < nrows * p.L; i += np) {
        const int q = i >> p.log2L, l = i & (p.L - 1);
        if (l < nb) cp_async4(dst + q * p.Lp + l, src + static_cast<size_t>(q) * B + b0 + l);
      }
    }
  }

  // The staged rows back out: row q of src (stride Lp) to dst + q * B + b0.
  __device__ __forceinline__ void unstage(float* dst, const float* src, int nrows, int B, int b0,
                                          const Plan& p) const {
    const int nb = min(p.L, B - b0);
    if (p.vec) {
      const int sh = p.log2L - 2, per_row = p.L >> 2;
      for (int i = pt; i < nrows * per_row; i += np) {
        const int q = i >> sh, l = 4 * (i & (per_row - 1));
        if (l < nb)
          *reinterpret_cast<float4*>(dst + static_cast<size_t>(q) * B + b0 + l) =
              *reinterpret_cast<const float4*>(src + q * p.Lp + l);
      }
    } else {
      for (int i = pt; i < nrows * p.L; i += np) {
        const int q = i >> p.log2L, l = i & (p.L - 1);
        if (l < nb) dst[static_cast<size_t>(q) * B + b0 + l] = src[q * p.Lp + l];
      }
    }
  }

  // The R dots of every step of a chunk and every lane: feat (stride Lp
  // rows, F a step) -> dots (R*L a step).  A producer thread keeps one
  // (row, lane) item and walks the chunk's steps, four dots in flight; with
  // more producers than items, the steps are dealt out among them.  FX is F
  // when it is known at compile time (3 or 4), else 0.
  template <int FX>
  __device__ __forceinline__ void dots_of(float* dots, const float* rows, const float* feat, int n,
                                          int F, int R, const Plan& p) const {
    const int RL = R * p.L;
    const int kstep = np >= RL ? np / RL : 1;
    if (pt >= kstep * RL) return;
    for (int j = pt % RL; j < RL; j += kstep == 1 ? np : RL) {
      const int row = j >> p.log2L, g = j & (p.L - 1);
      float w[FX > 0 ? FX : kMaxFeatures];
#pragma unroll
      for (int f = 0; f < (FX > 0 ? FX : kMaxFeatures); ++f)
        w[f] = (FX > 0 || f < F) ? rows[row * F + f] : 0.0f;
      const float* x = feat + g;
      float* d = dots + dot_offset(row, g, R);
#pragma unroll 4
      for (int k = pt / RL; k < n; k += kstep) {
        const float* xk = x + k * F * p.Lp;
        float m = 0.0f;
        if constexpr (FX > 0) {
#pragma unroll
          for (int f = 0; f < FX; ++f) m = __fadd_rn(m, __fmul_rn(w[f], xk[f * p.Lp]));
        } else {
#pragma unroll
          for (int f = 0; f < kMaxFeatures; ++f)
            if (f < F) m = __fadd_rn(m, __fmul_rn(w[f], xk[f * p.Lp]));
        }
        d[k * RL] = m;
      }
      if (kstep > 1) break;  // one item a thread
    }
  }

  __device__ __forceinline__ void dots(float* dots, const float* rows, const float* feat, int n,
                                       int F, int R, const Plan& p) const {
    if (F == 3)
      dots_of<3>(dots, rows, feat, n, F, R, p);
    else if (F == 4)
      dots_of<4>(dots, rows, feat, n, F, R, p);
    else
      dots_of<0>(dots, rows, feat, n, F, R, p);
  }
};

// Both kernels run one pipeline.  A block is `consumers` threads (L lanes
// of G threads) and kProducers producer threads.  At the start of chunk c the
// block holds chunk c's dots (and, for beta, its A_t) and chunk c + 1's
// features.  During chunk c the consumers run its recurrence, and the
// producers
//   copy chunk c + 2's features (and, for beta, chunk c + 1's A_t) into the
//   buffers chunks c and c - 1 have released (cp.async),
//   compute chunk c + 1's dots,
//   (alpha) write chunk c - 1's A_t out in rows of lanes,
//   and wait for their copies;
// one barrier ends the chunk.  The consumers issue nothing but the
// recurrence, its shared-memory reads and writes and (beta) its LLR stores,
// so the producers' instructions fill the recurrence's stalls instead of
// lengthening it.  A dot is sum_f w[f] * x[f], f = 0 .. F-1, from 0, each
// op rounded on its own, as the Pallas kernels sum it.

struct AlphaArgs {
  const float* rows;      // (R, F) distinct weight rows
  const int32_t* b0_row;  // (S,) state -> row of b0
  const int32_t* b1_row;  // (S,) state -> row of b1
  const float* feat;      // (T, F, B)
  float* alphas;          // (T, S, B)
  float* final_pm;        // (S, B)
  int B, T, F, R;
  Plan plan;
};

template <int S, int G>
__global__ void __launch_bounds__(kMaxThreads) alpha_kernel(const AlphaArgs a) {
  constexpr int SPT = S / G;  // states of this thread: r*SPT .. r*SPT + SPT-1
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const Plan& pl = a.plan;
  float* rows_s = smem + pl.rows_off;
  float* feat_s = smem + pl.feat_off;
  float* dots_s = smem + pl.dots_off;
  float* out_s = smem + pl.out_off;
  const int B = a.B, T = a.T, F = a.F, R = a.R, L = pl.L, Lp = pl.Lp, Tc = pl.chunk;
  const int b0 = blockIdx.x * L;
  const int nc = (T + Tc - 1) / Tc;
  const int RL = R * L;
  const bool producer = static_cast<int>(threadIdx.x) >= pl.consumers;
  const Producer prod{static_cast<int>(threadIdx.x) - pl.consumers,
                      static_cast<int>(blockDim.x) - pl.consumers};
  auto stage_feat = [&](int c) {  // features of chunk c into buffer c & 1
    prod.stage(feat_s + (c & 1) * pl.feat_buf, a.feat + static_cast<size_t>(c) * Tc * F * B,
               chunk_len(c, T, Tc) * F, B, b0, pl);
  };

  if (producer) {
    for (int i = prod.pt; i < R * F; i += prod.np) rows_s[i] = __ldg(a.rows + i);
    stage_feat(0);
    stage_feat(1);
    cp_async_commit();
    cp_async_wait_all();
  }
  __syncthreads();
  if (producer) prod.dots(dots_s, rows_s, feat_s, chunk_len(0, T, Tc), F, R, pl);
  __syncthreads();

  if (producer) {
    for (int c = 0; c < nc; ++c) {
      if (!(kCut & 2)) stage_feat(c + 2);  // into the buffer chunk c's features held
      cp_async_commit();
      if (!(kCut & 1))
        prod.dots(dots_s + ((c + 1) & 1) * pl.dots_buf, rows_s,
                  feat_s + ((c + 1) & 1) * pl.feat_buf, chunk_len(c + 1, T, Tc), F, R, pl);
      if (c > 0 && !(kCut & 4))
        prod.unstage(a.alphas + static_cast<size_t>(c - 1) * Tc * S * B,
                     out_s + ((c - 1) & 1) * pl.out_buf, Tc * S, B, b0, pl);
      cp_async_wait_all();
      __syncthreads();  // chunk c ends
    }
    prod.unstage(a.alphas + static_cast<size_t>(nc - 1) * Tc * S * B,
                 out_s + ((nc - 1) & 1) * pl.out_buf, chunk_len(nc - 1, T, Tc) * S, B, b0, pl);
    return;
  }

  // consumers
  const int g = threadIdx.x / G, r = threadIdx.x % G;
  const int b = b0 + g;
  const bool valid = b < B;
  int o0[SPT], o1[SPT];
  float A[SPT];
#pragma unroll
  for (int i = 0; i < SPT; ++i) {
    const int s = r * SPT + i;
    o0[i] = dot_offset(__ldg(a.b0_row + s), g, R);
    o1[i] = dot_offset(__ldg(a.b1_row + s), g, R);
    A[i] = s == 0 ? 0.0f : kUnreachable;
  }
  float acc = 0.0f;
  for (int c = 0; c < nc; ++c) {
    const int n = chunk_len(c, T, Tc);
    const float* dots_c = dots_s + (c & 1) * pl.dots_buf;
    float* out_c = out_s + (c & 1) * pl.out_buf + (r * SPT) * Lp + g;
    float d0[SPT], d1[SPT];
#pragma unroll
    for (int i = 0; i < SPT; ++i) d0[i] = dots_c[o0[i]], d1[i] = dots_c[o1[i]];
    for (int k = 0; k < n; ++k) {
      // the next step's branch costs, read while this step computes
      const float* dn = dots_c + min(k + 1, n - 1) * RL;
      float e0[SPT], e1[SPT];
#pragma unroll
      for (int i = 0; i < SPT; ++i) e0[i] = dn[o0[i]], e1[i] = dn[o1[i]];
      // emit the pre-update A_t (the producers write it out next chunk)
#pragma unroll
      for (int i = 0; i < SPT; ++i) out_c[(k * S + i) * Lp] = A[i];
      // predecessors: x[j] = A(2 * vbase + j), vbase the first v of this thread
      float x[2 * SPT];
      const int q0 = 2 * (r % (G / 2));
#pragma unroll
      for (int j = 0; j < 2 * SPT; ++j) x[j] = __shfl_sync(kFull, A[j % SPT], q0 + j / SPT, G);
      float nw[SPT];
#pragma unroll
      for (int i = 0; i < SPT; ++i)
        nw[i] = nan_min(__fadd_rn(x[2 * i], d0[i]), __fadd_rn(x[2 * i + 1], d1[i]));
      float shift = nw[0];
#pragma unroll
      for (int i = 1; i < SPT; ++i) shift = nan_min(shift, nw[i]);
#pragma unroll
      for (int o = 1; o < G; o <<= 1) shift = nan_min(shift, __shfl_xor_sync(kFull, shift, o, G));
#pragma unroll
      for (int i = 0; i < SPT; ++i) A[i] = nan_min(__fsub_rn(nw[i], shift), kUnreachable);
      acc = __fadd_rn(acc, shift);
#pragma unroll
      for (int i = 0; i < SPT; ++i) d0[i] = e0[i], d1[i] = e1[i];
    }
    __syncthreads();  // chunk c ends
  }
  if (valid) {
#pragma unroll
    for (int i = 0; i < SPT; ++i)
      a.final_pm[static_cast<size_t>(r * SPT + i) * B + b] = __fadd_rn(A[i], acc);
  }
}

struct BetaArgs {
  const float* rows;      // (R, F) distinct weight rows
  const int32_t* c0_row;  // (S,) state -> row of c0
  const int32_t* c1_row;
  const int32_t* w0_row;
  const int32_t* w1_row;
  const int32_t* reg_bit;  // (S, 2): next_state[p, u] >= S/2
  const float* alphas;     // (T, S, B)
  const float* feat;       // (T, F, B)
  float* llr;              // (T, B)
  int B, T, F, R, terminated;
  Plan plan;
};

template <int S, int G>
__global__ void __launch_bounds__(kMaxThreads) beta_llr_kernel(const BetaArgs a) {
  constexpr int SPT = S / G;  // states of this thread: i*G + r
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const Plan& pl = a.plan;
  float* rows_s = smem + pl.rows_off;
  float* feat_s = smem + pl.feat_off;
  float* alph_s = smem + pl.alph_off;
  float* dots_s = smem + pl.dots_off;
  const int B = a.B, T = a.T, F = a.F, R = a.R, L = pl.L, Lp = pl.Lp, Tc = pl.chunk;
  const int b0 = blockIdx.x * L;
  const int nc = (T + Tc - 1) / Tc;
  const int RL = R * L;
  const bool producer = static_cast<int>(threadIdx.x) >= pl.consumers;
  const Producer prod{static_cast<int>(threadIdx.x) - pl.consumers,
                      static_cast<int>(blockDim.x) - pl.consumers};
  // chunk c holds steps [t_lo(c), t_lo(c) + chunk_len(c)), walked backwards
  auto t_lo = [&](int c) { return max(0, T - (c + 1) * Tc); };
  auto stage_feat = [&](int c) {  // features of chunk c into buffer c & 1
    prod.stage(feat_s + (c & 1) * pl.feat_buf, a.feat + static_cast<size_t>(t_lo(c)) * F * B,
               chunk_len(c, T, Tc) * F, B, b0, pl);
  };
  auto stage_alph = [&](int c) {  // A_t of chunk c into buffer c & 1
    prod.stage(alph_s + (c & 1) * pl.alph_buf, a.alphas + static_cast<size_t>(t_lo(c)) * S * B,
               chunk_len(c, T, Tc) * S, B, b0, pl);
  };

  if (producer) {
    for (int i = prod.pt; i < R * F; i += prod.np) rows_s[i] = __ldg(a.rows + i);
    stage_feat(0);
    stage_alph(0);
    stage_feat(1);
    cp_async_commit();
    cp_async_wait_all();
  }
  __syncthreads();
  if (producer) prod.dots(dots_s, rows_s, feat_s, chunk_len(0, T, Tc), F, R, pl);
  __syncthreads();

  if (producer) {
    for (int c = 0; c < nc; ++c) {
      if (!(kCut & 2)) {
        stage_feat(c + 2);  // into the buffer chunk c's features held
        stage_alph(c + 1);  // into the buffer chunk c - 1's A_t held
      }
      cp_async_commit();
      if (!(kCut & 1))
        prod.dots(dots_s + ((c + 1) & 1) * pl.dots_buf, rows_s,
                  feat_s + ((c + 1) & 1) * pl.feat_buf, chunk_len(c + 1, T, Tc), F, R, pl);
      cp_async_wait_all();
      __syncthreads();  // chunk c ends
    }
    return;
  }

  // consumers
  const int g = threadIdx.x / G, r = threadIdx.x % G;
  const int b = b0 + g;
  const bool valid = b < B;
  int oc0[SPT], oc1[SPT], ow0[SPT], ow1[SPT];
  unsigned hi0 = 0, hi1 = 0;  // bit i: the transition of state i*G + r under u lands high
  float Bt[SPT];
#pragma unroll
  for (int i = 0; i < SPT; ++i) {
    const int p = i * G + r;
    oc0[i] = dot_offset(__ldg(a.c0_row + p), g, R);
    oc1[i] = dot_offset(__ldg(a.c1_row + p), g, R);
    ow0[i] = dot_offset(__ldg(a.w0_row + p), g, R);
    ow1[i] = dot_offset(__ldg(a.w1_row + p), g, R);
    hi0 |= (__ldg(a.reg_bit + 2 * p) ? 1u : 0u) << i;
    hi1 |= (__ldg(a.reg_bit + 2 * p + 1) ? 1u : 0u) << i;
    Bt[i] = (a.terminated && p != 0) ? kUnreachable : 0.0f;
  }
  for (int c = 0; c < nc; ++c) {
    const int t0 = t_lo(c), n = chunk_len(c, T, Tc);
    const float* dots_c = dots_s + (c & 1) * pl.dots_buf;
    const float* al = alph_s + (c & 1) * pl.alph_buf + r * Lp + g;  // + (k*S + i*G) * Lp
    float dc0[SPT], dc1[SPT], dw0[SPT], dw1[SPT], ap[SPT];
    auto load = [&](int k, float (&e0)[SPT], float (&e1)[SPT], float (&f0)[SPT],
                    float (&f1)[SPT], float (&av)[SPT]) {
      const float* d = dots_c + k * RL;
#pragma unroll
      for (int i = 0; i < SPT; ++i) {
        e0[i] = d[oc0[i]], e1[i] = d[oc1[i]], f0[i] = d[ow0[i]], f1[i] = d[ow1[i]];
        av[i] = al[(k * S + i * G) * Lp];
      }
    };
    load(n - 1, dc0, dc1, dw0, dw1, ap);
    for (int k = n - 1; k >= 0; --k) {
      float ec0[SPT], ec1[SPT], ew0[SPT], ew1[SPT], an[SPT];
      load(max(k - 1, 0), ec0, ec1, ew0, ew1, an);  // the next step's values
      // B[p >> 1] and B[S/2 + (p >> 1)] of each state p = i*G + r
      float lo[SPT], hi[SPT];
      const int q = r >> 1;
#pragma unroll
      for (int i = 0; i < SPT; ++i) {
        lo[i] = __shfl_sync(kFull, Bt[i >> 1], (i & 1) * (G / 2) + q, G);
        hi[i] = __shfl_sync(kFull, Bt[(SPT + i) >> 1], ((SPT + i) & 1) * (G / 2) + q, G);
      }
      // retire B_{t+1} -> B_t over the new-register-bit branches
      float nw[SPT];
#pragma unroll
      for (int i = 0; i < SPT; ++i)
        nw[i] = nan_min(__fadd_rn(lo[i], dc0[i]), __fadd_rn(hi[i], dc1[i]));
      float shift = nw[0];
#pragma unroll
      for (int i = 1; i < SPT; ++i) shift = nan_min(shift, nw[i]);
#pragma unroll
      for (int o = 1; o < G; o <<= 1) shift = nan_min(shift, __shfl_xor_sync(kFull, shift, o, G));
      // LLR of step t from A_t and B_{t+1} (off the chain)
      float mn0 = 0.0f, mn1 = 0.0f;
#pragma unroll
      for (int i = 0; i < SPT; ++i) {
        const float cost0 = __fadd_rn(__fadd_rn(ap[i], dw0[i]), (hi0 >> i) & 1u ? hi[i] : lo[i]);
        const float cost1 = __fadd_rn(__fadd_rn(ap[i], dw1[i]), (hi1 >> i) & 1u ? hi[i] : lo[i]);
        mn0 = i == 0 ? cost0 : nan_min(mn0, cost0);
        mn1 = i == 0 ? cost1 : nan_min(mn1, cost1);
      }
#pragma unroll
      for (int o = 1; o < G; o <<= 1) {
        mn0 = nan_min(mn0, __shfl_xor_sync(kFull, mn0, o, G));
        mn1 = nan_min(mn1, __shfl_xor_sync(kFull, mn1, o, G));
      }
#pragma unroll
      for (int i = 0; i < SPT; ++i) Bt[i] = nan_min(__fsub_rn(nw[i], shift), kUnreachable);
      if (valid && r == 0) a.llr[static_cast<size_t>(t0 + k) * B + b] = __fsub_rn(mn1, mn0);
#pragma unroll
      for (int i = 0; i < SPT; ++i)
        dc0[i] = ec0[i], dc1[i] = ec1[i], dw0[i] = ew0[i], dw1[i] = ew1[i], ap[i] = an[i];
    }
    __syncthreads();  // chunk c ends
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

bool bad_shape(int B, int T, int F, int S, int R) {
  return B < 1 || T < 1 || F < 1 || F > kMaxFeatures || S < 2 || S > 64 || (S & (S - 1)) ||
         R < 1 || R > 2 * S;
}

// Opt `kernel` in to more than 48 KB of dynamic shared memory, once per
// device (bit d of `done`).
cudaError_t allow_smem(const void* kernel, std::atomic<unsigned long long>& done) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
  if (done.load(std::memory_order_relaxed) & bit) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(kMaxSmem));
  if (e == cudaSuccess) done.fetch_or(bit, std::memory_order_relaxed);
  return e;
}

// Launch the one kernel built for (S, alpha or beta) with its choice.
template <int S, bool BETA, typename Args>
int launch(void (*kernel)(Args), Args a, bool vec, cudaStream_t st) {
  constexpr Choice c = choice(S, BETA);
  static_assert(valid(c, S), "a launch choice outside what the kernels take");
  static std::atomic<unsigned long long> smem_allowed{0};
  a.plan = make_plan(S, c.G, c.consumers, c.chunk, a.F, a.R, BETA, vec);
  if (a.plan.bytes > kMaxSmem) return cudaErrorInvalidValue;
  if (a.plan.bytes > 48 * 1024) {
    const cudaError_t e = allow_smem(reinterpret_cast<const void*>(kernel), smem_allowed);
    if (e != cudaSuccess) return e;
  }
  kernel<<<(a.B + a.plan.L - 1) / a.plan.L, c.consumers + kProducers, a.plan.bytes, st>>>(a);
  return cudaGetLastError();
}

template <int S>
int alpha_at(const AlphaArgs& a, bool vec, cudaStream_t st) {
  return launch<S, false, AlphaArgs>(alpha_kernel<S, choice(S, false).G>, a, vec, st);
}

template <int S>
int beta_at(const BetaArgs& a, bool vec, cudaStream_t st) {
  return launch<S, true, BetaArgs>(beta_llr_kernel<S, choice(S, true).G>, a, vec, st);
}

// The launchers by log2(S) - 1: the 6 + 6 kernels built.
constexpr int (*kAlphaAt[6])(const AlphaArgs&, bool, cudaStream_t) = {
    alpha_at<2>, alpha_at<4>, alpha_at<8>, alpha_at<16>, alpha_at<32>, alpha_at<64>};
constexpr int (*kBetaAt[6])(const BetaArgs&, bool, cudaStream_t) = {
    beta_at<2>, beta_at<4>, beta_at<8>, beta_at<16>, beta_at<32>, beta_at<64>};

}  // namespace

// Plain C entry points, loaded with ctypes.  Each returns the cudaError_t of
// its launch (0 = launched).  S must be a power of two in [2, 64], F at most
// 8 and R at most 2S; the launch choice is the table's row for S.

// `bcjr_alpha_scan`: feat (T, F, B) -> alphas (T, S, B), final_pm (S, B).
extern "C" int bcjr_alpha_scan_launch(const void* rows, const void* b0_row, const void* b1_row,
                                      const void* feat, void* alphas, void* final_pm, int B,
                                      int T, int F, int S, int R, void* stream) {
  if (bad_shape(B, T, F, S, R)) return cudaErrorInvalidValue;
  const bool vec = B % 4 == 0 && aligned16(feat) && aligned16(alphas);
  const AlphaArgs a{static_cast<const float*>(rows), static_cast<const int32_t*>(b0_row),
                    static_cast<const int32_t*>(b1_row), static_cast<const float*>(feat),
                    static_cast<float*>(alphas), static_cast<float*>(final_pm), B, T, F, R,
                    Plan{}};
  return kAlphaAt[log2i(S) - 1](a, vec, static_cast<cudaStream_t>(stream));
}

// `bcjr_beta_llr_scan`: alphas (T, S, B), feat (T, F, B) -> llr (T, B).
extern "C" int bcjr_beta_llr_scan_launch(const void* rows, const void* c0_row, const void* c1_row,
                                         const void* w0_row, const void* w1_row,
                                         const void* reg_bit, const void* alphas,
                                         const void* feat, void* llr, int B, int T, int F, int S,
                                         int R, int terminated, void* stream) {
  if (bad_shape(B, T, F, S, R)) return cudaErrorInvalidValue;
  const bool vec = B % 4 == 0 && aligned16(feat) && aligned16(alphas);
  const BetaArgs a{static_cast<const float*>(rows),     static_cast<const int32_t*>(c0_row),
                   static_cast<const int32_t*>(c1_row), static_cast<const int32_t*>(w0_row),
                   static_cast<const int32_t*>(w1_row), static_cast<const int32_t*>(reg_bit),
                   static_cast<const float*>(alphas),   static_cast<const float*>(feat),
                   static_cast<float*>(llr),            B, T, F, R, terminated, Plan{}};
  return kBetaAt[log2i(S) - 1](a, vec, static_cast<cudaStream_t>(stream));
}

extern "C" const char* bcjr_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
