// Fused Kronecker-head cross-entropy, forward and backward, for Hopper
// (sm_90a): order-2 heads. The forward and ce_bwd_kernel run fp32 on the
// CUDA cores; ce_bwd_tc_kernel, the backward of every head that fits it
// (the wrapper's static route), runs its three large products on the
// tensor cores in 3xTF32 (the last part of this header).
//
// Replaces: src/repro/kernels/kron_logits/kron_logits.py::_fwd_kernel
// (reached through kron_ce_pallas) and ::_bwd_kernel (reached through
// kron_ce_bwd_pallas).
//
// Computes, for x (N, q1*q2) read as (N, q1, q2), labels (N,) and the head
// factors F1 (r, q1, t1), F2 (r, q2, t2), with vocabulary column c*t2 + t:
//   stage 1  z_c[b, k*q2 + j] = sum_i x[b, i, j] F1[k, i, c]
//   stage 2  logit[b, c*t2 + t] = sum_{k, j} z_c[b, k*q2 + j] F2[k, j, t]
// Columns at or past vocab are masked. The forward keeps, per token, an
// online (m, l, label logit) and returns loss = m + log l - label logit with
// (m, l). The backward recomputes z_c and the logits from (x, F1, F2), forms
// dlogit = g (exp(logit - m) / l - onehot) from the saved (m, l), and pushes
// it back through the chain:
//   dz_c = dlogit_c F2^T,  dF2 += z_c^T dlogit_c,
//   dx[b, i, j] += sum_k F1[k, i, c] dz_c[b, k*q2 + j],
//   dF1[k, i, c] = sum_{b, j} x[b, i, j] dz_c[b, k*q2 + j].
// No logit and no dlogit reaches device memory in either direction.
//
// What bounds it on the H100: operations. A token costs
// 2 (r q1 q2 t1 + r q2 t1 t2) = 362.6 MFLOP forward at the qwen3-1.7b head
// (r 32, q (64, 32), t (390, 390)), 0.74 TFLOP at 2,048 tokens, or 11.1 ms
// at the 67 TFLOP/s of the fp32 CUDA cores; the backward recomputes the
// forward and adds three products of the stage-2 size and two of the
// stage-1 size, about 2.2 TFLOP (33 ms). It reads only x, the labels and
// 4.8 MB of factors.
//
// Design (simple first; tensor cores and TMA are later work):
//  * The TPU grid is (token blocks, t1 tiles) with the t1 axis sequential
//    and the (m, l, label) accumulators resident in VMEM across it. Here a
//    block owns 32 tokens and a contiguous range of t1 columns and loops
//    over its columns inside the block; the t1 axis is split across
//    gridDim.y blocks (chosen by the wrapper to fill the SMs), and a second
//    launch from this source merges the per-split (m, l, label) partials by
//    log-sum-exp, in a fixed order.
//  * Per column c: F1[:, :, c] is gathered into shared memory; stage 1
//    writes z_c (32 x r q2, 128 KB) to shared memory; stage 2 streams F2
//    through shared memory in 16-row chunks, each warp owning 4 tokens and
//    each lane 13 vocabulary columns t = lane + 32 u in registers, so a
//    token's whole 390-column slice lies in one warp and its max, sum and
//    label logit are warp shuffles.
//  * The backward keeps dlogit_c (32 x 416) in shared memory and overwrites
//    z_c with dz_c once dF2 has read it. The TPU accumulates dh, dF1 and dF2
//    in VMEM blocks revisited along its sequential grid; blocks here run in
//    parallel in no order, so every cross-block sum goes to per-block
//    partials in device memory, each written by one block only: dF2 per
//    block (accumulated over its columns), dx per t1 split (accumulated
//    over its columns), and dF1[:, :, c] per token block. Three reduce
//    launches from this source then sum them in a fixed order, so the
//    backward gives the same bits from run to run (no atomics). The dF2
//    partial is read and written once per column; that traffic (3.2 MB per
//    block per column) is the backward's main cost beyond its arithmetic.
//  * One block per SM (162 KB of shared memory forward, 216 KB backward),
//    256 threads. With no second block to hide the loads of F2 from L2,
//    each thread issues the next F2 chunk's loads into registers before it
//    multiplies the current chunk (stage 2 and dz alike).

// ce_bwd_tc_kernel: the backward on the tensor cores.
//  * What held ce_bwd_kernel back (214 ms at 2,048 tokens on an H100,
//    against a 33 ms fp32 bound): 32-token blocks walk 24,960 block-columns,
//    and each streams F2 twice from L2 and reads and rewrites its 1.6 MB
//    dF2 partial (205 MB of partials in all, past the 50 MB L2); its FMAs
//    reach about 16% of the CUDA cores' rate.
//  * Blocks of 64 tokens (one wgmma M) halve the block-columns. The three
//    stage-2-sized products run as wgmma m64nNk8 in TF32 on the 3xTF32
//    split: each fp32 operand a = hi + lo with hi = tf32(a), lo =
//    tf32(a - hi), and the product hi.hi + hi.lo + lo.hi accumulated in
//    fp32 (lo.lo, 2^-22 relative, dropped; adding it changed nothing on the
//    card). One TF32 pass is hundreds of times further from a float64
//    result than fp32.
//  * A has to be K-major for TF32 (no transpose), so the call first writes
//    two images of F2 (prep_f2_kernel), split and laid out as the ring
//    stages land in shared memory (32-byte swizzled tiles): F2^T, the B of
//    stage 2, and F2 in its stored orientation, the B of dz. A producer
//    warpgroup streams them with the TMA's bulk copies into two rings,
//    stage by stage on mbarriers; the A operands come from registers,
//    loaded from fp32 tiles in shared memory and split as they are loaded.
//  * z_c (64 x r q2, 256 KB) does not fit, so kz goes in chunks of 64 rows
//    ordered j-major ((j, k) pairs of a few j), and each column takes two
//    passes. Pass 1, per chunk: stage 1 on the CUDA cores, then for each
//    half of t, logits += z F2 (two consumer warpgroups, 64 tokens x 104 t
//    each). The logits become dlogit = g (softmax - onehot) in shared
//    memory (64 x 416). Pass 2, per chunk: stage 1 again, into the B tiles of
//    dF2^T += dlogit^T z (a 1.6 MB partial per block, as before);
//    dz = dlogit F2^T (the two warpgroups take alternate t stages, summed
//    in a fixed order); then dx and dF1 of the chunk on the CUDA cores.
//    Chunks of a few j keep each chunk's dx rows whole (dx has j inner,
//    so x is read transposed, (N, q2, q1), made per call).
//  * Pass 1's ring and z and pass 2's ring and z tiles share one region
//    after the logits; the producer starts each pass's copies when the
//    consumers have left the other.
//  * The tensor cores add in fp32 but truncate toward 0: chained over the
//    384 products of a logit (128 k-steps, 3 each) that biased the logits
//    by about 1e-5 of their size, and dh by 7e-4 of its largest entry (a
//    first version, on the card). So each k-step of the logits and of dz
//    is its own wgmma sum (the small hi.lo and lo.hi terms first), added in
//    fp32 with rounding to nearest: the logits' per chunk, then once per
//    chunk to the logits in shared memory; dF2^T's in two sums of four
//    k-steps. The second accumulator fits at 104 t a warpgroup, so pass 1
//    takes the two halves of t in turn.
//  * Every cross-block sum goes to per-block partials and fixed-order
//    reduces, as in ce_bwd_kernel: the same bits on every run.
//  * What bounds it: 3 x 0.64 TFLOP at 2,048 tokens on the 495 TFLOP/s
//    TF32 tensor cores (3 passes each: 11.6 ms), the stage-1-sized
//    products on the CUDA cores, the F2 images streamed from L2 (6.8 MB a
//    block-column) and the partials' read-modify-writes.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "smem_cap.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 32;        // tokens per block
constexpr int kRW = 4;           // tokens per warp
constexpr int kNU = 13;          // vocabulary columns per lane: t2 <= 416
constexpr int kKT = 16;          // kj rows per F2 chunk (stage 2)
constexpr int kTT = 8;           // t columns per F2^T chunk (dz)
constexpr int kZU = 16;          // kj per lane per dz slab (512 kj)
constexpr int kSU = 16;          // kj per lane per stage-1 pass
constexpr int kVX = 16;          // i per lane per dx / dF1 pass
constexpr float kNeg = -1e30f;
constexpr unsigned kFull = 0xffffffffu;
// staged floats per thread: an F2 chunk (stage 2) and an F2^T chunk (dz)
constexpr int kF2Ld = (kKT * 32 * kNU + kThreads - 1) / kThreads;
constexpr int kDzLd = kTT * 32 * kZU / kThreads;

struct Dims {
  int n, npad, r, q1, t1, q2, t2, vocab, kz, p, nu, t2p, splits;
};

// F2^T chunks are stored (kTT, slab + 4): the pad spreads the loader's
// 8 t columns x 4 kj rows of a warp over all 32 banks
__host__ __device__ inline int dz_stride(int kz) {
  return (kz < 32 * kZU ? kz : 32 * kZU) + 4;
}

__host__ __device__ inline int stage_floats(int kz, int t2p) {
  const int a = kKT * t2p;
  const int b = kTT * dz_stride(kz);
  return a > b ? a : b;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// the t1 columns [c0, c1) of split s
__device__ __forceinline__ void column_range(const Dims& d, int s, int& c0, int& c1) {
  const int per = (d.t1 + d.splits - 1) / d.splits;
  c0 = s * per;
  c1 = min(d.t1, c0 + per);
}

// f1c[k * q1 + i] = F1[k, i, c]
__device__ void load_f1_column(const float* __restrict__ f1, const Dims& d, int c,
                               float* f1c) {
  for (int e = threadIdx.x; e < d.r * d.q1; e += kThreads)
    f1c[e] = __ldg(f1 + static_cast<size_t>(e) * d.t1 + c);
}

// z[b * kz + kj] = sum_i f1c[k, i] x[row0 + b, i, j] with kj = k*q2 + j.
// Lane = kk*q2 + j (q2 divides 32), so kj = 32 u + lane and j is the same
// for every u: each x value is loaded once per (row, i).
__device__ void stage1(const float* __restrict__ x, int row0, const Dims& d,
                       const float* f1c, float* z) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int j = lane % d.q2, kk = lane / d.q2, kper = 32 / d.q2;
  const int nu = (d.kz + 31) / 32;
  for (int u0 = 0; u0 < nu; u0 += kSU) {
    float acc[kRW][kSU];
#pragma unroll
    for (int b = 0; b < kRW; ++b)
#pragma unroll
      for (int s = 0; s < kSU; ++s) acc[b][s] = 0.f;
#pragma unroll 4
    for (int i = 0; i < d.q1; ++i) {
      float xv[kRW];
#pragma unroll
      for (int b = 0; b < kRW; ++b) {
        const int row = row0 + warp * kRW + b;
        xv[b] = row < d.n ? __ldg(x + static_cast<size_t>(row) * d.p + i * d.q2 + j) : 0.f;
      }
#pragma unroll
      for (int s = 0; s < kSU; ++s) {
        const int k = (u0 + s) * kper + kk;
        const float f = k < d.r ? f1c[k * d.q1 + i] : 0.f;
#pragma unroll
        for (int b = 0; b < kRW; ++b) acc[b][s] = fmaf(xv[b], f, acc[b][s]);
      }
    }
#pragma unroll
    for (int s = 0; s < kSU; ++s) {
      const int kj = (u0 + s) * 32 + lane;
      if (kj < d.kz)
#pragma unroll
        for (int b = 0; b < kRW; ++b) z[(warp * kRW + b) * d.kz + kj] = acc[b][s];
    }
  }
}

// F2 rows [kj0, kj0 + kKT) as this thread's share of a (kKT, t2p) chunk
__device__ __forceinline__ void load_f2_rows(const float* __restrict__ f2, const Dims& d,
                                             int kj0, float (&pre)[kF2Ld]) {
  const int rows = min(kKT, d.kz - kj0);
#pragma unroll
  for (int it = 0; it < kF2Ld; ++it) {
    const int e = threadIdx.x + it * kThreads;
    const int kk = e / d.t2p, t = e - kk * d.t2p;
    pre[it] = (kk < rows && t < d.t2)
                  ? __ldg(f2 + static_cast<size_t>(kj0 + kk) * d.t2 + t) : 0.f;
  }
}

// acc[b][u] = logit of token warp*4 + b at column t = 32 u + lane of the
// current t1 column: z (in shared memory) times F2, streamed through
// `stage` in kKT-row chunks; the next chunk's loads are in flight while the
// current one is multiplied. Starts with a barrier (z complete, stage free).
__device__ void stage2(const float* __restrict__ f2, const Dims& d, const float* z,
                       float* stage, float (&acc)[kRW][kNU]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int b = 0; b < kRW; ++b)
#pragma unroll
    for (int u = 0; u < kNU; ++u) acc[b][u] = 0.f;
  float pre[kF2Ld];
  load_f2_rows(f2, d, 0, pre);
  for (int kj0 = 0; kj0 < d.kz; kj0 += kKT) {
    const int rows = min(kKT, d.kz - kj0);
    __syncthreads();
#pragma unroll
    for (int it = 0; it < kF2Ld; ++it) {
      const int e = threadIdx.x + it * kThreads;
      if (e < kKT * d.t2p) stage[e] = pre[it];
    }
    __syncthreads();
    if (kj0 + kKT < d.kz) load_f2_rows(f2, d, kj0 + kKT, pre);
    // the chunk's 16-deep sum apart from the running one: a 1,024-deep
    // sequential sum would lose about 16x more to rounding than the plain
    // version's rank-then-q2 contraction
    float part[kRW][kNU];
#pragma unroll
    for (int b = 0; b < kRW; ++b)
#pragma unroll
      for (int u = 0; u < kNU; ++u) part[b][u] = 0.f;
    for (int kk = 0; kk < rows; ++kk) {
      float zv[kRW];
#pragma unroll
      for (int b = 0; b < kRW; ++b) zv[b] = z[(warp * kRW + b) * d.kz + kj0 + kk];
      const float* srow = stage + kk * d.t2p + lane;
#pragma unroll
      for (int u = 0; u < kNU; ++u) {
        if (u < d.nu) {
          const float f = srow[u * 32];
#pragma unroll
          for (int b = 0; b < kRW; ++b) part[b][u] = fmaf(zv[b], f, part[b][u]);
        }
      }
    }
#pragma unroll
    for (int b = 0; b < kRW; ++b)
#pragma unroll
      for (int u = 0; u < kNU; ++u) acc[b][u] += part[b][u];
  }
}

// F2^T columns [t0, t0 + kTT) of kj rows [kb, kb + slab), this thread's share
__device__ __forceinline__ void load_f2t_cols(const float* __restrict__ f2, const Dims& d,
                                              int kb, int slab, int t0,
                                              float (&pre)[kDzLd]) {
#pragma unroll
  for (int it = 0; it < kDzLd; ++it) {
    const int e = threadIdx.x + it * kThreads;
    const int kk = e / kTT, tt = e % kTT;
    pre[it] = (kk < slab && t0 + tt < d.t2)
                  ? __ldg(f2 + static_cast<size_t>(kb + kk) * d.t2 + t0 + tt) : 0.f;
  }
}

__device__ __forceinline__ bool column_valid(const Dims& d, int col0, int u, int t) {
  return u < d.nu && t < d.t2 && col0 + t < d.vocab;
}

__global__ void __launch_bounds__(kThreads, 1)
ce_fwd_kernel(const float* __restrict__ x, const int32_t* __restrict__ labels,
              const float* __restrict__ f1, const float* __restrict__ f2, Dims d,
              float* __restrict__ m_part, float* __restrict__ l_part,
              float* __restrict__ y_part) {
  extern __shared__ float smem[];
  float* f1c = smem;
  float* z = f1c + d.r * d.q1;
  float* stage = z + kRows * d.kz;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = blockIdx.x * kRows;
  int c0, c1;
  column_range(d, blockIdx.y, c0, c1);

  float m[kRW], l[kRW], yl[kRW];
  int y[kRW];
#pragma unroll
  for (int b = 0; b < kRW; ++b) {
    const int row = row0 + warp * kRW + b;
    m[b] = kNeg;
    l[b] = 0.f;
    yl[b] = 0.f;
    y[b] = row < d.n ? labels[row] : -1;
  }
  for (int c = c0; c < c1; ++c) {
    __syncthreads();  // the previous column's readers of f1c and z are done
    load_f1_column(f1, d, c, f1c);
    __syncthreads();
    stage1(x, row0, d, f1c, z);
    float acc[kRW][kNU];
    stage2(f2, d, z, stage, acc);
    const int col0 = c * d.t2;
#pragma unroll
    for (int b = 0; b < kRW; ++b) {
      float mx = kNeg;
#pragma unroll
      for (int u = 0; u < kNU; ++u)
        if (column_valid(d, col0, u, u * 32 + lane)) mx = fmaxf(mx, acc[b][u]);
      const float m_new = fmaxf(m[b], warp_max(mx));
      float se = 0.f, pick = 0.f;
#pragma unroll
      for (int u = 0; u < kNU; ++u) {
        const int t = u * 32 + lane;
        if (column_valid(d, col0, u, t)) {
          se += expf(acc[b][u] - m_new);
          if (col0 + t == y[b]) pick = acc[b][u];
        }
      }
      se = warp_sum(se);
      pick = warp_sum(pick);
      l[b] = l[b] * expf(m[b] - m_new) + se;
      m[b] = m_new;
      if (y[b] >= col0 && y[b] < col0 + d.t2) yl[b] = pick;
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int b = 0; b < kRW; ++b) {
      const size_t idx = static_cast<size_t>(blockIdx.y) * d.npad + row0 + warp * kRW + b;
      m_part[idx] = m[b];
      l_part[idx] = l[b];
      y_part[idx] = yl[b];
    }
  }
}

// the log-sum-exp merge of the splits' partials, in split order
__global__ void ce_combine_kernel(const float* __restrict__ m_part,
                                  const float* __restrict__ l_part,
                                  const float* __restrict__ y_part, Dims d,
                                  float* __restrict__ loss, float* __restrict__ m_out,
                                  float* __restrict__ l_out) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= d.n) return;
  float M = kNeg;
  for (int s = 0; s < d.splits; ++s) M = fmaxf(M, m_part[static_cast<size_t>(s) * d.npad + row]);
  float L = 0.f, Y = 0.f;
  for (int s = 0; s < d.splits; ++s) {
    const size_t idx = static_cast<size_t>(s) * d.npad + row;
    L += l_part[idx] * expf(m_part[idx] - M);
    Y += y_part[idx];
  }
  loss[row] = M + logf(L) - Y;
  m_out[row] = M;
  l_out[row] = L;
}

__global__ void __launch_bounds__(kThreads, 1)
ce_bwd_kernel(const float* __restrict__ x, const int32_t* __restrict__ labels,
              const float* __restrict__ g, const float* __restrict__ m_in,
              const float* __restrict__ l_in, const float* __restrict__ f1,
              const float* __restrict__ f2, Dims d, float* __restrict__ df2_part,
              float* __restrict__ df1_part, float* __restrict__ dx_part) {
  extern __shared__ float smem[];
  float* f1c = smem;
  float* z = f1c + d.r * d.q1;             // z_c, then dz_c
  float* stage = z + kRows * d.kz;
  float* dl = stage + stage_floats(d.kz, d.t2p);  // [kRows][t2p]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tb = blockIdx.x, s = blockIdx.y;
  const int row0 = tb * kRows;
  int c0, c1;
  column_range(d, s, c0, c1);

  float* my_df2 = df2_part + static_cast<size_t>(tb * d.splits + s) * d.kz * d.t2;
  float* my_dx = dx_part + (static_cast<size_t>(s) * d.npad + row0) * d.p;
  float* my_df1 = df1_part + static_cast<size_t>(tb) * d.r * d.q1 * d.t1;
  for (size_t e = threadIdx.x; e < static_cast<size_t>(d.kz) * d.t2; e += kThreads)
    my_df2[e] = 0.f;
  for (size_t e = threadIdx.x; e < static_cast<size_t>(kRows) * d.p; e += kThreads)
    my_dx[e] = 0.f;

  float gv[kRW], mv[kRW], il[kRW];
  int y[kRW];
#pragma unroll
  for (int b = 0; b < kRW; ++b) {
    const int row = row0 + warp * kRW + b;
    const bool in = row < d.n;
    gv[b] = in ? g[row] : 0.f;  // padding rows push no gradient
    mv[b] = in ? m_in[row] : 0.f;
    il[b] = in ? 1.f / l_in[row] : 0.f;
    y[b] = in ? labels[row] : -1;
  }
  const int j = lane % d.q2, ii = lane / d.q2, iper = 32 / d.q2;
  const int nv = (d.q1 + iper - 1) / iper;  // i = ii + iper * v

  for (int c = c0; c < c1; ++c) {
    __syncthreads();
    load_f1_column(f1, d, c, f1c);
    __syncthreads();
    stage1(x, row0, d, f1c, z);
    float acc[kRW][kNU];
    stage2(f2, d, z, stage, acc);
    const int col0 = c * d.t2;
#pragma unroll
    for (int b = 0; b < kRW; ++b)
#pragma unroll
      for (int u = 0; u < kNU; ++u) {
        const int t = u * 32 + lane;
        float v = 0.f;
        if (column_valid(d, col0, u, t)) {
          const float p = expf(acc[b][u] - mv[b]) * il[b];
          v = gv[b] * (p - (col0 + t == y[b] ? 1.f : 0.f));
        }
        if (u < d.nu) dl[(warp * kRW + b) * d.t2p + t] = v;
      }
    __syncthreads();

    // dF2 partial += z_c^T dlogit_c: each warp owns groups of 4 kj rows
    for (int kj0 = warp * 4; kj0 < d.kz; kj0 += kWarps * 4) {
      float a[4][kNU];
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int u = 0; u < kNU; ++u) a[q][u] = 0.f;
      for (int b = 0; b < kRows; ++b) {
        float zv[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) zv[q] = kj0 + q < d.kz ? z[b * d.kz + kj0 + q] : 0.f;
        const float* drow = dl + b * d.t2p + lane;
#pragma unroll
        for (int u = 0; u < kNU; ++u) {
          if (u < d.nu) {
            const float dv = drow[u * 32];
#pragma unroll
            for (int q = 0; q < 4; ++q) a[q][u] = fmaf(zv[q], dv, a[q][u]);
          }
        }
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (kj0 + q >= d.kz) break;
        float* row = my_df2 + static_cast<size_t>(kj0 + q) * d.t2;
        float old[kNU];  // a row's loads in flight before its stores
#pragma unroll
        for (int u = 0; u < kNU; ++u) {
          const int t = u * 32 + lane;
          old[u] = (u < d.nu && t < d.t2) ? row[t] : 0.f;
        }
#pragma unroll
        for (int u = 0; u < kNU; ++u) {
          const int t = u * 32 + lane;
          if (u < d.nu && t < d.t2) row[t] = old[u] + a[q][u];
        }
      }
    }

    // dz_c = dlogit_c F2^T, into z (every reader of z_c is past the barrier
    // at the top of the first chunk)
    const int ds = dz_stride(d.kz);
    for (int kb = 0; kb < d.kz; kb += 32 * kZU) {
      const int slab = min(32 * kZU, d.kz - kb);
      float a[kRW][kZU];
#pragma unroll
      for (int b = 0; b < kRW; ++b)
#pragma unroll
        for (int w = 0; w < kZU; ++w) a[b][w] = 0.f;
      float pre[kDzLd];
      load_f2t_cols(f2, d, kb, slab, 0, pre);
      for (int t0 = 0; t0 < d.t2; t0 += kTT) {
        __syncthreads();
#pragma unroll
        for (int it = 0; it < kDzLd; ++it) {
          const int e = threadIdx.x + it * kThreads;
          const int kk = e / kTT, tt = e % kTT;
          if (kk < slab) stage[tt * ds + kk] = pre[it];
        }
        __syncthreads();
        if (t0 + kTT < d.t2) load_f2t_cols(f2, d, kb, slab, t0 + kTT, pre);
        float part[kRW][kZU];  // the chunk's sum apart, as in stage 2
#pragma unroll
        for (int b = 0; b < kRW; ++b)
#pragma unroll
          for (int w = 0; w < kZU; ++w) part[b][w] = 0.f;
#pragma unroll
        for (int tt = 0; tt < kTT; ++tt) {
          float dv[kRW];
#pragma unroll
          for (int b = 0; b < kRW; ++b) dv[b] = dl[(warp * kRW + b) * d.t2p + t0 + tt];
#pragma unroll
          for (int w = 0; w < kZU; ++w) {
            const int kk = w * 32 + lane;
            if (kk < slab) {
              const float f = stage[tt * ds + kk];
#pragma unroll
              for (int b = 0; b < kRW; ++b) part[b][w] = fmaf(dv[b], f, part[b][w]);
            }
          }
        }
#pragma unroll
        for (int b = 0; b < kRW; ++b)
#pragma unroll
          for (int w = 0; w < kZU; ++w) a[b][w] += part[b][w];
      }
#pragma unroll
      for (int w = 0; w < kZU; ++w) {
        const int kk = w * 32 + lane;
        if (kk < slab)
#pragma unroll
          for (int b = 0; b < kRW; ++b) z[(warp * kRW + b) * d.kz + kb + kk] = a[b][w];
      }
    }
    __syncthreads();

    // dx partial += sum_k F1[k, i, c] dz_c[b, k*q2 + j]; lane = ii*q2 + j, so
    // (i*q2 + j) = lane + 32 v and the read-modify-write is coalesced
    for (int v0 = 0; v0 < nv; v0 += kVX) {
      float a[kRW][kVX];
#pragma unroll
      for (int b = 0; b < kRW; ++b)
#pragma unroll
        for (int w = 0; w < kVX; ++w) a[b][w] = 0.f;
      for (int k = 0; k < d.r; ++k) {
        float dzv[kRW];
#pragma unroll
        for (int b = 0; b < kRW; ++b) dzv[b] = z[(warp * kRW + b) * d.kz + k * d.q2 + j];
#pragma unroll
        for (int w = 0; w < kVX; ++w) {
          const int i = ii + iper * (v0 + w);
          if (i < d.q1) {
            const float f = f1c[k * d.q1 + i];
#pragma unroll
            for (int b = 0; b < kRW; ++b) a[b][w] = fmaf(dzv[b], f, a[b][w]);
          }
        }
      }
#pragma unroll
      for (int b = 0; b < kRW; ++b) {
        float* row = my_dx + static_cast<size_t>(warp * kRW + b) * d.p + j;
        float old[kVX];  // a row's loads in flight before its stores
#pragma unroll
        for (int w = 0; w < kVX; ++w) {
          const int i = ii + iper * (v0 + w);
          old[w] = i < d.q1 ? row[i * d.q2] : 0.f;
        }
#pragma unroll
        for (int w = 0; w < kVX; ++w) {
          const int i = ii + iper * (v0 + w);
          if (i < d.q1) row[i * d.q2] = old[w] + a[b][w];
        }
      }
    }

    // dF1[k, i, c] for this token block = sum_{b, j} x[b, i, j] dz_c[b, k*q2 + j]:
    // each warp owns groups of 4 ranks; the sum over j is a shuffle across
    // the q2 lanes that share i
    for (int k0 = warp * 4; k0 < d.r; k0 += kWarps * 4) {
      for (int v0 = 0; v0 < nv; v0 += kVX) {
        float a[4][kVX];
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int w = 0; w < kVX; ++w) a[q][w] = 0.f;
#pragma unroll 2
        for (int b = 0; b < kRows && row0 + b < d.n; ++b) {
          float dzv[4];
#pragma unroll
          for (int q = 0; q < 4; ++q)
            dzv[q] = k0 + q < d.r ? z[b * d.kz + (k0 + q) * d.q2 + j] : 0.f;
          const float* xrow = x + static_cast<size_t>(row0 + b) * d.p;
#pragma unroll
          for (int w = 0; w < kVX; ++w) {
            const int i = ii + iper * (v0 + w);
            const float xv = i < d.q1 ? __ldg(xrow + i * d.q2 + j) : 0.f;
#pragma unroll
            for (int q = 0; q < 4; ++q) a[q][w] = fmaf(dzv[q], xv, a[q][w]);
          }
        }
        for (int o = d.q2 / 2; o > 0; o >>= 1)
#pragma unroll
          for (int q = 0; q < 4; ++q)
#pragma unroll
            for (int w = 0; w < kVX; ++w) a[q][w] += __shfl_xor_sync(kFull, a[q][w], o);
        if (j == 0) {
#pragma unroll
          for (int q = 0; q < 4; ++q)
#pragma unroll
            for (int w = 0; w < kVX; ++w) {
              const int i = ii + iper * (v0 + w);
              if (k0 + q < d.r && i < d.q1)
                my_df1[(static_cast<size_t>(k0 + q) * d.q1 + i) * d.t1 + c] = a[q][w];
            }
        }
      }
    }
  }
}

// out[e] = sum_p part[p * n + e], parts in order
__global__ void sum_parts_kernel(const float* __restrict__ part, int parts, long long n,
                                 float* __restrict__ out) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long e = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; e < n;
       e += stride) {
    float acc = 0.f;
    for (int p = 0; p < parts; ++p) acc += part[p * n + e];
    out[e] = acc;
  }
}

Dims make_dims(int n, int r, int q1, int t1, int q2, int t2, int vocab, int splits) {
  Dims d;
  d.n = n;
  d.npad = (n + kRows - 1) / kRows * kRows;
  d.r = r;
  d.q1 = q1;
  d.t1 = t1;
  d.q2 = q2;
  d.t2 = t2;
  d.vocab = vocab;
  d.kz = r * q2;
  d.p = q1 * q2;
  d.nu = (t2 + 31) / 32;
  d.t2p = 32 * d.nu;
  d.splits = splits;
  return d;
}

int sum_parts(const float* part, int parts, long long n, float* out, cudaStream_t st) {
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 132 * 16) blocks = 132 * 16;
  if (blocks < 1) blocks = 1;
  sum_parts_kernel<<<static_cast<int>(blocks), kThreads, 0, st>>>(part, parts, n, out);
  return static_cast<int>(cudaGetLastError());
}


// ---------------------------------------------------------------------------
// The backward on the tensor cores: ce_bwd_tc_kernel (see the header).

namespace tc {

constexpr int kT = 64;                   // tokens per block: one wgmma M
constexpr int kNH = 208;                 // t columns per half of stage 2
constexpr int kNW = kNH / 2;             // of which each consumer warpgroup takes 104
constexpr int kTP = 2 * kNH;             // 416: t2 padded
constexpr int kCR = 64;                  // rows of a kz chunk
constexpr int kKS1 = kCR / 8;            // stage-2 k-steps (8 kz rows each) per chunk
constexpr int kKS2 = kTP / 8;            // dz k-steps (8 t each) per chunk
constexpr int kSt2 = 2;                  // dz k-steps per pass-2 ring stage
constexpr int kStages2 = kKS2 / kSt2;    // pass-2 ring stages per chunk
// ring depths. The two consumer warpgroups take alternate pass-2 stages, so
// kNS2 is even: each warpgroup then owns kNS2 / 2 slots and waits on every
// phase of them. (With an odd depth a warpgroup's next use of a slot is two
// phases on, and a parity wait can pass on the phase before.)
constexpr int kNS1 = 4, kNS2 = 4;
static_assert(kNS2 % 2 == 0, "each consumer warpgroup owns its pass-2 slots");
constexpr int kThreads = 384, kConsumers = 256;
constexpr int kTile1 = kNH * 32;         // a 208-row tile of 8 tf32 (32-byte rows)
constexpr int kStage1 = 2 * kTile1;      // its hi and lo halves
constexpr int kTile2 = kCR * 32;         // a 64-row tile of 8 tf32
constexpr int kStage2 = kSt2 * 2 * kTile2;
constexpr int kZTiles = kT / 8;          // token k-steps of the z operand of dF2^T
constexpr int kDLS = 420;                // logits / dlogit row stride (floats)
constexpr int kZS = 68;                  // z / dz row stride (floats)
constexpr int kXMax = 8192;              // floats of a staged x chunk
// Byte offsets from the 1024-aligned base of shared memory. The logits of
// the column are summed chunk by chunk in dl and become dlogit there; pass
// 1 and pass 2 use the region after dl in turn.
constexpr int kOffDl = 0;                             // [kT][kDLS]
constexpr int kOffRing1 = kT * kDLS * 4;              // pass 1: F2^T ring
constexpr int kOffZ = kOffRing1 + kNS1 * kStage1;     // pass 1: z chunk [kT][kZS]
constexpr int kPass1End = kOffZ + kT * kZS * 4;
constexpr int kOffRing2 = kOffRing1;                  // pass 2: F2 ring
constexpr int kOffZt = kOffRing2 + kNS2 * kStage2;    // pass 2: z tiles, then dz [kT][kZS]
constexpr int kOffDf1 = kOffZt + kZTiles * 2 * kTile2;  // pass 2: dF1 sums [r][qp]
constexpr int kBars = 2 * kNS1 + 2 * kNS2 + 2;
static_assert(kT * kZS * 4 <= kZTiles * 2 * kTile2, "dz fits where the z tiles were");
static_assert(kOffRing1 % 1024 == 0 && kOffZt % 1024 == 0, "tiles on the swizzle repeat");

struct Dims {
  int n, npad, r, q1, t1, q2, t2, vocab, splits;
  int qp, rp;       // q1 and r rounded up to 4
  int jcm, kcm, nk;  // j per chunk, k per chunk, k groups per j group
  int nch, kzp;     // chunks, nch * kCR
};

// A chunk: the (j, k) pairs j0 <= j < j0 + jc, k0 <= k < k0 + kc of kz,
// at chunk rows jj * kcp + kk (kcp = kc rounded up to 4); other rows are 0.
struct Chunk {
  int j0, jc, k0, kc, kcp;
};

__host__ __device__ inline Chunk chunk_of(const Dims& d, int ch) {
  Chunk c;
  c.j0 = (ch / d.nk) * d.jcm;
  c.k0 = (ch % d.nk) * d.kcm;
  c.jc = d.q2 - c.j0 < d.jcm ? d.q2 - c.j0 : d.jcm;
  c.kc = d.r - c.k0 < d.kcm ? d.r - c.k0 : d.kcm;
  c.kcp = (c.kc + 3) & ~3;
  return c;
}

// the kz index k*q2 + j of chunk row `row`, or -1 for a padding row
__host__ __device__ inline int chunk_kz(const Dims& d, const Chunk& c, int row) {
  const int jj = row / c.kcp, kk = row % c.kcp;
  return jj < c.jc && kk < c.kc ? (c.k0 + kk) * d.q2 + c.j0 + jj : -1;
}

// after the two passes' region: the x chunk [jc][kT][qp], then the F1
// column as [q1][rp] and [r][qp], then the barriers
__host__ __device__ inline int x_offset(const Dims& d) {
  const int df1_end = kOffDf1 + 4 * d.r * d.qp;
  return ((df1_end > kPass1End ? df1_end : kPass1End) + 15) / 16 * 16;
}

__host__ __device__ inline int f1_offset(const Dims& d) { return x_offset(d) + kXMax * 4; }

__host__ __device__ inline int bars_offset(const Dims& d) {
  return f1_offset(d) + (4 * (d.q1 * d.rp + d.r * d.qp) + 7) / 8 * 8;
}

inline long long smem_bytes(const Dims& d) {
  return bars_offset(d) + 8LL * kBars + 1024;  // + the alignment of the base
}

// (jcm, kcm): chunk geometry chosen by the wrapper; 0 when the shape does not fit
Dims make_dims(int n, int r, int q1, int t1, int q2, int t2, int vocab, int splits, int jcm,
               int kcm) {
  Dims d;
  d.n = n;
  d.npad = (n + kT - 1) / kT * kT;
  d.r = r;
  d.q1 = q1;
  d.t1 = t1;
  d.q2 = q2;
  d.t2 = t2;
  d.vocab = vocab;
  d.splits = splits;
  d.qp = (q1 + 3) & ~3;
  d.rp = (r + 3) & ~3;
  d.jcm = jcm;
  d.kcm = kcm;
  d.nk = (r + kcm - 1) / kcm;
  d.nch = (q2 + jcm - 1) / jcm * d.nk;
  d.kzp = d.nch * kCR;
  return d;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// wait until the phase of parity `parity` has completed; a wait of more than
// 2^35 cycles (about 17 s at 1.98 GHz) traps, so a broken handshake fails the
// launch instead of holding the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  const long long t0 = clock64();
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (!done && clock64() - t0 > (1LL << 35)) __trap();
  } while (!done);
}

// a contiguous run of global memory into shared memory by the TMA's bulk copy,
// completing on `bar`
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// generic-proxy accesses of shared memory ordered before later async-proxy
// ones (TMA writes, wgmma reads)
__device__ __forceinline__ void fence_async_proxy() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// the 256 consumer threads only (the producer warpgroup has left)
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}

// byte offset of element (row, k) of a tile of 32-byte rows (8 tf32) under
// the 32-byte swizzle: a row's two 16-byte halves swap where row bit 2 is set
__host__ __device__ __forceinline__ uint32_t sw32(int row, int k) {
  return row * 32 + ((((k >> 2) ^ (row >> 2)) & 1) << 4) + (k & 3) * 4;
}

// wgmma's K-major shared-memory descriptor of such a tile: 8-row groups 256
// bytes apart, 32-byte swizzle (layout code 3), leading offset unused
__device__ __forceinline__ uint64_t desc_sw32(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | static_cast<uint64_t>(1) << 16 |
         static_cast<uint64_t>(256 >> 4) << 32 | static_cast<uint64_t>(3) << 62;
}

// x rounded to tf32 (10 mantissa bits, to nearest), as the bits of an fp32
__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// the 3xTF32 split: x = hi + lo up to 2^-22 |x|, both tf32
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keep the compiler from moving reads or writes of wgmma's accumulators
// across the asynchronous window
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// The A operand of one m64nNk8 step from an fp32 tile in shared memory,
// element (row, col) at src[row * rs + col * cs], split into tf32 hi and lo.
// Register a0 holds (r, q), a1 (r + 8, q), a2 (r, q + 4), a3 (r + 8, q + 4)
// with r = 16 warp + lane / 4 and q = lane % 4; rows at or past `rows` are 0.
__device__ __forceinline__ void a_frag(const float* src, int rs, int cs, int r, int q, int rows,
                                       uint32_t (&hi)[4], uint32_t (&lo)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int row = r + 8 * (e & 1), col = q + 4 * (e >> 1);
    const float v = row < rows ? src[row * rs + col * cs] : 0.f;
    split_tf32(v, hi[e], lo[e]);
  }
}

// d (64 x 104, fp32) = A (64 x 8, tf32 in registers) B (from shared memory), plus d
// itself when `accumulate` is nonzero
__device__ __forceinline__ void wgmma_n104(float (&d)[52], const uint32_t (&a)[4],
                                          uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %57, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n104k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, "
      "%42, %43, %44, %45, %46, %47, %48, %49, %50, %51}, "
      "{%52, %53, %54, %55}, %56, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// d (64 x 64, fp32) = A (64 x 8, tf32 in registers) B (from shared memory), plus d
// itself when `accumulate` is nonzero
__device__ __forceinline__ void wgmma_n64(float (&d)[32], const uint32_t (&a)[4],
                                          uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// d (64 x 32, fp32) = A (64 x 8, tf32 in registers) B (from shared memory), plus d
// itself when `accumulate` is nonzero
__device__ __forceinline__ void wgmma_n32(float (&d)[16], const uint32_t (&a)[4],
                                          uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// The two streamed images of F2, split into tf32 hi and lo and laid out as
// the ring stages land in shared memory (32-byte swizzled tiles):
//  * img1, stage 2's B operand: per chunk, half of t (rows 208 h..) and
//    k-step (8 kz rows of the chunk), a (208 rows t) x (8 kz) tile of
//    F2^T, hi then lo;
//  * img2, dz's B operand: per chunk and stage, kSt2 (kCR rows of the chunk)
//    x (8 t) tiles of F2, each hi then lo.
// Rows past t2 and padding rows of a chunk are 0.
__global__ void prep_f2_kernel(const float* __restrict__ f2, Dims d, uint8_t* __restrict__ img1,
                               uint8_t* __restrict__ img2) {
  const long long total = static_cast<long long>(d.kzp) * kTP;
  for (long long e = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; e < total;
       e += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int kzi = static_cast<int>(e / kTP), t = static_cast<int>(e % kTP);
    const int ch = kzi / kCR, row = kzi % kCR;
    const int kz = chunk_kz(d, chunk_of(d, ch), row);
    const float v = kz >= 0 && t < d.t2 ? f2[static_cast<size_t>(kz) * d.t2 + t] : 0.f;
    uint32_t hi, lo;
    split_tf32(v, hi, lo);
    const int h = t / kNH, th = t - h * kNH;
    uint8_t* s1 = img1 + ((static_cast<size_t>(ch) * 2 + h) * kKS1 + row / 8) * kStage1;
    *reinterpret_cast<uint32_t*>(s1 + sw32(th, kzi & 7)) = hi;
    *reinterpret_cast<uint32_t*>(s1 + kTile1 + sw32(th, kzi & 7)) = lo;
    const int ks = t / 8;
    uint8_t* s2 = img2 + (static_cast<size_t>(ch) * kStages2 + ks / kSt2) * kStage2 +
                  (ks % kSt2) * 2 * kTile2;
    *reinterpret_cast<uint32_t*>(s2 + sw32(row, t & 7)) = hi;
    *reinterpret_cast<uint32_t*>(s2 + kTile2 + sw32(row, t & 7)) = lo;
  }
}

// xt[b, j, i] = x[b, i, j] for b < n, 0 up to npad: one block per token
__global__ void transpose_x_kernel(const float* __restrict__ x, Dims d, float* __restrict__ xt) {
  const int b = blockIdx.x, P = d.q1 * d.q2;
  for (int e = threadIdx.x; e < P; e += blockDim.x) {
    const int j = e / d.q1, i = e - j * d.q1;
    xt[static_cast<size_t>(b) * P + e] =
        b < d.n ? __ldg(x + static_cast<size_t>(b) * P + i * d.q2 + j) : 0.f;
  }
}

// xs[jj][b][i] = x[row0 + b, i, j0 + jj] for the chunk's j, 0 for i >= q1;
// eight 16-byte loads a thread in flight before their stores
__device__ void stage_x(const float* __restrict__ xt, int row0, const Dims& d, const Chunk& c,
                        float* xs, int ct) {
  constexpr int kBatch = 8;
  const int per = d.qp / 4;
  const int total = c.jc * kT * per;
  for (int e0 = ct; e0 < total; e0 += kBatch * kConsumers) {
    float4 v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int e = e0 + u * kConsumers;
      v[u] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (e < total) {
        const int jb = e / per, i = 4 * (e - jb * per);
        const int jj = jb / kT, b = jb - jj * kT;
        const float* src = xt + (static_cast<size_t>(row0 + b) * d.q2 + c.j0 + jj) * d.q1;
        if (d.q1 % 4 == 0)
          v[u] = __ldg(reinterpret_cast<const float4*>(src + i));
        else
          v[u] = make_float4(i < d.q1 ? src[i] : 0.f, i + 1 < d.q1 ? src[i + 1] : 0.f,
                             i + 2 < d.q1 ? src[i + 2] : 0.f, i + 3 < d.q1 ? src[i + 3] : 0.f);
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int e = e0 + u * kConsumers;
      if (e < total) *reinterpret_cast<float4*>(xs + 4 * static_cast<size_t>(e)) = v[u];
    }
  }
}

// Stage 1 of a chunk on the CUDA cores: z[b, row] = sum_i x[b, i, j] F1[k, i, c]
// for chunk row (j, k), 0 for padding rows. Thread: rows 4 rg.. (one j, as
// kcp is a multiple of 4) x tokens 4 tq... kTiles: written as the hi / lo
// tiles of dF2^T's B operand (rows: chunk rows, K: tokens); otherwise fp32
// [kT][kZS], the A operand of stage 2.
template <bool kTiles>
__device__ void stage1(const Dims& d, const Chunk& c, const float* xs, const float* f1t,
                       float* zs, uint8_t* zt, int ct) {
  const int rg = ct & 15, tq = ct >> 4;
  const int row = 4 * rg;
  const int jj = row / c.kcp, kk = row - jj * c.kcp;
  float acc[4][4];
#pragma unroll
  for (int b = 0; b < 4; ++b)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[b][e] = 0.f;
  if (jj < c.jc && kk < c.kc) {
    const float* xb = xs + static_cast<size_t>(jj * kT + 4 * tq) * d.qp;
    const float* fb = f1t + c.k0 + kk;
#pragma unroll 2
    for (int i = 0; i < d.qp; i += 4) {
      float4 xv[4], fv[4];
#pragma unroll
      for (int b = 0; b < 4; ++b) xv[b] = *reinterpret_cast<const float4*>(xb + b * d.qp + i);
#pragma unroll
      for (int u = 0; u < 4; ++u) fv[u] = *reinterpret_cast<const float4*>(fb + (i + u) * d.rp);
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const float xu[4] = {xv[b].x, xv[b].y, xv[b].z, xv[b].w};
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          acc[b][0] = fmaf(xu[u], fv[u].x, acc[b][0]);
          acc[b][1] = fmaf(xu[u], fv[u].y, acc[b][1]);
          acc[b][2] = fmaf(xu[u], fv[u].z, acc[b][2]);
          acc[b][3] = fmaf(xu[u], fv[u].w, acc[b][3]);
        }
      }
    }
  }
#pragma unroll
  for (int e = 0; e < 4; ++e)
    if (jj >= c.jc || kk + e >= c.kc)
#pragma unroll
      for (int b = 0; b < 4; ++b) acc[b][e] = 0.f;
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    const int tok = 4 * tq + b;
    if constexpr (kTiles) {
      uint8_t* tile = zt + (tok / 8) * 2 * kTile2;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        uint32_t hi, lo;
        split_tf32(acc[b][e], hi, lo);
        *reinterpret_cast<uint32_t*>(tile + sw32(row + e, tok & 7)) = hi;
        *reinterpret_cast<uint32_t*>(tile + kTile2 + sw32(row + e, tok & 7)) = lo;
      }
    } else {
      *reinterpret_cast<float4*>(zs + tok * kZS + row) =
          make_float4(acc[b][0], acc[b][1], acc[b][2], acc[b][3]);
    }
  }
}

// dx[row0 + b, i, j] += sum_k F1[k, i, c] dz[b, (j, k)] over the chunk's pairs,
// into this split's (npad, q2, qp) partial; thread tiles of 4 tokens x 4 i
__device__ void dx_chunk(const Dims& d, const Chunk& c, const float* dzs, const float* f1k,
                         float* my_dx, int ct) {
  const int niq = d.qp / 4;
  const int tiles = c.jc * (kT / 4) * niq;
  for (int tile = ct; tile < tiles; tile += kConsumers) {
    const int iq = tile % niq, bq = (tile / niq) % (kT / 4), jj = tile / (niq * (kT / 4));
    float4 a[4];
#pragma unroll
    for (int b = 0; b < 4; ++b) a[b] = make_float4(0.f, 0.f, 0.f, 0.f);
    const float* dzb = dzs + 4 * bq * kZS + jj * c.kcp;
    const float* fb = f1k + static_cast<size_t>(c.k0) * d.qp + 4 * iq;
#pragma unroll 4
    for (int kk = 0; kk < c.kc; ++kk) {
      const float4 f = *reinterpret_cast<const float4*>(fb + kk * d.qp);
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const float z = dzb[b * kZS + kk];
        a[b].x = fmaf(z, f.x, a[b].x);
        a[b].y = fmaf(z, f.y, a[b].y);
        a[b].z = fmaf(z, f.z, a[b].z);
        a[b].w = fmaf(z, f.w, a[b].w);
      }
    }
    float4 old[4];
    float4* dst[4];
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      dst[b] = reinterpret_cast<float4*>(
          my_dx + (static_cast<size_t>(4 * bq + b) * d.q2 + c.j0 + jj) * d.qp + 4 * iq);
      old[b] = *dst[b];
    }
#pragma unroll
    for (int b = 0; b < 4; ++b)
      *dst[b] = make_float4(old[b].x + a[b].x, old[b].y + a[b].y, old[b].z + a[b].z,
                            old[b].w + a[b].w);
  }
}

// dF1 sums of the column: df1s[k][i] += sum_{j, b} x[b, i, j] dz[b, (j, k)] over
// the chunk's pairs; thread tiles of 2 k x 4 i
__device__ void df1_chunk(const Dims& d, const Chunk& c, const float* dzs, const float* xs,
                          float* df1s, int ct) {
  const int niq = d.qp / 4;
  const int tiles = (c.kc + 1) / 2 * niq;
  for (int tile = ct; tile < tiles; tile += kConsumers) {
    const int iq = tile % niq, kk = 2 * (tile / niq);
    float4 a0 = make_float4(0.f, 0.f, 0.f, 0.f), a1 = a0;
    for (int jj = 0; jj < c.jc; ++jj) {
      const float* xb = xs + static_cast<size_t>(jj * kT) * d.qp + 4 * iq;
      const float* zb = dzs + jj * c.kcp + kk;  // kk + 1 < kcp: a padding row reads 0
#pragma unroll 4
      for (int b = 0; b < kT; ++b) {
        const float4 xv = *reinterpret_cast<const float4*>(xb + b * d.qp);
        const float z0 = zb[b * kZS], z1 = zb[b * kZS + 1];
        a0.x = fmaf(z0, xv.x, a0.x);
        a0.y = fmaf(z0, xv.y, a0.y);
        a0.z = fmaf(z0, xv.z, a0.z);
        a0.w = fmaf(z0, xv.w, a0.w);
        a1.x = fmaf(z1, xv.x, a1.x);
        a1.y = fmaf(z1, xv.y, a1.y);
        a1.z = fmaf(z1, xv.z, a1.z);
        a1.w = fmaf(z1, xv.w, a1.w);
      }
    }
    float4* r0 = reinterpret_cast<float4*>(df1s + static_cast<size_t>(c.k0 + kk) * d.qp + 4 * iq);
    const float4 o0 = *r0;
    *r0 = make_float4(o0.x + a0.x, o0.y + a0.y, o0.z + a0.z, o0.w + a0.w);
    if (kk + 1 < c.kc) {
      float4* r1 = r0 + d.qp / 4;
      const float4 o1 = *r1;
      *r1 = make_float4(o1.x + a1.x, o1.y + a1.y, o1.z + a1.z, o1.w + a1.w);
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1)
ce_bwd_tc_kernel(const float* __restrict__ xt, const int32_t* __restrict__ labels,
                 const float* __restrict__ g, const float* __restrict__ m_in,
                 const float* __restrict__ l_in, const float* __restrict__ f1,
                 const uint8_t* __restrict__ img1, const uint8_t* __restrict__ img2, Dims d,
                 float* __restrict__ df2_part, float* __restrict__ df1_part,
                 float* __restrict__ dx_part) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sbase = (smem_addr(smem_raw) + 1023) & ~1023u;
  uint8_t* base = smem_raw + (sbase - smem_addr(smem_raw));
  float* zs = reinterpret_cast<float*>(base + kOffZ);
  float* dl = reinterpret_cast<float*>(base + kOffDl);
  uint8_t* zt = base + kOffZt;
  float* dzs = reinterpret_cast<float*>(base + kOffZt);
  float* df1s = reinterpret_cast<float*>(base + kOffDf1);
  float* xs = reinterpret_cast<float*>(base + x_offset(d));
  float* f1t = reinterpret_cast<float*>(base + f1_offset(d));  // [q1][rp]
  float* f1k = f1t + d.q1 * d.rp;                               // [r][qp]
  const uint32_t bars = sbase + bars_offset(d);
  const auto full1 = [&](int s) { return bars + 8 * s; };
  const auto empty1 = [&](int s) { return bars + 8 * (kNS1 + s); };
  const auto full2 = [&](int s) { return bars + 8 * (2 * kNS1 + s); };
  const auto empty2 = [&](int s) { return bars + 8 * (2 * kNS1 + kNS2 + s); };
  const uint32_t p1done = bars + 8 * (2 * kNS1 + 2 * kNS2);
  const uint32_t p2done = p1done + 8;

  const int tb = blockIdx.x, sp = blockIdx.y, row0 = tb * kT;
  const int per = (d.t1 + d.splits - 1) / d.splits;
  const int c0 = sp * per, c1 = min(d.t1, c0 + per);
  const int n1 = d.nch * kKS1, n2 = d.nch * kStages2;  // ring stages per column

  if (threadIdx.x == 0) {
    for (int s = 0; s < kNS1; ++s) {
      mbar_init(full1(s), 1);
      mbar_init(empty1(s), kConsumers);  // both warpgroups read every pass-1 stage
    }
    for (int s = 0; s < kNS2; ++s) {
      mbar_init(full2(s), 1);
      mbar_init(empty2(s), kConsumers / 2);  // one warpgroup reads a pass-2 stage
    }
    mbar_init(p1done, 1);
    mbar_init(p2done, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // the producer warpgroup: one thread issues every copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x != 0) return;
    uint32_t it1 = 0, it2 = 0;
    for (int c = c0, ci = 0; c < c1; ++c, ++ci) {
      if (ci > 0) mbar_wait(p2done, (ci - 1) & 1);  // the column before has left the region
      for (int gk = 0; gk < 2 * n1; ++gk, ++it1) {  // both halves of t
        const int s = it1 % kNS1;
        mbar_wait(empty1(s), ((it1 / kNS1) & 1) ^ 1);  // the first round passes at once
        mbar_expect_tx(full1(s), kStage1);
        bulk_load(sbase + kOffRing1 + s * kStage1, img1 + static_cast<size_t>(gk) * kStage1,
                  kStage1, full1(s));
      }
      mbar_wait(p1done, ci & 1);  // pass 1 has left the region
      for (int gs = 0; gs < n2; ++gs, ++it2) {
        const int s = it2 % kNS2;
        mbar_wait(empty2(s), ((it2 / kNS2) & 1) ^ 1);
        mbar_expect_tx(full2(s), kStage2);
        bulk_load(sbase + kOffRing2 + s * kStage2, img2 + static_cast<size_t>(gs) * kStage2,
                  kStage2, full2(s));
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const int ct = threadIdx.x - 128;  // consumer thread
  const int wg = ct >> 7, warp = (ct >> 5) & 3, lane = ct & 31;
  const int qd = lane & 3, r_lo = 16 * warp + (lane >> 2);  // accumulator rows r_lo, r_lo + 8

  float gv[2], mv[2], il[2];
  int yv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + r_lo + 8 * h;
    const bool in = row < d.n;
    gv[h] = in ? g[row] : 0.f;  // padding rows push no gradient
    mv[h] = in ? m_in[row] : 0.f;
    il[h] = in ? 1.f / l_in[row] : 0.f;
    yv[h] = in ? labels[row] : -1;
  }

  float* my_df2 = df2_part + static_cast<size_t>(tb * d.splits + sp) * d.t2 * d.kzp;
  float* my_dx = dx_part + (static_cast<size_t>(sp) * d.npad + row0) * d.q2 * d.qp;
  float* my_df1 = df1_part + static_cast<size_t>(tb) * d.r * d.q1 * d.t1;
  for (size_t e = ct; e < static_cast<size_t>(d.t2) * d.kzp; e += kConsumers) my_df2[e] = 0.f;
  for (size_t e = ct; e < static_cast<size_t>(kT) * d.q2 * d.qp; e += kConsumers) my_dx[e] = 0.f;
  for (int e = ct; e < d.q1 * d.rp + d.r * d.qp; e += kConsumers) f1t[e] = 0.f;  // pads stay 0

  uint32_t it1 = 0, it2 = 0;
  const int nmt = (d.t2 + 63) / 64;  // 64-row tiles of t in dF2^T
  for (int c = c0, ci = 0; c < c1; ++c, ++ci) {
    consumer_sync();  // the column before has read the F1 column and its dF1 sums
    for (int e = ct; e < d.r * d.q1; e += kConsumers) {
      const int k = e / d.q1, i = e - k * d.q1;
      const float v = __ldg(f1 + static_cast<size_t>(e) * d.t1 + c);
      f1t[i * d.rp + k] = v;
      f1k[k * d.qp + i] = v;
    }

    // pass 1: the logits of this column. Per chunk, stage 1 once, then each
    // half of t in turn, 64 tokens x 104 t per warpgroup. The tensor cores sum
    // in fp32 with truncation toward 0, which over 384 chained products biases
    // a logit by about 1e-5 of its size; so each k-step's three products start
    // from 0 and are added in fp32, rounding to nearest, to the chunk's sums,
    // and those to the logits in dl (16 adds at the logit's size, not 128)
    for (int ch = 0; ch < d.nch; ++ch) {
      const Chunk cc = chunk_of(d, ch);
      consumer_sync();  // the x chunk and z before are read
      stage_x(xt, row0, d, cc, xs, ct);
      consumer_sync();
      stage1<false>(d, cc, xs, f1t, zs, nullptr, ct);
      consumer_sync();
      for (int half = 0; half < 2; ++half) {
        float* mine = dl + half * kNH + wg * kNW + 2 * qd;  // + row * kDLS + 8 j
        float run[52] = {}, part[52] = {};
        for (int ks = 0; ks < kKS1; ++ks, ++it1) {
          const int s = it1 % kNS1;
          uint32_t ah[4], al[4];
          a_frag(zs + ks * 8, kZS, 1, r_lo, qd, kT, ah, al);
          mbar_wait(full1(s), (it1 / kNS1) & 1);
          const uint32_t b = sbase + kOffRing1 + s * kStage1 + wg * kNW * 32;
          fence_regs(part);
          wgmma_fence();
          wgmma_n104(part, ah, desc_sw32(b + kTile1), 0);
          wgmma_n104(part, al, desc_sw32(b), 1);
          wgmma_n104(part, ah, desc_sw32(b), 1);
          wgmma_commit();
          wgmma_wait_all();
          fence_regs(part);
          mbar_arrive(empty1(s));
#pragma unroll
          for (int e = 0; e < 52; ++e) run[e] += part[e];
        }
#pragma unroll
        for (int j = 0; j < kNW / 8; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float2* p = reinterpret_cast<float2*>(mine + (r_lo + 8 * h) * kDLS + 8 * j);
            float2 v = make_float2(run[4 * j + 2 * h], run[4 * j + 2 * h + 1]);
            if (ch > 0) {
              const float2 o = *p;
              v = make_float2(o.x + v.x, o.y + v.y);
            }
            *p = v;
          }
      }
    }

    // dlogit = g (softmax - onehot), 0 past t2 or the vocabulary, in place of
    // the logits (each thread rewrites the entries it summed)
    const int col0 = c * d.t2;
#pragma unroll 2
    for (int j = 0; j < kTP / 16; ++j)  // the thread's 8-column groups of both halves
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int t = (j / (kNW / 8)) * kNH + wg * kNW + 8 * (j % (kNW / 8)) + 2 * qd;
        float2* p = reinterpret_cast<float2*>(dl + (r_lo + 8 * h) * kDLS + t);
        const float2 lg = *p;
        float v[2] = {lg.x, lg.y};
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float logit = v[e];
          v[e] = 0.f;
          if (t + e < d.t2 && col0 + t + e < d.vocab) {
            const float pr = expf(logit - mv[h]) * il[h];
            v[e] = gv[h] * (pr - (col0 + t + e == yv[h] ? 1.f : 0.f));
          }
        }
        *p = make_float2(v[0], v[1]);
      }
    fence_async_proxy();  // z's accesses before the TMA reuses its region
    consumer_sync();
    if (ct == 0) mbar_arrive(p1done);
    for (int e = ct; e < d.r * d.qp; e += kConsumers) df1s[e] = 0.f;  // where z was

    // pass 2, per chunk: dF2^T += dlogit^T z, dz = dlogit F2^T, then dx and dF1
    for (int ch = 0; ch < d.nch; ++ch) {
      const Chunk cc = chunk_of(d, ch);
      consumer_sync();  // the chunk before has read xs and dz
      stage_x(xt, row0, d, cc, xs, ct);
      consumer_sync();
      stage1<true>(d, cc, xs, f1t, nullptr, zt, ct);
      fence_async_proxy();
      consumer_sync();

      // dF2^T: t rows in 64-row tiles, this warpgroup's 32 chunk rows; each
      // tile's partial sums are loaded while the tile before is computed
      const auto load_df2 = [&](int mt, float2 (&v)[8]) {
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int t = mt * 64 + r_lo + 8 * (e & 1);
          const int col = ch * kCR + 32 * wg + 8 * (e >> 1) + 2 * qd;
          v[e] = t < d.t2 ? *reinterpret_cast<const float2*>(
                                my_df2 + static_cast<size_t>(t) * d.kzp + col)
                          : make_float2(0.f, 0.f);
        }
      };
      float2 old[8], next[8] = {};
      load_df2(0, old);
      for (int mt = 0; mt < nmt; ++mt) {
        // two sums of four token k-steps each, added in fp32 below; in each
        // the hi.lo and lo.hi terms come first, while the sum is small
        float a16[16] = {}, b16[16] = {};
        uint32_t ah[kZTiles][4], al[kZTiles][4];
#pragma unroll
        for (int s = 0; s < kZTiles; ++s)
          a_frag(dl + s * 8 * kDLS + mt * 64, 1, kDLS, r_lo, qd, kTP - mt * 64, ah[s], al[s]);
        fence_regs(a16);
        fence_regs(b16);
        wgmma_fence();
#pragma unroll
        for (int s = 0; s < kZTiles; ++s) {
          const uint32_t b = sbase + kOffZt + s * 2 * kTile2 + wg * 32 * 32;
          float (&acc)[16] = s < kZTiles / 2 ? a16 : b16;
          wgmma_n32(acc, ah[s], desc_sw32(b + kTile2), s % (kZTiles / 2) > 0);
          wgmma_n32(acc, al[s], desc_sw32(b), 1);
        }
#pragma unroll
        for (int s = 0; s < kZTiles; ++s) {
          const uint32_t b = sbase + kOffZt + s * 2 * kTile2 + wg * 32 * 32;
          wgmma_n32(s < kZTiles / 2 ? a16 : b16, ah[s], desc_sw32(b), 1);
        }
        wgmma_commit();
        if (mt + 1 < nmt) load_df2(mt + 1, next);
        wgmma_wait_all();
        fence_regs(a16);
        fence_regs(b16);
#pragma unroll
        for (int e = 0; e < 16; ++e) a16[e] += b16[e];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int t = mt * 64 + r_lo + 8 * (e & 1);
          const int j = e >> 1, h = e & 1;
          const int col = ch * kCR + 32 * wg + 8 * j + 2 * qd;
          if (t < d.t2)
            *reinterpret_cast<float2*>(my_df2 + static_cast<size_t>(t) * d.kzp + col) =
                make_float2(old[e].x + a16[4 * j + 2 * h], old[e].y + a16[4 * j + 2 * h + 1]);
          old[e] = next[e];
        }
      }

      // dz: warpgroup wg takes the stages st = wg, wg + 2, ... of the chunk;
      // each k-step's product starts from 0 and is added to a32 in fp32
      float a32[32] = {}, part[kSt2][32] = {};
      for (int st = 0; st < kStages2; ++st, ++it2) {
        if ((st & 1) != wg) continue;
        const int s = it2 % kNS2;
        uint32_t ah[kSt2][4], al[kSt2][4];
#pragma unroll
        for (int u = 0; u < kSt2; ++u)
          a_frag(dl + (st * kSt2 + u) * 8, kDLS, 1, r_lo, qd, kT, ah[u], al[u]);
        mbar_wait(full2(s), (it2 / kNS2) & 1);
#pragma unroll
        for (int u = 0; u < kSt2; ++u) fence_regs(part[u]);
        wgmma_fence();
#pragma unroll
        for (int u = 0; u < kSt2; ++u) {  // the small terms first
          const uint32_t b = sbase + kOffRing2 + s * kStage2 + u * 2 * kTile2;
          wgmma_n64(part[u], ah[u], desc_sw32(b + kTile2), 0);
          wgmma_n64(part[u], al[u], desc_sw32(b), 1);
          wgmma_n64(part[u], ah[u], desc_sw32(b), 1);
        }
        wgmma_commit();
        wgmma_wait_all();
#pragma unroll
        for (int u = 0; u < kSt2; ++u) fence_regs(part[u]);
        mbar_arrive(empty2(s));
#pragma unroll
        for (int u = 0; u < kSt2; ++u)
#pragma unroll
          for (int e = 0; e < 32; ++e) a32[e] += part[u][e];
      }
      consumer_sync();  // every read of the z tiles is done: dz takes their place
      // dz = (even stages) + (odd stages), in that order
#pragma unroll
      for (int w = 1; w >= 0; --w) {
        if (wg == w) {
#pragma unroll
          for (int e = 0; e < 16; ++e) {
            const int j = e >> 1, h = e & 1;
            float2* p = reinterpret_cast<float2*>(dzs + (r_lo + 8 * h) * kZS + 8 * j + 2 * qd);
            float2 v = make_float2(a32[4 * j + 2 * h], a32[4 * j + 2 * h + 1]);
            if (w == 0) {
              const float2 o = *p;
              v = make_float2(v.x + o.x, v.y + o.y);
            }
            *p = v;
          }
        }
        consumer_sync();
      }
      dx_chunk(d, cc, dzs, f1k, my_dx, ct);
      df1_chunk(d, cc, dzs, xs, df1s, ct);
    }

    consumer_sync();
    for (int e = ct; e < d.r * d.q1; e += kConsumers) {
      const int k = e / d.q1, i = e - k * d.q1;
      my_df1[static_cast<size_t>(e) * d.t1 + c] = df1s[k * d.qp + i];
    }
    fence_async_proxy();  // z's, dz's and dF1's accesses before the TMA reuses the region
    consumer_sync();
    if (ct == 0) mbar_arrive(p2done);
  }
}

// df2[k, j, t] = sum_p part[p][t][kz] over the parts in order; one thread per
// (t, chunk row) of a part
__global__ void df2_reduce_kernel(const float* __restrict__ part, int parts, Dims d,
                                  float* __restrict__ df2) {
  const long long n = static_cast<long long>(d.t2) * d.kzp;
  for (long long e = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; e < n;
       e += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int t = static_cast<int>(e / d.kzp), kzi = static_cast<int>(e % d.kzp);
    const int kz = chunk_kz(d, chunk_of(d, kzi / kCR), kzi % kCR);
    if (kz < 0) continue;
    float acc = 0.f;
    for (int p = 0; p < parts; ++p) acc += part[p * n + e];
    df2[static_cast<size_t>(kz) * d.t2 + t] = acc;
  }
}

// dx[b, i*q2 + j] = sum_s part[s][b][j][i] over the splits in order
__global__ void dx_reduce_kernel(const float* __restrict__ part, Dims d, float* __restrict__ dx) {
  const long long n = static_cast<long long>(d.npad) * d.q2 * d.qp;
  for (long long e = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; e < n;
       e += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int i = static_cast<int>(e % d.qp);
    if (i >= d.q1) continue;
    const long long bj = e / d.qp;
    const int j = static_cast<int>(bj % d.q2);
    const long long b = bj / d.q2;
    float acc = 0.f;
    for (int s = 0; s < d.splits; ++s) acc += part[s * n + e];
    dx[b * d.q1 * d.q2 + i * d.q2 + j] = acc;
  }
}

int grid_for(long long n) {
  long long blocks = (n + 255) / 256;
  return static_cast<int>(blocks < 1 ? 1 : blocks > 132 * 16 ? 132 * 16 : blocks);
}

}  // namespace tc

}  // namespace

extern "C" long long w2k_kron_ce_smem_bytes(int rank, int q1, int q2, int t2, int backward) {
  const int kz = rank * q2, t2p = 32 * ((t2 + 31) / 32);
  long long floats = static_cast<long long>(rank) * q1 + static_cast<long long>(kRows) * kz +
                     stage_floats(kz, t2p);
  if (backward) floats += static_cast<long long>(kRows) * t2p;
  return floats * static_cast<long long>(sizeof(float));
}

// x (n, q1*q2) fp32, labels (n,) int32, F1 (r, q1, t1), F2 (r, q2, t2) fp32;
// *_part: (splits, npad) scratch; loss, m, l: (n,) fp32 outputs
extern "C" int w2k_kron_ce_fwd(const float* x, int n, const int32_t* labels, const float* f1,
                               const float* f2, int r, int q1, int t1, int q2, int t2,
                               int vocab, int splits, float* m_part, float* l_part,
                               float* y_part, float* loss, float* m, float* l, void* stream) {
  if (n <= 0) return 0;
  const Dims d = make_dims(n, r, q1, t1, q2, t2, vocab, splits);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = static_cast<size_t>(w2k_kron_ce_smem_bytes(r, q1, q2, t2, 0));
  static size_t caps[kMaxDevices] = {};
  int rc = raise_smem_cap(ce_fwd_kernel, smem, caps);
  if (rc) return rc;
  ce_fwd_kernel<<<dim3(d.npad / kRows, splits), kThreads, smem, st>>>(
      x, labels, f1, f2, d, m_part, l_part, y_part);
  rc = static_cast<int>(cudaGetLastError());
  if (rc) return rc;
  ce_combine_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, st>>>(
      m_part, l_part, y_part, d, loss, m, l);
  return static_cast<int>(cudaGetLastError());
}

// g, m, l: (n,) fp32 (the loss cotangent and the forward's statistics);
// df2_part (n_tb*splits, r*q2*t2), df1_part (n_tb, r*q1*t1), dx_part
// (splits, npad*q1*q2) scratch; df1 (r, q1, t1), df2 (r, q2, t2) and
// dx (npad, q1*q2) fp32 outputs
extern "C" int w2k_kron_ce_bwd(const float* x, int n, const int32_t* labels, const float* g,
                               const float* m, const float* l, const float* f1,
                               const float* f2, int r, int q1, int t1, int q2, int t2,
                               int vocab, int splits, float* df2_part, float* df1_part,
                               float* dx_part, float* df1, float* df2, float* dx,
                               void* stream) {
  if (n <= 0) return 0;
  const Dims d = make_dims(n, r, q1, t1, q2, t2, vocab, splits);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = static_cast<size_t>(w2k_kron_ce_smem_bytes(r, q1, q2, t2, 1));
  static size_t caps[kMaxDevices] = {};
  int rc = raise_smem_cap(ce_bwd_kernel, smem, caps);
  if (rc) return rc;
  const int n_tb = d.npad / kRows;
  ce_bwd_kernel<<<dim3(n_tb, splits), kThreads, smem, st>>>(
      x, labels, g, m, l, f1, f2, d, df2_part, df1_part, dx_part);
  rc = static_cast<int>(cudaGetLastError());
  if (rc) return rc;
  rc = sum_parts(df2_part, n_tb * splits, static_cast<long long>(d.kz) * t2, df2, st);
  if (rc) return rc;
  rc = sum_parts(df1_part, n_tb, static_cast<long long>(r) * q1 * t1, df1, st);
  if (rc) return rc;
  return sum_parts(dx_part, splits, static_cast<long long>(d.npad) * d.p, dx, st);
}

// The tensor-core backward: the inputs and outputs of w2k_kron_ce_bwd, with
// 64-token blocks (npad a multiple of 64) and the chunk geometry (jcm, kcm)
// chosen by the wrapper. Scratch: xt (npad, q2, q1); img1 and img2, each
// nch * 8 * 26,624 bytes; df2_part (n_tb*splits, t2, nch*64), df1_part
// (n_tb, r*q1*t1), dx_part (splits, npad, q2, qp).
extern "C" long long w2k_kron_ce_bwd_tc_smem_bytes(int r, int q1, int q2, int t2, int jcm,
                                                   int kcm) {
  return tc::smem_bytes(tc::make_dims(1, r, q1, 1, q2, t2, 1, 1, jcm, kcm));
}

extern "C" int w2k_kron_ce_bwd_tc(const float* x, int n, const int32_t* labels, const float* g,
                                  const float* m, const float* l, const float* f1,
                                  const float* f2, int r, int q1, int t1, int q2, int t2,
                                  int vocab, int splits, int jcm, int kcm, float* xt, void* img1,
                                  void* img2, float* df2_part, float* df1_part, float* dx_part,
                                  float* df1, float* df2, float* dx, void* stream) {
  if (n <= 0) return 0;
  const tc::Dims d = tc::make_dims(n, r, q1, t1, q2, t2, vocab, splits, jcm, kcm);
  const int kcp = (kcm + 3) & ~3;
  if (t2 > tc::kTP || kcm < 1 || kcm > r || jcm < 1 || jcm * kcp > tc::kCR ||
      jcm * tc::kT * d.qp > tc::kXMax)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  tc::transpose_x_kernel<<<d.npad, 256, 0, st>>>(x, d, xt);
  int rc = static_cast<int>(cudaGetLastError());
  if (rc) return rc;
  tc::prep_f2_kernel<<<tc::grid_for(static_cast<long long>(d.kzp) * tc::kTP), 256, 0, st>>>(
      f2, d, static_cast<uint8_t*>(img1), static_cast<uint8_t*>(img2));
  rc = static_cast<int>(cudaGetLastError());
  if (rc) return rc;
  const size_t smem = static_cast<size_t>(tc::smem_bytes(d));
  static size_t caps[kMaxDevices] = {};
  rc = raise_smem_cap(tc::ce_bwd_tc_kernel, smem, caps);
  if (rc) return rc;
  const int n_tb = d.npad / tc::kT;
  tc::ce_bwd_tc_kernel<<<dim3(n_tb, splits), tc::kThreads, smem, st>>>(
      xt, labels, g, m, l, f1, static_cast<const uint8_t*>(img1),
      static_cast<const uint8_t*>(img2), d, df2_part, df1_part, dx_part);
  rc = static_cast<int>(cudaGetLastError());
  if (rc) return rc;
  tc::df2_reduce_kernel<<<tc::grid_for(static_cast<long long>(t2) * d.kzp), 256, 0, st>>>(
      df2_part, n_tb * splits, d, df2);
  rc = static_cast<int>(cudaGetLastError());
  if (rc) return rc;
  rc = sum_parts(df1_part, n_tb, static_cast<long long>(r) * q1 * t1, df1, st);
  if (rc) return rc;
  tc::dx_reduce_kernel<<<tc::grid_for(static_cast<long long>(d.npad) * q2 * d.qp), 256, 0,
                         st>>>(dx_part, d, dx);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* w2k_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
