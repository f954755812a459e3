// Fused Kronecker-head cross-entropy, forward and backward, for Hopper
// (sm_90a): order-2 heads, fp32 on the CUDA cores.
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

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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

template <typename K>
int set_smem(K kernel, size_t smem, size_t& cap) {
  if (smem > cap) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    cap = smem;
  }
  return 0;
}

int sum_parts(const float* part, int parts, long long n, float* out, cudaStream_t st) {
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 132 * 16) blocks = 132 * 16;
  if (blocks < 1) blocks = 1;
  sum_parts_kernel<<<static_cast<int>(blocks), kThreads, 0, st>>>(part, parts, n, out);
  return static_cast<int>(cudaGetLastError());
}

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
  static size_t cap = 48 * 1024;
  int rc = set_smem(ce_fwd_kernel, smem, cap);
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
  static size_t cap = 48 * 1024;
  int rc = set_smem(ce_bwd_kernel, smem, cap);
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

extern "C" const char* w2k_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
