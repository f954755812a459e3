// Fused word2ketXS row lookup and its backward for Hopper (sm_90a), order-2
// operators.
//
// Replaces: src/repro/kernels/kron_gather/kron_gather.py::_fwd_kernel (the
// forward legs without and with LN statistics, reached through _gather_call
// / kron_gather_pallas and kron_gather_fwd_pallas, and the quantized=True
// leg, reached through ops.kron_gather_quant -> kron_gather_pallas with
// scales), and ::_bwd_kernel, reached through kron_gather_bwd_pallas (the
// backward kernel is described below the forward one).
//
// Computes, per id n:  (d1, d2) = mixed-radix digits of ids[n] over (t1, t2);
//   a_k = F1[k, :, d1] (q1),  b_k = F2[k, :, d2] (q2)  for each rank k;
//   out[n, i*q2 + j] = sum_k LN(a_k ⊗ b_k)[i*q2 + j]
// with LN the non-affine LayerNorm over the q1*q2 node (eps given), or no LN.
// The left factor is the major index, as in kernels/common._pair_kron.
//
// What bounds it on the H100: almost nothing moves. Per id it reads
// rank*(q1+q2) floats of factor columns (12 KB at rank 32, q = (64, 32)) and
// writes q1*q2 floats (8 KB); a decode step (8 ids) moves under 0.2 MB and a
// prefill chunk (128 ids) about 2.6 MB, so the kernel is bound by its launch
// and by the latency of the strided column loads, not by bandwidth or FLOPs.
//
// Design:
//  * The TPU kernel gathers by one-hot matmul (no pointer chase in VMEM);
//    here the gather is an indexed load. Column d of F_j (rank, q_j, t_j) has
//    stride t_j; the parameters keep that public layout and the kernel reads
//    the rank*q_j strided floats straight from global memory / L2 (the whole
//    factor stacks are 4.8 MB and stay in the 50 MB L2), with no transposed
//    copy.
//  * One block per id. The gathered columns sit in shared memory; each
//    thread issues its strided column loads eight at a time, so they are in
//    flight together.
//  * The order-2 LN moments are separable: mean(a⊗b) = mean(a)·mean(b) and
//    E[(a⊗b)^2] = E[a^2]·E[b^2], so each rank's node moments cost q1+q2 work
//    instead of q1*q2 and the (rank, q1*q2) node is never built. One warp per
//    rank reduces them with shuffles.
//  * LN(a_k⊗b_k) = (rstd_k a_k)⊗b_k − rstd_k·mean_k, so the rank sum is
//    out[i,j] = sum_k a'_k[i]·b_k[j] − sum_k rstd_k·mean_k: each thread
//    walks its output columns with a rank loop over shared memory (b reads
//    are consecutive across a warp, a reads are broadcasts).
//  * An id outside [0, t1*t2) gives a row of NaN and reads nothing.
//  * Writes only the first out_cols columns (the caller's embed_dim), so the
//    output is contiguous with no slice afterwards.
//  * The stats leg (training) writes the root node's moments as they are
//    taken, stats[n, 0, k] = mean_k and stats[n, 1, k] = rstd_k (the
//    (N, 2*nodes, rank) layout of the Pallas kernel with one node); the
//    serving leg passes no stats pointer and writes none.
//
// The stats leg (w2k_kron_gather2_stats) reads its columns another way. At
// 2,048 ids each id's rank*(q1+q2) = 3,072 strided floats sit in 3,072
// separate 32-byte sectors: about 98 KB through L2 per id, 201 MB a call,
// against the 34 MB that F.embedding moves. So the call first writes a
// column-contiguous copy of both stacks, FT_j (t_j, rank, q_j), 4.8 MB
// (transpose_factors_kernel, 32 x 32 tiles through shared memory); the
// lookup then reads each id's two columns as contiguous runs of rank*q_j
// floats, in 16-byte loads when both runs are multiples of 4 floats. Its
// rank sum, which loaded two shared-memory floats per FMA, takes eight
// outputs of a row per thread when q2 is a multiple of 8. The LN moments,
// each output's sum, the NaN rows and the first out_cols columns are
// those of the serving leg (the kernel below, instantiated with kRows), so
// the two legs give the same bits.
//
// The quantized leg (serving, w2k_kron_gather2_quant) is the same kernel
// instantiated for int8 or fp8 e4m3 payloads with fp32 per-rank scales
// (core/quant's wire format): each factor element is dequantized as it is
// loaded, float(q) * scale[k], before the LN moments are taken (LN with eps
// is not scale-invariant, so the scale must come first, as _factors_2d does
// it). The payloads stream at one byte per element: the qwen3-1.7b stacks
// are 1.2 MB instead of 4.8 MB, and a decode step reads rank*(q1+q2) bytes
// of columns per id. Still bound by the launch and the load latency, as the
// fp32 leg is. The fp32 instantiation is the code of the fp32 legs.

#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "smem_cap.cuh"

namespace {

constexpr int kThreads = 256;

// element idx of a factor stack as fp32: an fp32 stack as it is; an int8 /
// fp8 payload times the scale of its rank slice k
template <typename T>
__device__ __forceinline__ float load_elem(const T* __restrict__ f, size_t idx,
                                           const float* __restrict__ scale, int k) {
  return static_cast<float>(f[idx]) * scale[k];
}

template <>
__device__ __forceinline__ float load_elem<float>(const float* __restrict__ f, size_t idx,
                                                  const float* __restrict__, int) {
  return f[idx];
}

// dst[e] = F[e * t + d] for e < n (a strided column of a factor stack of
// rank slices of q rows, dequantized by load_elem): eight loads per thread
// are issued before any store, so they are in flight together instead of
// one memory round trip each
template <typename T>
__device__ __forceinline__ void gather_column(const T* __restrict__ f, int n, int t, int d,
                                              const float* __restrict__ scale, int q,
                                              float* dst) {
  for (int e0 = 0; e0 < n; e0 += 8 * kThreads) {
    float v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int e = e0 + u * kThreads + threadIdx.x;
      v[u] = e < n ? load_elem(f, static_cast<size_t>(e) * t + d, scale, e / q) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int e = e0 + u * kThreads + threadIdx.x;
      if (e < n) dst[e] = v[u];
    }
  }
}

// dst[e] = ft[d * n + e] for e < n: one factor column read as a contiguous
// run of a (t_j, rank, q_j) copy, 16 bytes a load when `vec` (n and the
// destination's offset multiples of 4 floats)
__device__ __forceinline__ void gather_row(const float* __restrict__ ft, int n, int d,
                                           bool vec, float* dst) {
  const float* src = ft + static_cast<size_t>(d) * n;
  if (vec) {
    const float4* s4 = reinterpret_cast<const float4*>(src);
    float4* d4 = reinterpret_cast<float4*>(dst);
    for (int e = threadIdx.x; e < n / 4; e += kThreads) d4[e] = __ldg(s4 + e);
  } else {
    for (int e = threadIdx.x; e < n; e += kThreads) dst[e] = __ldg(src + e);
  }
}

// s1, s2: the payloads' (rank,) scales; unused (nullptr) for fp32 stacks.
// kRows: f1, f2 are the (t_j, rank, q_j) copies of the stats leg, whose
// columns are contiguous rows (T = float); otherwise the (rank, q_j, t_j)
// stacks, read a strided column at a time.
template <typename T, bool kRows = false>
__global__ void __launch_bounds__(kThreads)
kron_gather2_kernel(const int32_t* __restrict__ ids,
                    const T* __restrict__ f1, const T* __restrict__ f2,
                    const float* __restrict__ s1, const float* __restrict__ s2,
                    int rank, int q1, int t1, int q2, int t2, int use_ln, float eps,
                    float* __restrict__ out, int out_cols, float* __restrict__ stats) {
  extern __shared__ __align__(16) float smem[];
  float* a = smem;                  // [rank][q1], scaled by rstd_k under LN
  float* b = a + rank * q1;         // [rank][q2]
  float* shift = b + rank * q2;     // [rank]: rstd_k * mean_k (0 without LN)

  const int n = blockIdx.x;
  float* row = out + static_cast<size_t>(n) * out_cols;
  const int id = ids[n];
  if (id < 0 || id >= t1 * t2) {
    for (int e = threadIdx.x; e < out_cols; e += blockDim.x) row[e] = nanf("");
    if (stats != nullptr)
      for (int e = threadIdx.x; e < 2 * rank; e += blockDim.x)
        stats[static_cast<size_t>(n) * 2 * rank + e] = nanf("");
    return;
  }
  const int d1 = id / t2;
  const int d2 = id - d1 * t2;

  if constexpr (kRows) {
    const bool vec = (rank * q1) % 4 == 0 && (rank * q2) % 4 == 0;
    gather_row(f1, rank * q1, d1, vec, a);
    gather_row(f2, rank * q2, d2, vec, b);
  } else {
    // F_j[k, i, d] lives at (k*q_j + i)*t_j + d
    gather_column(f1, rank * q1, t1, d1, s1, q1, a);
    gather_column(f2, rank * q2, t2, d2, s2, q2, b);
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  for (int k = warp; k < rank; k += nwarps) {
    if (!use_ln) {
      if (lane == 0) shift[k] = 0.f;
      continue;
    }
    float sa = 0.f, saa = 0.f, sb = 0.f, sbb = 0.f;
    for (int i = lane; i < q1; i += 32) {
      const float v = a[k * q1 + i];
      sa += v;
      saa = fmaf(v, v, saa);
    }
    for (int j = lane; j < q2; j += 32) {
      const float v = b[k * q2 + j];
      sb += v;
      sbb = fmaf(v, v, sbb);
    }
    for (int o = 16; o > 0; o >>= 1) {
      sa += __shfl_xor_sync(0xffffffffu, sa, o);
      saa += __shfl_xor_sync(0xffffffffu, saa, o);
      sb += __shfl_xor_sync(0xffffffffu, sb, o);
      sbb += __shfl_xor_sync(0xffffffffu, sbb, o);
    }
    const float mean = (sa / q1) * (sb / q2);
    const float ez2 = (saa / q1) * (sbb / q2);
    const float rstd = rsqrtf(fmaxf(ez2 - mean * mean, 0.f) + eps);
    // each lane rescales exactly the entries it summed above
    for (int i = lane; i < q1; i += 32) a[k * q1 + i] *= rstd;
    if (lane == 0) {
      shift[k] = rstd * mean;
      if (stats != nullptr) {
        stats[(static_cast<size_t>(n) * 2) * rank + k] = mean;
        stats[(static_cast<size_t>(n) * 2 + 1) * rank + k] = rstd;
      }
    }
  }
  __syncthreads();

  float c = 0.f;
  for (int k = 0; k < rank; ++k) c += shift[k];
  if constexpr (kRows) {
    // eight outputs of one row i a thread: a'_k[i] loaded once for eight
    // b_k[j] (two 16-byte loads), where the loop below loads both for each
    // output; each output's rank sum is the same fmaf chain, so the same bits
    if (q2 % 8 == 0 && (rank * q1) % 4 == 0) {
      for (int g = threadIdx.x; 8 * g < out_cols; g += blockDim.x) {
        const int e0 = 8 * g, i = e0 / q2, j0 = e0 - i * q2;
        float acc[8] = {};
#pragma unroll 4
        for (int k = 0; k < rank; ++k) {
          const float av = a[k * q1 + i];
          const float4 b0 = *reinterpret_cast<const float4*>(b + k * q2 + j0);
          const float4 b1 = *reinterpret_cast<const float4*>(b + k * q2 + j0 + 4);
          const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
          for (int u = 0; u < 8; ++u) acc[u] = fmaf(av, bv[u], acc[u]);
        }
#pragma unroll
        for (int u = 0; u < 8; ++u)
          if (e0 + u < out_cols) row[e0 + u] = acc[u] - c;
      }
      return;
    }
  }
  for (int e = threadIdx.x; e < out_cols; e += blockDim.x) {
    const int i = e / q2;
    const int j = e - i * q2;
    float acc = 0.f;
#pragma unroll 8
    for (int k = 0; k < rank; ++k) acc = fmaf(a[k * q1 + i], b[k * q2 + j], acc);
    row[e] = acc - c;
  }
}

// ---------------------------------------------------------------------------
// Backward: dL/dF_j of the lookup.
//
// Replaces: src/repro/kernels/kron_gather/kron_gather.py::_bwd_kernel.
//
// Computes, per id n with digits (d1, d2), u_k = F1[k, :, d1] (q1) and
// v_k = F2[k, :, d2] (q2), the output cotangent row D = g[n] read as
// (q1, q2) (zero past g_cols) and, under LN, the saved root moments
// (mu_k, rstd_k) of the forward's stats leg, the separable root split of
// kernels/common.tree_backward:
//   Dv[k, m] = sum_j D[m, j] v_k[j],   Du[k, j] = sum_m D[m, j] u_k[m]
//   mbar = mean(D), udv_k = sum_m u_k[m] Dv[k, m],
//   c_k = rstd_k (udv_k - mu_k P mbar) / P
//   du_k = rstd_k ((Dv_k - mbar sum v_k) - c_k rstd_k (u_k sum v_k^2 - mu_k sum v_k))
//   dv_k = rstd_k ((Du_k - mbar sum u_k) - c_k rstd_k (v_k sum u_k^2 - mu_k sum u_k))
// (du = Dv, dv = Du without LN), then dF1[k, m, d1] += du_k[m] and
// dF2[k, j, d2] += dv_k[j] over the ids. No (rank, q1*q2) tensor is built.
//
// What bounds it on the H100: memory. At N = 2,048 ids of the qwen3-1.7b
// embedding it reads g (16.8 MB), the stats and the touched factor columns
// and writes the 4.8 MB of dF: about 22 MB, 6.6 us at 3.35 TB/s; the
// arithmetic is 0.5 GFLOP. The fixed-order sum adds the du / dv rows
// (25 MB at 2,048 ids) written once and read once.
//
// Design:
//  * One block per id: the row of g, both gathered columns and the two
//    contractions live in shared memory; u and v rows are padded by one
//    float, so the rank-major thread mapping (one rank per lane) reads them
//    without bank conflicts while D is a broadcast. It writes its du and dv
//    rows to (N, rank*q1) and (N, rank*q2) scratch.
//  * The TPU sums dF as one_hot^T @ dleaf into factor-sized sums resident in
//    VMEM across its sequential grid, so its bits repeat from run to run.
//    Here a second kernel runs one block per factor column (t1 + t2 blocks):
//    it walks the ids in token order, 256 at a time, compacts the positions
//    whose digit is its column (warp ballots, in order) and adds their
//    scratch rows in that order, so every dF element is one fixed-order sum
//    and two calls give the same bits (no atomics). A column no id touches
//    is written as zeros.
//  * An id outside [0, t1*t2) contributes nothing.
__global__ void __launch_bounds__(kThreads)
kron_gather2_bwd_kernel(const int32_t* __restrict__ ids, const float* __restrict__ g,
                        int g_cols, const float* __restrict__ stats,
                        const float* __restrict__ f1, const float* __restrict__ f2,
                        int rank, int q1, int t1, int q2, int t2, int use_ln,
                        float* __restrict__ du_rows, float* __restrict__ dv_rows) {
  extern __shared__ float smem[];
  const int us = q1 + 1, vs = q2 + 1, P = q1 * q2;
  float* u = smem;                  // [rank][q1 + 1]
  float* v = u + rank * us;         // [rank][q2 + 1]
  float* D = v + rank * vs;         // [q1][q2]
  float* Dv = D + P;                // [rank][q1]
  float* Du = Dv + rank * q1;       // [rank][q2]
  float* sc = Du + rank * q2;       // [7][rank]: su1 su2 sv1 sv2 udv mu rstd
  float* red = sc + 7 * rank;       // [32]: warp partial sums of D

  const int n = blockIdx.x;
  const int id = ids[n];
  if (id < 0 || id >= t1 * t2) return;
  const int d1 = id / t2;
  const int d2 = id - d1 * t2;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;

  for (int e = threadIdx.x; e < rank * q1; e += blockDim.x)
    u[(e / q1) * us + e % q1] = f1[static_cast<size_t>(e) * t1 + d1];
  for (int e = threadIdx.x; e < rank * q2; e += blockDim.x)
    v[(e / q2) * vs + e % q2] = f2[static_cast<size_t>(e) * t2 + d2];
  float part = 0.f;
  const float* grow = g + static_cast<size_t>(n) * g_cols;
  for (int e = threadIdx.x; e < P; e += blockDim.x) {
    const float val = e < g_cols ? grow[e] : 0.f;
    D[e] = val;
    part += val;
  }
  for (int o = 16; o > 0; o >>= 1) part += __shfl_xor_sync(0xffffffffu, part, o);
  if (lane == 0) red[warp] = part;
  if (use_ln)
    for (int k = threadIdx.x; k < rank; k += blockDim.x) {
      sc[5 * rank + k] = stats[(static_cast<size_t>(n) * 2) * rank + k];
      sc[6 * rank + k] = stats[(static_cast<size_t>(n) * 2 + 1) * rank + k];
    }
  __syncthreads();

  // Dv[k, m] and Du[k, j], one rank per lane
  for (int e = threadIdx.x; e < rank * q1; e += blockDim.x) {
    const int k = e % rank, m = e / rank;
    float acc = 0.f;
    for (int j = 0; j < q2; ++j) acc = fmaf(D[m * q2 + j], v[k * vs + j], acc);
    Dv[k * q1 + m] = acc;
  }
  for (int e = threadIdx.x; e < rank * q2; e += blockDim.x) {
    const int k = e % rank, j = e / rank;
    float acc = 0.f;
    for (int m = 0; m < q1; ++m) acc = fmaf(D[m * q2 + j], u[k * us + m], acc);
    Du[k * q2 + j] = acc;
  }
  __syncthreads();

  float mbar = 0.f;
  if (use_ln) {
    for (int w = 0; w < nwarps; ++w) mbar += red[w];
    mbar /= static_cast<float>(P);
    // per-rank sums, one warp per rank
    for (int k = warp; k < rank; k += nwarps) {
      float a1 = 0.f, a2 = 0.f, b1 = 0.f, b2 = 0.f, ud = 0.f;
      for (int m = lane; m < q1; m += 32) {
        const float x = u[k * us + m];
        a1 += x;
        a2 = fmaf(x, x, a2);
        ud = fmaf(x, Dv[k * q1 + m], ud);
      }
      for (int j = lane; j < q2; j += 32) {
        const float x = v[k * vs + j];
        b1 += x;
        b2 = fmaf(x, x, b2);
      }
      for (int o = 16; o > 0; o >>= 1) {
        a1 += __shfl_xor_sync(0xffffffffu, a1, o);
        a2 += __shfl_xor_sync(0xffffffffu, a2, o);
        b1 += __shfl_xor_sync(0xffffffffu, b1, o);
        b2 += __shfl_xor_sync(0xffffffffu, b2, o);
        ud += __shfl_xor_sync(0xffffffffu, ud, o);
      }
      if (lane == 0) {
        sc[k] = a1;
        sc[rank + k] = a2;
        sc[2 * rank + k] = b1;
        sc[3 * rank + k] = b2;
        sc[4 * rank + k] = ud;
      }
    }
    __syncthreads();
  }

  for (int e = threadIdx.x; e < rank * q1; e += blockDim.x) {
    const int k = e / q1, m = e - k * q1;
    float du = Dv[e];
    if (use_ln) {
      const float mu = sc[5 * rank + k], rstd = sc[6 * rank + k];
      const float sv1 = sc[2 * rank + k], sv2 = sc[3 * rank + k];
      const float c = rstd * (sc[4 * rank + k] - mu * P * mbar) / P;
      du = rstd * ((du - mbar * sv1) - c * rstd * (u[k * us + m] * sv2 - mu * sv1));
    }
    du_rows[static_cast<size_t>(n) * rank * q1 + e] = du;
  }
  for (int e = threadIdx.x; e < rank * q2; e += blockDim.x) {
    const int k = e / q2, j = e - k * q2;
    float dv = Du[e];
    if (use_ln) {
      const float mu = sc[5 * rank + k], rstd = sc[6 * rank + k];
      const float su1 = sc[k], su2 = sc[rank + k];
      const float c = rstd * (sc[4 * rank + k] - mu * P * mbar) / P;
      dv = rstd * ((dv - mbar * su1) - c * rstd * (v[k * vs + j] * su2 - mu * su1));
    }
    dv_rows[static_cast<size_t>(n) * rank * q2 + e] = dv;
  }
}

// dF of one factor column per block: blocks [0, t1) sum the du rows of the
// ids whose first digit is the block's column, blocks [t1, t1 + t2) the dv
// rows by the second digit, in token order.
constexpr int kColPer = 8;  // accumulators per thread: rank*q up to 2,048 a pass

__global__ void __launch_bounds__(kThreads)
kron_gather2_bwd_cols_kernel(const int32_t* __restrict__ ids, int n_ids,
                             const float* __restrict__ du_rows,
                             const float* __restrict__ dv_rows, int rank, int q1, int t1,
                             int q2, int t2, float* __restrict__ df1,
                             float* __restrict__ df2) {
  __shared__ int hits[kThreads];                 // matching positions, in order
  __shared__ int warp_base[kThreads / 32 + 1];  // exclusive prefix, then total
  const bool first = blockIdx.x < t1;
  const int col = first ? blockIdx.x : blockIdx.x - t1;
  const int R = rank * (first ? q1 : q2);
  const int ncols = first ? t1 : t2;
  const float* rows = first ? du_rows : dv_rows;
  float* df = first ? df1 : df2;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int e0 = 0; e0 < R; e0 += kThreads * kColPer) {
    float acc[kColPer];
#pragma unroll
    for (int u = 0; u < kColPer; ++u) acc[u] = 0.f;
    for (int n0 = 0; n0 < n_ids; n0 += kThreads) {
      const int n = n0 + threadIdx.x;
      bool hit = false;
      if (n < n_ids) {
        const int id = ids[n];
        hit = id >= 0 && id < t1 * t2 && (first ? id / t2 : id % t2) == col;
      }
      const unsigned mask = __ballot_sync(0xffffffffu, hit);
      if (lane == 0) warp_base[warp] = __popc(mask);
      __syncthreads();
      if (threadIdx.x == 0) {
        int total = 0;
        for (int w = 0; w < kThreads / 32; ++w) {
          const int c = warp_base[w];
          warp_base[w] = total;
          total += c;
        }
        warp_base[kThreads / 32] = total;
      }
      __syncthreads();
      if (hit) hits[warp_base[warp] + __popc(mask & ((1u << lane) - 1u))] = n;
      __syncthreads();
      const int nh = warp_base[kThreads / 32];
      for (int h = 0; h < nh; ++h) {
        const float* row = rows + static_cast<size_t>(hits[h]) * R;
#pragma unroll
        for (int u = 0; u < kColPer; ++u) {
          const int e = e0 + u * kThreads + threadIdx.x;
          if (e < R) acc[u] += row[e];
        }
      }
      __syncthreads();  // hits and warp_base are rewritten by the next chunk
    }
#pragma unroll
    for (int u = 0; u < kColPer; ++u) {
      const int e = e0 + u * kThreads + threadIdx.x;
      if (e < R) df[static_cast<size_t>(e) * ncols + col] = acc[u];
    }
  }
}

long long gather_smem_bytes(int rank, int q1, int q2) {
  return static_cast<long long>(rank) * (q1 + q2 + 1) * static_cast<long long>(sizeof(float));
}

template <typename T>
int launch_gather(const int32_t* ids, int n_ids, const T* f1, const T* f2, const float* s1,
                  const float* s2, int rank, int q1, int t1, int q2, int t2, int use_ln,
                  float eps, float* out, int out_cols, float* stats, cudaStream_t st) {
  if (n_ids <= 0) return 0;
  const size_t smem = static_cast<size_t>(gather_smem_bytes(rank, q1, q2));
  static size_t caps[kMaxDevices] = {};  // one set per payload type
  const int rc = raise_smem_cap(kron_gather2_kernel<T>, smem, caps);
  if (rc) return rc;
  kron_gather2_kernel<T><<<n_ids, kThreads, smem, st>>>(
      ids, f1, f2, s1, s2, rank, q1, t1, q2, t2, use_ln, eps, out, out_cols, stats);
  return static_cast<int>(cudaGetLastError());
}

// FT_j[d, e] = F_j[e, d] for both stacks, read as (R_j = rank*q_j, t_j)
// matrices: one 32 x 32 tile per block, blocks [0, tiles of F1) for F1
__global__ void __launch_bounds__(kThreads)
transpose_factors_kernel(const float* __restrict__ f1, int r1, int t1,
                         float* __restrict__ ft1, const float* __restrict__ f2, int r2,
                         int t2, float* __restrict__ ft2) {
  __shared__ float tile[32][33];
  const int n1 = ((r1 + 31) / 32) * ((t1 + 31) / 32);
  const bool first = static_cast<int>(blockIdx.x) < n1;
  const int blk = first ? blockIdx.x : blockIdx.x - n1;
  const float* f = first ? f1 : f2;
  float* ft = first ? ft1 : ft2;
  const int R = first ? r1 : r2, t = first ? t1 : t2;
  const int ct = (t + 31) / 32;
  const int r0 = (blk / ct) * 32, c0 = (blk % ct) * 32;
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  for (int y = ty; y < 32; y += kThreads / 32)
    if (r0 + y < R && c0 + tx < t) tile[y][tx] = f[static_cast<size_t>(r0 + y) * t + c0 + tx];
  __syncthreads();
  for (int y = ty; y < 32; y += kThreads / 32)
    if (c0 + y < t && r0 + tx < R) ft[static_cast<size_t>(c0 + y) * R + r0 + tx] = tile[tx][y];
}

}  // namespace

extern "C" long long w2k_kron_gather2_smem_bytes(int rank, int q1, int q2) {
  return gather_smem_bytes(rank, q1, q2);
}

// stats: nullptr for the serving leg, else (n_ids, 2, rank) fp32 (LN on)
extern "C" int w2k_kron_gather2(const int32_t* ids, int n_ids, const float* f1,
                                const float* f2, int rank, int q1, int t1, int q2,
                                int t2, int use_ln, float eps, float* out,
                                int out_cols, float* stats, void* stream) {
  return launch_gather<float>(ids, n_ids, f1, f2, nullptr, nullptr, rank, q1, t1, q2, t2,
                              use_ln, eps, out, out_cols, stats,
                              static_cast<cudaStream_t>(stream));
}

// The stats leg (LN on): ft1, ft2 are (t_j, rank, q_j) fp32 scratch that
// this call fills with the column-contiguous copies of f1, f2; stats:
// (n_ids, 2, rank) fp32
extern "C" int w2k_kron_gather2_stats(const int32_t* ids, int n_ids, const float* f1,
                                      const float* f2, int rank, int q1, int t1, int q2,
                                      int t2, float eps, float* ft1, float* ft2, float* out,
                                      int out_cols, float* stats, void* stream) {
  if (n_ids <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int r1 = rank * q1, r2 = rank * q2;
  const int tiles = ((r1 + 31) / 32) * ((t1 + 31) / 32) + ((r2 + 31) / 32) * ((t2 + 31) / 32);
  transpose_factors_kernel<<<tiles, kThreads, 0, st>>>(f1, r1, t1, ft1, f2, r2, t2, ft2);
  const int rc = static_cast<int>(cudaGetLastError());
  if (rc) return rc;
  const size_t smem = static_cast<size_t>(gather_smem_bytes(rank, q1, q2));
  static size_t caps[kMaxDevices] = {};
  const int cap = raise_smem_cap(kron_gather2_kernel<float, true>, smem, caps);
  if (cap) return cap;
  kron_gather2_kernel<float, true><<<n_ids, kThreads, smem, st>>>(
      ids, ft1, ft2, nullptr, nullptr, rank, q1, t1, q2, t2, 1, eps, out, out_cols, stats);
  return static_cast<int>(cudaGetLastError());
}

// The quantized serving leg: f1, f2 are (rank, q_j, t_j) payloads of
// `payload` kind (0: int8, 1: fp8 e4m3), s1, s2 their (rank,) fp32 scales;
// no stats
extern "C" int w2k_kron_gather2_quant(const int32_t* ids, int n_ids, const void* f1,
                                      const void* f2, const float* s1, const float* s2,
                                      int payload, int rank, int q1, int t1, int q2, int t2,
                                      int use_ln, float eps, float* out, int out_cols,
                                      void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (payload == 0)
    return launch_gather(ids, n_ids, static_cast<const int8_t*>(f1),
                         static_cast<const int8_t*>(f2), s1, s2, rank, q1, t1, q2, t2,
                         use_ln, eps, out, out_cols, nullptr, st);
  if (payload == 1)
    return launch_gather(ids, n_ids, static_cast<const __nv_fp8_e4m3*>(f1),
                         static_cast<const __nv_fp8_e4m3*>(f2), s1, s2, rank, q1, t1, q2,
                         t2, use_ln, eps, out, out_cols, nullptr, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" long long w2k_kron_gather2_bwd_smem_bytes(int rank, int q1, int q2) {
  const long long floats = static_cast<long long>(rank) * (q1 + 1 + q2 + 1 + q1 + q2 + 7) +
                           static_cast<long long>(q1) * q2 + 32;
  return floats * static_cast<long long>(sizeof(float));
}

// g: (n_ids, g_cols) fp32; stats: (n_ids, 2, rank) fp32 under LN, else
// ignored; du_rows (n_ids, rank*q1) and dv_rows (n_ids, rank*q2) fp32
// scratch; df1, df2: (rank, q_j, t_j) fp32 outputs, every element written
extern "C" int w2k_kron_gather2_bwd(const int32_t* ids, int n_ids, const float* g,
                                    int g_cols, const float* stats, const float* f1,
                                    const float* f2, int rank, int q1, int t1, int q2,
                                    int t2, int use_ln, float* du_rows, float* dv_rows,
                                    float* df1, float* df2, void* stream) {
  if (n_ids <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = static_cast<size_t>(w2k_kron_gather2_bwd_smem_bytes(rank, q1, q2));
  static size_t caps[kMaxDevices] = {};
  const int rc = raise_smem_cap(kron_gather2_bwd_kernel, smem, caps);
  if (rc) return rc;
  kron_gather2_bwd_kernel<<<n_ids, kThreads, smem, st>>>(
      ids, g, g_cols, stats, f1, f2, rank, q1, t1, q2, t2, use_ln, du_rows, dv_rows);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  kron_gather2_bwd_cols_kernel<<<t1 + t2, kThreads, 0, st>>>(
      ids, n_ids, du_rows, dv_rows, rank, q1, t1, q2, t2, df1, df2);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* w2k_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
