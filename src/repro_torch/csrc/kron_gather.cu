// Fused word2ketXS row lookup and its backward for Hopper (sm_90a), order-2
// operators.
//
// Replaces: src/repro/kernels/kron_gather/kron_gather.py::_fwd_kernel (the
// forward legs without and with LN statistics, not quantized), reached
// through _gather_call / kron_gather_pallas and kron_gather_fwd_pallas, and
// ::_bwd_kernel, reached through kron_gather_bwd_pallas (the backward kernel
// is described below the forward one).
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

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// dst[e] = f[e * t + d] for e < n (a strided column of a factor stack):
// eight loads per thread are issued before any store, so they are in flight
// together instead of one memory round trip each
__device__ __forceinline__ void gather_column(const float* __restrict__ f, int n, int t,
                                              int d, float* dst) {
  for (int e0 = 0; e0 < n; e0 += 8 * kThreads) {
    float v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int e = e0 + u * kThreads + threadIdx.x;
      v[u] = e < n ? f[static_cast<size_t>(e) * t + d] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int e = e0 + u * kThreads + threadIdx.x;
      if (e < n) dst[e] = v[u];
    }
  }
}

__global__ void __launch_bounds__(kThreads)
kron_gather2_kernel(const int32_t* __restrict__ ids,
                    const float* __restrict__ f1, const float* __restrict__ f2,
                    int rank, int q1, int t1, int q2, int t2, int use_ln, float eps,
                    float* __restrict__ out, int out_cols, float* __restrict__ stats) {
  extern __shared__ float smem[];
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

  // F_j[k, i, d] lives at (k*q_j + i)*t_j + d
  gather_column(f1, rank * q1, t1, d1, a);
  gather_column(f2, rank * q2, t2, d2, b);
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

}  // namespace

extern "C" long long w2k_kron_gather2_smem_bytes(int rank, int q1, int q2) {
  return static_cast<long long>(rank) * (q1 + q2 + 1) * static_cast<long long>(sizeof(float));
}

// stats: nullptr for the serving leg, else (n_ids, 2, rank) fp32 (LN on)
extern "C" int w2k_kron_gather2(const int32_t* ids, int n_ids, const float* f1,
                                const float* f2, int rank, int q1, int t1, int q2,
                                int t2, int use_ln, float eps, float* out,
                                int out_cols, float* stats, void* stream) {
  if (n_ids <= 0) return 0;
  const size_t smem = static_cast<size_t>(w2k_kron_gather2_smem_bytes(rank, q1, q2));
  // raise the dynamic shared-memory cap only when a shape needs more than
  // any earlier launch
  static size_t smem_cap = 48 * 1024;
  if (smem > smem_cap) {
    const cudaError_t e = cudaFuncSetAttribute(
        kron_gather2_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_cap = smem;
  }
  kron_gather2_kernel<<<n_ids, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      ids, f1, f2, rank, q1, t1, q2, t2, use_ln, eps, out, out_cols, stats);
  return static_cast<int>(cudaGetLastError());
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
  static size_t smem_cap = 48 * 1024;
  if (smem > smem_cap) {
    const cudaError_t e = cudaFuncSetAttribute(
        kron_gather2_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_cap = smem;
  }
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
