// Fused word2ketXS row lookup for Hopper (sm_90a), order-2 operators.
//
// Replaces: src/repro/kernels/kron_gather/kron_gather.py::_fwd_kernel (the
// forward leg without LN statistics, not quantized), reached through
// _gather_call / kron_gather_pallas.
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
                    float* __restrict__ out, int out_cols) {
  extern __shared__ float smem[];
  float* a = smem;                  // [rank][q1], scaled by rstd_k under LN
  float* b = a + rank * q1;         // [rank][q2]
  float* shift = b + rank * q2;     // [rank]: rstd_k * mean_k (0 without LN)

  const int n = blockIdx.x;
  float* row = out + static_cast<size_t>(n) * out_cols;
  const int id = ids[n];
  if (id < 0 || id >= t1 * t2) {
    for (int e = threadIdx.x; e < out_cols; e += blockDim.x) row[e] = nanf("");
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
    if (lane == 0) shift[k] = rstd * mean;
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

}  // namespace

extern "C" long long w2k_kron_gather2_smem_bytes(int rank, int q1, int q2) {
  return static_cast<long long>(rank) * (q1 + q2 + 1) * static_cast<long long>(sizeof(float));
}

extern "C" int w2k_kron_gather2(const int32_t* ids, int n_ids, const float* f1,
                                const float* f2, int rank, int q1, int t1, int q2,
                                int t2, int use_ln, float eps, float* out,
                                int out_cols, void* stream) {
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
      ids, f1, f2, rank, q1, t1, q2, t2, use_ln, eps, out, out_cols);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* w2k_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
