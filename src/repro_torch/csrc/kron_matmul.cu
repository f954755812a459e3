// Rank-folded Kronecker chain y = x · (Σ_k F1_k ⊗ F2_k) for Hopper (sm_90a),
// order-2 operators, fp32.
//
// Replaces: src/repro/kernels/kron_matmul/kron_matmul.py::_fwd_kernel (not
// quantized), reached through kron_matmul_pallas; on the serving path it is
// the kron vocab head (core/logits.kron_head_logits).
//
// Computes, for x (B, q1*q2) read as (B, q1, q2) and factors F1 (r, q1, t1),
// F2 (r, q2, t2):
//   stage 1  z[b*t1 + a, k*q2 + j] = sum_i x[b, i, j] * F1[k, i, a]
//   stage 2  y[b, a*t2 + c]        = sum_{k, j} z[b*t1 + a, k*q2 + j] * F2[k, j, c]
// Stage 2 contracts the rank and q2 together (the rank fold of
// kernels/common.chain_fused_forward), so no (B, r, t1*t2) pre-sum tensor
// exists. Only columns a*t2 + c < out_dim are written, into a contiguous
// (B, out_dim) output.
//
// What bounds it on the H100: operations. At the qwen3-1.7b head (r 32,
// q (64, 32), t (390, 390)) a token costs 2*(r*t1*q1*q2 + r*q2*t1*t2) =
// 363 MFLOP in fp32 on the CUDA cores (67 TFLOP/s), while it moves the 4.8 MB
// of factors once per call and writes 0.6 MB of logits per token; a decode
// step at B = 8 is about 43 us of fp32 arithmetic against 3 us of traffic.
//
// Design (simple first; tensor cores and TMA are later work):
//  * The TPU kernel walks a (token block, t1 tile) grid in order, streaming
//    F1 tiles through VMEM and keeping each tile's z in VMEM. Blocks on the
//    card run in parallel and a block's shared memory is small, so the two
//    stages are two kernels launched back to back on the caller's stream:
//    stage 1 writes z (B*t1 rows of r*q2 floats, 12.8 MB at B = 8) and
//    stage 2 is a plain fp32 GEMM z · F2 over all B*t1 rows, which gives the
//    card enough blocks even at B = 1 and reads each F2 tile once per
//    64-row tile instead of once per token.
//  * Stage 1: a block per (token, 16 t1 columns, group of 8 ranks); the F1
//    slab of its ranks is staged in shared memory (runs of 16 contiguous
//    floats per (k, i), loaded eight per thread at once), one thread per
//    (k, j) computes 16 z values, and writes are coalesced along (k, j).
//  * Stage 2: 64 x 64 output tiles, 16-deep K steps through shared memory
//    (A stored transposed so both operands are read as float4), a 4 x 4
//    register tile per thread, and the next K step's global loads issued
//    before the current step's FMAs. Rows map back to (b, a) in the store,
//    which drops columns at or past out_dim.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTA = 16;          // stage 1: t1 columns per block
constexpr int kF1Floats = 8192;  // stage 1: shared-memory budget of an F1 slab
constexpr int kBM = 64;          // stage 2: output rows per block
constexpr int kBN = 64;          // stage 2: output columns per block
constexpr int kBK = 16;          // stage 2: K depth per step

// ranks of F1 per stage-1 block: one thread per (rank, j) pair and at most
// kF1Floats of F1 in shared memory
__host__ __device__ inline int f1_ranks_per_block(int rank, int q1, int q2) {
  int g = kThreads / q2;
  const int cap = kF1Floats / (q1 * kTA);
  if (g > cap) g = cap;
  if (g < 1) g = 1;
  return g < rank ? g : rank;
}

__host__ __device__ inline long long stage1_smem_bytes(int rank, int q1, int q2) {
  return (static_cast<long long>(f1_ranks_per_block(rank, q1, q2)) * q1 * kTA +
          static_cast<long long>(q1) * q2) *
         static_cast<long long>(sizeof(float));
}

__global__ void __launch_bounds__(kThreads)
kron_stage1_kernel(const float* __restrict__ x, const float* __restrict__ f1, int rank,
                   int q1, int t1, int q2, float* __restrict__ z) {
  extern __shared__ float4 smem4[];
  const int K = rank * q2;
  const int P = q1 * q2;
  const int G = f1_ranks_per_block(rank, q1, q2);
  float* f1s = reinterpret_cast<float*>(smem4);             // [G][q1][kTA]
  float* xs = f1s + static_cast<size_t>(G) * q1 * kTA;      // [q1][q2]

  const int b = blockIdx.x;
  const int a0 = blockIdx.y * kTA;
  const int na = min(kTA, t1 - a0);
  const int k0 = blockIdx.z * G;  // this block's rank group
  const int g = min(G, rank - k0);
  for (int e = threadIdx.x; e < P; e += blockDim.x)
    xs[e] = x[static_cast<size_t>(b) * P + e];
  const int n = g * q1 * kTA;
  // loads first, then stores, eight at a time: the loads are in flight
  // together instead of one L2 round trip each
  for (int e0 = 0; e0 < n; e0 += 8 * kThreads) {
    float v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int e = e0 + u * kThreads + threadIdx.x;
      const int a = e % kTA;
      const int ki = e / kTA;  // kk * q1 + i
      v[u] = (e < n && a < na)
                 ? f1[(static_cast<size_t>(k0) * q1 + ki) * t1 + a0 + a] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int e = e0 + u * kThreads + threadIdx.x;
      if (e < n) f1s[e] = v[u];
    }
  }
  __syncthreads();
  for (int kj = threadIdx.x; kj < g * q2; kj += blockDim.x) {
    const int kk = kj / q2;
    const int j = kj - kk * q2;
    float acc[kTA];
#pragma unroll
    for (int a = 0; a < kTA; ++a) acc[a] = 0.f;
    const float4* fk =
        reinterpret_cast<const float4*>(f1s + static_cast<size_t>(kk) * q1 * kTA);
#pragma unroll 4
    for (int i = 0; i < q1; ++i) {
      const float xv = xs[i * q2 + j];
#pragma unroll
      for (int v = 0; v < kTA / 4; ++v) {
        const float4 f = fk[i * (kTA / 4) + v];
        acc[4 * v + 0] = fmaf(xv, f.x, acc[4 * v + 0]);
        acc[4 * v + 1] = fmaf(xv, f.y, acc[4 * v + 1]);
        acc[4 * v + 2] = fmaf(xv, f.z, acc[4 * v + 2]);
        acc[4 * v + 3] = fmaf(xv, f.w, acc[4 * v + 3]);
      }
    }
    float* zr = z + (static_cast<size_t>(b) * t1 + a0) * K + k0 * q2 + kj;
#pragma unroll
    for (int a = 0; a < kTA; ++a)
      if (a < na) zr[static_cast<size_t>(a) * K] = acc[a];
  }
}

// y[(row / t1), (row % t1) * t2 + c] = sum_k z[row][k] * f2[k][c], rows < M
__global__ void __launch_bounds__(kThreads)
kron_stage2_kernel(const float* __restrict__ z, const float* __restrict__ f2, int M,
                   int K, int N, int t1, float* __restrict__ out, int out_dim) {
  __shared__ __align__(16) float As[2][kBK][kBM];  // A tile, transposed
  __shared__ __align__(16) float Bs[2][kBK][kBN];
  const int tid = threadIdx.x;
  const int tx = tid % 16;  // columns 4*tx .. 4*tx+3
  const int ty = tid / 16;  // rows 4*ty .. 4*ty+3
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;

  // each thread loads 4 A values (row lr, k lk..lk+3) and 4 B values
  const int lr = tid / 4, lk = (tid % 4) * 4;    // A: 64 rows x 16 k
  const int bk = tid / 16, bc = (tid % 16) * 4;  // B: 16 k x 64 columns
  float ra[4], rb[4];
  auto load = [&](int k0) {
    const int row = m0 + lr;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int k = k0 + lk + u;
      ra[u] = (row < M && k < K) ? z[static_cast<size_t>(row) * K + k] : 0.f;
    }
    const int kb = k0 + bk;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int c = n0 + bc + u;
      rb[u] = (kb < K && c < N) ? f2[static_cast<size_t>(kb) * N + c] : 0.f;
    }
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int u = 0; u < 4; ++u) As[buf][lk + u][lr] = ra[u];
    *reinterpret_cast<float4*>(&Bs[buf][bk][bc]) = make_float4(rb[0], rb[1], rb[2], rb[3]);
  };

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  load(0);
  store(0);
  __syncthreads();
  int buf = 0;
  for (int k0 = 0; k0 < K; k0 += kBK) {
    const bool more = k0 + kBK < K;
    if (more) load(k0 + kBK);  // in flight while this step computes
#pragma unroll
    for (int k = 0; k < kBK; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(&As[buf][k][4 * ty]);
      const float4 bv = *reinterpret_cast<const float4*>(&Bs[buf][k][4 * tx]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bw[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bw[j], acc[i][j]);
    }
    if (more) {
      store(buf ^ 1);
      __syncthreads();
      buf ^= 1;
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + 4 * ty + i;
    if (row >= M) break;
    const int bb = row / t1;
    const int a = row - bb * t1;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = n0 + 4 * tx + j;
      const long long col = static_cast<long long>(a) * N + c;
      if (c < N && col < out_dim) out[static_cast<size_t>(bb) * out_dim + col] = acc[i][j];
    }
  }
}

}  // namespace

extern "C" long long w2k_kron_matmul2_smem_bytes(int rank, int q1, int q2) {
  return stage1_smem_bytes(rank, q1, q2);
}

extern "C" long long w2k_kron_matmul2_scratch_floats(int batch, int rank, int t1, int q2) {
  return static_cast<long long>(batch) * t1 * rank * q2;
}

// z: caller-allocated scratch of w2k_kron_matmul2_scratch_floats floats
extern "C" int w2k_kron_matmul2(const float* x, int batch, const float* f1,
                                const float* f2, int rank, int q1, int t1, int q2,
                                int t2, float* z, float* out, int out_dim, void* stream) {
  if (batch <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = static_cast<size_t>(stage1_smem_bytes(rank, q1, q2));
  // raise the dynamic shared-memory cap only when a shape needs more than
  // any earlier launch
  static size_t smem_cap = 48 * 1024;
  if (smem > smem_cap) {
    const cudaError_t e = cudaFuncSetAttribute(
        kron_stage1_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_cap = smem;
  }
  const int groups = (rank + f1_ranks_per_block(rank, q1, q2) - 1) /
                     f1_ranks_per_block(rank, q1, q2);
  kron_stage1_kernel<<<dim3(batch, (t1 + kTA - 1) / kTA, groups), kThreads, smem, st>>>(
      x, f1, rank, q1, t1, q2, z);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int M = batch * t1;
  const int K = rank * q2;
  kron_stage2_kernel<<<dim3((t2 + kBN - 1) / kBN, (M + kBM - 1) / kBM), kThreads, 0, st>>>(
      z, f2, M, K, t2, t1, out, out_dim);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* w2k_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
