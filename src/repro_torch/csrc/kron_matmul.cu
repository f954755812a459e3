// Rank-folded Kronecker chain y = x · (Σ_k F1_k ⊗ F2_k) for Hopper (sm_90a),
// order-2 operators, fp32, forward and backward.
//
// Replaces: src/repro/kernels/kron_matmul/kron_matmul.py::_fwd_kernel (not
// quantized), reached through kron_matmul_pallas, and ::_bwd_kernel, reached
// through kron_matmul_bwd_pallas. The forward is the kron vocab head
// (core/logits.kron_head_logits) and every ket linear (linear_kind="ket":
// the attention q/k/v/o and FFN wi/wg/wo projections); the backward trains
// the ket linears. The backward is described above w2k_kron_matmul2_bwd.
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
#include <limits.h>
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

// ---------------------------------------------------------------------------
// Backward
// ---------------------------------------------------------------------------
//
// Read x as (B, q1, q2) and the output cotangent g, zero-padded past out_dim,
// as (B, t1, t2). With z the forward's stage 1, recomputed:
//   z [b,a,k,j] = sum_i     x[b,i,j]  * F1[k,i,a]     (stage 1, its kernel)
//   dz[b,a,k,j] = sum_c     g[b,a,c]  * F2[k,j,c]     (stage-2 size)
//   dF2[k,j,c]  = sum_{b,a} z[b,a,k,j] * g[b,a,c]     (stage-2 size)
//   dF1[k,i,a]  = sum_{b,j} x[b,i,j]  * dz[b,a,k,j]   (stage-1 size)
//   dx [b,i,j]  = sum_{k,a} F1[k,i,a] * dz[b,a,k,j]   (stage-1 size)
// z and dz live in a (B*t1, r*q2) scratch each, laid out as the forward's z.
//
// What bounds it on the H100: operations. A token costs 3 contractions of
// stage 1's size (2*r*t1*q1*q2 flops) and 2 of stage 2's (2*r*q2*t1*t2); at
// the qwen3-1.7b ket linears (rank 8) that is 79.4 MFLOP per token per layer
// over the seven projections, about 2.4 ms of fp32 on the CUDA cores per
// layer at 2,048 tokens. Its inputs and outputs are small next to that; the
// z and dz scratch (2.1 GB a layer, written once and read back once or
// twice) is its largest memory traffic, about 1.6 ms a layer at 3.35 TB/s.
//
// Design (simple first; tensor cores and TMA are later work):
//  * Each contraction after stage 1 is one launch of kron_gemm_kernel, a
//    tiled fp32 GEMM C = A·B with 64 x 64 output tiles, 16-deep K steps double
//    buffered through shared memory and a 4 x 4 register tile per thread
//    (stage 2's scheme). Its operands are strided views: each of the M, N
//    and K indices maps to an offset through a Dim, idx -> (idx / len) *
//    s_out + (idx % len) * s_in, which folds the (b, j) and (a, k) index
//    pairs into one GEMM dimension without copying x, F1 or dz. The loads
//    walk the operand's unit-stride axis across neighbouring threads (the
//    template flags), so they coalesce.
//  * The TPU kernel sums dF1 and dF2 over token blocks in VMEM along its
//    sequential grid. Blocks here run in parallel, so the reduction axis of
//    those two GEMMs (B*t1 and B*q2 long) is cut into chunks, each block
//    writes its chunk's partial tile to scratch (every element written by
//    one block), and kron_sum_parts_kernel adds the partials in chunk order:
//    the same bits every run, no atomics. The chunk count fills about two
//    waves of the card and depends only on the shapes.
//  * dx and dz need no cross-block sum: each element's whole reduction
//    (r*t1 and t2 deep) runs in one thread, in a fixed order.

// One GEMM dimension of an operand: index idx -> element offset
// (idx / len) * s_out + (idx % len) * s_in; len = INT_MAX is a plain stride.
struct Dim {
  long long s_out, s_in;
  int len;
};

__host__ __device__ inline Dim plain(long long s) { return Dim{0, s, INT_MAX}; }

__device__ __forceinline__ long long doff(const Dim& d, int idx) {
  const int o = idx / d.len;
  return static_cast<long long>(o) * d.s_out + static_cast<long long>(idx - o * d.len) * d.s_in;
}

// C[z][m][n] = sum_{k in split's chunk} A[m][k] * B[k][n], z = batch*splits+split
struct Gemm {
  const float* a;
  Dim am, ak;
  long long a_batch;
  const float* b;
  Dim bk, bn;
  long long b_batch;
  float* c;
  Dim cm, cn;
  long long c_batch, c_split;
  int M, N, K, kchunk, splits;
};

// kAAlongK: A's unit stride runs along k (else along m); kBAlongN: B's along n
// (else along k). Neighbouring threads load along that axis.
template <bool kAAlongK, bool kBAlongN>
__global__ void __launch_bounds__(kThreads) kron_gemm_kernel(const Gemm p) {
  __shared__ __align__(16) float As[2][kBK][kBM];  // A tile, transposed
  __shared__ __align__(16) float Bs[2][kBK][kBN];
  const int tid = threadIdx.x;
  const int tx = tid % 16;  // columns 4*tx .. 4*tx+3
  const int ty = tid / 16;  // rows 4*ty .. 4*ty+3
  const int ntn = (p.N + kBN - 1) / kBN;
  const int m0 = (blockIdx.x / ntn) * kBM;
  const int n0 = (blockIdx.x % ntn) * kBN;
  const int batch = blockIdx.z / p.splits;
  const int split = blockIdx.z - batch * p.splits;
  const int kb = split * p.kchunk;
  const int ke = min(p.K, kb + p.kchunk);
  const float* A = p.a + batch * p.a_batch;
  const float* B = p.b + batch * p.b_batch;

  // this thread's tile coordinates for its 4 A and 4 B loads
  const int a_m = kAAlongK ? tid / 4 : (tid % 16) * 4;  // + u when !kAAlongK
  const int a_k = kAAlongK ? (tid % 4) * 4 : tid / 16;  // + u when kAAlongK
  const int b_k = kBAlongN ? tid / 16 : (tid % 4) * 4;  // + u when !kBAlongN
  const int b_n = kBAlongN ? (tid % 16) * 4 : tid / 4;  // + u when kBAlongN
  long long a_moff[4], b_noff[4];
  bool a_mok[4], b_nok[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int m = m0 + a_m + (kAAlongK ? 0 : u);
    a_mok[u] = m < p.M;
    a_moff[u] = a_mok[u] ? doff(p.am, m) : 0;
    const int n = n0 + b_n + (kBAlongN ? u : 0);
    b_nok[u] = n < p.N;
    b_noff[u] = b_nok[u] ? doff(p.bn, n) : 0;
  }
  float ra[4], rb[4];
  auto load = [&](int k0) {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int ka = k0 + a_k + (kAAlongK ? u : 0);
      ra[u] = (a_mok[u] && ka < ke) ? A[a_moff[u] + doff(p.ak, ka)] : 0.f;
      const int kk = k0 + b_k + (kBAlongN ? 0 : u);
      rb[u] = (b_nok[u] && kk < ke) ? B[doff(p.bk, kk) + b_noff[u]] : 0.f;
    }
  };
  auto store = [&](int buf) {
    if (kAAlongK) {
#pragma unroll
      for (int u = 0; u < 4; ++u) As[buf][a_k + u][a_m] = ra[u];
    } else {
      *reinterpret_cast<float4*>(&As[buf][a_k][a_m]) = make_float4(ra[0], ra[1], ra[2], ra[3]);
    }
    if (kBAlongN) {
      *reinterpret_cast<float4*>(&Bs[buf][b_k][b_n]) = make_float4(rb[0], rb[1], rb[2], rb[3]);
    } else {
#pragma unroll
      for (int u = 0; u < 4; ++u) Bs[buf][b_k + u][b_n] = rb[u];
    }
  };

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  if (kb < ke) {
    load(kb);
    store(0);
    __syncthreads();
    int buf = 0;
    for (int k0 = kb; k0 < ke; k0 += kBK) {
      const bool more = k0 + kBK < ke;
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
  }

  // an empty chunk writes its zeros too: every partial element is written
  float* C = p.c + batch * p.c_batch + split * p.c_split;
  long long c_noff[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int n = n0 + 4 * tx + j;
    c_noff[j] = n < p.N ? doff(p.cn, n) : 0;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + 4 * ty + i;
    if (m >= p.M) break;
    const long long row = doff(p.cm, m);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (n0 + 4 * tx + j < p.N) C[row + c_noff[j]] = acc[i][j];
  }
}

// out[e] = sum_p part[p * n + e], parts in order
__global__ void kron_sum_parts_kernel(const float* __restrict__ part, int parts,
                                      long long n, float* __restrict__ out) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long e = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; e < n;
       e += stride) {
    float acc = 0.f;
    for (int p = 0; p < parts; ++p) acc += part[p * n + e];
    out[e] = acc;
  }
}

int sum_parts(const float* part, int parts, long long n, float* out, cudaStream_t st) {
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 132 * 16) blocks = 132 * 16;
  if (blocks < 1) blocks = 1;
  kron_sum_parts_kernel<<<static_cast<int>(blocks), kThreads, 0, st>>>(part, parts, n, out);
  return static_cast<int>(cudaGetLastError());
}

template <bool kAAlongK, bool kBAlongN>
int launch_gemm(const Gemm& p, int batches, cudaStream_t st) {
  const int tiles = ((p.M + kBM - 1) / kBM) * ((p.N + kBN - 1) / kBN);
  kron_gemm_kernel<kAAlongK, kBAlongN>
      <<<dim3(tiles, 1, batches * p.splits), kThreads, 0, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// Reduction chunks of a split GEMM: about two waves of 132 SMs over its
// output tiles, chunks at least 512 deep and a multiple of kBK. Depends on
// the shapes only, so a shape always sums in the same order.
struct Split {
  int splits, kchunk;
};

__host__ inline Split plan_split(int M, int N, int batches, int K) {
  const int tiles = ((M + kBM - 1) / kBM) * ((N + kBN - 1) / kBN) * batches;
  int s = (2 * 132 + tiles - 1) / tiles;
  const int most = (K + 511) / 512;
  if (s > most) s = most;
  if (s < 1) s = 1;
  int chunk = (K + s - 1) / s;
  chunk = (chunk + kBK - 1) / kBK * kBK;
  if (chunk < kBK) chunk = kBK;
  return Split{(K + chunk - 1) / chunk, chunk};
}

struct BwdPlan {
  Split s2, s1;
  long long z, p2, p1;  // scratch floats: z and dz each, dF2 and dF1 partials
};

__host__ inline BwdPlan plan_bwd(int batch, int rank, int q1, int t1, int q2, int t2) {
  BwdPlan pl;
  const int K1 = rank * q2;
  pl.s2 = plan_split(K1, t2, 1, batch * t1);
  pl.s1 = plan_split(q1, t1, rank, batch * q2);
  pl.z = static_cast<long long>(batch) * t1 * K1;
  pl.p2 = static_cast<long long>(pl.s2.splits) * K1 * t2;
  pl.p1 = static_cast<long long>(pl.s1.splits) * rank * q1 * t1;
  return pl;
}

int launch_stage1(const float* x, int batch, const float* f1, int rank, int q1, int t1,
                  int q2, float* z, cudaStream_t st) {
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
  return static_cast<int>(cudaGetLastError());
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
  int rc = launch_stage1(x, batch, f1, rank, q1, t1, q2, z, st);
  if (rc) return rc;
  const int M = batch * t1;
  const int K = rank * q2;
  kron_stage2_kernel<<<dim3((t2 + kBN - 1) / kBN, (M + kBM - 1) / kBM), kThreads, 0, st>>>(
      z, f2, M, K, t2, t1, out, out_dim);
  return static_cast<int>(cudaGetLastError());
}

extern "C" long long w2k_kron_matmul2_bwd_scratch_floats(int batch, int rank, int q1, int t1,
                                                         int q2, int t2) {
  const BwdPlan pl = plan_bwd(batch, rank, q1, t1, q2, t2);
  return 2 * pl.z + pl.p2 + pl.p1;
}

// x (batch, q1*q2) and g (batch, t1*t2) fp32, zero-padded by the caller;
// scratch: w2k_kron_matmul2_bwd_scratch_floats floats; dx (batch, q1*q2),
// df1 (rank, q1, t1), df2 (rank, q2, t2) fp32 outputs, every element written
extern "C" int w2k_kron_matmul2_bwd(const float* x, int batch, const float* g,
                                    const float* f1, const float* f2, int rank, int q1,
                                    int t1, int q2, int t2, float* scratch, float* dx,
                                    float* df1, float* df2, void* stream) {
  if (batch <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const BwdPlan pl = plan_bwd(batch, rank, q1, t1, q2, t2);
  const int K1 = rank * q2, P = q1 * q2, Mz = batch * t1;
  const long long bstride = static_cast<long long>(t1) * K1;  // one token of z / dz
  float* z = scratch;
  float* dz = z + pl.z;
  float* p2 = dz + pl.z;
  float* p1 = p2 + pl.p2;

  int rc = launch_stage1(x, batch, f1, rank, q1, t1, q2, z, st);
  if (rc) return rc;

  Gemm d{};  // dz[m][n] = sum_c g[m][c] * F2[n][c], m = b*t1 + a, n = k*q2 + j
  d.a = g, d.am = plain(t2), d.ak = plain(1);
  d.b = f2, d.bk = plain(1), d.bn = plain(t2);
  d.c = dz, d.cm = plain(K1), d.cn = plain(1);
  d.M = Mz, d.N = K1, d.K = t2, d.kchunk = t2, d.splits = 1;
  rc = launch_gemm<true, false>(d, 1, st);
  if (rc) return rc;

  Gemm w2{};  // dF2 partials: [n][c] = sum_m z[m][n] * g[m][c]
  w2.a = z, w2.am = plain(1), w2.ak = plain(K1);
  w2.b = g, w2.bk = plain(t2), w2.bn = plain(1);
  w2.c = p2, w2.cm = plain(t2), w2.cn = plain(1), w2.c_split = static_cast<long long>(K1) * t2;
  w2.M = K1, w2.N = t2, w2.K = Mz, w2.kchunk = pl.s2.kchunk, w2.splits = pl.s2.splits;
  rc = launch_gemm<false, true>(w2, 1, st);
  if (rc) return rc;
  rc = sum_parts(p2, pl.s2.splits, static_cast<long long>(K1) * t2, df2, st);
  if (rc) return rc;

  Gemm w1{};  // dF1 partials, batch k: [i][a] = sum_{b,j} x[b][i][j] * dz[b][a][k][j]
  w1.a = x, w1.am = plain(q2), w1.ak = Dim{P, 1, q2};
  w1.b = dz, w1.bk = Dim{bstride, 1, q2}, w1.bn = plain(K1), w1.b_batch = q2;
  w1.c = p1, w1.cm = plain(t1), w1.cn = plain(1),
  w1.c_batch = static_cast<long long>(q1) * t1;
  w1.c_split = static_cast<long long>(rank) * q1 * t1;
  w1.M = q1, w1.N = t1, w1.K = batch * q2, w1.kchunk = pl.s1.kchunk, w1.splits = pl.s1.splits;
  rc = launch_gemm<true, false>(w1, rank, st);
  if (rc) return rc;
  rc = sum_parts(p1, pl.s1.splits, static_cast<long long>(rank) * q1 * t1, df1, st);
  if (rc) return rc;

  Gemm v{};  // dx[i][(b,j)] = sum_{(a,k)} F1[k][i][a] * dz[b][a][k][j]
  v.a = f1, v.am = plain(t1), v.ak = Dim{1, static_cast<long long>(q1) * t1, rank};
  v.b = dz, v.bk = plain(q2), v.bn = Dim{bstride, 1, q2};
  v.c = dx, v.cm = plain(q2), v.cn = Dim{P, 1, q2};
  v.M = q1, v.N = batch * q2, v.K = t1 * rank, v.kchunk = t1 * rank, v.splits = 1;
  return launch_gemm<true, true>(v, 1, st);
}

extern "C" const char* w2k_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
