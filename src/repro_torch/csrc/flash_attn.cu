// Full-sequence flash attention for Hopper (sm_90a), forward.
//
// Replaces: src/repro/kernels/flash_attn/flash_attn.py::_kernel (reached
// through flash_attention_pallas).
//
// Computes, for q (B, Sq, H, D), k (B, Skv, KVH, D), v (B, Skv, KVH, D) of
// one dtype (fp32, bf16 or fp16) and D in {16, 32, 64, 96, 128}:
//   out[b, i, h] = sum_j p_ij v[b, j, h / G] / max(l_i, 1e-30),   G = H / KVH,
// with scores s_ij = (q[b, i, h] * D^-0.5) . k[b, j, h / G] in fp32 (q scaled
// in fp32 and not rounded back), kept where key j is valid for query i
// (positions count from 0 on both sides, Sq may differ from Skv; `causal`:
// j <= i; `window` > 0: j > i - window) and NEG = -1e30 elsewhere. The row
// max m_i and sum l_i are taken online over key tiles; each tile's p_ij =
// exp(s_ij - m_i) is added to l_i unrounded and rounded to v's dtype before
// the PV product, as the Pallas kernel does. Output in q's dtype.
//
// What bounds it on the H100: per valid (query, key) pair and head the
// function takes 4 D flops (QK^T and PV). At the training shape (8 x 256
// tokens, 16 heads, D 128) that is 2.2 GFLOP against 25 MB of q, k, v and
// out in bf16, and at a 32,768-token prefill 4.4 TFLOP per layer against
// 0.4 GB. With bf16 inputs the card could do them on its tensor cores
// (989 TFLOP/s): the training shape is then bound by its bytes (7.5 us),
// the prefill by its operations (4.4 ms); fp32 inputs by 67 TFLOP/s of
// fp32 on the CUDA cores. This kernel does every flop in fp32 on the CUDA
// cores, so 67 TFLOP/s is its own ceiling at any dtype. The design keeps
// every operand on chip and the flop count to the valid pairs' tiles;
// tensor cores (wgmma), TMA and a pipelined K/V ring are later work.
//
// Design:
//  * The TPU's sequential KV axis of the grid becomes a loop inside the
//    block; the running (m, l) and the output rows live in registers. One
//    block of 128 threads per (b*H + h, tile of 64 query rows), the longest
//    (causal) rows scheduled first. Query head h reads kv head h / G from
//    its own index arithmetic: no broadcast copy, any group size.
//  * The block's q tile is staged once in shared memory, scaled in fp32;
//    each 64-key tile of K and V is staged after it, widened to fp32.
//    Thread (ty, tx) of 16 x 8 owns query rows 4 ty .. 4 ty + 3: it takes
//    the scores of keys tx + 8 j (j < 8), the row max and sum across the 8
//    lanes of its row by shuffles, and output columns 4 tx + 32 c (+0..3).
//    At D 16 the lanes tx >= 4 repeat the columns of tx - 4 and store
//    nothing. The K rows are padded by 4 floats so the 8 lanes' 16-byte
//    reads hit distinct banks; after the scores the K buffer holds the
//    rounded p (it is sized for the wider of the two). Shared memory:
//    99,328 bytes at D 128, two blocks per SM.
//  * The KV loop starts at the window's first tile and stops at the causal
//    diagonal, so fully masked tiles are skipped: a masked score seen
//    before a row's first valid key is wiped by exp(NEG - m) = 0 when that
//    key arrives, and one seen after it adds exp(NEG - m) = 0, so the sums
//    are the Pallas kernel's. Keys past Skv score -inf (they add nothing).
//    A block whose last row sees no key at all (a window that ends before
//    Skv) walks every tile instead: such a row keeps m = NEG, every key
//    adds p = 1, and it comes out as the mean of v, as the oracle's
//    softmax over an all-NEG row does.
//  * Each launch function raises the kernel's dynamic shared-memory cap
//    once per device, keyed by cudaGetDevice(): the attribute belongs to
//    one device's context.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "smem_cap.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kBQ = 64;       // query rows per block
constexpr int kBK = 64;       // keys per tile
static_assert(kBQ == kBK, "stage_tile stages 64-row tiles of either");
constexpr int kRows = 4;      // query rows per thread
constexpr int kCols = 8;      // keys per thread per tile: tx + 8 j
constexpr int kPS = kBK + 4;  // row stride of the p tile
constexpr float kNeg = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }
__device__ __forceinline__ void store(__half* p, float x) { *p = __float2half(x); }

// x rounded to T and widened back (the probabilities before the PV product)
template <typename T> __device__ __forceinline__ float round_as(float x);
template <> __device__ __forceinline__ float round_as<float>(float x) { return x; }
template <> __device__ __forceinline__ float round_as<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16(x));
}
template <> __device__ __forceinline__ float round_as<__half>(float x) {
  return __half2float(__float2half(x));
}

// Stage the 64 rows from src on of a (rows, row_stride) array of T into
// dst[64][STRIDE] as fp32 times `mul` (a q tile or a K or V tile: kBQ ==
// kBK); rows at or past n_valid are zeros.
// Each thread moves 16-byte chunks (rows are 16-byte aligned: D*sizeof(T)
// is a multiple of 16 and the wrapper checks the base pointers).
template <typename T, int D, int STRIDE>
__device__ __forceinline__ void stage_tile(const T* __restrict__ src, size_t row_stride,
                                           int n_valid, float* dst, float mul) {
  constexpr int V = 16 / sizeof(T);
  constexpr int kChunks = D / V;
  for (int e = threadIdx.x; e < kBK * kChunks; e += kThreads) {
    const int r = e / kChunks, c = e % kChunks;
    float x[V];
    if (r < n_valid) {
      const uint4 raw = __ldg(reinterpret_cast<const uint4*>(
          src + static_cast<size_t>(r) * row_stride + c * V));
      const T* el = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int i = 0; i < V; ++i) x[i] = to_f(el[i]) * mul;
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i) x[i] = 0.f;
    }
    float* d = dst + r * STRIDE + c * V;
#pragma unroll
    for (int i = 0; i < V; i += 4)
      *reinterpret_cast<float4*>(d + i) = make_float4(x[i], x[i + 1], x[i + 2], x[i + 3]);
  }
}

__device__ __forceinline__ float row_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 4));
}

__device__ __forceinline__ float row_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  return x + __shfl_xor_sync(0xffffffffu, x, 4);
}

// row stride of the K buffer: a K row padded by 4 floats, or a p row
template <int D>
__host__ __device__ constexpr int k_buf_stride() {
  return D + 4 > kPS ? D + 4 : kPS;
}

template <int D>
constexpr size_t flash_smem_bytes() {
  return (static_cast<size_t>(kBQ) * D + static_cast<size_t>(kBK) * k_buf_stride<D>() +
          static_cast<size_t>(kBK) * D) * sizeof(float);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 2)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ out, int H, int KVH, int Sq, int Skv, int causal,
                 int window, float scale) {
  static_assert(D % 32 == 0 || D == 16, "output columns 4 tx + 32 c cover D");
  constexpr int kC = (D + 31) / 32;  // float4 output columns per thread: 4 tx + 32 c
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // [kBQ][D], q * scale
  float* ks = qs + kBQ * D;                     // [kBK][D + 4], then p [kBQ][kPS]
  float* vs = ks + kBK * k_buf_stride<D>();     // [kBK][D]

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int kvh = h / (H / KVH);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;  // longest rows first
  const int q_rows = min(kBQ, Sq - q0);
  const int q_last = q0 + q_rows - 1;
  const int ty = threadIdx.x / 8, tx = threadIdx.x % 8;
  const int col0 = D < 32 ? 4 * tx % D : 4 * tx;  // this lane's first output column

  // the KV tiles this block walks: [lo, hi)
  const int nk = (Skv + kBK - 1) / kBK;
  int lo = 0, hi = nk;
  const bool blind = window > 0 && q_last - window + 1 > Skv - 1;  // last row sees no key
  if (!blind) {
    if (causal) hi = min(q_last, Skv - 1) / kBK + 1;
    if (window > 0) lo = max(0, q0 - window + 1) / kBK;
  }

  const size_t q_stride = static_cast<size_t>(H) * D;
  const size_t kv_stride = static_cast<size_t>(KVH) * D;
  const T* k_base = k + (static_cast<size_t>(b) * Skv * KVH + kvh) * D;
  const T* v_base = v + (static_cast<size_t>(b) * Skv * KVH + kvh) * D;
  stage_tile<T, D, D>(q + ((static_cast<size_t>(b) * Sq + q0) * H + h) * D, q_stride,
                      q_rows, qs, scale);

  float o[kRows][4 * kC];
  float m[kRows], l[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNeg;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * kC; ++c) o[i][c] = 0.f;
  }

  for (int t = lo; t < hi; ++t) {
    const int k0 = t * kBK;
    const int k_rows = min(kBK, Skv - k0);
    __syncthreads();  // the q tile is staged; the last tile's p and V are consumed
    stage_tile<T, D, D + 4>(k_base + static_cast<size_t>(k0) * kv_stride, kv_stride, k_rows,
                            ks, 1.f);
    stage_tile<T, D, D>(v_base + static_cast<size_t>(k0) * kv_stride, kv_stride, k_rows, vs,
                        1.f);
    __syncthreads();

    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qv[kRows], kv[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
        qv[i] = *reinterpret_cast<const float4*>(qs + (ty * kRows + i) * D + d);
#pragma unroll
      for (int j = 0; j < kCols; ++j)
        kv[j] = *reinterpret_cast<const float4*>(ks + (tx + 8 * j) * (D + 4) + d);
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          float a = s[i][j];
          a = fmaf(qv[i].x, kv[j].x, a);
          a = fmaf(qv[i].y, kv[j].y, a);
          a = fmaf(qv[i].z, kv[j].z, a);
          s[i][j] = fmaf(qv[i].w, kv[j].w, a);
        }
    }

    // s becomes p: summed unrounded into l, kept rounded to T for the PV product
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int qpos = q0 + ty * kRows + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int kpos = k0 + tx + 8 * j;
        if (kpos >= Skv)
          s[i][j] = -INFINITY;
        else if ((causal && kpos > qpos) || (window > 0 && kpos <= qpos - window))
          s[i][j] = kNeg;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float corr = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float p = expf(s[i][j] - m_new);
        sum += p;
        s[i][j] = round_as<T>(p);
      }
      l[i] = l[i] * corr + row_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < 4 * kC; ++c) o[i][c] *= corr;
    }

    __syncthreads();  // every read of the K tile is done: it takes p now
    float* ps = ks;
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) ps[(ty * kRows + i) * kPS + tx + 8 * j] = s[i][j];
    __syncwarp();  // a row's p is written and read by the same 8 lanes

#pragma unroll 2
    for (int kk = 0; kk < kBK; kk += 4) {
      float4 p4[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
        p4[i] = *reinterpret_cast<const float4*>(ps + (ty * kRows + i) * kPS + kk);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float4 vv[kC];
#pragma unroll
        for (int c = 0; c < kC; ++c)
          vv[c] = *reinterpret_cast<const float4*>(vs + (kk + u) * D + col0 + 32 * c);
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          const float p = u == 0 ? p4[i].x : u == 1 ? p4[i].y : u == 2 ? p4[i].z : p4[i].w;
#pragma unroll
          for (int c = 0; c < kC; ++c) {
            o[i][4 * c + 0] = fmaf(p, vv[c].x, o[i][4 * c + 0]);
            o[i][4 * c + 1] = fmaf(p, vv[c].y, o[i][4 * c + 1]);
            o[i][4 * c + 2] = fmaf(p, vv[c].z, o[i][4 * c + 2]);
            o[i][4 * c + 3] = fmaf(p, vv[c].w, o[i][4 * c + 3]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = ty * kRows + i;
    if (row >= q_rows || 4 * tx >= D) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    T* dst = out + ((static_cast<size_t>(b) * Sq + q0 + row) * H + h) * D + col0;
#pragma unroll
    for (int c = 0; c < kC; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) store(dst + 32 * c + e, o[i][4 * c + e] / denom);
  }
}

template <typename T, int D>
int launch_d(const void* q, const void* k, const void* v, void* out, int B, int Sq, int Skv,
             int H, int KVH, int causal, int window, float scale, cudaStream_t st) {
  const size_t smem = flash_smem_bytes<D>();
  static size_t caps[kMaxDevices] = {};  // one set per dtype and D
  int rc = raise_smem_cap(flash_fwd_kernel<T, D>, smem, caps);
  if (rc) return rc;
  // two blocks per SM need the largest shared-memory carveout (a hint, set
  // in the current device's context on every launch: it costs no sync)
  rc = static_cast<int>(cudaFuncSetAttribute(flash_fwd_kernel<T, D>,
                                             cudaFuncAttributePreferredSharedMemoryCarveout,
                                             cudaSharedmemCarveoutMaxShared));
  if (rc) return rc;
  const dim3 grid(static_cast<unsigned>(B) * H, (Sq + kBQ - 1) / kBQ);
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), H, KVH, Sq, Skv, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(int D, const void* q, const void* k, const void* v, void* out, int B, int Sq,
           int Skv, int H, int KVH, int causal, int window, float scale, cudaStream_t st) {
  switch (D) {
    case 16:
      return launch_d<T, 16>(q, k, v, out, B, Sq, Skv, H, KVH, causal, window, scale, st);
    case 32:
      return launch_d<T, 32>(q, k, v, out, B, Sq, Skv, H, KVH, causal, window, scale, st);
    case 64:
      return launch_d<T, 64>(q, k, v, out, B, Sq, Skv, H, KVH, causal, window, scale, st);
    case 96:
      return launch_d<T, 96>(q, k, v, out, B, Sq, Skv, H, KVH, causal, window, scale, st);
    case 128:
      return launch_d<T, 128>(q, k, v, out, B, Sq, Skv, H, KVH, causal, window, scale, st);
    default:
      return -1;
  }
}

}  // namespace

// dtype: 0 fp32, 1 bf16, 2 fp16; q (B, Sq, H, D), k and v (B, Skv, KVH, D),
// out (B, Sq, H, D), all contiguous and 16-byte aligned. Returns 0, a
// cudaError_t, or a negative code for shapes the kernel does not take.
extern "C" int w2k_flash_fwd(const void* q, const void* k, const void* v, void* out,
                             int dtype, int B, int Sq, int Skv, int H, int KVH, int D,
                             int causal, int window, float scale, void* stream) {
  if (D != 16 && D != 32 && D != 64 && D != 96 && D != 128) return -1;
  if (KVH < 1 || H % KVH) return -2;
  if (Skv < 1 || window < 0 || (Sq + kBQ - 1) / kBQ > 65535) return -3;
  if (B <= 0 || Sq <= 0 || H <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<float>(D, q, k, v, out, B, Sq, Skv, H, KVH, causal, window, scale, st);
    case 1:
      return launch<__nv_bfloat16>(D, q, k, v, out, B, Sq, Skv, H, KVH, causal, window,
                                   scale, st);
    case 2:
      return launch<__half>(D, q, k, v, out, B, Sq, Skv, H, KVH, causal, window, scale, st);
    default:
      return -1;
  }
}

extern "C" const char* w2k_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
