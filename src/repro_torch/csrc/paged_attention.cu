// Split-KV paged decode read for Hopper (sm_90a): the split kernel and the
// combine kernel.
//
// Replaces: src/repro/kernels/flash_attn/paged.py::_split_kernel (reached
// through paged_attention_split_pallas) and ::_combine_kernel (through
// combine_splits_pallas).
//
// Computes, for one decode query per slot over paged K/V pools
// (P, ps, KVH, Dh) through the page table ptab (B, NP) and lens (B,):
//   split:   block (b, h, s) walks logical pages p in [s*pps, (s+1)*pps) with
//            p*ps < lens[b], page by page with an online softmax for the G
//            query rows of kv head h, and writes the unnormalized partials
//            mid_o (B, KVH, S, G, Dh) and the running max / sum m, l
//            (B, KVH, S, G, 1), all fp32. A split with no such page writes
//            (0, NEG, 0).
//   combine: block (b, h) merges the S partials by log-sum-exp:
//            m* = max_s m_s, l* = sum_s l_s e^{m_s - m*},
//            out = sum_s o_s e^{m_s - m*} / max(l*, 1e-30)  -> (B, KVH, G, Dh);
//            only non-positive exponents are taken, and lens == 0 gives 0.
//
// What bounds it on the H100: bytes. Per valid token and kv head the split
// reads 2*Dh K/V elements (512 bytes in bf16 at Dh = 128) and does 4*G*Dh
// flops (2 per byte), far below the card's 20 fp32 flops per byte, so the
// least time is the K/V bytes of the valid tokens over 3.35 TB/s. At the
// engine's decode shape (8 slots, 8 kv heads, 32 pages of 16) a read moves
// at most 4 MB: a few microseconds, so launch and memory latency decide.
// The combine moves the partials once (under 0.3 MB there).
//
// Design:
//  * The TPU's sequential page axis of the grid becomes a loop inside the
//    block; the (B, KVH, S) axes become the grid (512 blocks at the engine's
//    shape). Each block reads its own ptab[b, .] and lens[b] (no scalar
//    prefetch), stops at the slot's last valid page, and never indexes ptab
//    at or past NP: an idle slot's length can exceed NP*ps, and then the
//    pages past NP re-read ptab[b, NP-1], as the JAX gather clamps. Pool
//    rows are clamped to [0, P) the same way.
//  * 128 threads. A token's Dh-wide K (and V) row is read as 16-byte loads
//    by lpt = Dh/(16/sizeof(T)) neighbouring lanes, so one warp covers
//    32/lpt tokens and the block 128/lpt tokens per pass; a page of 16 is
//    one pass in bf16 at Dh = 128 (four in fp32). All K and V loads of a
//    page are issued before any arithmetic, so they are in flight together:
//    one memory round trip per page.
//  * The G query rows sit in registers and share each loaded K/V row. The
//    dot products reduce across the lpt lanes with shuffles into a (G, ps)
//    score tile in shared memory; every thread then takes the page max and
//    sum itself (identical across threads, no second barrier), rescales its
//    own partial output, and adds its tokens' p*V. The probabilities are
//    rounded to the value dtype before the PV product, as paged.py rounds
//    them; the running sum l uses them unrounded, as there.
//  * Tokens at or past lens[b] are never loaded and add nothing, so stale or
//    NaN data in an unwritten tail or in the trash page cannot leak.
//  * At the end the partial outputs of the 128/lpt token groups are summed
//    through shared memory. The two kernels stay separate launches so the
//    partials remain testable.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxPass = 4;  // token passes per page held in registers
constexpr float kNeg = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }

// x rounded to T and widened back (the probabilities before the PV product)
template <typename T> __device__ __forceinline__ float round_as(float x);
template <> __device__ __forceinline__ float round_as<float>(float x) { return x; }
template <> __device__ __forceinline__ float round_as<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16(x));
}
template <> __device__ __forceinline__ float round_as<__half>(float x) {
  return __half2float(__float2half(x));
}

// one 16-byte load of 16/sizeof(T) elements, widened to fp32
template <typename T>
__device__ __forceinline__ void load16(const T* p, float* out) {
  constexpr int V = 16 / sizeof(T);
  const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < V; ++i) out[i] = to_f(e[i]);
}

template <typename T, int G>
__global__ void __launch_bounds__(kThreads)
paged_split_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                   const T* __restrict__ vp, const int32_t* __restrict__ ptab,
                   const int32_t* __restrict__ lens, int P, int KVH, int Dh, int ps,
                   int NP, int S, int pps, float scale, float* __restrict__ mid_o,
                   float* __restrict__ m_out, float* __restrict__ l_out) {
  constexpr int V = 16 / sizeof(T);
  extern __shared__ float smem[];
  const int lpt = Dh / V;           // lanes per token row
  const int ntg = kThreads / lpt;   // tokens per pass
  float* sc = smem;                 // [G][ps] scores of the current page
  float* red = smem + G * ps;       // [ntg][G][Dh] for the final sum

  const int s = blockIdx.x % S;
  const int h = (blockIdx.x / S) % KVH;
  const int b = blockIdx.x / (S * KVH);
  const int c = threadIdx.x % lpt;  // 16-byte chunk of the row
  const int ts = threadIdx.x / lpt; // token slot within a pass
  const size_t stat = (static_cast<size_t>(b * KVH + h) * S + s) * G;

  const int len = lens[b];
  const int n_pages = len > 0 ? (len - 1) / ps + 1 : 0;  // pages with p*ps < len
  const int p0 = s * pps;
  const int p1 = min(p0 + pps, n_pages);
  if (p0 >= p1) {  // empty split
    for (int e = threadIdx.x; e < G * Dh; e += kThreads) mid_o[stat * Dh + e] = 0.f;
    if (threadIdx.x < G) {
      m_out[stat + threadIdx.x] = kNeg;
      l_out[stat + threadIdx.x] = 0.f;
    }
    return;
  }

  float qr[G][V];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    load16(q + (static_cast<size_t>(b * KVH + h) * G + g) * Dh + c * V, qr[g]);
#pragma unroll
    for (int e = 0; e < V; ++e) qr[g][e] *= scale;
  }
  float acc[G][V];
  float m_run[G], l_run[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m_run[g] = kNeg;
    l_run[g] = 0.f;
#pragma unroll
    for (int e = 0; e < V; ++e) acc[g][e] = 0.f;
  }

  const int npass = (ps + ntg - 1) / ntg;
  const size_t tok_stride = static_cast<size_t>(KVH) * Dh;
  const int32_t* tab = ptab + static_cast<size_t>(b) * NP;
  for (int p = p0; p < p1; ++p) {
    const int row = min(max(tab[min(p, NP - 1)], 0), P - 1);
    const size_t base = static_cast<size_t>(row) * ps * tok_stride +
                        static_cast<size_t>(h) * Dh + c * V;
    const int tok0 = p * ps;
    float kk[kMaxPass][V], vv[kMaxPass][V];
#pragma unroll
    for (int i = 0; i < kMaxPass; ++i) {
      const int t = i * ntg + ts;
      if (i < npass && t < ps && tok0 + t < len) {
        load16(kp + base + t * tok_stride, kk[i]);
        load16(vp + base + t * tok_stride, vv[i]);
      } else {
#pragma unroll
        for (int e = 0; e < V; ++e) kk[i][e] = vv[i][e] = 0.f;
      }
    }
#pragma unroll
    for (int i = 0; i < kMaxPass; ++i) {
      if (i >= npass) break;  // uniform across the block
      const int t = i * ntg + ts;
      float d[G];
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float x = 0.f;
#pragma unroll
        for (int e = 0; e < V; ++e) x = fmaf(qr[g][e], kk[i][e], x);
        d[g] = x;
      }
      for (int off = lpt >> 1; off > 0; off >>= 1) {
#pragma unroll
        for (int g = 0; g < G; ++g) d[g] += __shfl_xor_sync(0xffffffffu, d[g], off);
      }
      if (c == 0 && t < ps) {
        const bool ok = tok0 + t < len;
#pragma unroll
        for (int g = 0; g < G; ++g) sc[g * ps + t] = ok ? d[g] : kNeg;
      }
    }
    __syncthreads();

    const int nvalid = min(ps, len - tok0);  // >= 1: p < n_pages
    float m_new[G], corr[G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float mx = kNeg;
      for (int t = 0; t < nvalid; ++t) mx = fmaxf(mx, sc[g * ps + t]);
      m_new[g] = fmaxf(m_run[g], mx);
      corr[g] = expf(m_run[g] - m_new[g]);
      float sum = 0.f;
      for (int t = 0; t < nvalid; ++t) sum += expf(sc[g * ps + t] - m_new[g]);
      l_run[g] = l_run[g] * corr[g] + sum;
      m_run[g] = m_new[g];
#pragma unroll
      for (int e = 0; e < V; ++e) acc[g][e] *= corr[g];
    }
#pragma unroll
    for (int i = 0; i < kMaxPass; ++i) {
      const int t = i * ntg + ts;
      if (i < npass && t < nvalid) {
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const float pr = round_as<T>(expf(sc[g * ps + t] - m_new[g]));
#pragma unroll
          for (int e = 0; e < V; ++e) acc[g][e] = fmaf(pr, vv[i][e], acc[g][e]);
        }
      }
    }
    __syncthreads();  // the next page overwrites sc
  }

#pragma unroll
  for (int g = 0; g < G; ++g) {
#pragma unroll
    for (int e = 0; e < V; ++e) red[(ts * G + g) * Dh + c * V + e] = acc[g][e];
  }
  __syncthreads();
  for (int e = threadIdx.x; e < G * Dh; e += kThreads) {
    float x = 0.f;
    for (int j = 0; j < ntg; ++j) x += red[j * G * Dh + e];
    mid_o[stat * Dh + e] = x;
  }
  if (threadIdx.x < G) {
    m_out[stat + threadIdx.x] = m_run[threadIdx.x];
    l_out[stat + threadIdx.x] = l_run[threadIdx.x];
  }
}

__global__ void __launch_bounds__(kThreads)
paged_combine_kernel(const float* __restrict__ mid_o, const float* __restrict__ m,
                     const float* __restrict__ l, int S, int G, int Dv,
                     float* __restrict__ out) {
  const size_t bh = blockIdx.x;
  for (int e = threadIdx.x; e < G * Dv; e += blockDim.x) {
    const int g = e / Dv;
    const int d = e - g * Dv;
    float m_max = kNeg;
    for (int s = 0; s < S; ++s) m_max = fmaxf(m_max, m[(bh * S + s) * G + g]);
    float l_tot = 0.f, o_tot = 0.f;
    for (int s = 0; s < S; ++s) {
      const size_t r = (bh * S + s) * G + g;
      const float w = expf(m[r] - m_max);  // <= 1: never overflows
      l_tot = fmaf(l[r], w, l_tot);
      o_tot = fmaf(mid_o[r * Dv + d], w, o_tot);
    }
    out[(bh * G + g) * Dv + d] = o_tot / fmaxf(l_tot, 1e-30f);
  }
}

template <typename T>
int launch_split(int G, dim3 grid, size_t smem, cudaStream_t st, const void* q,
                 const void* kp, const void* vp, const int32_t* ptab,
                 const int32_t* lens, int P, int KVH, int Dh, int ps, int NP, int S,
                 int pps, float scale, float* mid_o, float* m, float* l) {
  const T* q_ = static_cast<const T*>(q);
  const T* k_ = static_cast<const T*>(kp);
  const T* v_ = static_cast<const T*>(vp);
#define W2K_SPLIT(GG)                                                              \
  paged_split_kernel<T, GG><<<grid, kThreads, smem, st>>>(                         \
      q_, k_, v_, ptab, lens, P, KVH, Dh, ps, NP, S, pps, scale, mid_o, m, l)
  switch (G) {
    case 1: W2K_SPLIT(1); break;
    case 2: W2K_SPLIT(2); break;
    case 4: W2K_SPLIT(4); break;
    case 8: W2K_SPLIT(8); break;
    default: return -3;
  }
#undef W2K_SPLIT
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 fp32, 1 bf16, 2 fp16. Returns 0, a cudaError_t, or a negative
// code for shapes the kernel does not take.
extern "C" int w2k_paged_split(const void* q, const void* kp, const void* vp,
                               const int32_t* ptab, const int32_t* lens, int dtype,
                               int B, int P, int KVH, int G, int Dh, int ps, int NP,
                               int S, float scale, float* mid_o, float* m, float* l,
                               void* stream) {
  const int esize = dtype == 0 ? 4 : 2;
  const int V = 16 / esize;
  if (dtype < 0 || dtype > 2 || Dh % V) return -1;
  const int lpt = Dh / V;
  if (lpt > 32 || (lpt & (lpt - 1))) return -1;
  const int ntg = kThreads / lpt;
  if (ps < 1 || ps > kMaxPass * ntg || NP < 1 || P < 1) return -2;
  if (B <= 0) return 0;
  S = S < 1 ? 1 : (S > NP ? NP : S);
  const int pps = (NP + S - 1) / S;
  const size_t smem = (static_cast<size_t>(G) * ps + static_cast<size_t>(ntg) * G * Dh) *
                      sizeof(float);
  if (smem > 48 * 1024) return -2;
  const dim3 grid(static_cast<unsigned>(B) * KVH * S);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_split<float>(G, grid, smem, st, q, kp, vp, ptab, lens, P, KVH, Dh,
                                 ps, NP, S, pps, scale, mid_o, m, l);
    case 1:
      return launch_split<__nv_bfloat16>(G, grid, smem, st, q, kp, vp, ptab, lens, P,
                                         KVH, Dh, ps, NP, S, pps, scale, mid_o, m, l);
    default:
      return launch_split<__half>(G, grid, smem, st, q, kp, vp, ptab, lens, P, KVH, Dh,
                                  ps, NP, S, pps, scale, mid_o, m, l);
  }
}

extern "C" int w2k_paged_combine(const float* mid_o, const float* m, const float* l,
                                 int BH, int S, int G, int Dv, float* out,
                                 void* stream) {
  if (BH <= 0 || G * Dv <= 0) return 0;
  if (S < 1) return -1;
  paged_combine_kernel<<<BH, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      mid_o, m, l, S, G, Dv, out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* w2k_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
