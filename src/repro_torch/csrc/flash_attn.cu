// Full-sequence flash attention for Hopper (sm_90a), forward: two kernels,
// routed by dtype in the wrapper (kernels/flash_attn/ops.py).
//
// Replaces: src/repro/kernels/flash_attn/flash_attn.py::_kernel (reached
// through flash_attention_pallas).
//
// Both compute, for q (B, Sq, H, D), k (B, Skv, KVH, D), v (B, Skv, KVH, D)
// of one dtype and D in {16, 32, 64, 96, 128}:
//   out[b, i, h] = sum_j p_ij v[b, j, h / G] / max(l_i, 1e-30),   G = H / KVH,
// over the fp32 scores s_ij = D^-0.5 q[b, i, h] . k[b, j, h / G], kept where
// key j is valid for query i (positions count from 0 on both sides, Sq may
// differ from Skv; `causal`: j <= i; `window` > 0: j > i - window) and NEG =
// -1e30 elsewhere. The row max m_i and sum l_i are taken online over key
// tiles; each tile's p_ij = exp(s_ij - m_i) is added to l_i unrounded and
// rounded to v's dtype before the PV product, as the Pallas kernel does.
// Keys past Skv score -inf. Output in q's dtype.
//
// What bounds it on the H100: per valid (query, key) pair and head the
// function takes 4 D flops (QK^T and PV). At the training shape (8 x 256
// tokens, 16 heads, D 128) that is 2.2 GFLOP against 25 MB of q, k, v and
// out in bf16, and at a 32,768-token prefill 4.4 TFLOP per layer against
// 0.4 GB. On the bf16 tensor cores (989 TFLOP/s, reached only through
// wgmma) the training shape is bound by its bytes (7.5 us), the prefill by
// its operations (4.4 ms); fp32 inputs by 67 TFLOP/s of fp32 on the CUDA
// cores (tensor cores would compute them in TF32, outside the fp32
// tolerance).
//
// flash_fwd_tc_kernel (bf16 and fp16): the tensor-core kernel.
//  * One block of three warpgroups per (b*H + h, tile of 128 query rows),
//    the longest (causal) rows scheduled first. Warpgroup 0 is the
//    producer: after setmaxnreg gives its registers away, one thread issues
//    every TMA load. Warpgroups 1 and 2 own 64 query rows each and take 240
//    registers.
//  * TMA maps are 4-D over (D, heads, S, B) with a box of (C, 1, 128, 1),
//    so a tile never crosses a head or a batch whatever the row stride (H*D
//    for q, KVH*D for k and v); rows past Sq or Skv arrive as zeros. A
//    row of D is loaded as D / C boxes of C columns, C*2 bytes being the
//    swizzle span (C = 64: 128-byte swizzle at D 64 and 128; C = 32: 64-byte
//    at D 32 and 96; C = 16: 32-byte at D 16), the layout wgmma's shared-
//    memory descriptors read. The maps are encoded on the host for every
//    call by cuTensorMapEncodeTiled, which the runtime hands out (no -lcuda).
//  * Shared memory holds the q tile (loaded once) and a ring of two (K, V)
//    stages of 128 keys: 160 KB at D 128, one block per SM. Each stage has
//    a "full" mbarrier (armed with the bytes TMA brings) and an "empty"
//    one that every consumer thread arrives on once its wgmmas have read
//    the stage, so the producer keeps the next tile in flight while the
//    current one is multiplied.
//  * S = Q K^T: wgmma m64n128k16, both operands in shared memory (K rows
//    are D-contiguous: K-major), fp32 accumulators in registers; the scale
//    D^-0.5 log2(e) is applied to the fp32 scores after the product, and
//    the softmax runs in base 2 (exp2f), which gives exp(s - m) up to fp32
//    rounding. Each thread holds two rows' scores; a row's max and sum are
//    taken across the 4 lanes that share it.
//  * O += P V: P is rounded to T in registers and fed as wgmma's A operand
//    (the accumulator layout of S is the register-A layout of P); V is B
//    from shared memory with D contiguous (MN-major, transposed
//    descriptor). O is 64 x D fp32 in registers per consumer warpgroup;
//    the epilogue divides by max(l, 1e-30) and stores rows < Sq.
//  * The KV walk is kv_tiles(): from the window's first tile to the causal
//    diagonal, so fully masked tiles are skipped (a masked score seen
//    before a row's first valid key is wiped by exp(NEG - m) = 0 when that
//    key arrives, one seen after it adds exp(NEG - m) = 0). A block whose
//    last row sees no key at all (a window that ends before Skv) walks
//    every tile instead: such a row keeps m = NEG, every key adds p = 1,
//    and it comes out as the mean of v, as the oracle's softmax over an
//    all-NEG row does. Producer and consumers take their range from the
//    same function: a mismatch would leave a barrier waiting forever.
//
// flash_fwd_kernel (fp32): the CUDA-core kernel.
//  * One block of 128 threads per (b*H + h, tile of 64 query rows); the
//    TPU's sequential KV axis becomes a loop inside the block with the
//    running (m, l) and the output rows in registers, over 64-key tiles
//    with the same walk rules. The q tile is staged once in shared memory,
//    scaled; each K and V tile after it. Thread (ty, tx) of 16 x 8 owns
//    query rows 4 ty .. 4 ty + 3: it takes the scores of keys tx + 8 j
//    (j < 8), the row max and sum across the 8 lanes of its row by
//    shuffles, and output columns 4 tx + 32 c (+0..3). At D 16 the lanes
//    tx >= 4 repeat the columns of tx - 4 and store nothing. The K rows are
//    padded by 4 floats so the 8 lanes' 16-byte reads hit distinct banks;
//    after the scores the K buffer holds p. Shared memory: 99,328 bytes at
//    D 128, two blocks per SM.
//
// Each launch function raises its kernel's dynamic shared-memory cap once
// per device, keyed by cudaGetDevice(): the attribute belongs to one
// device's context.

#include <cuda.h>  // CUtensorMap and its enums; the encoder comes from the runtime
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "smem_cap.cuh"

namespace {

constexpr float kNeg = -1e30f;

// ---------------------------------------------------------------------------
// The fp32 CUDA-core kernel.

constexpr int kThreads = 128;
constexpr int kBQ = 64;       // query rows per block
constexpr int kBK = 64;       // keys per tile
static_assert(kBQ == kBK, "stage_tile stages 64-row tiles of either");
constexpr int kRows = 4;      // query rows per thread
constexpr int kCols = 8;      // keys per thread per tile: tx + 8 j
constexpr int kPS = kBK + 4;  // row stride of the p tile

// Stage the 64 rows from src on of a (rows, row_stride) fp32 array into
// dst[64][STRIDE] times `mul` (a q tile or a K or V tile: kBQ == kBK); rows
// at or past n_valid are zeros. Each thread moves 16-byte chunks (rows are
// 16-byte aligned: D*4 is a multiple of 16 and the wrapper checks the base
// pointers).
template <int D, int STRIDE>
__device__ __forceinline__ void stage_tile(const float* __restrict__ src, size_t row_stride,
                                           int n_valid, float* dst, float mul) {
  constexpr int kChunks = D / 4;
  for (int e = threadIdx.x; e < kBK * kChunks; e += kThreads) {
    const int r = e / kChunks, c = e % kChunks;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < n_valid) {
      x = __ldg(reinterpret_cast<const float4*>(src + static_cast<size_t>(r) * row_stride +
                                                c * 4));
      x = make_float4(x.x * mul, x.y * mul, x.z * mul, x.w * mul);
    }
    *reinterpret_cast<float4*>(dst + r * STRIDE + c * 4) = x;
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

template <int D>
__global__ void __launch_bounds__(kThreads, 2)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out, int H, int KVH, int Sq,
                 int Skv, int causal, int window, float scale) {
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
  const float* k_base = k + (static_cast<size_t>(b) * Skv * KVH + kvh) * D;
  const float* v_base = v + (static_cast<size_t>(b) * Skv * KVH + kvh) * D;
  stage_tile<D, D>(q + ((static_cast<size_t>(b) * Sq + q0) * H + h) * D, q_stride, q_rows,
                   qs, scale);

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
    stage_tile<D, D + 4>(k_base + static_cast<size_t>(k0) * kv_stride, kv_stride, k_rows, ks,
                         1.f);
    stage_tile<D, D>(v_base + static_cast<size_t>(k0) * kv_stride, kv_stride, k_rows, vs, 1.f);
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

    // s becomes p, summed into l (in fp32, v's dtype, p needs no rounding)
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
        s[i][j] = expf(s[i][j] - m_new);
        sum += s[i][j];
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
    float* dst = out + ((static_cast<size_t>(b) * Sq + q0 + row) * H + h) * D + col0;
#pragma unroll
    for (int c = 0; c < kC; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) dst[32 * c + e] = o[i][4 * c + e] / denom;
  }
}

template <int D>
int launch_d(const void* q, const void* k, const void* v, void* out, int B, int Sq, int Skv,
             int H, int KVH, int causal, int window, float scale, cudaStream_t st) {
  const size_t smem = flash_smem_bytes<D>();
  static size_t caps[kMaxDevices] = {};  // one set per D
  int rc = raise_smem_cap(flash_fwd_kernel<D>, smem, caps);
  if (rc) return rc;
  // two blocks per SM need the largest shared-memory carveout (a hint, set
  // in the current device's context on every launch: it costs no sync)
  rc = static_cast<int>(cudaFuncSetAttribute(flash_fwd_kernel<D>,
                                             cudaFuncAttributePreferredSharedMemoryCarveout,
                                             cudaSharedmemCarveoutMaxShared));
  if (rc) return rc;
  const dim3 grid(static_cast<unsigned>(B) * H, (Sq + kBQ - 1) / kBQ);
  flash_fwd_kernel<D><<<grid, kThreads, smem, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(out), H, KVH, Sq, Skv, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// The bf16 / fp16 tensor-core kernel.

namespace tc {

constexpr int kBQ = 128;      // query rows per block: two consumer warpgroups of 64
constexpr int kBK = 128;      // keys per K / V tile
constexpr int kStages = 2;    // (K, V) stages in the ring
constexpr int kThreads = 384; // the producer warpgroup and two consumers
constexpr int kConsumers = 256;
constexpr float kLog2e = 1.4426950408889634f;

// The shared-memory geometry of a 128-row tile of D columns: D / C boxes of
// 128 rows by C columns, each row of a box C*2 bytes (the swizzle span).
template <int D>
struct Tile {
  static constexpr int kC = D % 64 == 0 ? 64 : D % 32 == 0 ? 32 : 16;
  static constexpr int kBoxes = D / kC;
  static constexpr int kLine = kC * 2;                // bytes per row of a box
  static constexpr int kBoxBytes = 128 * kLine;
  static constexpr int kBytes = kBoxes * kBoxBytes;  // = 128 * D * 2
  // wgmma's descriptor layout code: 1 = 128-byte swizzle, 2 = 64, 3 = 32
  static constexpr uint64_t kLayout = kLine == 128 ? 1 : kLine == 64 ? 2 : 3;
  static constexpr CUtensorMapSwizzle kSwizzle =
      kLine == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                   : kLine == 64 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_32B;
  static_assert(D % 16 == 0 && kBoxes * kC == D, "D is a multiple of 16");
};

// q, a K and V ring, the barriers; +1024 to align the tiles to the swizzle
// repeat (the hardware swizzles on address bits)
template <int D>
constexpr size_t smem_bytes() {
  return static_cast<size_t>(1 + 2 * kStages) * Tile<D>::kBytes + 8 * (1 + 2 * kStages) + 1024;
}

struct KvRange {
  int lo, hi;
};

// The 128-key tiles that the block of query rows [q0, q0 + 128) walks. The
// producer and the consumers both take their range from here.
__device__ __forceinline__ KvRange kv_tiles(int q0, int Sq, int Skv, int causal, int window) {
  const int q_last = min(q0 + kBQ, Sq) - 1;
  KvRange r{0, (Skv + kBK - 1) / kBK};
  const bool blind = window > 0 && q_last - window + 1 > Skv - 1;  // last row sees no key
  if (!blind) {
    if (causal) r.hi = min(q_last, Skv - 1) / kBK + 1;
    if (window > 0) r.lo = max(0, q0 - window + 1) / kBK;
  }
  return r;
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

// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// one box of a 4-D map, coordinates innermost first, into shared memory
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// A wgmma shared-memory descriptor: start address, leading and stride byte
// offsets (16-byte units) and the swizzle layout.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                         uint64_t layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 | layout << 62;
}

// K-major (q and K: rows with D contiguous): 8-row groups kLine * 8 bytes
// apart; the leading offset is unused with a swizzle. The k-th 16-column
// step starts 32 bytes on within its box's row.
template <int D>
__device__ __forceinline__ uint64_t desc_k_major(uint32_t tile, int ks) {
  using G = Tile<D>;
  constexpr int kSteps = G::kC / 16;  // 16-column steps per box
  return desc(tile + (ks / kSteps) * G::kBoxBytes + (ks % kSteps) * 32, 16, 8 * G::kLine,
              G::kLayout);
}

// MN-major (V as the B operand of P V: N = D contiguous): C-column blocks
// along N one box apart (the leading offset), 8-key groups along K kLine * 8
// bytes apart (the stride offset). The kk-th 16-key step starts 16 rows on.
template <int D>
__device__ __forceinline__ uint64_t desc_mn_major(uint32_t tile, int kk) {
  using G = Tile<D>;
  return desc(tile + kk * 16 * G::kLine, G::kBoxBytes, 8 * G::kLine, G::kLayout);
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

// Keep the compiler from moving reads or writes of wgmma's registers across
// the asynchronous window.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Operand lists of the wgmma asm: fp32 accumulators, and their register
// numbers in the template string.
#define W2K_ACC8(d, i)                                                                    \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]),            \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define W2K_ACC16(d, i) W2K_ACC8(d, i), W2K_ACC8(d, i + 8)
#define W2K_ACC32(d, i) W2K_ACC16(d, i), W2K_ACC16(d, i + 16)
#define W2K_D8 "%0, %1, %2, %3, %4, %5, %6, %7"
#define W2K_D16 W2K_D8 ", %8, %9, %10, %11, %12, %13, %14, %15"
#define W2K_D32 W2K_D16 ", %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, " \
                        "%29, %30, %31"
#define W2K_D48 W2K_D32 ", %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, " \
                        "%45, %46, %47"
#define W2K_D64 W2K_D48 ", %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, " \
                        "%61, %62, %63"

// d (+)= A B for one 16-deep step; `scale` names the operand that says
// whether d is added to (nonzero) or overwritten
#define W2K_WGMMA(SHAPE, OPS, SCALE, IMM, ...)                                            \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, " SCALE ", 0;\n"                         \
               "wgmma.mma_async.sync.aligned." SHAPE " " OPS ", p, " IMM ";\n}\n"         \
               : __VA_ARGS__)

// S (64 x 128, fp32) = Q K^T over one 16-column step, both from shared memory
template <typename T>
__device__ __forceinline__ void wgmma_qk(float (&d)[64], uint64_t da, uint64_t db,
                                         int accumulate) {
  if constexpr (std::is_same_v<T, __nv_bfloat16>)
    W2K_WGMMA("m64n128k16.f32.bf16.bf16", "{" W2K_D64 "}, %64, %65", "%66", "1, 1, 0, 0",
              W2K_ACC32(d, 0), W2K_ACC32(d, 32) : "l"(da), "l"(db), "r"(accumulate));
  else
    W2K_WGMMA("m64n128k16.f32.f16.f16", "{" W2K_D64 "}, %64, %65", "%66", "1, 1, 0, 0",
              W2K_ACC32(d, 0), W2K_ACC32(d, 32) : "l"(da), "l"(db), "r"(accumulate));
}

// O (64 x D, fp32) += P V over one 16-key step: P from registers, V (MN-major,
// transposed) from shared memory. With R = D / 2 accumulators, the A
// registers are %R..%R+3, the B descriptor %R+4 and the scale operand %R+5.
#define W2K_PV(TY, N, DREGS, R, ...)                                                     \
  W2K_WGMMA("m64n" #N "k16.f32." TY "." TY, "{" DREGS "}, " W2K_PV_AB_##R,              \
            W2K_PV_SCALE_##R, "1, 1, 1", __VA_ARGS__                                    \
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1))
#define W2K_PV_AB_8 "{%8, %9, %10, %11}, %12"
#define W2K_PV_SCALE_8 "%13"
#define W2K_PV_AB_16 "{%16, %17, %18, %19}, %20"
#define W2K_PV_SCALE_16 "%21"
#define W2K_PV_AB_32 "{%32, %33, %34, %35}, %36"
#define W2K_PV_SCALE_32 "%37"
#define W2K_PV_AB_48 "{%48, %49, %50, %51}, %52"
#define W2K_PV_SCALE_48 "%53"
#define W2K_PV_AB_64 "{%64, %65, %66, %67}, %68"
#define W2K_PV_SCALE_64 "%69"

template <typename T, int D>
__device__ __forceinline__ void wgmma_pv(float (&d)[D / 2], const uint32_t (&a)[4],
                                         uint64_t db) {
  constexpr bool kBf16 = std::is_same_v<T, __nv_bfloat16>;
  if constexpr (D == 16) {
    if constexpr (kBf16) W2K_PV("bf16", 16, W2K_D8, 8, W2K_ACC8(d, 0));
    else W2K_PV("f16", 16, W2K_D8, 8, W2K_ACC8(d, 0));
  } else if constexpr (D == 32) {
    if constexpr (kBf16) W2K_PV("bf16", 32, W2K_D16, 16, W2K_ACC16(d, 0));
    else W2K_PV("f16", 32, W2K_D16, 16, W2K_ACC16(d, 0));
  } else if constexpr (D == 64) {
    if constexpr (kBf16) W2K_PV("bf16", 64, W2K_D32, 32, W2K_ACC32(d, 0));
    else W2K_PV("f16", 64, W2K_D32, 32, W2K_ACC32(d, 0));
  } else if constexpr (D == 96) {
    if constexpr (kBf16) W2K_PV("bf16", 96, W2K_D48, 48, W2K_ACC32(d, 0), W2K_ACC16(d, 32));
    else W2K_PV("f16", 96, W2K_D48, 48, W2K_ACC32(d, 0), W2K_ACC16(d, 32));
  } else {
    static_assert(D == 128, "head dims 16, 32, 64, 96, 128");
    if constexpr (kBf16) W2K_PV("bf16", 128, W2K_D64, 64, W2K_ACC32(d, 0), W2K_ACC32(d, 32));
    else W2K_PV("f16", 128, W2K_D64, 64, W2K_ACC32(d, 0), W2K_ACC32(d, 32));
  }
}

// two fp32 values rounded to T and packed, the lower column in the low half
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    const __nv_bfloat162 x = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&x);
  } else {
    const __half2 x = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&x);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_tc_kernel(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v, T* __restrict__ out, int H,
                    int KVH, int Sq, int Skv, int causal, int window, float scale_log2) {
  using G = Tile<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sq = (smem_addr(smem_raw) + 1023) & ~1023u;  // the q tile
  const uint32_t sk = sq + G::kBytes;                          // K tiles [kStages]
  const uint32_t sv = sk + kStages * G::kBytes;                // V tiles [kStages]
  const uint32_t q_full = sv + kStages * G::kBytes;            // then full, empty [kStages]
  const auto full = [&](int s) { return q_full + 8 * (1 + s); };
  const auto empty = [&](int s) { return q_full + 8 * (1 + kStages + s); };

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int kvh = h / (H / KVH);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;  // longest rows first
  const KvRange range = kv_tiles(q0, Sq, Skv, causal, window);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // the producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x != 0) return;
    mbar_expect_tx(q_full, G::kBytes);
    for (int c = 0; c < G::kBoxes; ++c)
      tma_load(sq + c * G::kBoxBytes, &tm_q, q_full, c * G::kC, h, q0, b);
    for (int t = range.lo, it = 0; t < range.hi; ++t, ++it) {
      const int s = it % kStages;
      mbar_wait(empty(s), ((it / kStages) & 1) ^ 1);  // the first round passes at once
      mbar_expect_tx(full(s), 2 * G::kBytes);
      for (int c = 0; c < G::kBoxes; ++c) {
        tma_load(sk + s * G::kBytes + c * G::kBoxBytes, &tm_k, full(s), c * G::kC, kvh,
                 t * kBK, b);
        tma_load(sv + s * G::kBytes + c * G::kBoxBytes, &tm_v, full(s), c * G::kC, kvh,
                 t * kBK, b);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const int cw = threadIdx.x / 128 - 1;  // consumer 0 or 1: query rows 64 cw on
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int wq0 = q0 + 64 * cw;           // this warpgroup's first query row
  const int row = wq0 + 16 * warp + lane / 4;  // this thread's rows: row, row + 8
  // Accumulator layout (m64nN): element 4 j + e sits in row row + 8 (e >> 1),
  // column 8 j + 2 (lane % 4) + (e & 1).
  const uint32_t sq_wg = sq + 64 * cw * G::kLine;  // this warpgroup's 64 q rows in each box

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};  // l: this thread's share of the row sum
  float s[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) s[i] = 0.f;

  mbar_wait(q_full, 0);
  for (int t = range.lo, it = 0; t < range.hi; ++t, ++it) {
    const int st = it % kStages;
    mbar_wait(full(st), (it / kStages) & 1);

    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
      wgmma_qk<T>(s, desc_k_major<D>(sq_wg, ks), desc_k_major<D>(sk + st * G::kBytes, ks),
                  ks > 0);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);

    const int k0 = t * kBK;
#pragma unroll
    for (int i = 0; i < 64; ++i) s[i] *= scale_log2;
    // a tile that reaches past Skv, past a row's diagonal or before a row's
    // window (uniform over the warpgroup) is masked element by element
    if (k0 + kBK > Skv || (causal && k0 + kBK - 1 > wq0) ||
        (window > 0 && k0 <= wq0 + 63 - window)) {
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        const int kpos = k0 + 8 * (i / 4) + 2 * (lane % 4) + (i & 1);
        const int qpos = row + 8 * ((i >> 1) & 1);
        if (kpos >= Skv)
          s[i] = -INFINITY;
        else if ((causal && kpos > qpos) || (window > 0 && kpos <= qpos - window))
          s[i] = kNeg;
      }
    }

    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < 64; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      corr[r] = exp2f(m[r] - m_new);
      m[r] = m_new;
      l[r] *= corr[r];
    }
    // p: added to l unrounded, rounded to T as the A operand of P V
    uint32_t pa[8][4];
#pragma unroll
    for (int i = 0; i < 64; i += 2) {
      const int r = (i >> 1) & 1;
      const float p0 = exp2f(s[i] - m[r]), p1 = exp2f(s[i + 1] - m[r]);
      l[r] += p0 + p1;
      // key step i / 8 (16 keys); within it, registers 0 / 1 hold keys 0-7
      // of rows row / row + 8, registers 2 / 3 keys 8-15
      pa[i / 8][(i / 4) % 2 * 2 + r] = pack2<T>(p0, p1);
    }
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] *= corr[(i >> 1) & 1];

    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
      wgmma_pv<T, D>(o, pa[kk], desc_mn_major<D>(sv + st * G::kBytes, kk));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o);
    mbar_arrive(empty(st));  // this thread's reads of the stage are done
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    l[r] = fmaxf(l[r], 1e-30f);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qpos = row + 8 * r;
    if (qpos >= Sq) continue;
    T* dst = out + ((static_cast<size_t>(b) * Sq + qpos) * H + h) * D +
             2 * (lane % 4);
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(dst + 8 * j) =
          pack2<T>(o[4 * j + 2 * r] / l[r], o[4 * j + 2 * r + 1] / l[r]);
  }
}

// cuTensorMapEncodeTiled, fetched once through the CUDA runtime
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                           cudaEnableDefault, &found);
#else
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return e == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A 4-D map over (D, heads, S, B) of a contiguous (B, S, heads, D) array,
// with a box of (C, 1, 128, 1)
template <typename T, int D>
int encode(CUtensorMap* map, const void* ptr, int B, int S, int heads) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  const cuuint64_t row = static_cast<cuuint64_t>(D) * sizeof(T);
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(S), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {row, row * heads, row * heads * S};  // bytes, dims 1..3
  const cuuint32_t box[4] = {Tile<D>::kC, 1, kBQ, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = fn(map,
                        std::is_same_v<T, __nv_bfloat16> ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                                         : CU_TENSOR_MAP_DATA_TYPE_FLOAT16,
                        4, const_cast<void*>(ptr), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, Tile<D>::kSwizzle,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

template <typename T, int D>
int launch_d(const void* q, const void* k, const void* v, void* out, int B, int Sq, int Skv,
             int H, int KVH, int causal, int window, float scale, cudaStream_t st) {
  static_assert(kBQ == kBK, "one box height for q and for K / V");
  CUtensorMap tq, tk, tv;
  int rc = encode<T, D>(&tq, q, B, Sq, H);
  if (!rc) rc = encode<T, D>(&tk, k, B, Skv, KVH);
  if (!rc) rc = encode<T, D>(&tv, v, B, Skv, KVH);
  if (rc) return rc;
  const size_t smem = smem_bytes<D>();
  static size_t caps[kMaxDevices] = {};  // one set per dtype and D
  rc = raise_smem_cap(flash_fwd_tc_kernel<T, D>, smem, caps);
  if (rc) return rc;
  const dim3 grid(static_cast<unsigned>(B) * H, (Sq + kBQ - 1) / kBQ);
  flash_fwd_tc_kernel<T, D><<<grid, kThreads, smem, st>>>(
      tq, tk, tv, static_cast<T*>(out), H, KVH, Sq, Skv, causal, window, scale * kLog2e);
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

}  // namespace tc

// the checks both entry points make; 0 when the launch may go ahead
int check_shapes(int D, int B, int Sq, int Skv, int H, int KVH, int window, int block_q) {
  if (D != 16 && D != 32 && D != 64 && D != 96 && D != 128) return -1;
  if (KVH < 1 || H % KVH) return -2;
  if (Skv < 1 || window < 0 || (Sq + block_q - 1) / block_q > 65535) return -3;
  return 0;
}

}  // namespace

// q (B, Sq, H, D), k and v (B, Skv, KVH, D), out (B, Sq, H, D), all
// contiguous and 16-byte aligned. Each entry returns 0, a cudaError_t, or a
// negative code for shapes or dtypes it does not take.

// fp32 (dtype 0) on the CUDA cores
extern "C" int w2k_flash_fwd(const void* q, const void* k, const void* v, void* out,
                             int dtype, int B, int Sq, int Skv, int H, int KVH, int D,
                             int causal, int window, float scale, void* stream) {
  if (const int rc = check_shapes(D, B, Sq, Skv, H, KVH, window, kBQ)) return rc;
  if (dtype != 0) return -4;
  if (B <= 0 || Sq <= 0 || H <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16:
      return launch_d<16>(q, k, v, out, B, Sq, Skv, H, KVH, causal, window, scale, st);
    case 32:
      return launch_d<32>(q, k, v, out, B, Sq, Skv, H, KVH, causal, window, scale, st);
    case 64:
      return launch_d<64>(q, k, v, out, B, Sq, Skv, H, KVH, causal, window, scale, st);
    case 96:
      return launch_d<96>(q, k, v, out, B, Sq, Skv, H, KVH, causal, window, scale, st);
    default:
      return launch_d<128>(q, k, v, out, B, Sq, Skv, H, KVH, causal, window, scale, st);
  }
}

// bf16 (dtype 1) or fp16 (dtype 2) on the tensor cores
extern "C" int w2k_flash_fwd_tc(const void* q, const void* k, const void* v, void* out,
                                int dtype, int B, int Sq, int Skv, int H, int KVH, int D,
                                int causal, int window, float scale, void* stream) {
  if (const int rc = check_shapes(D, B, Sq, Skv, H, KVH, window, tc::kBQ)) return rc;
  if (B <= 0 || Sq <= 0 || H <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 1:
      return tc::launch<__nv_bfloat16>(D, q, k, v, out, B, Sq, Skv, H, KVH, causal, window,
                                       scale, st);
    case 2:
      return tc::launch<__half>(D, q, k, v, out, B, Sq, Skv, H, KVH, causal, window, scale,
                                st);
    default:
      return -4;
  }
}

extern "C" const char* w2k_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
