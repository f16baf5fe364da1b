// Fused matmul + batch-norm statistics (K6), fp32 or bf16 I/O, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel paddle_tpu/pallas/conv_bn.py _kernel (:38),
// launched by _pallas_impl (:71): y = x @ w with fp32 accumulation, y
// stored in x's dtype, and the column sums colsum = sum_m y and
// colsumsq = sum_m y^2 in fp32, taken from the fp32 accumulators before
// y is rounded. ops/fused_ops.py feeds it every 1x1 conv + BN of a
// ResNet as x [M, K] = the NHWC-flattened activations, w [K, N] = the
// transposed filter, so the BN statistics never need a second read of
// the conv output. The statistics are the same bits on every launch:
// fixed orders of summation, no atomics.
//
// What bounds it on an H100: mostly bytes. For large M the product does
// K * N / (K + N) FLOP per byte of bf16 x and y: 32-51 at ResNet-50's
// stage-1 shapes (K, N = 64 .. 256, the largest M), up to 683 at the
// widest stage-4 shape (K = 1024, N = 2048), against the ~295 FLOP per
// byte at which the bf16 tensor cores (989 TFLOP/s) outrun the 3.35 TB/s
// of HBM. Of the 15 shapes of a ResNet-50 step at batch 256, the ten
// with M >= 50176 and K or N <= 256 are bound by bytes (x read once, y
// written once), the four at M = 12544 and [50176, 512, 1024] by
// operations. The job is to read x and w once, write y once at HBM's
// rate, keep the tensor cores fed where K is deep, and add nothing but
// [N] vectors of statistics.
//
// Two kernels, routed by kernels/conv_bn.py _route:
//
// matmul_bn_stats_wgmma_kernel<BN> (namespace tc): bf16 with K % 8 == 0
// and N % 8 == 0 (TMA needs 16-byte rows), which is every ResNet shape.
//  - Tiles are 128 x BN (BN = 128, or 64 where N <= 64) over a depth of
//    64: an x slice [128, 64] is one 128-byte-swizzled panel (the
//    K-major A operand), a w slice [64, BN] is BN / 64 such panels with
//    N along the rows (the MN-major B operand, as V is in K1's P V). Two
//    consumer warpgroups take 64 rows each, one wgmma m64nBNk16 per 16
//    of depth, fp32 accumulators in registers (BN / 2 a thread).
//  - A persistent grid: CTA c walks tiles c, c + grid, ... of the tiles
//    numbered m-tile major (the n-blocks of an m-tile adjacent, so the
//    CTAs running at one time share x through L2 and HBM sees x once).
//    The grid is the largest multiple of the n-block count within the
//    132 SMs (128 at N = 1024 and 2048), so each CTA keeps one n-block
//    for its walk (kernels/conv_bn.py _plan).
//  - Why not BN = 256 (x read once per m-tile even through L2): its
//    stage (48 KB) and staging tile (64 KB) leave room for a 3-stage
//    ring, too shallow to cover the loads; BN = 128 gets 5-8 stages and
//    keeps w resident at K <= 256, and measured as fast or faster at
//    every ResNet-50 shape (PERF.md, section 6).
//  - The pipeline: one producer thread (warp 8) issues TMA loads
//    (cp.async.bulk.tensor, zeros outside the matrix) into a ring of
//    3-8 stages, each completing on a "full" mbarrier; the consumers
//    release a stage on its "empty" mbarrier once their wgmma on it has
//    been waited for, keeping one wgmma group in flight. The producer
//    runs ahead across tiles, so the next tile's x arrives under this
//    tile's products and epilogue. Where w's [K, BN] block fits in 64
//    KB (K <= 256 at BN 128, K <= 512 at BN 64) it is loaded once per
//    CTA and stays resident.
//  - The epilogue: each warpgroup rounds its accumulators to bf16 pairs
//    into a swizzled staging tile (conflict-free 4-byte stores), and one
//    thread stores it with TMA (rows >= M and columns >= N are not
//    written); the store runs under the next tile's products and is
//    waited for (its read of shared memory) only before the staging
//    tile is written again.
//  - The statistics, from the fp32 accumulators: each thread adds its
//    two rows' y and y^2 per column, the 8 lanes of a column combine by
//    a fixed 3-step reduce-scatter butterfly (__shfl_xor 16, 8, 4; each
//    lane keeps an eighth of the columns), and each lane adds the result
//    to its running sums in shared memory, tile after tile in walk
//    order. At the end of the walk the 8 warps' sums are added in order
//    of warp; the CTA writes one row of partials, and column_sums_kernel
//    adds the grid / gn rows of each column in order. Rows beyond M and
//    columns beyond N are zeros in the accumulators.
//
// matmul_bn_stats_kernel<Elem> (the first cut, namespace-local): fp32
// (exact FMAs on the CUDA cores, no TF32: the plain version is full
// fp32) and bf16 with K or N not a multiple of 8 (nvcuda::wmma 16x16x16
// fragments) or rows not 16-byte aligned.
//  - one block of 256 threads per 128 x 64 output tile: grid
//    (ceil(M/128), ceil(N/64)); each block writes its tile's column
//    partials to part_s/part_q [gm, N] and column_sums_kernel sums them
//    over gm in a fixed order;
//  - x and w tiles (128 x 32 and 32 x 64) are staged in shared memory;
//    loads are 16-byte vectors where a row is in bounds and 16-byte
//    aligned, scalar with bounds checks otherwise, out-of-bounds
//    elements staged as zeros: any M, K and N work;
//  - epilogue: the fp32 accumulators go through shared memory, y is
//    written row-coalesced in x's dtype, and 4 threads per column reduce
//    the tile's y and y^2 over its valid rows, combined in a fixed order.
#include <cuda.h>  // CUtensorMap and its enums; the encoder is looked up
                    // at run time, so nothing links -lcuda
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kBM = 128;      // rows of an output tile
constexpr int kBN = 64;       // columns of an output tile
constexpr int kBK = 32;       // depth of a staged k slice
constexpr int kThreads = 256;
constexpr int kLdA = kBK + 8;     // bf16 row strides: multiples of 8 for
constexpr int kLdB = kBN + 8;     // wmma, and off the 128-byte bank period
constexpr int kLdAf = kBM + 4;    // fp32 k-major A tile [kBK][kBM]
constexpr int kLdBf = kBN + 4;    // fp32 B tile [kBK][kBN]
constexpr int kLdC = kBN + 4;     // fp32 epilogue tile [kBM][kBN]

// shared memory: the staging tiles of the main loop and the epilogue's
// fp32 output tile share one buffer
constexpr int kBytesBf16 =
    (kBM * kLdA + kBK * kLdB) * (int)sizeof(__nv_bfloat16);
constexpr int kBytesF32 = (kBK * kLdAf + kBK * kLdBf) * (int)sizeof(float);
constexpr int kBytesC = (kBM * kLdC) * (int)sizeof(float);
constexpr int kSmemBytes =
    (kBytesC > kBytesF32 ? (kBytesC > kBytesBf16 ? kBytesC : kBytesBf16)
                         : (kBytesF32 > kBytesBf16 ? kBytesF32 : kBytesBf16));
static_assert(kSmemBytes <= 48 * 1024, "static shared memory limit");

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);  // round to nearest even, once
}

// --- staging ----------------------------------------------------------------

// bf16 tile rows [r0, r0 + R) x columns [c0, c0 + C) of a row-major
// [rows, cols] matrix into dst[R][ld]; out-of-bounds elements are zeros.
template <int R, int C>
__device__ __forceinline__ void stage_bf16(__nv_bfloat16* dst, int ld,
                                           const __nv_bfloat16* src,
                                           int rows, int cols, int r0,
                                           int c0, bool vec_ok, int tid) {
  constexpr int kVec = 8;  // bf16 per 16-byte load
  constexpr int kChunks = C / kVec;
  const __nv_bfloat16 zero = __float2bfloat16(0.f);
  for (int idx = tid; idx < R * kChunks; idx += kThreads) {
    const int r = idx / kChunks;
    const int c = (idx % kChunks) * kVec;
    const int gr = r0 + r, gc = c0 + c;
    __nv_bfloat16* d = dst + r * ld + c;
    if (gr < rows && vec_ok && gc + kVec <= cols) {
      *reinterpret_cast<uint4*>(d) =
          *reinterpret_cast<const uint4*>(src + (long)gr * cols + gc);
    } else {
#pragma unroll
      for (int i = 0; i < kVec; ++i)
        d[i] = (gr < rows && gc + i < cols) ? src[(long)gr * cols + gc + i]
                                            : zero;
    }
  }
}

// fp32 x tile rows [m0, m0 + kBM) x k [k0, k0 + kBK), stored k-major
// (dst[k][m]) so that the product reads a row of 8 m values per k.
__device__ __forceinline__ void stage_a_f32(float* dst, const float* x,
                                            int M, int K, int m0, int k0,
                                            bool vec_ok, int tid) {
  constexpr int kChunks = kBK / 4;
  for (int idx = tid; idx < kBM * kChunks; idx += kThreads) {
    const int r = idx / kChunks;
    const int c = (idx % kChunks) * 4;
    const int gm = m0 + r, gk = k0 + c;
    float v[4];
    if (gm < M && vec_ok && gk + 4 <= K) {
      const float4 f = *reinterpret_cast<const float4*>(x + (long)gm * K + gk);
      v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        v[i] = (gm < M && gk + i < K) ? x[(long)gm * K + gk + i] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) dst[(c + i) * kLdAf + r] = v[i];
  }
}

// fp32 w tile k [k0, k0 + kBK) x columns [n0, n0 + kBN) into dst[k][n].
__device__ __forceinline__ void stage_b_f32(float* dst, const float* w,
                                            int K, int N, int k0, int n0,
                                            bool vec_ok, int tid) {
  constexpr int kChunks = kBN / 4;
  for (int idx = tid; idx < kBK * kChunks; idx += kThreads) {
    const int r = idx / kChunks;
    const int c = (idx % kChunks) * 4;
    const int gk = k0 + r, gn = n0 + c;
    float* d = dst + r * kLdBf + c;
    if (gk < K && vec_ok && gn + 4 <= N) {
      *reinterpret_cast<float4*>(d) =
          *reinterpret_cast<const float4*>(w + (long)gk * N + gn);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        d[i] = (gk < K && gn + i < N) ? w[(long)gk * N + gn + i] : 0.f;
    }
  }
}

// --- main loops: the tile's product into the fp32 epilogue tile Cs ----------

__device__ __forceinline__ void product_bf16(
    unsigned char* smem, const __nv_bfloat16* x, const __nv_bfloat16* w,
    int M, int K, int N, int m0, int n0, int tid) {
  using namespace nvcuda;
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Bs = As + kBM * kLdA;
  const int warp = tid / 32;
  const int wm = (warp / 2) * 32;  // 4 warps down M
  const int wn = (warp % 2) * 32;  // 2 warps across N
  const bool vec_x = (K % 8 == 0) && ((uintptr_t)x % 16 == 0);
  const bool vec_w = (N % 8 == 0) && ((uintptr_t)w % 16 == 0);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int k0 = 0; k0 < K; k0 += kBK) {
    stage_bf16<kBM, kBK>(As, kLdA, x, M, K, m0, k0, vec_x, tid);
    stage_bf16<kBK, kBN>(Bs, kLdB, w, K, N, k0, n0, vec_w, tid);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], As + (wm + 16 * i) * kLdA + kk, kLdA);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], Bs + kk * kLdB + wn + 16 * j, kLdB);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();  // the tiles are overwritten by the next slice
  }

  float* Cs = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wm + 16 * i) * kLdC + wn + 16 * j,
                              acc[i][j], kLdC, wmma::mem_row_major);
  __syncthreads();
}

__device__ __forceinline__ void product_f32(unsigned char* smem,
                                            const float* x, const float* w,
                                            int M, int K, int N, int m0,
                                            int n0, int tid) {
  float* As = reinterpret_cast<float*>(smem);  // [kBK][kLdAf], k-major
  float* Bs = As + kBK * kLdAf;                // [kBK][kLdBf]
  const int tx = tid % 16;  // columns tx + 16 j, j < 4
  const int ty = tid / 16;  // rows ty + 16 i, i < 8
  const bool vec_x = (K % 4 == 0) && ((uintptr_t)x % 16 == 0);
  const bool vec_w = (N % 4 == 0) && ((uintptr_t)w % 16 == 0);

  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kBK) {
    stage_a_f32(As, x, M, K, m0, k0, vec_x, tid);
    stage_b_f32(Bs, w, K, N, k0, n0, vec_w, tid);
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kBK; ++kk) {
      float a[8], b[4];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = As[kk * kLdAf + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[kk * kLdBf + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  float* Cs = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      Cs[(ty + 16 * i) * kLdC + tx + 16 * j] = acc[i][j];
  __syncthreads();
}

// --- the kernel -------------------------------------------------------------

template <typename Elem>
__global__ void __launch_bounds__(kThreads)
matmul_bn_stats_kernel(const Elem* __restrict__ x, const Elem* __restrict__ w,
                       Elem* __restrict__ y, float* __restrict__ part_s,
                       float* __restrict__ part_q, int M, int K, int N) {
  __shared__ __align__(128) unsigned char smem[kSmemBytes];
  __shared__ float red_s[4][kBN];
  __shared__ float red_q[4][kBN];
  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;

  if constexpr (sizeof(Elem) == 2)
    product_bf16(smem, x, w, M, K, N, m0, n0, tid);
  else
    product_f32(smem, x, w, M, K, N, m0, n0, tid);
  const float* Cs = reinterpret_cast<const float*>(smem);

  // y, rounded once to Elem, consecutive threads on consecutive columns
  for (int idx = tid; idx < kBM * kBN; idx += kThreads) {
    const int r = idx / kBN, c = idx % kBN;
    if (m0 + r < M && n0 + c < N)
      store(y + (long)(m0 + r) * N + n0 + c, Cs[r * kLdC + c]);
  }

  // the tile's column partials of y and y^2 from the fp32 values: thread
  // (part, c) sums rows part, part + 4, ... ; the 4 parts are then added
  // in a fixed order
  const int c = tid % kBN;
  const int part = tid / kBN;
  const int rows = min(kBM, M - m0);
  float s = 0.f, q = 0.f;
  for (int r = part; r < rows; r += 4) {
    const float v = Cs[r * kLdC + c];
    s += v;
    q = fmaf(v, v, q);
  }
  red_s[part][c] = s;
  red_q[part][c] = q;
  __syncthreads();
  if (part == 0 && n0 + c < N) {
    const long o = (long)blockIdx.x * N + n0 + c;
    part_s[o] = ((red_s[0][c] + red_s[1][c]) + red_s[2][c]) + red_s[3][c];
    part_q[o] = ((red_q[0][c] + red_q[1][c]) + red_q[2][c]) + red_q[3][c];
  }
}

// colsum[n] = sum_g part_s[g, n] (and colsumsq from part_q), in a fixed
// order: thread (tx, ty) sums rows ty, ty + kRedY, ... of column tx, then
// the kRedY partials are added in order of ty.
constexpr int kRedX = 32, kRedY = 16;

__global__ void __launch_bounds__(kRedX * kRedY)
column_sums_kernel(const float* __restrict__ part_s,
                   const float* __restrict__ part_q, float* __restrict__ s,
                   float* __restrict__ q, int gm, int N) {
  __shared__ float rs[kRedY][kRedX + 1];
  __shared__ float rq[kRedY][kRedX + 1];
  const int tx = threadIdx.x % kRedX;
  const int ty = threadIdx.x / kRedX;
  const int n = blockIdx.x * kRedX + tx;
  float as = 0.f, aq = 0.f;
  if (n < N) {
    for (int g = ty; g < gm; g += kRedY) {
      as += part_s[(long)g * N + n];
      aq += part_q[(long)g * N + n];
    }
  }
  rs[ty][tx] = as;
  rq[ty][tx] = aq;
  __syncthreads();
  if (ty == 0 && n < N) {
    float ts = 0.f, tq = 0.f;
    for (int i = 0; i < kRedY; ++i) {
      ts += rs[i][tx];
      tq += rq[i][tx];
    }
    s[n] = ts;
    q[n] = tq;
  }
}

template <typename Elem>
int launch(const void* x, const void* w, void* y, float* part_s,
           float* part_q, float* s, float* q, int M, int K, int N,
           void* stream) {
  if (M < 1 || K < 1 || N < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int gm = (M + kBM - 1) / kBM;
  const int gn = (N + kBN - 1) / kBN;
  if (gn > 65535) return (int)cudaErrorInvalidValue;
  matmul_bn_stats_kernel<Elem><<<dim3(gm, gn), kThreads, 0, st>>>(
      static_cast<const Elem*>(x), static_cast<const Elem*>(w),
      static_cast<Elem*>(y), part_s, part_q, M, K, N);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  column_sums_kernel<<<(N + kRedX - 1) / kRedX, kRedX * kRedY, 0, st>>>(
      part_s, part_q, s, q, gm, N);
  return (int)cudaGetLastError();
}

}  // namespace

// --- the tensor-core kernel (bf16) -------------------------------------------

namespace tc {

constexpr int kBM = 128;               // rows of a tile: 2 warpgroups x 64
constexpr int kBK = 64;                // depth of a slice: one bf16 panel
constexpr int kConsumers = 256;        // two warpgroups
constexpr int kThreads = kConsumers + 32;  // + the producer warp
constexpr int kPanel = 64 * 128;       // 64 rows of 128 bytes
constexpr int kSliceA = kBM * 128;     // x [128, 64]
constexpr int kSmemLimit = 232448;

// Byte offsets from the 1024-aligned base of dynamic shared memory; the
// same arithmetic as kernels/conv_bn.py _smem_bytes.
struct Layout {
  int a, b, c, red, bars, total;
};

__host__ __device__ inline Layout layout(int bn, int stages, int resident,
                                         int K) {
  const int w_slices = resident ? (K + kBK - 1) / kBK : stages;
  Layout L;
  L.a = 0;                                // x ring: stages x [128, 64]
  L.b = stages * kSliceA;                 // w: slices of [64, bn]
  L.c = L.b + w_slices * bn * 128;        // y staging: [128, bn] bf16
  L.red = L.c + kBM * bn * 2;             // warps' sums: [8][2][bn] fp32
  L.bars = L.red + 8 * 2 * bn * 4;        // full[stages], empty[stages], w
  L.total = L.bars + 8 * (2 * stages + 1) + 1024;  // + alignment
  return L;
}

// One reduce-scatter step over the lanes `mask` apart: of v[0, 2 HALF)
// a lane keeps the half its lane bit selects, adds its partner's copy of
// that half, and leaves the sums in v[0, HALF).
template <int HALF, int N>
__device__ __forceinline__ void scatter_step(float (&v)[N], int lane,
                                             int mask) {
  const bool upper = (lane & mask) != 0;
#pragma unroll
  for (int i = 0; i < HALF; ++i) {
    const float lo = v[i], hi = v[i + HALF];
    const float keep = upper ? hi : lo, send = upper ? lo : hi;
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, mask);
  }
}

// Offset of reduce-scatter entry r of a lane from its first slot of the
// warps' sums: y^2 a row of BN further, then 8 columns per 4 entries.
template <int BN>
__host__ __device__ constexpr int run_slot(int r) {
  return ((r >> 1) & 1) * BN + 8 * (r >> 2) + (r & 1);
}

template <int BN>
__global__ void __launch_bounds__(kThreads, 1)
matmul_bn_stats_wgmma_kernel(const __grid_constant__ CUtensorMap tm_x,
                             const __grid_constant__ CUtensorMap tm_w,
                             const __grid_constant__ CUtensorMap tm_y,
                             float* __restrict__ part_s,
                             float* __restrict__ part_q, int M, int K, int N,
                             int stages, int resident) {
  constexpr int kPanels = BN / 64;
  constexpr int kSliceB = BN * 128;  // w [64, BN]
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = hopper::align_1024(smem_raw);
  const Layout L = layout(BN, stages, resident, K);
  const uint32_t full = base + L.bars;
  const uint32_t empty = full + 8 * stages;
  const uint32_t bar_w = empty + 8 * stages;
  float* red = reinterpret_cast<float*>(
      smem_raw + (base - hopper::smem_addr(smem_raw)) + L.red);
  const int tid = threadIdx.x;
  const int gn = (N + BN - 1) / BN;
  const int tiles = ((M + kBM - 1) / kBM) * gn;
  const int slices = (K + kBK - 1) / kBK;
  // the grid is a multiple of gn: this CTA's tiles share one n-block
  const int n0 = (blockIdx.x % gn) * BN;
  // w panels that hold a column < N (a panel wholly beyond N is not
  // loaded; its columns of the product are never stored or summed)
  const int w_panels = min(kPanels, (N - n0 + 63) / 64);

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      hopper::mbar_init(full + 8 * s, 1);
      hopper::mbar_init(empty + 8 * s, kConsumers / 32);
    }
    hopper::mbar_init(bar_w, 1);
    hopper::fence_mbar_init();
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // the producer: one thread keeps the ring full, tile after tile
    if (tid != kConsumers) return;
    if (resident) {
      hopper::mbar_arrive_expect_tx(bar_w, slices * w_panels * kPanel);
      for (int kb = 0; kb < slices; ++kb)
        for (int p = 0; p < w_panels; ++p)
          hopper::tma_load_2d(base + L.b + kb * kSliceB + p * kPanel, &tm_w,
                              n0 + 64 * p, kb * kBK, bar_w);
    }
    const uint32_t tx = kSliceA + (resident ? 0 : w_panels * kPanel);
    int s = 0, phase = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int m0 = (t / gn) * kBM;
      for (int kb = 0; kb < slices; ++kb) {
        hopper::mbar_wait(empty + 8 * s, phase ^ 1);
        const uint32_t bar = full + 8 * s;
        hopper::mbar_arrive_expect_tx(bar, tx);
        hopper::tma_load_2d(base + L.a + s * kSliceA, &tm_x, kb * kBK, m0,
                            bar);
        if (!resident)
          for (int p = 0; p < w_panels; ++p)
            hopper::tma_load_2d(base + L.b + s * kSliceB + p * kPanel, &tm_w,
                                n0 + 64 * p, kb * kBK, bar);
        if (++s == stages) {
          s = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // the consumers: warpgroup wg holds rows 64 wg .. 64 wg + 63 of a tile;
  // warp w4 of it rows 16 w4 + g and 16 w4 + g + 8, columns 8 j + 2 t4 + e
  const int wg = tid / 128;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int w4 = warp % 4, g = lane / 4, t4 = lane % 4;
  const bool leader = tid % 128 == 0;
  float acc[BN / 2];
  // this lane's running column sums, in slots of red [8][2][BN] that no
  // other lane touches: entry i = g BN / 16 + r of the reduce-scatter
  // below is column 8 (i / 4) + 2 t4 + i % 2, y (i / 2 even) or y^2
  // (odd); BN / 16 is a multiple of 4, so r alone sets i % 4
  float* const run = red + warp * 2 * BN + 8 * g * (BN / 64) + 2 * t4;
#pragma unroll
  for (int r = 0; r < BN / 16; ++r) run[run_slot<BN>(r)] = 0.f;
  if (resident) hopper::mbar_wait(bar_w, 0);

  const uint32_t stage_y = base + L.c + wg * kPanels * kPanel;
  int s = 0, phase = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int m0 = (t / gn) * kBM;
    int held = 0;
    for (int kb = 0; kb < slices; ++kb) {
      hopper::mbar_wait(full + 8 * s, phase);
      const uint32_t a = base + L.a + s * kSliceA + wg * (64 * 128);
      const uint32_t b = base + L.b + (resident ? kb : s) * kSliceB;
      hopper::fence_regs(acc);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
        // 16 of depth: 32 bytes into each x row, 16 rows down each w panel
        hopper::mma_ss_mn<BN>(acc, hopper::desc_sw128(a + kk * 32, 0, 1024),
                              hopper::desc_sw128(b + kk * (16 * 128), kPanel,
                                                 1024),
                              (kb > 0 || kk > 0) ? 1 : 0);
      hopper::wgmma_commit();
      hopper::wgmma_wait<1>();
      hopper::fence_regs(acc);
      // the previous slice's products are done: its stage may refill
      if (kb > 0 && lane == 0) hopper::mbar_arrive(empty + 8 * held);
      held = s;
      if (++s == stages) {
        s = 0;
        phase ^= 1;
      }
    }
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc);
    if (lane == 0) hopper::mbar_arrive(empty + 8 * held);

    // y: bf16 pairs into the staging tile (swizzled as TMA stores it),
    // once the previous tile's store has read it
    if (leader) hopper::bulk_wait_read<0>();
    hopper::named_barrier(1 + wg, 128);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = 16 * w4 + g + 8 * h;  // r % 8 == g
        hopper::st_shared_b32(
            stage_y + (j / 8) * kPanel + r * 128 + (((j % 8) ^ g) << 4) +
                4 * t4,
            hopper::pack_bf16(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]));
      }
    hopper::fence_view_async_shared();
    hopper::named_barrier(1 + wg, 128);
    if (leader && m0 + 64 * wg < M) {
      for (int p = 0; p < w_panels; ++p)
        hopper::tma_store_2d(&tm_y, n0 + 64 * p, m0 + 64 * wg,
                             stage_y + p * kPanel);
      hopper::bulk_commit();
    }

    // statistics from the fp32 accumulators: per column, this thread's
    // two rows (s into acc[4 j + e], y^2 into acc[4 j + 2 + e]) ...
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float y0 = acc[4 * j + e], y1 = acc[4 * j + 2 + e];
        acc[4 * j + e] = y0 + y1;
        acc[4 * j + 2 + e] = fmaf(y1, y1, y0 * y0);
      }
    // ... then the 8 lanes g of a column by reduce-scatter: lane g ends
    // with entries [g BN / 16, (g + 1) BN / 16) of acc summed over the
    // warp's 16 rows, in acc[0, BN / 16)
    scatter_step<BN / 4>(acc, lane, 16);
    scatter_step<BN / 8>(acc, lane, 8);
    scatter_step<BN / 16>(acc, lane, 4);
#pragma unroll
    for (int r = 0; r < BN / 16; ++r) run[run_slot<BN>(r)] += acc[r];
  }

  // the warps' sums meet in shared memory
  if (leader) hopper::bulk_wait_all();
  hopper::named_barrier(3, kConsumers);
  // one row of partials per CTA of this n-block, warps added in order
  const long row = (long)(blockIdx.x / gn) * N;
  for (int c = tid; c < BN; c += kConsumers) {
    if (n0 + c >= N) continue;
    float ss = 0.f, qq = 0.f;
#pragma unroll
    for (int w = 0; w < kConsumers / 32; ++w) {
      ss += red[(w * 2) * BN + c];
      qq += red[(w * 2 + 1) * BN + c];
    }
    part_s[row + n0 + c] = ss;
    part_q[row + n0 + c] = qq;
  }
}

// cuTensorMapEncodeTiled, looked up through the CUDA runtime.
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

EncodeTiledFn encoder() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A [rows, cols] row-major bf16 matrix as TMA boxes of box_rows x 64
// columns (128 bytes), 128-byte swizzle, zeros outside the matrix.
int encode(CUtensorMap* map, const void* ptr, int rows, int cols,
           int box_rows) {
  const EncodeTiledFn fn = encoder();
  if (fn == nullptr) return (int)cudaErrorSymbolNotFound;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_rows};
  const cuuint32_t steps[2] = {1, 1};
  const CUresult r =
      fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr),
         dims, strides, box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE,
         CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int BN>
int launch(const CUtensorMap& tx, const CUtensorMap& tw,
           const CUtensorMap& ty, float* part_s, float* part_q, int M, int K,
           int N, int grid, int stages, int resident, int smem,
           void* stream) {
  return hopper::launch_1d(matmul_bn_stats_wgmma_kernel<BN>, smem, grid,
                           kThreads, stream, tx, tw, ty, part_s, part_q, M, K,
                           N, stages, resident);
}

}  // namespace tc

// Rows of the output tile: part_s and part_q hold ceil(M / tile_m) rows.
extern "C" int matmul_bn_stats_tile_m() { return kBM; }

// x [M, K], w [K, N], y [M, N]: row-major, contiguous, fp32 (_f32) or
// bf16 (_bf16); part_s, part_q [ceil(M / tile_m), N] fp32 scratch;
// s, q [N] fp32. Launches the product kernel and the column-sum kernel
// on `stream` and returns the CUDA error code of the launches (0 on
// success); it does not synchronise.
extern "C" int matmul_bn_stats_f32(const void* x, const void* w, void* y,
                                   float* part_s, float* part_q, float* s,
                                   float* q, int M, int K, int N,
                                   void* stream) {
  return launch<float>(x, w, y, part_s, part_q, s, q, M, K, N, stream);
}

extern "C" int matmul_bn_stats_bf16(const void* x, const void* w, void* y,
                                    float* part_s, float* part_q, float* s,
                                    float* q, int M, int K, int N,
                                    void* stream) {
  return launch<__nv_bfloat16>(x, w, y, part_s, part_q, s, q, M, K, N,
                               stream);
}

// Dynamic shared memory of the tensor-core kernel for a plan.
extern "C" int matmul_bn_stats_wgmma_smem(int bn, int stages, int resident,
                                          int K) {
  return tc::layout(bn, stages, resident, K).total;
}

// The tensor-core kernel (bf16): x [M, K], w [K, N], y [M, N] row-major,
// contiguous, 16-byte aligned, K and N multiples of 8; the plan of
// kernels/conv_bn.py _plan: tile width bn (64 or 128), a grid that
// is a multiple of ceil(N / bn), the stages of the x ring and whether
// w's block stays resident. part_s, part_q [grid / ceil(N / bn), N] fp32
// scratch; s, q [N] fp32. Launches the kernel and the column-sum kernel
// on `stream` and returns the CUDA error code (0 on success); it does
// not synchronise.
extern "C" int matmul_bn_stats_wgmma(const void* x, const void* w, void* y,
                                     float* part_s, float* part_q, float* s,
                                     float* q, int M, int K, int N, int bn,
                                     int grid, int stages, int resident,
                                     void* stream) {
  if (M < 1 || K < 1 || N < 1 || K % 8 || N % 8 || stages < 2 ||
      ((uintptr_t)x | (uintptr_t)w | (uintptr_t)y) % 16)
    return (int)cudaErrorInvalidValue;
  if (bn != 64 && bn != 128) return (int)cudaErrorInvalidValue;
  const int gn = (N + bn - 1) / bn;
  if (grid < 1 || grid % gn) return (int)cudaErrorInvalidValue;
  const int smem = tc::layout(bn, stages, resident, K).total;
  if (smem > tc::kSmemLimit) return (int)cudaErrorInvalidValue;
  CUtensorMap tx, tw, ty;
  int err = tc::encode(&tx, x, M, K, tc::kBM);
  if (!err) err = tc::encode(&tw, w, K, N, tc::kBK);
  if (!err) err = tc::encode(&ty, y, M, N, 64);
  if (err) return err;
  if (bn == 128)
    err = tc::launch<128>(tx, tw, ty, part_s, part_q, M, K, N, grid, stages,
                          resident, smem, stream);
  else
    err = tc::launch<64>(tx, tw, ty, part_s, part_q, M, K, N, grid, stages,
                         resident, smem, stream);
  if (err) return err;
  column_sums_kernel<<<(N + kRedX - 1) / kRedX, kRedX * kRedY, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      part_s, part_q, s, q, grid / gn, N);
  return (int)cudaGetLastError();
}
