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
// the conv output.
//
// What bounds it on an H100: mostly bytes. For large M the product does
// K * N / (K + N) FLOP per byte of bf16 x and y: 32-51 at ResNet-50's
// stage-1 shapes (K, N = 64 .. 256, the largest M), up to 683 at the
// widest stage-4 shape (K = 1024, N = 2048), against the ~295 FLOP per
// byte at which the bf16 tensor cores (989 TFLOP/s) outrun the 3.35 TB/s
// of HBM. Summed over the 36 launches of a training step the bytes
// dominate the bound. The kernel's job is therefore to read x and w
// once, write y once, and add nothing but two [N] vectors of statistics
// (the reduction XLA re-reads y for on the TPU), while keeping the
// tensor cores busy enough not to become the limit at the wide layers.
//
// Design (right and simple first; wgmma, TMA and reading NCHW directly
// are later work):
//  - one block of 256 threads per 128 x 64 output tile: grid
//    (ceil(M/128), ceil(N/64)). The TPU grid walks m innermost and keeps
//    the statistics in VMEM across the sweep; CUDA blocks run in no
//    order, so each block writes its tile's column partials to
//    part_s/part_q [gm, N] and a second small kernel sums them over gm
//    in a fixed order. That keeps the statistics deterministic, bit for
//    bit from run to run (fp32 atomicAdd would not be), which matters
//    because they normalise every later layer;
//  - bf16: x and w tiles (128 x 32 and 32 x 64) are staged in shared
//    memory and multiplied with nvcuda::wmma 16x16x16 bf16 fragments
//    into fp32 accumulators (mma.sync on the tensor cores); each of the
//    8 warps owns a 32 x 32 sub-tile (2 x 2 fragments);
//  - fp32: the same tiles, multiplied with fp32 FMAs on the CUDA cores
//    (no TF32: the plain version is full fp32), each thread owning an
//    8 x 4 register tile;
//  - loads are 16-byte vectors where a row is in bounds and 16-byte
//    aligned, scalar with bounds checks otherwise: any M, K and N work,
//    with no padding to tiles (the TPU pads to 512 / 128 / 256). Out-of-
//    bounds elements are staged as zeros, so they add 0 to the product
//    and the partial sums;
//  - epilogue: the fp32 accumulators go through shared memory (the
//    staging buffers are reused), y is written row-coalesced in x's
//    dtype, and 4 threads per column reduce the tile's y and y^2 over
//    its valid rows, combined in a fixed order.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

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
