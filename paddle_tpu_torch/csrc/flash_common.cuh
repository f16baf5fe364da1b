// Shared pieces of the flash-attention kernels (flash_attention_fwd.cu,
// flash_attention_bwd.cu): tile sizes, fp32/bf16 loads, tile staging, and
// the launch of one block per (64-row tile, bh).
//
// The CUDA-core kernels (all but the bf16 K4a and K4b, which keep bf16
// tiles for the tensor cores: hopper.cuh) stage 64-row tiles of [T, D]
// matrices (q, k, v, dO) in shared memory as fp32 with a row stride of
// D + 1 floats: the column reads of the tile products then hit distinct
// banks. bf16 inputs are widened to fp32 as they are staged; all math is
// fp32.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace flash {

constexpr int kBlock = 64;     // rows of a q or k tile
constexpr int kThreads = 256;  // a 16 x 16 thread grid, 4 x 4 outputs each
constexpr float kNegInf = -1e30f;

template <typename Elem>
__device__ __forceinline__ Elem from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even
}

// One 16-byte load of consecutive elements, widened to fp32.
template <typename Elem>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ static void load(const float* p, float* out) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x;
    out[1] = v.y;
    out[2] = v.z;
    out[3] = v.w;
  }
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void load(const __nv_bfloat16* p, float* out) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
};

// Stage rows [row0, row0 + kBlock) of a [T, D] matrix as fp32 times
// `scale`, row stride D + 1; rows >= T are zeros.
template <int D, typename Elem>
__device__ __forceinline__ void load_tile(float* dst, const Elem* src,
                                          int row0, int T, float scale,
                                          int tid) {
  constexpr int V = Vec<Elem>::N;
  constexpr int kVecs = D / V;  // 16-byte loads per row
  for (int idx = tid; idx < kBlock * kVecs; idx += kThreads) {
    const int r = idx / kVecs;
    const int c = (idx % kVecs) * V;
    float val[V];
    if (row0 + r < T) {
      Vec<Elem>::load(src + (long)(row0 + r) * D + c, val);
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i) val[i] = 0.f;
    }
    float* d = dst + r * (D + 1) + c;
#pragma unroll
    for (int i = 0; i < V; ++i) d[i] = val[i] * scale;
  }
}

// Stage kBlock entries of a per-row fp32 vector (lse, delta); rows >= T
// are zeros.
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          int row0, int T, int tid) {
  for (int r = tid; r < kBlock; r += kThreads)
    dst[r] = row0 + r < T ? src[row0 + r] : 0.f;
}

// Launch one block of kThreads per (64-row tile, bh), grid (ceil(t/64),
// bh), with `smem` bytes of dynamic shared memory; returns the CUDA error
// code of the launch.
template <typename... KArgs, typename... Args>
int run(void (*kernel)(KArgs...), int smem, int bh, int t, void* stream,
        Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((t + kBlock - 1) / kBlock, bh);
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      args...);
  return (int)cudaGetLastError();
}

// f(std::integral_constant<int, D>()) for a head dim d of 64 or 128.
template <typename F>
int by_dim(int d, F f) {
  if (d == 64) return f(std::integral_constant<int, 64>());
  if (d == 128) return f(std::integral_constant<int, 128>());
  return (int)cudaErrorInvalidValue;
}

}  // namespace flash
