// Flash-attention forward (K1), fp32 or bf16 I/O, for Hopper (sm_90a).
//
// Replaces the TPU kernel paddle_tpu/pallas/flash_attention.py
// _fwd_kernel (:171), launched by _fwd_online (:684): softmax(q k^T *
// scale [+ causal mask]) v computed tile by tile with the online-softmax
// recurrence, so the [T, T] score matrix never reaches device memory.
// Returns o [BH, T, d] and the row log-sum-exp lse [BH, T], which the
// ring merge and the backward kernels consume.
//
// What bounds it on an H100: arithmetic. At the serving shape (BH = 16,
// T = 512, d = 128, causal) the visited half of the score matrix costs
// 4 * BH * T^2 * d / 2 = 1.07 GFLOP against 16.8 MB of q, k, v and o,
// i.e. ~64 FLOP per byte: ~16 us at the 67 TFLOP/s fp32 (non-tensor
// core) peak against ~5 us for the bytes at 3.35 TB/s. At the training
// shape (BH = 128, bf16) it is 8.6 GFLOP against 67 MB: ~8.7 us at the
// bf16 tensor-core peak, which this CUDA-core kernel does not reach.
//
// Design (right and simple first; tensor cores, wgmma and TMA are later
// work):
//  - one block of 256 threads per (64-row q tile, bh): grid
//    (ceil(T/64), BH). Nothing carries between blocks, so the TPU's
//    sequential ki grid axis becomes a loop inside the block;
//  - each K/V tile (64 rows) is staged in shared memory; Q, K, V tiles
//    use a row stride of d + 1 floats so the column reads of the score
//    product hit 16 distinct banks. At d = 128 Q + K + V + P take 113 KB,
//    above the 48 KB static limit, so shared memory is dynamic after
//    cudaFuncSetAttribute;
//  - thread (ty, tx) of a 16 x 16 grid owns score rows ty + 16 i and
//    columns tx + 16 j (i, j < 4) and output columns tx + 16 c: a 4 x 4
//    register tile, so each shared-memory load feeds two FMAs;
//  - the row max and row sum are reduced over the 16 lanes of a row with
//    warp shuffles; m, l and the output accumulator stay in fp32
//    registers for the whole sweep;
//  - causal tiles stop the sweep at the diagonal tile; keys at index >= T
//    are masked, so any T works (no T % 128 rule as on the TPU);
//  - masked scores are -1e30 and a fully masked row uses 0 as its safe
//    max, exactly as the TPU kernel does, so exp() underflows to 0;
//  - bf16 I/O (the training path under AMP): q, k, v are widened to fp32
//    as they are staged, m, l, the accumulator and lse stay fp32, and o
//    is rounded to bf16 once, at the store. The fp32 instantiation is the
//    serving path's kernel, unchanged.
#include "flash_common.cuh"

namespace {

using flash::kNegInf;
using flash::kThreads;
constexpr int kBlockQ = flash::kBlock;
constexpr int kBlockK = flash::kBlock;

template <int D, typename Elem>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const Elem* __restrict__ q, const Elem* __restrict__ k,
                 const Elem* __restrict__ v, Elem* __restrict__ o,
                 float* __restrict__ lse, int T, int causal,
                 float sm_scale) {
  constexpr int LD = D + 1;         // padded row stride of Q, K, V tiles
  constexpr int LDP = kBlockK + 1;  // padded row stride of the P tile
  constexpr int CPT = D / 16;       // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + kBlockQ * LD;
  float* Vs = Ks + kBlockK * LD;
  float* Ps = Vs + kBlockK * LD;

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const long base = (long)blockIdx.y * T * D;
  const int q0 = blockIdx.x * kBlockQ;

  // q is scaled as it is staged, as the TPU kernel scales q before q k^T
  flash::load_tile<D>(Qs, q + base, q0, T, sm_scale, tid);

  float m[4], l[4], acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;
  }

  const int nk = (T + kBlockK - 1) / kBlockK;
  int last = nk - 1;
  if (causal) last = min(last, (q0 + kBlockQ - 1) / kBlockK);

  for (int kt = 0; kt <= last; ++kt) {
    const int k0 = kt * kBlockK;
    flash::load_tile<D>(Ks, k + base, k0, T, 1.f, tid);
    flash::load_tile<D>(Vs, v + base, k0, T, 1.f, tid);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int kk = 0; kk < D; ++kk) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty + 16 * i) * LD + kk];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * LD + kk];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k0 + tx + 16 * j;
        if (kj >= T || (causal && kj > qi)) s[i][j] = kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      // the 16 lanes holding one row are one half of a warp
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float safe_m = m_new <= kNegInf / 2 ? 0.f : m_new;
      const float corr =
          expf((m[i] <= kNegInf / 2 ? safe_m : m[i]) - safe_m);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - safe_m);
        Ps[(ty + 16 * i) * LDP + tx + 16 * j] = p;
        rs += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * corr + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[i][c] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kBlockK; ++kk) {
      float pv[4], vv[CPT];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty + 16 * i) * LDP + kk];
#pragma unroll
      for (int c = 0; c < CPT; ++c) vv[c] = Vs[kk * LD + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < CPT; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
    __syncthreads();  // K, V and P are overwritten by the next tile
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= T) continue;
    const float safe_l = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < CPT; ++c)
      o[base + (long)row * D + tx + 16 * c] =
          flash::from_f32<Elem>(acc[i][c] / safe_l);
    if (tx == 0) {
      lse[(long)blockIdx.y * T + row] =
          m[i] <= kNegInf / 2 ? kNegInf : m[i] + logf(safe_l);
    }
  }
}

template <int D, typename Elem>
int launch(const Elem* q, const Elem* k, const Elem* v, Elem* o, float* lse,
           int bh, int t, int causal, float sm_scale, cudaStream_t stream) {
  const int smem =
      (3 * kBlockQ * (D + 1) + kBlockQ * (kBlockK + 1)) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D, Elem>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((t + kBlockQ - 1) / kBlockQ, bh);
  flash_fwd_kernel<D, Elem><<<grid, kThreads, smem, stream>>>(
      q, k, v, o, lse, t, causal, sm_scale);
  return (int)cudaGetLastError();
}

template <typename Elem>
int dispatch(const void* q, const void* k, const void* v, void* o,
             float* lse, int bh, int t, int d, int causal, float sm_scale,
             void* stream) {
  const Elem* qe = static_cast<const Elem*>(q);
  const Elem* ke = static_cast<const Elem*>(k);
  const Elem* ve = static_cast<const Elem*>(v);
  Elem* oe = static_cast<Elem*>(o);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 64)
    return launch<64, Elem>(qe, ke, ve, oe, lse, bh, t, causal, sm_scale, s);
  if (d == 128)
    return launch<128, Elem>(qe, ke, ve, oe, lse, bh, t, causal, sm_scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q, k, v, o: [bh, t, d] contiguous, 16-byte aligned, fp32 (_f32) or
// bf16 (_bf16); lse: [bh, t] fp32. d is 64 or 128. Launches on `stream`
// and returns the CUDA error code of the launch (0 on success); it does
// not synchronise.
extern "C" int flash_attention_fwd_f32(const void* q, const void* k,
                                       const void* v, void* o, float* lse,
                                       int bh, int t, int d, int causal,
                                       float sm_scale, void* stream) {
  return dispatch<float>(q, k, v, o, lse, bh, t, d, causal, sm_scale,
                         stream);
}

extern "C" int flash_attention_fwd_bf16(const void* q, const void* k,
                                        const void* v, void* o, float* lse,
                                        int bh, int t, int d, int causal,
                                        float sm_scale, void* stream) {
  return dispatch<__nv_bfloat16>(q, k, v, o, lse, bh, t, d, causal,
                                 sm_scale, stream);
}
