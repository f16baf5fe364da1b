// Flash-attention backward for Hopper (sm_90a), fp32 or bf16 I/O:
//
//   K2  flash_bwd_kv_kernel<D, Elem, true>   replaces the TPU kernel
//       paddle_tpu/pallas/flash_attention.py _bwd_kvmajor_kernel (:512),
//       launched by _bwd_kvmajor (:952): the default, kv-major one-pass
//       backward;
//   K3a flash_bwd_dq_kernel<D, Elem>          replaces _dq_kernel (:339),
//       launched by _bwd_split (:871);
//   K3b flash_bwd_kv_kernel<D, Elem, false>  replaces _dkv_kernel (:385),
//       launched by _bwd_split (:898). K3a + K3b are the split arm
//       (PADDLE_FLASH_BWD=split): deterministic, no atomics.
//
// Inputs: q, k, v, dO [BH, T, D] (fp32 or bf16), lse and
// delta = rowsum(dO * O) [BH, T] fp32 (delta is computed by the wrapper
// with a torch op, as the TPU package computes it outside its kernels).
// All three kernels share the per-pair math pair_grads (the TPU's
// _pair_grads, :365): for a (64-row q tile, 64-row k tile) pair
//   S  = (q * scale) k^T            masked to -1e30: P is exactly 0 past
//   P  = exp(S - lse)               the causal diagonal, for keys >= T
//   dP = dO v^T                     and for rows >= T, so any T works
//   dS = P * (dP - delta)
// and then dV += P^T dO, dK += dS^T (q * scale) (dk carries the scale
// through the pre-scaled q and gets no extra factor), dQ += dS k (dq is
// scaled once at the end).
//
// What bounds them on an H100: arithmetic. K2 does 5 matrix products
// per visited pair (10 * D FLOP per score): at the training shape
// (BH = 128, T = 512, D = 128, causal; 16.8M visited scores) that is
// 21.5 GFLOP against 84 MB of bf16 q, k, v, dO, dq, dk, dv + fp32 lse,
// delta, ~256 FLOP per byte. On the bf16 tensor cores the bound is
// ~22 us; these kernels run the products as fp32 FMAs on the CUDA cores
// (67 TFLOP/s peak), so they sit far above that bound. Tensor cores
// (mma.sync / wgmma) and TMA are later work.
//
// Design (right and simple first):
//  - K2 and K3b: one block of 256 threads per (64-row k tile, bh): grid
//    (ceil(T/64), BH). K and V stay in shared memory; the block loops over
//    q tiles from the first one the causal mask lets through,
//    first = k0 / 64 (the TPU's first_qi), staging Q (pre-scaled), dO,
//    lse and delta for each. dK and dV accumulate in fp32 registers and
//    are written once;
//  - K2's dQ: several k-tile blocks add to the same dQ rows, so each
//    block adds its partial dS k into a zeroed fp32 [BH, T, D] buffer
//    with atomicAdd (the TPU keeps a full-sequence dq scratch in VMEM; at
//    T = 512, D = 128 that is 256 KB per bh, over the 227 KB of shared
//    memory). The wrapper scales it by sm_scale and casts it. The
//    summation order varies from run to run;
//  - K3a: one block per (64-row q tile, bh) loops over k tiles up to the
//    diagonal and writes dQ directly;
//  - thread (ty, tx) of a 16 x 16 grid owns rows ty + 16 i and columns
//    tx + 16 j (i, j < 4) of each 64 x 64 pair tile, and rows ty + 16 i,
//    columns tx + 16 c of each 64 x D gradient tile: every shared-memory
//    load feeds two FMAs;
//  - at D = 128 the six tiles (Q, dO, K, V at stride D + 1, P and dS at
//    stride 65) take 162 KB of dynamic shared memory: one block per SM.
#include "flash_common.cuh"

namespace {

using flash::kBlock;
using flash::kThreads;

template <int D>
constexpr int smem_bytes() {
  return (4 * kBlock * (D + 1) + 2 * kBlock * (kBlock + 1) + 2 * kBlock) *
         (int)sizeof(float);
}

// The per-pair math shared by K2, K3a and K3b (module comment). Writes
// P and dS of the pair to Ps and dSs ([q][k], row stride kBlock + 1).
template <int D>
__device__ __forceinline__ void pair_grads(
    const float* Qs, const float* Ks, const float* Vs, const float* dOs,
    const float* lse_s, const float* delta_s, float* Ps, float* dSs, int q0,
    int k0, int T, int causal, int tx, int ty) {
  constexpr int LD = D + 1;
  constexpr int LDP = kBlock + 1;
  float s[4][4], dp[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      s[i][j] = 0.f;
      dp[i][j] = 0.f;
    }
#pragma unroll 4
  for (int kk = 0; kk < D; ++kk) {
    float qv[4], ov[4], kv[4], vv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      qv[i] = Qs[(ty + 16 * i) * LD + kk];
      ov[i] = dOs[(ty + 16 * i) * LD + kk];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      kv[j] = Ks[(tx + 16 * j) * LD + kk];
      vv[j] = Vs[(tx + 16 * j) * LD + kk];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
        dp[i][j] = fmaf(ov[i], vv[j], dp[i][j]);
      }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    const int qi = q0 + r;
    const float l = lse_s[r];
    const float dl = delta_s[r];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx + 16 * j;
      const int kj = k0 + c;
      const bool live = qi < T && kj < T && !(causal && kj > qi);
      const float p = live ? expf(s[i][j] - l) : 0.f;
      Ps[r * LDP + c] = p;
      dSs[r * LDP + c] = p * (dp[i][j] - dl);
    }
  }
}

// K2 (kDQ = true) and K3b (kDQ = false): one block per (k tile, bh).
template <int D, typename Elem, bool kDQ>
__global__ void __launch_bounds__(kThreads)
flash_bwd_kv_kernel(const Elem* __restrict__ q, const Elem* __restrict__ k,
                    const Elem* __restrict__ v, const Elem* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    float* __restrict__ dq_acc, Elem* __restrict__ dk,
                    Elem* __restrict__ dv, int T, int causal,
                    float sm_scale) {
  constexpr int LD = D + 1;
  constexpr int LDP = kBlock + 1;
  constexpr int CPT = D / 16;  // gradient columns per thread
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + kBlock * LD;
  float* Qs = Vs + kBlock * LD;
  float* dOs = Qs + kBlock * LD;
  float* Ps = dOs + kBlock * LD;
  float* dSs = Ps + kBlock * LDP;
  float* lse_s = dSs + kBlock * LDP;
  float* delta_s = lse_s + kBlock;

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const long base = (long)blockIdx.y * T * D;
  const long rbase = (long)blockIdx.y * T;
  const int k0 = blockIdx.x * kBlock;

  flash::load_tile<D>(Ks, k + base, k0, T, 1.f, tid);
  flash::load_tile<D>(Vs, v + base, k0, T, 1.f, tid);

  float dk_acc[4][CPT], dv_acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      dk_acc[i][c] = 0.f;
      dv_acc[i][c] = 0.f;
    }

  const int nq = (T + kBlock - 1) / kBlock;
  const int first = causal ? k0 / kBlock : 0;
  for (int qt = first; qt < nq; ++qt) {
    const int q0 = qt * kBlock;
    flash::load_tile<D>(Qs, q + base, q0, T, sm_scale, tid);
    flash::load_tile<D>(dOs, dout + base, q0, T, 1.f, tid);
    flash::load_rows(lse_s, lse + rbase, q0, T, tid);
    flash::load_rows(delta_s, delta + rbase, q0, T, tid);
    __syncthreads();

    pair_grads<D>(Qs, Ks, Vs, dOs, lse_s, delta_s, Ps, dSs, q0, k0, T,
                  causal, tx, ty);
    __syncthreads();

    // dV += P^T dO and dK += dS^T (q * scale): rows are keys
#pragma unroll 4
    for (int r = 0; r < kBlock; ++r) {
      float pv[4], sv[4], ov[CPT], qv[CPT];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pv[i] = Ps[r * LDP + ty + 16 * i];
        sv[i] = dSs[r * LDP + ty + 16 * i];
      }
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        ov[c] = dOs[r * LD + tx + 16 * c];
        qv[c] = Qs[r * LD + tx + 16 * c];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          dv_acc[i][c] = fmaf(pv[i], ov[c], dv_acc[i][c]);
          dk_acc[i][c] = fmaf(sv[i], qv[c], dk_acc[i][c]);
        }
    }

    if (kDQ) {
      // this k tile's share of dQ = dS k, added into the fp32 buffer
      float acc[4][CPT];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;
#pragma unroll 4
      for (int kc = 0; kc < kBlock; ++kc) {
        float sv[4], kv[CPT];
#pragma unroll
        for (int i = 0; i < 4; ++i) sv[i] = dSs[(ty + 16 * i) * LDP + kc];
#pragma unroll
        for (int c = 0; c < CPT; ++c) kv[c] = Ks[kc * LD + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < CPT; ++c) acc[i][c] = fmaf(sv[i], kv[c], acc[i][c]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = q0 + ty + 16 * i;
        if (row >= T) continue;
#pragma unroll
        for (int c = 0; c < CPT; ++c)
          atomicAdd(dq_acc + base + (long)row * D + tx + 16 * c, acc[i][c]);
      }
    }
    __syncthreads();  // Q, dO, P and dS are overwritten by the next tile
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = k0 + ty + 16 * i;
    if (row >= T) continue;
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const long at = base + (long)row * D + tx + 16 * c;
      dk[at] = flash::from_f32<Elem>(dk_acc[i][c]);
      dv[at] = flash::from_f32<Elem>(dv_acc[i][c]);
    }
  }
}

// K3a: one block per (q tile, bh); writes dq = sm_scale * sum_k dS k.
template <int D, typename Elem>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const Elem* __restrict__ q, const Elem* __restrict__ k,
                    const Elem* __restrict__ v, const Elem* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, Elem* __restrict__ dq,
                    int T, int causal, float sm_scale) {
  constexpr int LD = D + 1;
  constexpr int LDP = kBlock + 1;
  constexpr int CPT = D / 16;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + kBlock * LD;
  float* Qs = Vs + kBlock * LD;
  float* dOs = Qs + kBlock * LD;
  float* Ps = dOs + kBlock * LD;
  float* dSs = Ps + kBlock * LDP;
  float* lse_s = dSs + kBlock * LDP;
  float* delta_s = lse_s + kBlock;

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const long base = (long)blockIdx.y * T * D;
  const long rbase = (long)blockIdx.y * T;
  const int q0 = blockIdx.x * kBlock;

  flash::load_tile<D>(Qs, q + base, q0, T, sm_scale, tid);
  flash::load_tile<D>(dOs, dout + base, q0, T, 1.f, tid);
  flash::load_rows(lse_s, lse + rbase, q0, T, tid);
  flash::load_rows(delta_s, delta + rbase, q0, T, tid);

  float acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;

  const int nk = (T + kBlock - 1) / kBlock;
  int last = nk - 1;
  if (causal) last = min(last, (q0 + kBlock - 1) / kBlock);
  for (int kt = 0; kt <= last; ++kt) {
    const int k0 = kt * kBlock;
    flash::load_tile<D>(Ks, k + base, k0, T, 1.f, tid);
    flash::load_tile<D>(Vs, v + base, k0, T, 1.f, tid);
    __syncthreads();

    pair_grads<D>(Qs, Ks, Vs, dOs, lse_s, delta_s, Ps, dSs, q0, k0, T,
                  causal, tx, ty);
    __syncthreads();

#pragma unroll 4
    for (int kc = 0; kc < kBlock; ++kc) {
      float sv[4], kv[CPT];
#pragma unroll
      for (int i = 0; i < 4; ++i) sv[i] = dSs[(ty + 16 * i) * LDP + kc];
#pragma unroll
      for (int c = 0; c < CPT; ++c) kv[c] = Ks[kc * LD + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < CPT; ++c) acc[i][c] = fmaf(sv[i], kv[c], acc[i][c]);
    }
    __syncthreads();  // K, V and dS are overwritten by the next tile
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= T) continue;
#pragma unroll
    for (int c = 0; c < CPT; ++c)
      dq[base + (long)row * D + tx + 16 * c] =
          flash::from_f32<Elem>(acc[i][c] * sm_scale);
  }
}

template <typename Kernel>
cudaError_t prepare(Kernel kernel, int smem) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem);
}

template <int D, typename Elem, bool kDQ>
int launch_kv(const void* q, const void* k, const void* v, const void* dout,
              const float* lse, const float* delta, float* dq_acc, void* dk,
              void* dv, int bh, int t, int causal, float sm_scale,
              cudaStream_t stream) {
  auto kernel = flash_bwd_kv_kernel<D, Elem, kDQ>;
  const int smem = smem_bytes<D>();
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((t + kBlock - 1) / kBlock, bh);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const Elem*>(q), static_cast<const Elem*>(k),
      static_cast<const Elem*>(v), static_cast<const Elem*>(dout), lse, delta,
      dq_acc, static_cast<Elem*>(dk), static_cast<Elem*>(dv), t, causal,
      sm_scale);
  return (int)cudaGetLastError();
}

template <int D, typename Elem>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const float* lse, const float* delta, void* dq, int bh, int t,
              int causal, float sm_scale, cudaStream_t stream) {
  auto kernel = flash_bwd_dq_kernel<D, Elem>;
  const int smem = smem_bytes<D>();
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((t + kBlock - 1) / kBlock, bh);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const Elem*>(q), static_cast<const Elem*>(k),
      static_cast<const Elem*>(v), static_cast<const Elem*>(dout), lse, delta,
      static_cast<Elem*>(dq), t, causal, sm_scale);
  return (int)cudaGetLastError();
}

template <typename Elem, bool kDQ>
int kv(const void* q, const void* k, const void* v, const void* dout,
       const float* lse, const float* delta, float* dq_acc, void* dk,
       void* dv, int bh, int t, int d, int causal, float sm_scale,
       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 64)
    return launch_kv<64, Elem, kDQ>(q, k, v, dout, lse, delta, dq_acc, dk,
                                    dv, bh, t, causal, sm_scale, s);
  if (d == 128)
    return launch_kv<128, Elem, kDQ>(q, k, v, dout, lse, delta, dq_acc, dk,
                                     dv, bh, t, causal, sm_scale, s);
  return (int)cudaErrorInvalidValue;
}

template <typename Elem>
int dq_only(const void* q, const void* k, const void* v, const void* dout,
            const float* lse, const float* delta, void* dq, int bh, int t,
            int d, int causal, float sm_scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 64)
    return launch_dq<64, Elem>(q, k, v, dout, lse, delta, dq, bh, t, causal,
                               sm_scale, s);
  if (d == 128)
    return launch_dq<128, Elem>(q, k, v, dout, lse, delta, dq, bh, t, causal,
                                sm_scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Every entry point: q, k, v, dout and the gradients are [bh, t, d]
// contiguous and 16-byte aligned, fp32 (_f32) or bf16 (_bf16); lse,
// delta [bh, t] fp32; d is 64 or 128. Each launches on `stream` and
// returns the CUDA error code of the launch (0 on success); none
// synchronises.

// K2. dq_acc: [bh, t, d] fp32, zeroed by the caller; receives sum dS k
// (not yet scaled by sm_scale).
extern "C" int flash_attention_bwd_kvmajor_f32(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, float* dq_acc, void* dk, void* dv,
    int bh, int t, int d, int causal, float sm_scale, void* stream) {
  return kv<float, true>(q, k, v, dout, lse, delta, dq_acc, dk, dv, bh, t, d,
                         causal, sm_scale, stream);
}

extern "C" int flash_attention_bwd_kvmajor_bf16(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, float* dq_acc, void* dk, void* dv,
    int bh, int t, int d, int causal, float sm_scale, void* stream) {
  return kv<__nv_bfloat16, true>(q, k, v, dout, lse, delta, dq_acc, dk, dv,
                                 bh, t, d, causal, sm_scale, stream);
}

// K3a.
extern "C" int flash_attention_bwd_dq_f32(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, void* dq, int bh, int t, int d,
    int causal, float sm_scale, void* stream) {
  return dq_only<float>(q, k, v, dout, lse, delta, dq, bh, t, d, causal,
                        sm_scale, stream);
}

extern "C" int flash_attention_bwd_dq_bf16(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, void* dq, int bh, int t, int d,
    int causal, float sm_scale, void* stream) {
  return dq_only<__nv_bfloat16>(q, k, v, dout, lse, delta, dq, bh, t, d,
                                causal, sm_scale, stream);
}

// K3b.
extern "C" int flash_attention_bwd_dkv_f32(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, void* dk, void* dv, int bh, int t,
    int d, int causal, float sm_scale, void* stream) {
  return kv<float, false>(q, k, v, dout, lse, delta, nullptr, dk, dv, bh, t,
                          d, causal, sm_scale, stream);
}

extern "C" int flash_attention_bwd_dkv_bf16(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, void* dk, void* dv, int bh, int t,
    int d, int causal, float sm_scale, void* stream) {
  return kv<__nv_bfloat16, false>(q, k, v, dout, lse, delta, nullptr, dk, dv,
                                  bh, t, d, causal, sm_scale, stream);
}
