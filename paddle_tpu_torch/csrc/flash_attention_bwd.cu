// Flash-attention backward for Hopper (sm_90a), fp32 or bf16 I/O:
//
//   K2  flash_bwd_kv_kernel<D, Elem, true>   replaces the TPU kernel
//       paddle_tpu/pallas/flash_attention.py _bwd_kvmajor_kernel (:512),
//       launched by _bwd_kvmajor (:952): the default, kv-major one-pass
//       backward;
//   K3a flash_bwd_q_kernel<D, Elem, false>   replaces _dq_kernel (:339),
//       launched by _bwd_split (:871);
//   K3b flash_bwd_kv_kernel<D, Elem, false>  replaces _dkv_kernel (:385),
//       launched by _bwd_split (:898). K3a + K3b are the split arm
//       (PADDLE_FLASH_BWD=split): deterministic, no atomics;
//   K5  flash_bwd_q_kernel<D, Elem, true>    replaces _bwd_onepass_kernel
//       (:436), launched by _bwd (:813): the qi-major one-pass backward
//       (PADDLE_FLASH_BWD=onepass).
//
// Inputs: q, k, v, dO [BH, T, D] (fp32 or bf16), lse and
// delta = rowsum(dO * O) [BH, T] fp32 (delta is computed by the wrapper
// with a torch op, as the TPU package computes it outside its kernels).
// All four kernels share the per-pair math pair_grads (the TPU's
// _pair_grads, :365): for a (64-row q tile, 64-row k tile) pair
//   S  = (q * scale) k^T            masked to -1e30: P is exactly 0 past
//   P  = exp(S - lse)               the causal diagonal, for keys >= T
//   dP = dO v^T                     and for rows >= T, so any T works
//   dS = P * (dP - delta)
// and then dV += P^T dO, dK += dS^T (q * scale) (dk carries the scale
// through the pre-scaled q and gets no extra factor), dQ += dS k (dq is
// scaled once at the end).
//
// What bounds them on an H100: arithmetic. K2 and K5 do 5 matrix
// products per visited pair (10 * D FLOP per score): at the training
// shape (BH = 128, T = 512, D = 128, causal; 16.8M visited scores) that
// is 21.5 GFLOP against 84 MB of bf16 q, k, v, dO, dq, dk, dv + fp32 lse,
// delta, ~256 FLOP per byte, and at the long-context shape (BH = 16,
// T = 8192, D = 128, causal; 536.9M visited scores) 687 GFLOP against
// 50 MB. On the bf16 tensor cores the bounds are ~22 us and ~0.69 ms;
// these kernels run the products as fp32 FMAs on the CUDA cores (67
// TFLOP/s peak), so they sit far above them. Tensor cores (mma.sync /
// wgmma) and TMA are later work.
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
//  - K3a and K5: one block per (64-row q tile, bh) loops over k tiles up
//    to the diagonal; dQ stays in fp32 registers and is written once,
//    scaled;
//  - K5's dK and dV: the TPU keeps them as full-sequence fp32 VMEM
//    accumulators (:443-447, :847-849), 8 MB per bh at T = 8192, D = 128,
//    far over the 227 KB of shared memory. Here each pair's partials
//    P^T dO and dS^T (q * scale) are added into zeroed fp32 [BH, T, D]
//    buffers with atomicAdd, and the wrapper casts them. That is twice
//    K2's atomic traffic (2 x 64 x D atomics per pair against K2's one),
//    and the last bits of dk and dv vary from run to run. No state is
//    held across q tiles, so there is no residency rule (the TPU's guard,
//    :799-801) and the arm runs at every T and dtype;
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

// The per-pair math shared by K2, K3a, K3b and K5 (module comment). Writes
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

// One pair's dV += P^T dO and dK += dS^T (q * scale): rows are keys.
template <int D>
__device__ __forceinline__ void add_pair_dkv(const float* Ps,
                                             const float* dSs,
                                             const float* dOs,
                                             const float* Qs, int tx, int ty,
                                             float dk[4][D / 16],
                                             float dv[4][D / 16]) {
  constexpr int LD = D + 1;
  constexpr int LDP = kBlock + 1;
  constexpr int CPT = D / 16;
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
        dv[i][c] = fmaf(pv[i], ov[c], dv[i][c]);
        dk[i][c] = fmaf(sv[i], qv[c], dk[i][c]);
      }
  }
}

// One pair's dQ += dS k: rows are queries.
template <int D>
__device__ __forceinline__ void add_pair_dq(const float* dSs,
                                            const float* Ks, int tx, int ty,
                                            float acc[4][D / 16]) {
  constexpr int LD = D + 1;
  constexpr int LDP = kBlock + 1;
  constexpr int CPT = D / 16;
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
}

template <int D>
__device__ __forceinline__ void zero(float a[4][D / 16]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < D / 16; ++c) a[i][c] = 0.f;
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
  zero<D>(dk_acc);
  zero<D>(dv_acc);

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

    add_pair_dkv<D>(Ps, dSs, dOs, Qs, tx, ty, dk_acc, dv_acc);

    if (kDQ) {
      // this k tile's share of dQ = dS k, added into the fp32 buffer
      float acc[4][CPT];
      zero<D>(acc);
      add_pair_dq<D>(dSs, Ks, tx, ty, acc);
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

// K3a (kDKV = false) and K5 (kDKV = true): one block per (q tile, bh);
// writes dq = sm_scale * sum_k dS k. K5 also adds each pair's dV and dK
// partials into the zeroed fp32 buffers dk_acc and dv_acc.
template <int D, typename Elem, bool kDKV>
__global__ void __launch_bounds__(kThreads)
flash_bwd_q_kernel(const Elem* __restrict__ q, const Elem* __restrict__ k,
                   const Elem* __restrict__ v, const Elem* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, Elem* __restrict__ dq,
                   float* __restrict__ dk_acc, float* __restrict__ dv_acc,
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
  zero<D>(acc);

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

    add_pair_dq<D>(dSs, Ks, tx, ty, acc);
    if (kDKV) {
      // this pair's share of dK and dV, added into the fp32 buffers
      float dk_p[4][CPT], dv_p[4][CPT];
      zero<D>(dk_p);
      zero<D>(dv_p);
      add_pair_dkv<D>(Ps, dSs, dOs, Qs, tx, ty, dk_p, dv_p);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = k0 + ty + 16 * i;
        if (row >= T) continue;
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          const long at = base + (long)row * D + tx + 16 * c;
          atomicAdd(dk_acc + at, dk_p[i][c]);
          atomicAdd(dv_acc + at, dv_p[i][c]);
        }
      }
    }
    __syncthreads();  // K, V, P and dS are overwritten by the next tile
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

template <typename Elem, bool kDQ>
int kv(const void* q, const void* k, const void* v, const void* dout,
       const float* lse, const float* delta, float* dq_acc, void* dk,
       void* dv, int bh, int t, int d, int causal, float sm_scale,
       void* stream) {
  return flash::by_dim(d, [&](auto dim) {
    constexpr int D = decltype(dim)::value;
    return flash::run(flash_bwd_kv_kernel<D, Elem, kDQ>, smem_bytes<D>(), bh,
                      t, stream, static_cast<const Elem*>(q),
                      static_cast<const Elem*>(k),
                      static_cast<const Elem*>(v),
                      static_cast<const Elem*>(dout), lse, delta, dq_acc,
                      static_cast<Elem*>(dk), static_cast<Elem*>(dv), t,
                      causal, sm_scale);
  });
}

template <typename Elem, bool kDKV>
int qmajor(const void* q, const void* k, const void* v, const void* dout,
           const float* lse, const float* delta, void* dq, float* dk_acc,
           float* dv_acc, int bh, int t, int d, int causal, float sm_scale,
           void* stream) {
  return flash::by_dim(d, [&](auto dim) {
    constexpr int D = decltype(dim)::value;
    return flash::run(flash_bwd_q_kernel<D, Elem, kDKV>, smem_bytes<D>(), bh,
                      t, stream, static_cast<const Elem*>(q),
                      static_cast<const Elem*>(k),
                      static_cast<const Elem*>(v),
                      static_cast<const Elem*>(dout), lse, delta,
                      static_cast<Elem*>(dq), dk_acc, dv_acc, t, causal,
                      sm_scale);
  });
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
  return qmajor<float, false>(q, k, v, dout, lse, delta, dq, nullptr,
                              nullptr, bh, t, d, causal, sm_scale, stream);
}

extern "C" int flash_attention_bwd_dq_bf16(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, void* dq, int bh, int t, int d,
    int causal, float sm_scale, void* stream) {
  return qmajor<__nv_bfloat16, false>(q, k, v, dout, lse, delta, dq, nullptr,
                                      nullptr, bh, t, d, causal, sm_scale,
                                      stream);
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

// K5. dk_acc, dv_acc: [bh, t, d] fp32, zeroed by the caller; receive the
// summed dK and dV.
extern "C" int flash_attention_bwd_onepass_f32(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, void* dq, float* dk_acc,
    float* dv_acc, int bh, int t, int d, int causal, float sm_scale,
    void* stream) {
  return qmajor<float, true>(q, k, v, dout, lse, delta, dq, dk_acc, dv_acc,
                             bh, t, d, causal, sm_scale, stream);
}

extern "C" int flash_attention_bwd_onepass_bf16(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, void* dq, float* dk_acc,
    float* dv_acc, int bh, int t, int d, int causal, float sm_scale,
    void* stream) {
  return qmajor<__nv_bfloat16, true>(q, k, v, dout, lse, delta, dq, dk_acc,
                                     dv_acc, bh, t, d, causal, sm_scale,
                                     stream);
}
