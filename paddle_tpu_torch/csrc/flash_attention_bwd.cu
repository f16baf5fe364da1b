// Flash-attention backward for Hopper (sm_90a), fp32 or bf16 I/O:
//
//   K2  replaces the TPU kernel paddle_tpu/pallas/flash_attention.py
//       _bwd_kvmajor_kernel (:512), launched by _bwd_kvmajor (:952): the
//       default, kv-major one-pass backward. fp32: flash_bwd_kv_kernel<D,
//       float, true>; bf16: flash_bwd_wgmma_kernel<D>;
//   K3a replaces _dq_kernel (:339), launched by _bwd_split (:871). fp32:
//       flash_bwd_q_kernel<D, float, false>; bf16:
//       flash_bwd_dq_wgmma_kernel<D>;
//   K3b replaces _dkv_kernel (:385), launched by _bwd_split (:898). fp32:
//       flash_bwd_kv_kernel<D, float, false>; bf16:
//       flash_bwd_dkv_wgmma_kernel<D>. K3a + K3b are the split arm
//       (PADDLE_FLASH_BWD=split): deterministic, no atomics in either
//       dtype, so dq, dk and dv are the same bits on every run;
//   K5  replaces _bwd_onepass_kernel (:436), launched by _bwd (:813): the
//       one-pass backward of PADDLE_FLASH_BWD=onepass. fp32:
//       flash_bwd_q_kernel<D, float, true>; bf16: flash_bwd_wgmma_kernel<D>,
//       the same kernel as bf16 K2 (K2 and K5 compute one function from
//       the same arguments, so the contract lets one kv-major kernel
//       serve both arms).
//
// Inputs: q, k, v, dO [BH, T, D] (fp32 or bf16), lse and
// delta = rowsum(dO * O) [BH, T] fp32 (delta is computed by the wrapper
// with a torch op, as the TPU package computes it outside its kernels).
// Every kernel computes the per-pair math of the TPU's _pair_grads
// (:365): for a (q tile, k tile) pair
//   S  = (q * scale) k^T            masked: P is exactly 0 past the causal
//   P  = exp(S - lse)               diagonal, for keys >= T and for rows
//   dP = dO v^T                     >= T, so any T works
//   dS = P * (dP - delta)
// and then dV += P^T dO, dK += scale dS^T q, dQ += scale dS k.
//
// What bounds them on an H100: arithmetic. Five matrix products per
// visited pair (10 * D FLOP per score): at the training shape (BH = 128,
// T = 512, D = 128, causal; 16.8M visited scores) 21.5 GFLOP against
// 84 MB of bf16 q, k, v, dO, dq, dk, dv + fp32 lse, delta, ~256 FLOP per
// byte, and at the long-context shape (BH = 16, T = 8192, D = 128,
// causal; 536.9M visited scores) 687 GFLOP against 50 MB. On the bf16
// tensor cores the bounds are ~22 us and ~0.69 ms. The split arm does
// S and dP twice (once in each of K3a and K3b): 14 * D FLOP per score.
// Alone at the training shape K3a (6 D FLOP a score: S, dP, dS k) and
// K3b (8 D: S, dP, P^T dO, dS^T q) are bound by bytes: 0.025 and 0.030
// ms to read q, k, v, dO, lse, delta once and write their gradients,
// against 17 and 26 us of tensor-core time even with the hi + lo
// products below. So the bf16 K3 keep every sum in registers and write
// each gradient once: no fp32 buffer, no zeroing pass, no atomics.
//
// The fp32 kernels (right and simple first) run the products as fp32
// FMAs on the CUDA cores (67 TFLOP/s peak; tensor cores would mean TF32,
// which the fp32 contract does not allow):
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
//    accumulators (:443-447, :847-849), 8 MB per bh at T = 8192,
//    D = 128, far over shared memory. Here each pair's partials are added
//    into zeroed fp32 [BH, T, D] buffers with atomicAdd (2 x 64 x D per
//    pair), and the wrapper casts them;
//  - thread (ty, tx) of a 16 x 16 grid owns rows ty + 16 i and columns
//    tx + 16 j (i, j < 4) of each 64 x 64 pair tile, and rows ty + 16 i,
//    columns tx + 16 c of each 64 x D gradient tile; at D = 128 the six
//    tiles take 162 KB of shared memory: one block per SM.
//
// The bf16 kernels (namespace tc) run every product on the tensor cores
// (hopper.cuh: bf16 tiles in the 128-byte swizzle, filled by cp.async,
// wgmma with fp32 accumulators in registers). Each gradient is summed in
// the registers of the one warpgroup that owns its rows, except bf16
// K2/K5's dq:
//  - K2/K5 and K3b are one kv-major body (kv_major<D, kDQ>): one block of
//    two warpgroups (256 threads) per (128-key tile, bh); warpgroup wg
//    owns keys [64 wg, 64 wg + 64). The grid is 1-D and starts with key
//    tile 0, which under causal visits the most q tiles;
//  - k and v are loaded once as bf16 in the 128-byte swizzle; the block
//    loops over 64-row q tiles from k0 / 64 (causal) to the last, with q,
//    dO and their lse and delta rows in a 2-stage cp.async ring, so the
//    next tile's copy overlaps this tile's products;
//  - per q tile and warpgroup, S^T = K Q^T and dP^T = V dO^T are wgmma
//    m64n64k16 with both operands K-major in shared memory; P^T =
//    exp2(S^T scale log2(e) - lse log2(e)) on ex2.approx, dS^T = P^T *
//    (dP^T - delta), each thread reading lse and delta of its accumulator
//    columns from shared memory; only tiles that straddle the causal
//    diagonal or T are masked;
//  - dV += P^T dO and dK += dS^T Q take P^T and dS^T straight from the
//    accumulators as wgmma's register A operand, with dO and Q read
//    MN-major; dV and dK stay fp32 in registers for the whole loop and
//    are written once as bf16 (dK times scale): deterministic. That is
//    all of K3b (12 D FLOP per score): no dS^T in shared memory, no
//    barrier but the ring's, no atomics; 130 KB of shared memory at
//    D = 128;
//  - K2/K5's dQ = dS K: both warpgroups store dS^T as bf16 into shared
//    memory and meet at a barrier; wgmma reads dS transposed (MN-major A)
//    and K MN-major. At D = 128 each warpgroup takes 64 of the D columns
//    over all 128 keys, at D = 64 all columns over its own 64 keys; each
//    adds its part into the zeroed fp32 dq buffer with sm_90's float2
//    atomicAdd (one atomic per two visited scores at D = 128), which the
//    wrapper scales and casts. dq's last bits vary from run to run; the
//    dS^T tiles take 32 KB more (162 KB at D = 128);
//  - K3a is the q-major mirror, shaped as bf16 K1: one block of two
//    warpgroups per (128-row q tile, bh), warpgroup wg owning rows
//    [64 wg, 64 wg + 64), on a 1-D grid from the last q tile (under
//    causal the one that visits the most keys) to the first. Q and dO are
//    staged once; each thread keeps lse log2(e) and delta of its two
//    accumulator rows in registers. 64-key k and v tiles stream through
//    a 2-stage cp.async ring up to the causal diagonal (a warpgroup
//    skips the last tile when it lies past all its rows). Per tile, S =
//    Q K^T and dP = dO V^T are wgmma m64n64k16 (K-major), P and dS =
//    P * (dP - delta) stay in registers, and dQ += dS K takes dS from
//    the accumulator as the register A operand with K read MN-major.
//    dQ stays fp32 in registers and is written once as bf16, times
//    scale: no fp32 buffer, no zeroing pass, no atomics. 8 D FLOP per
//    score; 64-key tiles keep S, dP and dS's fragments at 32 registers
//    each beside dQ's D / 2 (128-key tiles would need 256 for these
//    alone); 129 KB of shared memory at D = 128;
//  - accuracy: P and dS enter every product as two bf16 operands, hi =
//    bf16(x) and lo = bf16(x - hi), as K4b feeds P: with one bf16
//    rounding, as the TPU kernels round p and ds (:409, :412), the
//    gradients of the first rows and keys of a head (few keys, P ~ 1/n)
//    lie several per cent of mean |g| from the fp32 plain version, over
//    chip_smoke.py's bound on |g - g_ref| / (|g_ref| + mean |g_ref|)
//    (phase b4 logs that evaluation). That is 8 products per pair
//    instead of 5 in K2/K5 (1.1 ms of tensor-core time at the
//    long-context shape), 4 instead of 3 in K3a (8 D FLOP a score) and
//    6 instead of 4 in K3b (12 D);
//  - registers: fp32 dK and dV take 128 a thread at D = 128, S^T and
//    dP^T 64 more; K3a's dQ 64, S, dP and dS's fragments 96.
#include "flash_common.cuh"
#include "hopper.cuh"

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


// -- bf16 K2, K5, K3b and K3a on the tensor cores ---------------------------

namespace tc {

constexpr int kBK = 128;       // keys per kv-major block: 64 per warpgroup
constexpr int kBQ = 64;        // q rows per step of the kv-major q loop
constexpr int kThreads = 256;  // two warpgroups
constexpr int kStages = 2;     // (q, dO, lse, delta) tiles in the ring
constexpr float kLog2e = 1.4426950408889634f;

// Dynamic shared memory of the kv-major kernels, byte offsets from the
// 1024-aligned k tile: the k and v tiles; kStages (q tile, dO tile)
// pairs; kStages (lse, delta) rows of kBQ floats; and, for K2/K5 only,
// dS^T as bf16 hi and lo ([kBK keys, kBQ q], one 64-column panel each).
template <int D>
struct Smem {
  static constexpr int kKV = kBK * D * 2;  // bytes of the k (or v) tile
  static constexpr int kQ = kBQ * D * 2;   // bytes of a q (or dO) tile
  static constexpr int kDS = kBK * kBQ * 2;
  static constexpr int kRing = 2 * kKV;
  static constexpr int kRows = kRing + kStages * 2 * kQ;
  static constexpr int kDSHi = kRows + kStages * 2 * kBQ * 4;
  static constexpr int kDSLo = kDSHi + kDS;
  static_assert(kDSHi % 1024 == 0, "dS^T tiles on swizzle-atom bounds");
  // with the dS^T tiles (K2/K5) or without them (K3b)
  static constexpr int bytes(bool with_ds) {
    return 1024 + (with_ds ? kDSLo + kDS : kDSHi);
  }
};

extern __shared__ uint8_t smem_tc[];

// Start the cp.async copies of q tile `tile` (q, dO, lse, delta rows;
// zeros past T) into ring stage tile % kStages, if it exists, and close
// the group either way, so that group n always holds tile n.
template <int D>
__device__ __forceinline__ void fetch(uint32_t k_s, const __nv_bfloat16* q,
                                      const __nv_bfloat16* dout,
                                      const float* lse, const float* delta,
                                      int tile, int n_tiles, int T) {
  if (tile < n_tiles) {
    const int stage = tile % kStages;
    const uint32_t slot = k_s + Smem<D>::kRing + stage * 2 * Smem<D>::kQ;
    const int q0 = tile * kBQ;
    hopper::load_tile_async<kBQ, D, kThreads>(slot, q, q0, T, threadIdx.x);
    hopper::load_tile_async<kBQ, D, kThreads>(slot + Smem<D>::kQ, dout, q0,
                                              T, threadIdx.x);
    if (threadIdx.x < 2 * kBQ) {  // lse rows, then delta rows
      const int r = threadIdx.x % kBQ;
      const bool valid = q0 + r < T;
      hopper::cp_async_4(
          k_s + Smem<D>::kRows + (stage * 2 * kBQ + threadIdx.x) * 4,
          (threadIdx.x < kBQ ? lse : delta) + (valid ? q0 + r : 0), valid);
    }
  }
  hopper::cp_async_commit();
}

// Wait for this tile's copies, make every thread's copies visible to
// wgmma, and (the barrier) let the stage of the tile before be reused.
__device__ __forceinline__ void tile_ready() {
  hopper::cp_async_wait<kStages - 2>();
  hopper::fence_view_async_shared();
  __syncthreads();
}

// S^T = K Q^T into s and dP^T = V dO^T into dp for this warpgroup's 64
// keys and one q tile: D / 16 wgmma m64n64k16 each, both operands K-major.
// Returns with s complete and dp still in flight (one wgmma group).
template <int D>
__device__ __forceinline__ void scores_t(float (&s)[32], float (&dp)[32],
                                         uint32_t k_s, uint32_t q_t, int wg) {
  const uint32_t v_s = k_s + Smem<D>::kKV;
  const uint32_t do_t = q_t + Smem<D>::kQ;
  hopper::fence_regs(s);
  hopper::fence_regs(dp);
  hopper::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    // 16 columns of d: panel kk / 4, bytes 32 (kk % 4) into each row
    const uint32_t a =
        (kk / 4) * (kBK * 128) + wg * (64 * 128) + (kk % 4) * 32;
    const uint32_t b = (kk / 4) * (kBQ * 128) + (kk % 4) * 32;
    hopper::mma_ss_n64<0, 0>(s, hopper::desc_sw128(k_s + a, 0, 1024),
                             hopper::desc_sw128(q_t + b, 0, 1024), kk > 0);
  }
  hopper::wgmma_commit();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t a =
        (kk / 4) * (kBK * 128) + wg * (64 * 128) + (kk % 4) * 32;
    const uint32_t b = (kk / 4) * (kBQ * 128) + (kk % 4) * 32;
    hopper::mma_ss_n64<0, 0>(dp, hopper::desc_sw128(v_s + a, 0, 1024),
                             hopper::desc_sw128(do_t + b, 0, 1024), kk > 0);
  }
  hopper::wgmma_commit();
  hopper::wgmma_wait<1>();
  hopper::fence_regs(s);
}

// dV += P^T dO and dK += dS^T Q for this warpgroup: P^T and dS^T as hi +
// lo bf16 A operands from registers, dO and Q MN-major (kBQ / 16 k steps
// of 4 wgmma). Waits for them.
template <int D>
__device__ __forceinline__ void accumulate_dkv(
    float (&dv)[D / 2], float (&dk)[D / 2], uint32_t (&p_hi)[4][4],
    uint32_t (&p_lo)[4][4], uint32_t (&d_hi)[4][4], uint32_t (&d_lo)[4][4],
    uint32_t q_t) {
  hopper::fence_regs(dv);
  hopper::fence_regs(dk);
  hopper::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kBQ / 16; ++kk) {
    // q rows 16 kk .. 16 kk + 15: two 8-row atoms of every column panel
    const uint64_t b_q =
        hopper::desc_sw128(q_t + kk * (16 * 128), kBQ * 128, 1024);
    const uint64_t b_do = hopper::desc_sw128(
        q_t + Smem<D>::kQ + kk * (16 * 128), kBQ * 128, 1024);
    hopper::mma_rs<D>(dv, p_hi[kk], b_do);
    hopper::mma_rs<D>(dv, p_lo[kk], b_do);
    hopper::mma_rs<D>(dk, d_hi[kk], b_q);
    hopper::mma_rs<D>(dk, d_lo[kk], b_q);
  }
  hopper::wgmma_commit();
  hopper::wgmma_wait<0>();
  hopper::fence_regs(dv);
  hopper::fence_regs(dk);
#pragma unroll
  for (int kk = 0; kk < kBQ / 16; ++kk) {
    hopper::fence_regs(p_hi[kk]);
    hopper::fence_regs(p_lo[kk]);
    hopper::fence_regs(d_hi[kk]);
    hopper::fence_regs(d_lo[kk]);
  }
}

// This warpgroup's part of dQ = dS K for one q tile, from the dS^T hi and
// lo tiles (read MN-major: q runs along the rows) and the k tile
// (MN-major): at D = 128 columns [64 wg, 64 wg + 64) over all kBK keys,
// at D = 64 every column over the warpgroup's own 64 keys.
template <int D>
__device__ __forceinline__ void dq_part(float (&dq)[32], uint32_t k_s,
                                        int wg) {
  constexpr int kSteps = D == 128 ? kBK / 16 : 64 / 16;
  const int ks0 = D == 128 ? 0 : kSteps * wg;
  const uint32_t k_panel = k_s + (D == 128 ? wg * (kBK * 128) : 0);
  hopper::fence_regs(dq);
  hopper::wgmma_fence();
#pragma unroll
  for (int i = 0; i < kSteps; ++i) {
    // keys 16 ks .. 16 ks + 15: two 8-row atoms of the k panel and of dS^T
    const uint32_t rows = (ks0 + i) * (16 * 128);
    const uint64_t b = hopper::desc_sw128(k_panel + rows, kBK * 128, 1024);
    hopper::mma_ss_n64<1, 1>(
        dq, hopper::desc_sw128(k_s + Smem<D>::kDSHi + rows, kBK * 128, 1024),
        b, i > 0);
    hopper::mma_ss_n64<1, 1>(
        dq, hopper::desc_sw128(k_s + Smem<D>::kDSLo + rows, kBK * 128, 1024),
        b, 1);
  }
  hopper::wgmma_commit();
  hopper::wgmma_wait<0>();
  hopper::fence_regs(dq);
}

// The kv-major backward (module comment): dk, dv written once. With kDQ
// (bf16 K2 and K5) dq_acc (fp32, zeroed) also receives sum dS k, not yet
// scaled by sm_scale; without it (bf16 K3b) nothing is summed with
// atomics and dq_acc is not read.
template <int D, bool kDQ>
__device__ __forceinline__ void kv_major(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v,
    const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, float* __restrict__ dq_acc,
    __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
    int bh_count, int T, int causal, float sm_scale) {
  const uint32_t k_s = hopper::align_1024(smem_tc);
  const float* rows = reinterpret_cast<const float*>(
      smem_tc + (k_s - hopper::smem_addr(smem_tc)) + Smem<D>::kRows);
  const int bh = blockIdx.x % bh_count;
  const int k0 = (int)(blockIdx.x / bh_count) * kBK;  // heaviest first
  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x / 32) % 4;
  const int g = (threadIdx.x % 32) / 4;
  const int t = threadIdx.x % 4;
  const int kw0 = k0 + 64 * wg;          // this warpgroup's first key
  const int key = kw0 + 16 * warp + g;   // accumulator rows key, key + 8
  const long base = (long)bh * T * D;
  const long rbase = (long)bh * T;
  const int n_tiles = (T + kBQ - 1) / kBQ;
  const int first = causal ? k0 / kBQ : 0;
  const float c = sm_scale * kLog2e;

  hopper::load_tile_async<kBK, D, kThreads>(k_s, k + base, k0, T,
                                            threadIdx.x);
  hopper::load_tile_async<kBK, D, kThreads>(k_s + Smem<D>::kKV, v + base, k0,
                                            T, threadIdx.x);
  fetch<D>(k_s, q + base, dout + base, lse + rbase, delta + rbase, first,
           n_tiles, T);  // one group with k and v

  float dv_acc[D / 2], dk_acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) {
    dv_acc[i] = 0.f;
    dk_acc[i] = 0.f;
  }

  for (int qt = first; qt < n_tiles; ++qt) {
    tile_ready();
    fetch<D>(k_s, q + base, dout + base, lse + rbase, delta + rbase, qt + 1,
             n_tiles, T);
    const int q0 = qt * kBQ;
    const int stage = qt % kStages;
    const uint32_t q_t = k_s + Smem<D>::kRing + stage * 2 * Smem<D>::kQ;
    const float* lse_t = rows + stage * 2 * kBQ;
    const float* delta_t = lse_t + kBQ;

    // accumulator register 4 j + 2 h + e: key row key + 8 h, q column
    // q0 + 8 j + 2 t + e
    float s[32], dp[32];
    scores_t<D>(s, dp, k_s, q_t, wg);
    const bool edge =
        q0 + kBQ > T || kw0 + 64 > T || (causal && kw0 + 63 > q0);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 l = *reinterpret_cast<const float2*>(lse_t + 8 * j + 2 * t);
      const float shift[2] = {l.x * kLog2e, l.y * kLog2e};
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float p = hopper::ex2(fmaf(s[4 * j + 2 * h + e], c, -shift[e]));
          if (edge) {
            const int qi = q0 + 8 * j + 2 * t + e, kj = key + 8 * h;
            if (qi >= T || kj >= T || (causal && kj > qi)) p = 0.f;
          }
          s[4 * j + 2 * h + e] = p;
        }
    }
    hopper::wgmma_wait<0>();
    hopper::fence_regs(dp);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 dl =
          *reinterpret_cast<const float2*>(delta_t + 8 * j + 2 * t);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        dp[4 * j + 2 * h] = s[4 * j + 2 * h] * (dp[4 * j + 2 * h] - dl.x);
        dp[4 * j + 2 * h + 1] =
            s[4 * j + 2 * h + 1] * (dp[4 * j + 2 * h + 1] - dl.y);
      }
    }

    // the accumulator of q columns 16 kk .. 16 kk + 15 is, register for
    // register, the A fragment of the k step kk of P^T dO and dS^T Q
    uint32_t p_hi[4][4], p_lo[4][4], d_hi[4][4], d_lo[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        hopper::split_bf16(s[8 * kk + 2 * i], s[8 * kk + 2 * i + 1],
                           p_hi[kk][i], p_lo[kk][i]);
        hopper::split_bf16(dp[8 * kk + 2 * i], dp[8 * kk + 2 * i + 1],
                           d_hi[kk][i], d_lo[kk][i]);
        if constexpr (kDQ) {
          // dS^T into the swizzled [kBK keys, kBQ q] tiles: fragment
          // register i holds key row 8 (i % 2) + 16 warp + g of this
          // warpgroup and q columns 16 kk + 8 (i / 2) + 2 t, + 1
          const int r = 64 * wg + 16 * warp + g + 8 * (i % 2);
          const uint32_t at =
              r * 128 + (((2 * kk + i / 2) ^ (r & 7)) << 4) + 4 * t;
          hopper::st_shared_b32(k_s + Smem<D>::kDSHi + at, d_hi[kk][i]);
          hopper::st_shared_b32(k_s + Smem<D>::kDSLo + at, d_lo[kk][i]);
        }
      }
    accumulate_dkv<D>(dv_acc, dk_acc, p_hi, p_lo, d_hi, d_lo, q_t);

    if constexpr (kDQ) {
      // both warpgroups' dS^T are in shared memory and visible to wgmma
      hopper::fence_view_async_shared();
      __syncthreads();
      float dq[32];
      dq_part<D>(dq, k_s, wg);
      const int col0 = D == 128 ? 64 * wg : 0;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = q0 + 16 * warp + g + 8 * h;
        if (r >= T) continue;
        float* out = dq_acc + base + (long)r * D + col0 + 2 * t;
#pragma unroll
        for (int j = 0; j < 8; ++j)  // sm_90's 8-byte atomic add
          atomicAdd(reinterpret_cast<float2*>(out + 8 * j),
                    make_float2(dq[4 * j + 2 * h], dq[4 * j + 2 * h + 1]));
      }
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = key + 8 * h;
    if (r >= T) continue;
    __nv_bfloat16* out_v = dv + base + (long)r * D + 2 * t;
    __nv_bfloat16* out_k = dk + base + (long)r * D + 2 * t;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<uint32_t*>(out_v + 8 * j) =
          hopper::pack_bf16(dv_acc[4 * j + 2 * h], dv_acc[4 * j + 2 * h + 1]);
      *reinterpret_cast<uint32_t*>(out_k + 8 * j) =
          hopper::pack_bf16(dk_acc[4 * j + 2 * h] * sm_scale,
                            dk_acc[4 * j + 2 * h + 1] * sm_scale);
    }
  }
}

// bf16 K2 and K5: dk, dv written once; dq_acc (fp32, zeroed) receives
// sum dS k, not yet scaled by sm_scale.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_wgmma_kernel(const __nv_bfloat16* __restrict__ q,
                       const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v,
                       const __nv_bfloat16* __restrict__ dout,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta,
                       float* __restrict__ dq_acc,
                       __nv_bfloat16* __restrict__ dk,
                       __nv_bfloat16* __restrict__ dv, int bh_count, int T,
                       int causal, float sm_scale) {
  kv_major<D, true>(q, k, v, dout, lse, delta, dq_acc, dk, dv, bh_count, T,
                    causal, sm_scale);
}

// bf16 K3b: dk, dv written once, no atomics.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkv_wgmma_kernel(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v,
                           const __nv_bfloat16* __restrict__ dout,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           __nv_bfloat16* __restrict__ dk,
                           __nv_bfloat16* __restrict__ dv, int bh_count,
                           int T, int causal, float sm_scale) {
  kv_major<D, false>(q, k, v, dout, lse, delta, nullptr, dk, dv, bh_count, T,
                     causal, sm_scale);
}

// -- bf16 K3a: q-major, dQ in registers -------------------------------------

constexpr int kQT = 128;      // q rows per K3a block: 64 per warpgroup
constexpr int kKT = 64;       // keys per step of K3a's k loop
constexpr int kKVStages = 2;  // (k tile, v tile) pairs in K3a's ring

// K3a's dynamic shared memory, byte offsets from the 1024-aligned q tile:
// the q and dO tiles, then kKVStages (k tile, v tile) pairs.
template <int D>
struct DqSmem {
  static constexpr int kQ = kQT * D * 2;   // bytes of the q (or dO) tile
  static constexpr int kKV = kKT * D * 2;  // bytes of a k (or v) tile
  static constexpr int kRing = 2 * kQ;
  static constexpr int kBytes = 1024 + kRing + kKVStages * 2 * kKV;
  static_assert(kKVStages == kStages, "tile_ready waits as for K2's ring");
};

// Start the cp.async copies of k tile `tile` and its v tile (zeros past
// T) into ring slot tile % kKVStages, if it exists, and close the group
// either way, so that group n always holds tile n.
template <int D>
__device__ __forceinline__ void fetch_kv(uint32_t ring,
                                         const __nv_bfloat16* k,
                                         const __nv_bfloat16* v, int tile,
                                         int n_tiles, int T) {
  if (tile < n_tiles) {
    const uint32_t slot = ring + (tile % kKVStages) * 2 * DqSmem<D>::kKV;
    hopper::load_tile_async<kKT, D, kThreads>(slot, k, tile * kKT, T,
                                              threadIdx.x);
    hopper::load_tile_async<kKT, D, kThreads>(slot + DqSmem<D>::kKV, v,
                                              tile * kKT, T, threadIdx.x);
  }
  hopper::cp_async_commit();
}

// S = Q K^T into s and dP = dO V^T into dp for this warpgroup's 64 q rows
// and one k tile: D / 16 wgmma m64n64k16 each, both operands K-major.
// Returns with s complete and dp still in flight (one wgmma group).
template <int D>
__device__ __forceinline__ void scores_q(float (&s)[32], float (&dp)[32],
                                         uint32_t q_s, uint32_t k_t, int wg) {
  const uint32_t do_s = q_s + DqSmem<D>::kQ;
  const uint32_t v_t = k_t + DqSmem<D>::kKV;
  hopper::fence_regs(s);
  hopper::fence_regs(dp);
  hopper::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    // 16 columns of d: panel kk / 4, bytes 32 (kk % 4) into each row
    const uint32_t a =
        (kk / 4) * (kQT * 128) + wg * (64 * 128) + (kk % 4) * 32;
    const uint32_t b = (kk / 4) * (kKT * 128) + (kk % 4) * 32;
    hopper::mma_ss_n64<0, 0>(s, hopper::desc_sw128(q_s + a, 0, 1024),
                             hopper::desc_sw128(k_t + b, 0, 1024), kk > 0);
  }
  hopper::wgmma_commit();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t a =
        (kk / 4) * (kQT * 128) + wg * (64 * 128) + (kk % 4) * 32;
    const uint32_t b = (kk / 4) * (kKT * 128) + (kk % 4) * 32;
    hopper::mma_ss_n64<0, 0>(dp, hopper::desc_sw128(do_s + a, 0, 1024),
                             hopper::desc_sw128(v_t + b, 0, 1024), kk > 0);
  }
  hopper::wgmma_commit();
  hopper::wgmma_wait<1>();
  hopper::fence_regs(s);
}

// dQ += dS K for this warpgroup: dS as hi + lo bf16 A operands from
// registers, the k tile MN-major (kKT / 16 k steps of 2 wgmma). Waits
// for them.
template <int D>
__device__ __forceinline__ void accumulate_dq(float (&acc)[D / 2],
                                              uint32_t (&hi)[kKT / 16][4],
                                              uint32_t (&lo)[kKT / 16][4],
                                              uint32_t k_t) {
  hopper::fence_regs(acc);
  hopper::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kKT / 16; ++kk) {
    // keys 16 kk .. 16 kk + 15: two 8-row atoms of every column panel
    const uint64_t b =
        hopper::desc_sw128(k_t + kk * (16 * 128), kKT * 128, 1024);
    hopper::mma_rs<D>(acc, hi[kk], b);
    hopper::mma_rs<D>(acc, lo[kk], b);
  }
  hopper::wgmma_commit();
  hopper::wgmma_wait<0>();
  hopper::fence_regs(acc);
#pragma unroll
  for (int kk = 0; kk < kKT / 16; ++kk) {
    hopper::fence_regs(hi[kk]);
    hopper::fence_regs(lo[kk]);
  }
}

// bf16 K3a: dq = sm_scale sum_k dS k, each row summed by one thread in
// one order and written once: no atomics, no zeroed buffer.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_wgmma_kernel(const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v,
                          const __nv_bfloat16* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          __nv_bfloat16* __restrict__ dq, int bh_count, int T,
                          int causal, float sm_scale) {
  const uint32_t q_s = hopper::align_1024(smem_tc);
  const uint32_t ring = q_s + DqSmem<D>::kRing;
  const int n_q = gridDim.x / bh_count;
  const int bh = blockIdx.x % bh_count;
  const int q0 = (n_q - 1 - (int)blockIdx.x / bh_count) * kQT;  // heaviest
  const int wg = threadIdx.x / 128;                             // first
  const int wrow = q0 + 64 * wg + 16 * ((threadIdx.x / 32) % 4);
  const int row = wrow + (threadIdx.x % 32) / 4;  // rows row, row + 8
  const int col = 2 * (threadIdx.x % 4);
  const long base = (long)bh * T * D;
  const long rbase = (long)bh * T;
  const int nk = (T + kKT - 1) / kKT;
  // the block's k tiles, and this warpgroup's (under causal its last
  // rows see one k tile fewer than the block's)
  const int n_tiles = causal ? min(nk, (q0 + kQT - 1) / kKT + 1) : nk;
  const int wg_tiles = causal ? min(nk, (q0 + 64 * wg + 63) / kKT + 1) : nk;
  const float c = sm_scale * kLog2e;

  hopper::load_tile_async<kQT, D, kThreads>(q_s, q + base, q0, T,
                                            threadIdx.x);
  hopper::load_tile_async<kQT, D, kThreads>(q_s + DqSmem<D>::kQ, dout + base,
                                            q0, T, threadIdx.x);
  fetch_kv<D>(ring, k + base, v + base, 0, n_tiles, T);  // one group

  // lse log2(e) and delta of the thread's two rows; rows >= T have zero
  // q and dO, so with both 0 their dS is 0 (and they are not written)
  float shift[2], dl[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row + 8 * h;
    shift[h] = r < T ? lse[rbase + r] * kLog2e : 0.f;
    dl[h] = r < T ? delta[rbase + r] : 0.f;
  }
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  for (int kt = 0; kt < n_tiles; ++kt) {
    tile_ready();
    fetch_kv<D>(ring, k + base, v + base, kt + 1, n_tiles, T);
    if (kt >= wg_tiles) continue;  // past the diagonal of every row here
    const int k0 = kt * kKT;
    const uint32_t k_t = ring + (kt % kKVStages) * 2 * DqSmem<D>::kKV;

    // accumulator register 4 j + 2 h + e: q row row + 8 h, key
    // k0 + 8 j + col + e
    float s[32], dp[32];
    scores_q<D>(s, dp, q_s, k_t, wg);
    const bool edge = k0 + kKT > T || (causal && k0 + kKT - 1 > wrow);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float p = hopper::ex2(fmaf(s[4 * j + 2 * h + e], c, -shift[h]));
          if (edge) {
            const int kj = k0 + 8 * j + col + e;
            if (kj >= T || (causal && kj > row + 8 * h)) p = 0.f;
          }
          s[4 * j + 2 * h + e] = p;
        }
    hopper::wgmma_wait<0>();
    hopper::fence_regs(dp);
#pragma unroll
    for (int i = 0; i < 32; ++i) dp[i] = s[i] * (dp[i] - dl[(i / 2) % 2]);

    // the accumulator of keys 16 kk .. 16 kk + 15 is, register for
    // register, the A fragment of the k step kk of dS K
    uint32_t hi[kKT / 16][4], lo[kKT / 16][4];
#pragma unroll
    for (int kk = 0; kk < kKT / 16; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        hopper::split_bf16(dp[8 * kk + 2 * i], dp[8 * kk + 2 * i + 1],
                           hi[kk][i], lo[kk][i]);
    accumulate_dq<D>(acc, hi, lo, k_t);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row + 8 * h;
    if (r >= T) continue;
    __nv_bfloat16* out = dq + base + (long)r * D + col;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(out + 8 * j) = hopper::pack_bf16(
          acc[4 * j + 2 * h] * sm_scale, acc[4 * j + 2 * h + 1] * sm_scale);
  }
}

}  // namespace tc

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

// K3a (fp32): the CUDA-core q-major kernel.
extern "C" int flash_attention_bwd_dq_f32(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, void* dq, int bh, int t, int d,
    int causal, float sm_scale, void* stream) {
  return qmajor<float, false>(q, k, v, dout, lse, delta, dq, nullptr,
                              nullptr, bh, t, d, causal, sm_scale, stream);
}

// bf16 K3a: the tensor-core q-major kernel.
extern "C" int flash_attention_bwd_dq_bf16(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, void* dq, int bh, int t, int d,
    int causal, float sm_scale, void* stream) {
  return flash::by_dim(d, [&](auto dim) {
    constexpr int D = decltype(dim)::value;
    return hopper::launch_1d(
        tc::flash_bwd_dq_wgmma_kernel<D>, tc::DqSmem<D>::kBytes,
        (long)bh * ((t + tc::kQT - 1) / tc::kQT), tc::kThreads, stream,
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v),
        static_cast<const __nv_bfloat16*>(dout), lse, delta,
        static_cast<__nv_bfloat16*>(dq), bh, t, causal, sm_scale);
  });
}

// K3b (fp32): the CUDA-core kv-major kernel.
extern "C" int flash_attention_bwd_dkv_f32(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, void* dk, void* dv, int bh, int t,
    int d, int causal, float sm_scale, void* stream) {
  return kv<float, false>(q, k, v, dout, lse, delta, nullptr, dk, dv, bh, t,
                          d, causal, sm_scale, stream);
}

// bf16 K3b: the tensor-core kv-major kernel without dq.
extern "C" int flash_attention_bwd_dkv_bf16(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, void* dk, void* dv, int bh, int t,
    int d, int causal, float sm_scale, void* stream) {
  return flash::by_dim(d, [&](auto dim) {
    constexpr int D = decltype(dim)::value;
    return hopper::launch_1d(
        tc::flash_bwd_dkv_wgmma_kernel<D>, tc::Smem<D>::bytes(false),
        (long)bh * ((t + tc::kBK - 1) / tc::kBK), tc::kThreads, stream,
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v),
        static_cast<const __nv_bfloat16*>(dout), lse, delta,
        static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), bh,
        t, causal, sm_scale);
  });
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

// bf16 K2 and K5 (both arms): the tensor-core kernel. dq_acc: [bh, t, d]
// fp32, zeroed by the caller; receives sum dS k (not yet scaled by
// sm_scale); dk, dv: bf16.
extern "C" int flash_attention_bwd_wgmma_bf16(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, float* dq_acc, void* dk, void* dv,
    int bh, int t, int d, int causal, float sm_scale, void* stream) {
  return flash::by_dim(d, [&](auto dim) {
    constexpr int D = decltype(dim)::value;
    return hopper::launch_1d(
        tc::flash_bwd_wgmma_kernel<D>, tc::Smem<D>::bytes(true),
        (long)bh * ((t + tc::kBK - 1) / tc::kBK), tc::kThreads, stream,
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v),
        static_cast<const __nv_bfloat16*>(dout), lse, delta, dq_acc,
        static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), bh,
        t, causal, sm_scale);
  });
}
