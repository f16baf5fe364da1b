// Flash-attention forward for Hopper (sm_90a), fp32 or bf16 I/O:
//
//   K1  flash_fwd_kernel        replaces the TPU kernel
//       paddle_tpu/pallas/flash_attention.py _fwd_kernel (:171), launched
//       by _fwd_online (:684): the default, online-softmax forward;
//   K4a flash_fwd_stats_kernel  replaces _fwd_stats_kernel (:229),
//       launched by _fwd_twopass (:728): pass 1 of the two-pass forward,
//       the row max and lse only;
//   K4b flash_fwd_acc_kernel    replaces _fwd_acc_kernel (:276), launched
//       by _fwd_twopass (:758): pass 2, o = sum_k exp(s - lse) v.
//   K4a + K4b are the twopass arm (PADDLE_FLASH_FWD=twopass).
//
// All three compute softmax(q k^T * scale [+ causal mask]) v tile by
// tile, so the [T, T] score matrix never reaches device memory, and
// return the row log-sum-exp lse [BH, T] fp32 beside o [BH, T, d], which
// the backward kernels consume.
//
// What bounds them on an H100: arithmetic. K1 does 4 * D FLOP per
// visited score (q k^T and p v): at the serving shape (BH = 16, T = 512,
// d = 128, causal) 1.07 GFLOP against 16.8 MB of q, k, v and o, ~64 FLOP
// per byte: ~16 us at the 67 TFLOP/s fp32 (non-tensor core) peak against
// ~5 us for the bytes at 3.35 TB/s. At the long-context shape (BH = 16,
// T = 8192, d = 128, bf16, causal; 536.9M visited scores) K4a does
// 2 * D FLOP per score (q k^T only; 137 GFLOP, 0.14 ms at the bf16
// tensor-core peak) and K4b 4 * D (275 GFLOP, 0.28 ms) against ~100 MB
// of bytes (0.03 ms). These kernels run the products as fp32 FMAs on the
// CUDA cores, far above those bounds; tensor cores, wgmma and TMA are
// later work.
//
// Design (right and simple first):
//  - one block of 256 threads per (64-row q tile, bh): grid
//    (ceil(T/64), BH). Nothing carries between blocks, so the TPU's
//    sequential ki grid axis becomes a loop inside the block;
//  - each K (and V) tile of 64 rows is staged in shared memory as fp32
//    with a row stride of d + 1 floats, so the column reads of the score
//    product hit 16 distinct banks. Above 48 KB (K1 113 KB, K4a 66 KB,
//    K4b 113 KB at d = 128) shared memory is dynamic after
//    cudaFuncSetAttribute;
//  - thread (ty, tx) of a 16 x 16 grid owns score rows ty + 16 i and
//    columns tx + 16 j (i, j < 4) and output columns tx + 16 c: a 4 x 4
//    register tile, so each shared-memory load feeds two FMAs;
//  - row max and row sum are reduced over the 16 lanes of a row with
//    warp shuffles; m, l and the output accumulator stay in fp32
//    registers for the whole sweep;
//  - causal tiles stop the sweep at the diagonal tile; keys at index >= T
//    are masked, so any T works (no T % 128 rule as on the TPU);
//  - masked scores are -1e30 and a fully masked row uses 0 as its safe
//    max (K1, K4a) or shift (K4b), exactly as the TPU kernels do, so
//    exp() underflows to 0; K1 and K4a write lse = -1e30 for such a row;
//  - K4a reads no V and keeps only m and l per row (no output
//    accumulator); K4b reads lse and accumulates p = exp(s - lse) times v
//    with no running max, no rescale and no final division. Neither
//    keeps full-sequence state on chip, so there is no residency rule
//    (the TPU's VMEM guard, :653-656) and the arm runs at every T;
//  - bf16 I/O (the training path under AMP): q, k, v are widened to fp32
//    as they are staged, m, l, the accumulator and lse stay fp32, and o
//    is rounded to bf16 once, at the store.
#include "flash_common.cuh"

namespace {

using flash::kNegInf;
using flash::kThreads;
constexpr int kBlockQ = flash::kBlock;
constexpr int kBlockK = flash::kBlock;
constexpr int kLDP = kBlockK + 1;  // padded row stride of the P tile

// s = Q K^T over one (q tile, k tile) pair, masked to -1e30 past the
// causal diagonal and for keys >= T. Q was scaled as it was staged, as
// the TPU kernels scale q before q k^T.
template <int D>
__device__ __forceinline__ void masked_scores(const float* Qs,
                                              const float* Ks, int q0,
                                              int k0, int T, int causal,
                                              int tx, int ty,
                                              float s[4][4]) {
  constexpr int LD = D + 1;
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
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int kj = k0 + tx + 16 * j;
      if (kj >= T || (causal && kj > qi)) s[i][j] = kNegInf;
    }
  }
}

// The online-softmax step of one row (K1, K4a): fold the row's four
// masked scores into the running max m; returns the safe max the scores
// are shifted by and writes the correction of the old l (and acc).
__device__ __forceinline__ float online_row(const float s[4], float& m,
                                            float& corr) {
  float mx = kNegInf;
#pragma unroll
  for (int j = 0; j < 4; ++j) mx = fmaxf(mx, s[j]);
  // the 16 lanes holding one row are one half of a warp
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  const float m_new = fmaxf(m, mx);
  const float safe_m = m_new <= kNegInf / 2 ? 0.f : m_new;
  corr = expf((m <= kNegInf / 2 ? safe_m : m) - safe_m);
  m = m_new;
  return safe_m;
}

__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// acc += P V over one k tile (P: [64 q][64 k] at stride kLDP).
template <int D>
__device__ __forceinline__ void accumulate_pv(const float* Ps,
                                              const float* Vs, int tx,
                                              int ty, float acc[4][D / 16]) {
  constexpr int LD = D + 1;
  constexpr int CPT = D / 16;
#pragma unroll 4
  for (int kk = 0; kk < kBlockK; ++kk) {
    float pv[4], vv[CPT];
#pragma unroll
    for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty + 16 * i) * kLDP + kk];
#pragma unroll
    for (int c = 0; c < CPT; ++c) vv[c] = Vs[kk * LD + tx + 16 * c];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
  }
}

__device__ __forceinline__ int last_k_tile(int q0, int T, int causal) {
  const int last = (T + kBlockK - 1) / kBlockK - 1;
  return causal ? min(last, (q0 + kBlockQ - 1) / kBlockK) : last;
}

__device__ __forceinline__ float row_lse(float m, float l) {
  return m <= kNegInf / 2 ? kNegInf : m + logf(fmaxf(l, 1e-30f));
}

// K1: one sweep with the online-softmax recurrence; writes o and lse.
template <int D, typename Elem>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const Elem* __restrict__ q, const Elem* __restrict__ k,
                 const Elem* __restrict__ v, Elem* __restrict__ o,
                 float* __restrict__ lse, int T, int causal,
                 float sm_scale) {
  constexpr int LD = D + 1;
  constexpr int CPT = D / 16;  // output columns per thread
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
  flash::load_tile<D>(Qs, q + base, q0, T, sm_scale, tid);

  float m[4], l[4], acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;
  }

  const int last = last_k_tile(q0, T, causal);
  for (int kt = 0; kt <= last; ++kt) {
    const int k0 = kt * kBlockK;
    flash::load_tile<D>(Ks, k + base, k0, T, 1.f, tid);
    flash::load_tile<D>(Vs, v + base, k0, T, 1.f, tid);
    __syncthreads();

    float s[4][4];
    masked_scores<D>(Qs, Ks, q0, k0, T, causal, tx, ty, s);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float corr;
      const float safe_m = online_row(s[i], m[i], corr);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - safe_m);
        Ps[(ty + 16 * i) * kLDP + tx + 16 * j] = p;
        rs += p;
      }
      l[i] = l[i] * corr + row_sum(rs);
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[i][c] *= corr;
    }
    __syncthreads();
    accumulate_pv<D>(Ps, Vs, tx, ty, acc);
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
    if (tx == 0) lse[(long)blockIdx.y * T + row] = row_lse(m[i], l[i]);
  }
}

// K4a: the row max and lse only; reads no V, holds no accumulator.
template <int D, typename Elem>
__global__ void __launch_bounds__(kThreads)
flash_fwd_stats_kernel(const Elem* __restrict__ q,
                       const Elem* __restrict__ k, float* __restrict__ lse,
                       int T, int causal, float sm_scale) {
  constexpr int LD = D + 1;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + kBlockQ * LD;

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const long base = (long)blockIdx.y * T * D;
  const int q0 = blockIdx.x * kBlockQ;
  flash::load_tile<D>(Qs, q + base, q0, T, sm_scale, tid);

  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
  }

  const int last = last_k_tile(q0, T, causal);
  for (int kt = 0; kt <= last; ++kt) {
    const int k0 = kt * kBlockK;
    flash::load_tile<D>(Ks, k + base, k0, T, 1.f, tid);
    __syncthreads();

    float s[4][4];
    masked_scores<D>(Qs, Ks, q0, k0, T, causal, tx, ty, s);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float corr;
      const float safe_m = online_row(s[i], m[i], corr);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) rs += expf(s[i][j] - safe_m);
      l[i] = l[i] * corr + row_sum(rs);
    }
    __syncthreads();  // K is overwritten by the next tile
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row < T && tx == 0)
      lse[(long)blockIdx.y * T + row] = row_lse(m[i], l[i]);
  }
}

// K4b: o = sum over k tiles of exp(s - lse) v, from K4a's lse.
template <int D, typename Elem>
__global__ void __launch_bounds__(kThreads)
flash_fwd_acc_kernel(const Elem* __restrict__ q, const Elem* __restrict__ k,
                     const Elem* __restrict__ v,
                     const float* __restrict__ lse, Elem* __restrict__ o,
                     int T, int causal, float sm_scale) {
  constexpr int LD = D + 1;
  constexpr int CPT = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + kBlockQ * LD;
  float* Vs = Ks + kBlockK * LD;
  float* Ps = Vs + kBlockK * LD;
  float* lse_s = Ps + kBlockQ * kLDP;

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const long base = (long)blockIdx.y * T * D;
  const int q0 = blockIdx.x * kBlockQ;
  flash::load_tile<D>(Qs, q + base, q0, T, sm_scale, tid);
  flash::load_rows(lse_s, lse + (long)blockIdx.y * T, q0, T, tid);

  float acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;

  const int last = last_k_tile(q0, T, causal);
  for (int kt = 0; kt <= last; ++kt) {
    const int k0 = kt * kBlockK;
    flash::load_tile<D>(Ks, k + base, k0, T, 1.f, tid);
    flash::load_tile<D>(Vs, v + base, k0, T, 1.f, tid);
    __syncthreads();

    float s[4][4];
    masked_scores<D>(Qs, Ks, q0, k0, T, causal, tx, ty, s);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      // lse = -1e30 marks an all-masked row: the shift is zeroed and the
      // masked s = -1e30 underflows p to exactly 0, as on the TPU
      const float l = lse_s[ty + 16 * i];
      const float shift = l <= kNegInf / 2 ? 0.f : l;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        Ps[(ty + 16 * i) * kLDP + tx + 16 * j] = expf(s[i][j] - shift);
    }
    __syncthreads();
    accumulate_pv<D>(Ps, Vs, tx, ty, acc);
    __syncthreads();  // K, V and P are overwritten by the next tile
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= T) continue;
#pragma unroll
    for (int c = 0; c < CPT; ++c)
      o[base + (long)row * D + tx + 16 * c] = flash::from_f32<Elem>(acc[i][c]);
  }
}

template <int D>
constexpr int tiles_bytes(int d_tiles, int p_tiles, int rows) {
  return (d_tiles * kBlockQ * (D + 1) + p_tiles * kBlockQ * kLDP + rows) *
         (int)sizeof(float);
}

template <typename Elem>
int launch_fwd(const void* q, const void* k, const void* v, void* o,
               float* lse, int bh, int t, int d, int causal, float sm_scale,
               void* stream) {
  return flash::by_dim(d, [&](auto dim) {
    constexpr int D = decltype(dim)::value;
    return flash::run(flash_fwd_kernel<D, Elem>, tiles_bytes<D>(3, 1, 0),
                      bh, t, stream, static_cast<const Elem*>(q),
                      static_cast<const Elem*>(k),
                      static_cast<const Elem*>(v), static_cast<Elem*>(o),
                      lse, t, causal, sm_scale);
  });
}

template <typename Elem>
int launch_stats(const void* q, const void* k, float* lse, int bh, int t,
                 int d, int causal, float sm_scale, void* stream) {
  return flash::by_dim(d, [&](auto dim) {
    constexpr int D = decltype(dim)::value;
    return flash::run(flash_fwd_stats_kernel<D, Elem>,
                      tiles_bytes<D>(2, 0, 0), bh, t, stream,
                      static_cast<const Elem*>(q),
                      static_cast<const Elem*>(k), lse, t, causal, sm_scale);
  });
}

template <typename Elem>
int launch_acc(const void* q, const void* k, const void* v,
               const float* lse, void* o, int bh, int t, int d, int causal,
               float sm_scale, void* stream) {
  return flash::by_dim(d, [&](auto dim) {
    constexpr int D = decltype(dim)::value;
    return flash::run(flash_fwd_acc_kernel<D, Elem>,
                      tiles_bytes<D>(3, 1, kBlockQ), bh, t, stream,
                      static_cast<const Elem*>(q),
                      static_cast<const Elem*>(k),
                      static_cast<const Elem*>(v), lse,
                      static_cast<Elem*>(o), t, causal, sm_scale);
  });
}

}  // namespace

// Every entry point: q, k, v, o are [bh, t, d] contiguous and 16-byte
// aligned, fp32 (_f32) or bf16 (_bf16); lse is [bh, t] fp32; d is 64 or
// 128. Each launches on `stream` and returns the CUDA error code of the
// launch (0 on success); none synchronises.

// K1: writes o and lse.
extern "C" int flash_attention_fwd_f32(const void* q, const void* k,
                                       const void* v, void* o, float* lse,
                                       int bh, int t, int d, int causal,
                                       float sm_scale, void* stream) {
  return launch_fwd<float>(q, k, v, o, lse, bh, t, d, causal, sm_scale,
                           stream);
}

extern "C" int flash_attention_fwd_bf16(const void* q, const void* k,
                                        const void* v, void* o, float* lse,
                                        int bh, int t, int d, int causal,
                                        float sm_scale, void* stream) {
  return launch_fwd<__nv_bfloat16>(q, k, v, o, lse, bh, t, d, causal,
                                   sm_scale, stream);
}

// K4a: writes lse.
extern "C" int flash_attention_fwd_stats_f32(const void* q, const void* k,
                                             float* lse, int bh, int t,
                                             int d, int causal,
                                             float sm_scale, void* stream) {
  return launch_stats<float>(q, k, lse, bh, t, d, causal, sm_scale, stream);
}

extern "C" int flash_attention_fwd_stats_bf16(const void* q, const void* k,
                                              float* lse, int bh, int t,
                                              int d, int causal,
                                              float sm_scale, void* stream) {
  return launch_stats<__nv_bfloat16>(q, k, lse, bh, t, d, causal, sm_scale,
                                     stream);
}

// K4b: reads K4a's lse, writes o.
extern "C" int flash_attention_fwd_acc_f32(const void* q, const void* k,
                                           const void* v, const float* lse,
                                           void* o, int bh, int t, int d,
                                           int causal, float sm_scale,
                                           void* stream) {
  return launch_acc<float>(q, k, v, lse, o, bh, t, d, causal, sm_scale,
                           stream);
}

extern "C" int flash_attention_fwd_acc_bf16(const void* q, const void* k,
                                            const void* v, const float* lse,
                                            void* o, int bh, int t, int d,
                                            int causal, float sm_scale,
                                            void* stream) {
  return launch_acc<__nv_bfloat16>(q, k, v, lse, o, bh, t, d, causal,
                                   sm_scale, stream);
}
