// Flash-attention forward for Hopper (sm_90a), fp32 or bf16 I/O:
//
//   K1  flash_fwd_kernel        replaces the TPU kernel
//       paddle_tpu/pallas/flash_attention.py _fwd_kernel (:171), launched
//       by _fwd_online (:684): the default, online-softmax forward;
//   K4a flash_fwd_stats_kernel (fp32), flash_fwd_stats_wgmma_kernel
//       (bf16)  replace _fwd_stats_kernel (:229), launched by
//       _fwd_twopass (:728): pass 1 of the two-pass forward, the row max
//       and lse only;
//   K4b flash_fwd_acc_kernel (fp32), flash_fwd_acc_wgmma_kernel (bf16)
//       replace _fwd_acc_kernel (:276), launched by _fwd_twopass (:758):
//       pass 2, o = sum_k exp(s - lse) v.
//   K4a + K4b are the twopass arm (PADDLE_FLASH_FWD=twopass).
//
// All of them compute softmax(q k^T * scale [+ causal mask]) v tile by
// tile, so the [T, T] score matrix never reaches device memory, and
// return the row log-sum-exp lse [BH, T] fp32 beside o [BH, T, d], which
// the backward kernels consume.
//
// What bounds them on an H100: arithmetic. K1 does 4 * D FLOP per
// visited score (q k^T and p v): at the serving shape (BH = 16, T = 512,
// d = 128, causal) 1.07 GFLOP against 16.8 MB of q, k, v and o, ~64 FLOP
// per byte. At the long-context shape (BH = 16, T = 8192, d = 128, bf16,
// causal; 536.9M visited scores) K4a does 2 * D FLOP per score (q k^T
// only; 137 GFLOP, 0.14 ms at the 989 TFLOP/s bf16 tensor-core peak) and
// K4b 4 * D (275 GFLOP, 0.28 ms) against ~100 MB of bytes (0.03 ms); each
// also takes one exp per score on the special-function unit (16 a clock
// per SM: 0.14 ms for 537M), which ties with K4a's products.
//
// K1 and the fp32 K4a, K4b (right and simple first) run the products as
// fp32 FMAs on the CUDA cores:
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
//    accumulator); K4b accumulates p = exp(s - lse) times v with no
//    running max, no rescale and no final division. Neither keeps
//    full-sequence state on chip, so there is no residency rule (the
//    TPU's VMEM guard, :653-656) and the arm runs at every T;
//  - K1 in bf16 (the flagship training path under AMP) widens q, k, v to
//    fp32 as they are staged, and rounds o to bf16 once, at the store.
//    fp32 K4a and K4b stay on the CUDA cores: tensor cores would mean
//    TF32, which the fp32 contract does not allow.
//
// The bf16 K4a and K4b (the long-context training path) run on the
// tensor cores (hopper.cuh):
//  - one block of two warpgroups (256 threads) per (128-row q tile, bh);
//    warpgroup wg owns q rows [64 wg, 64 wg + 64). The grid is 1-D and
//    walks the q tiles from the last (the most causal k tiles) to the
//    first, over every bh, so the light tiles fill the tail;
//  - q, k and v stay bf16 in shared memory, 128 x d tiles in the
//    128-byte swizzle that wgmma reads without bank conflicts; k (and v)
//    tiles of 128 keys stream through a ring of kStages buffers filled by
//    cp.async (zeros past T), so the next tile's copy overlaps this
//    tile's products;
//  - S = Q K^T is wgmma m64n128k16 per warpgroup with both operands in
//    shared memory and fp32 accumulators in registers; sm_scale * log2(e)
//    multiplies the fp32 scores (q is not rounded after scaling, so lse
//    keeps fp32 accuracy), and exponentials are ex2.approx;
//  - only the tiles that straddle the causal diagonal or T are masked;
//  - K4a reduces the row max and the sum of exp2 from the S fragment in
//    registers (4 lanes per row, warp shuffles; the sums are kept per lane
//    and reduced once at the end) and writes lse as a natural log; no P
//    leaves registers;
//  - K4b computes P = exp2(S c - lse log2(e)) in registers and feeds it
//    as wgmma's register A operand to O += P V, V read MN-major from the
//    same swizzled tile layout; O stays fp32 in registers and is rounded
//    to bf16 once, at the store. P goes in as two bf16 operands, hi =
//    bf16(P) and lo = bf16(P - hi), so o keeps fp32 P's accuracy at the
//    cost of one more P V product: with P rounded once to bf16, as the
//    TPU kernel rounds p to v's dtype (:307-309), the first rows of a
//    head (few keys, p ~ 1/n) are off by up to 2^-9 |v|, far above
//    chip_smoke.py's bound on |o - o_ref| / (|o_ref| + mean |o_ref|) at
//    T = 8192, where mean |o| is ~1.8e-2 (phase b4 logs that evaluation);
//  - ptxas (sm_90a, d = 128): K4a 126 registers (two blocks of 97 KB
//    shared memory per SM), K4b 222 (one block of 161 KB), no spills.
#include "flash_common.cuh"
#include "hopper.cuh"

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
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_stats_kernel(const float* __restrict__ q,
                       const float* __restrict__ k, float* __restrict__ lse,
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
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_acc_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ lse, float* __restrict__ o,
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
      o[base + (long)row * D + tx + 16 * c] = acc[i][c];
  }
}

// -- bf16 K4a, K4b on the tensor cores -----------------------------------------

namespace tc {

constexpr int kBQ = 128;         // q rows per block: 64 per warpgroup
constexpr int kBK = 128;         // keys per k tile (one m64n128 product)
constexpr int kThreads = 256;    // two warpgroups
constexpr int kStages = 2;       // k (and v) tiles in the ring
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Dynamic shared memory: 1024 bytes of alignment slack, the q tile, then
// kStages k tiles (K4a) or kStages (k tile, v tile) pairs (K4b).
template <int D>
struct Smem {
  static_assert(kBQ == kBK, "q, k and v tiles share one size");
  static constexpr int kTile = kBQ * D * 2;  // bytes of one bf16 tile
  static constexpr int kStats = 1024 + kTile + kStages * kTile;
  static constexpr int kAcc = 1024 + kTile + kStages * 2 * kTile;
};

// Where this thread sits: its q tile, bh, warpgroup, and its two
// accumulator rows row and row + 8 (absolute); col is the first of its
// two columns in every 8-column block of an accumulator.
struct Place {
  int bh, q0, wg, warp_row, row, col, lane;
};

__device__ __forceinline__ Place place(int bh_count) {
  Place p;
  const int nq_minus_1 = gridDim.x / bh_count - 1;
  p.bh = blockIdx.x % bh_count;
  p.q0 = (nq_minus_1 - (int)blockIdx.x / bh_count) * kBQ;  // heaviest first
  p.wg = threadIdx.x / 128;
  p.lane = threadIdx.x % 32;
  p.warp_row = p.q0 + 64 * p.wg + 16 * ((threadIdx.x / 32) % 4);
  p.row = p.warp_row + p.lane / 4;
  p.col = 2 * (p.lane % 4);
  return p;
}

__device__ __forceinline__ int k_tiles(int q0, int T, int causal) {
  const int nk = (T + kBK - 1) / kBK;
  return causal ? min(nk, (q0 + kBQ - 1) / kBK + 1) : nk;
}

// Does k tile k0 hold a key that some row of this warp may not see?
__device__ __forceinline__ bool straddles(const Place& p, int k0, int T,
                                          int causal) {
  return k0 + kBK > T || (causal && k0 + kBK - 1 > p.warp_row);
}

// S = Q K^T for this warpgroup's 64 rows and one k tile: D / 16 wgmma
// m64n128k16, both operands K-major in shared memory; fp32 in s.
template <int D>
__device__ __forceinline__ void scores(float (&s)[kBK / 2], uint32_t q_s,
                                       uint32_t k_s, int wg) {
  hopper::fence_regs(s);
  hopper::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    // 16 columns of d: panel kk / 4, bytes 32 (kk % 4) into each row
    const uint32_t a =
        q_s + (kk / 4) * (kBQ * 128) + wg * (64 * 128) + (kk % 4) * 32;
    const uint32_t b = k_s + (kk / 4) * (kBK * 128) + (kk % 4) * 32;
    hopper::mma_ss_n128(s, hopper::desc_sw128(a, 0, 1024),
                        hopper::desc_sw128(b, 0, 1024), kk > 0);
  }
  hopper::wgmma_commit();
  hopper::wgmma_wait<0>();
  hopper::fence_regs(s);
}

// -inf for keys >= T and, if causal, for keys past the row.
__device__ __forceinline__ void mask(float (&s)[kBK / 2], const Place& p,
                                     int k0, int T, int causal) {
#pragma unroll
  for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = k0 + 8 * j + p.col + e;
        if (key >= T || (causal && key > p.row + 8 * h))
          s[4 * j + 2 * h + e] = -INFINITY;
      }
}

// Start the cp.async copies of k tile `tile` (and its v tile) into ring
// slot tile % kStages, if it exists, and close the group either way, so
// that group n always holds tile n.
template <int D, bool WITH_V>
__device__ __forceinline__ void fetch(uint32_t ring, const __nv_bfloat16* k,
                                      const __nv_bfloat16* v, int tile,
                                      int n_tiles, int T) {
  if (tile < n_tiles) {
    constexpr int kSlot = (WITH_V ? 2 : 1) * Smem<D>::kTile;
    const uint32_t slot = ring + (tile % kStages) * kSlot;
    hopper::load_tile_async<kBK, D, kThreads>(slot, k, tile * kBK, T,
                                              threadIdx.x);
    if (WITH_V)
      hopper::load_tile_async<kBK, D, kThreads>(slot + Smem<D>::kTile, v,
                                                tile * kBK, T, threadIdx.x);
  }
  hopper::cp_async_commit();
}

// Wait for tile kt's copies, make every thread's copies visible to
// wgmma, and (the barrier) let the ring slot of tile kt - 1 be reused.
__device__ __forceinline__ void tile_ready() {
  hopper::cp_async_wait<kStages - 2>();
  hopper::fence_view_async_shared();
  __syncthreads();
}

extern __shared__ uint8_t smem_tc[];

// K4a (bf16): lse only. m is the running row max of S c (log2 units), l
// this lane's share of the row's sum of exp2(S c - m).
template <int D>
__global__ void __launch_bounds__(kThreads, 2)
flash_fwd_stats_wgmma_kernel(const __nv_bfloat16* __restrict__ q,
                             const __nv_bfloat16* __restrict__ k,
                             float* __restrict__ lse, int bh_count, int T,
                             int causal, float sm_scale) {
  const uint32_t q_s = hopper::align_1024(smem_tc);
  const uint32_t ring = q_s + Smem<D>::kTile;
  const Place p = place(bh_count);
  const long base = (long)p.bh * T * D;
  const int n_tiles = k_tiles(p.q0, T, causal);
  const float c = sm_scale * kLog2e;

  hopper::load_tile_async<kBQ, D, kThreads>(q_s, q + base, p.q0, T,
                                            threadIdx.x);
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st)
    fetch<D, false>(ring, k + base, nullptr, st, n_tiles, T);

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  for (int kt = 0; kt < n_tiles; ++kt) {
    tile_ready();
    fetch<D, false>(ring, k + base, nullptr, kt + kStages - 1, n_tiles, T);
    float s[kBK / 2];
    scores<D>(s, q_s, ring + (kt % kStages) * Smem<D>::kTile, p.wg);
    const int k0 = kt * kBK;
    if (straddles(p, k0, T, causal)) mask(s, p, k0, T, causal);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j)
        mx = fmaxf(mx, fmaxf(s[4 * j + 2 * h], s[4 * j + 2 * h + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[h], mx * c);
      const float safe = m_new == -INFINITY ? 0.f : m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          sum += hopper::ex2(fmaf(s[4 * j + 2 * h + e], c, -safe));
      l[h] = l[h] * hopper::ex2(m[h] - safe) + sum;
      m[h] = m_new;
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float lt = l[h];
    lt += __shfl_xor_sync(0xffffffffu, lt, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    const int r = p.row + 8 * h;
    if (p.lane % 4 == 0 && r < T)
      lse[(long)p.bh * T + r] =
          m[h] == -INFINITY ? kNegInf : (m[h] + log2f(lt)) * kLn2;
  }
}

// O += P V for this warpgroup: P as hi + lo, two bf16 A operands from
// registers, against the v tile MN-major in shared memory (2 kBK / 16
// wgmma).
template <int D>
__device__ __forceinline__ void accumulate_pv(float (&acc)[D / 2],
                                              uint32_t (&hi)[kBK / 16][4],
                                              uint32_t (&lo)[kBK / 16][4],
                                              uint32_t v_s) {
  hopper::fence_regs(acc);
  hopper::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk) {
    // keys 16 kk .. 16 kk + 15: two 8-row atoms of every column panel
    const uint64_t b =
        hopper::desc_sw128(v_s + kk * (16 * 128), kBK * 128, 1024);
    hopper::mma_rs<D>(acc, hi[kk], b);
    hopper::mma_rs<D>(acc, lo[kk], b);
  }
  hopper::wgmma_commit();
  hopper::wgmma_wait<0>();
  hopper::fence_regs(acc);
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk) {
    hopper::fence_regs(hi[kk]);
    hopper::fence_regs(lo[kk]);
  }
}

// K4b (bf16): o = sum over k tiles of exp2(S c - lse log2(e)) V.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_acc_wgmma_kernel(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v,
                           const float* __restrict__ lse,
                           __nv_bfloat16* __restrict__ o, int bh_count, int T,
                           int causal, float sm_scale) {
  const uint32_t q_s = hopper::align_1024(smem_tc);
  const uint32_t ring = q_s + Smem<D>::kTile;
  const Place p = place(bh_count);
  const long base = (long)p.bh * T * D;
  const int n_tiles = k_tiles(p.q0, T, causal);
  const float c = sm_scale * kLog2e;

  hopper::load_tile_async<kBQ, D, kThreads>(q_s, q + base, p.q0, T,
                                            threadIdx.x);
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st)
    fetch<D, true>(ring, k + base, v + base, st, n_tiles, T);

  // lse = -1e30 marks an all-masked row: the shift is zeroed and the
  // masked s = -inf gives p = 0, as on the TPU
  float shift[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = p.row + 8 * h;
    const float x = r < T ? lse[(long)p.bh * T + r] : 0.f;
    shift[h] = x <= kNegInf / 2 ? 0.f : x * kLog2e;
  }
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  for (int kt = 0; kt < n_tiles; ++kt) {
    tile_ready();
    fetch<D, true>(ring, k + base, v + base, kt + kStages - 1, n_tiles, T);
    const uint32_t slot = ring + (kt % kStages) * 2 * Smem<D>::kTile;
    float s[kBK / 2];
    scores<D>(s, q_s, slot, p.wg);
    const int k0 = kt * kBK;
    if (straddles(p, k0, T, causal)) mask(s, p, k0, T, causal);
    // the S accumulator of keys 16 kk .. 16 kk + 15 is, register for
    // register, the A fragment of the k step kk of P V
    uint32_t hi[kBK / 16][4], lo[kBK / 16][4];
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float sh = shift[i % 2];
        hopper::split_bf16(hopper::ex2(fmaf(s[8 * kk + 2 * i], c, -sh)),
                           hopper::ex2(fmaf(s[8 * kk + 2 * i + 1], c, -sh)),
                           hi[kk][i], lo[kk][i]);
      }
    accumulate_pv<D>(acc, hi, lo, slot + Smem<D>::kTile);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = p.row + 8 * h;
    if (r >= T) continue;
    __nv_bfloat16* out = o + base + (long)r * D + p.col;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(out + 8 * j) =
          hopper::pack_bf16(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
  }
}

// One block of kThreads per (128-row q tile, bh), on a 1-D grid; returns
// the CUDA error code of the launch.
template <typename... KArgs, typename... Args>
int run(void (*kernel)(KArgs...), int smem, int bh, int t, void* stream,
        Args... args) {
  return hopper::launch_1d(kernel, smem, (long)bh * ((t + kBQ - 1) / kBQ),
                           kThreads, stream, args...);
}

}  // namespace tc

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

// K4a and K4b: fp32 on the CUDA cores, bf16 on the tensor cores.
int launch_stats(const float* q, const float* k, float* lse, int bh, int t,
                 int d, int causal, float sm_scale, void* stream) {
  return flash::by_dim(d, [&](auto dim) {
    constexpr int D = decltype(dim)::value;
    return flash::run(flash_fwd_stats_kernel<D>, tiles_bytes<D>(2, 0, 0), bh,
                      t, stream, q, k, lse, t, causal, sm_scale);
  });
}

int launch_stats(const __nv_bfloat16* q, const __nv_bfloat16* k, float* lse,
                 int bh, int t, int d, int causal, float sm_scale,
                 void* stream) {
  return flash::by_dim(d, [&](auto dim) {
    constexpr int D = decltype(dim)::value;
    return tc::run(tc::flash_fwd_stats_wgmma_kernel<D>, tc::Smem<D>::kStats,
                   bh, t, stream, q, k, lse, bh, t, causal, sm_scale);
  });
}

int launch_acc(const float* q, const float* k, const float* v,
               const float* lse, float* o, int bh, int t, int d, int causal,
               float sm_scale, void* stream) {
  return flash::by_dim(d, [&](auto dim) {
    constexpr int D = decltype(dim)::value;
    return flash::run(flash_fwd_acc_kernel<D>, tiles_bytes<D>(3, 1, kBlockQ),
                      bh, t, stream, q, k, v, lse, o, t, causal, sm_scale);
  });
}

int launch_acc(const __nv_bfloat16* q, const __nv_bfloat16* k,
               const __nv_bfloat16* v, const float* lse, __nv_bfloat16* o,
               int bh, int t, int d, int causal, float sm_scale,
               void* stream) {
  return flash::by_dim(d, [&](auto dim) {
    constexpr int D = decltype(dim)::value;
    return tc::run(tc::flash_fwd_acc_wgmma_kernel<D>, tc::Smem<D>::kAcc, bh,
                   t, stream, q, k, v, lse, o, bh, t, causal, sm_scale);
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
  return launch_stats(static_cast<const float*>(q),
                      static_cast<const float*>(k), lse, bh, t, d, causal,
                      sm_scale, stream);
}

extern "C" int flash_attention_fwd_stats_bf16(const void* q, const void* k,
                                              float* lse, int bh, int t,
                                              int d, int causal,
                                              float sm_scale, void* stream) {
  return launch_stats(static_cast<const __nv_bfloat16*>(q),
                      static_cast<const __nv_bfloat16*>(k), lse, bh, t, d,
                      causal, sm_scale, stream);
}

// K4b: reads K4a's lse, writes o.
extern "C" int flash_attention_fwd_acc_f32(const void* q, const void* k,
                                           const void* v, const float* lse,
                                           void* o, int bh, int t, int d,
                                           int causal, float sm_scale,
                                           void* stream) {
  return launch_acc(static_cast<const float*>(q), static_cast<const float*>(k),
                    static_cast<const float*>(v), lse, static_cast<float*>(o),
                    bh, t, d, causal, sm_scale, stream);
}

extern "C" int flash_attention_fwd_acc_bf16(const void* q, const void* k,
                                            const void* v, const float* lse,
                                            void* o, int bh, int t, int d,
                                            int causal, float sm_scale,
                                            void* stream) {
  return launch_acc(static_cast<const __nv_bfloat16*>(q),
                    static_cast<const __nv_bfloat16*>(k),
                    static_cast<const __nv_bfloat16*>(v), lse,
                    static_cast<__nv_bfloat16*>(o), bh, t, d, causal,
                    sm_scale, stream);
}
