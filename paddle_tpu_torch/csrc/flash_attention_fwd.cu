// Flash-attention forward for Hopper (sm_90a), fp32 or bf16 I/O:
//
//   K1  flash_fwd_f32_kernel (fp32), flash_fwd_wgmma_kernel (bf16)  replace
//       the TPU kernel paddle_tpu/pallas/flash_attention.py _fwd_kernel
//       (:171), launched by _fwd_online (:684): the default,
//       online-softmax forward;
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
// What bounds them on an H100. K1 does 4 * D FLOP per visited score
// (q k^T and p v). fp32 at the serving shape (BH = 16, T = 512, d = 128,
// causal): 1.07 GFLOP against 16.8 MB of q, k, v and o, ~64 FLOP per
// byte, so arithmetic at the 67 TFLOP/s of the CUDA cores. bf16 at the
// flagship training shape (BH = 128, T = 512, d = 128, causal): 8.6
// GFLOP against 67 MB, bytes (0.020 ms at 3.35 TB/s against 0.009 ms of
// tensor-core time); at the long-context shape (BH = 16, T = 8192,
// d = 128, causal; 536.9M visited scores): 275 GFLOP against 134 MB,
// operations (0.28 ms at the 989 TFLOP/s bf16 tensor-core peak). K4a
// does 2 * D FLOP per score (q k^T only; 137 GFLOP, 0.14 ms there), K4b
// 4 * D. Each also takes one exp per score on the special-function unit
// (16 a clock per SM: 0.14 ms for 537M), which ties with K4a's products.
//
// fp32 K1 (the serving prefill's forward; 12 launches a prefill at
// [16, 512, 128] causal) runs the products as exact fp32 FMAs on the
// CUDA cores: tensor cores would mean TF32, which puts o ~1.4e-3 from
// fp32 there, against the 1e-4 the fp32 contract allows, and 3xTF32
// would buy at most ~1.5x over the CUDA cores' peak. Its bound is
// operations: 1.076 GFLOP of visited scores, 0.0161 ms at 67 TFLOP/s
// (the 32 x 32 tiles execute 1.141 GFLOP, the diagonal tiles whole).
// flash_fwd_f32_kernel (namespace f32):
//  - fill the card and balance it: one block of 256 threads (8 warps)
//    per (32-row q tile, bh), 256 blocks at the serving shape, on a 1-D
//    grid that walks the q tiles heaviest first (tc::place's order). At
//    d = 128 a block takes 98,176 bytes of shared memory (q tile, rings
//    of two 32-key k tiles and two v tiles, two P slots) and at most 128
//    registers (__launch_bounds__(256, 2)), so two blocks share an SM
//    and all 256 are resident in one wave (57,216 bytes at d = 64). With
//    blocks placed one a SM, then a second a SM, the plain walk would
//    give SM j ranks j and 132 + j: 24 tile pairs of 32 x 32 on the
//    busiest SM (1.46x the mean of 16.5). So the walk folds at the SM
//    count: blocks from 132 on take the order from its lightest end, SM j
//    holds ranks j and 255 - j, 17 pairs at most (1.03x the mean, 8.9
//    MFLOP: 0.0176 ms at one SM's 0.51 TFLOP/s). The heaviest block
//    holds 16 pairs (8.4 MFLOP) and runs nearly alone on its SM, so it
//    has 8 warps. A row's keys stay in one block: no atomics, and the
//    block merges its two key halves in one fixed order;
//  - keep the FMA pipes fed: the warps split the work by product, one k
//    tile apart (warp specialisation): warps 0-3 compute S_j and P_j,
//    warps 4-7 O += P_{j-1} V_{j-1} meanwhile. A score warp holds 4 rows
//    x 4 keys a lane over half of d (warps 2, 3 hand their partial
//    scores to warps 0, 1, which add them and run the softmax): per 4
//    columns of d 8 LDS.128 against 64 FFMA. A P V warp holds 8 rows x
//    d / 16 columns a lane over half of the tile's keys (warps 6, 7 hand
//    their O to warps 4, 5 at the end): per key 8 LDS.32 of P and d / 64
//    LDS.128 of V against d / 2 FFMA. Counted as wavefronts with a
//    16-byte load served a quarter-warp at a time (one address a quarter
//    for q and P, 8 keys in distinct bank quads for k: q and k rows are
//    padded to d + 4 floats; 2 addresses in distinct banks for an
//    LDS.32 of P): S 32 wavefronts for 64 FFMA (2 a wavefront), P V 16
//    for 64 at d = 128 (4; 8 / 3 at 64). If a quarter-warp broadcast
//    costs no wavefront of its own, S is at 8 and P V at 5.3. The four
//    schedulers of an SM issue up to 4 FFMA a clock against one
//    shared-memory wavefront;
//  - overlap copies with the math: the score warps fill the k ring and
//    the P V warps the v ring by 16-byte cp.async (rows >= T
//    zero-filled), tile j + 1 while tile j is multiplied; q is scaled by
//    sm_scale log2(e) as it is staged (one rounding) and stays resident.
//    No block-wide barrier in the sweep: each role waits for its ring
//    at its own named barrier (128 threads), P and the rows'
//    corrections pass through two slots, each with a "full" and a
//    "free" named barrier (bar.arrive by the writer, bar.sync by the
//    reader), and the partial scores through one more;
//  - exp2: S is in log2 units, P = ex2.approx(S - m) on the
//    special-function unit; m, l and O stay fp32 in registers (l as each
//    lane's share, reduced once at the end) and lse = (m + log2 l) ln 2
//    at the store. Only the last k tile of a block (the one across the
//    causal diagonal or T) is masked;
//  - every sum runs in one order that depends on T, the row and causal
//    only (a score: d in order over each half, then lower + upper half;
//    O: keys in order over each half of every tile, tiles in order, then
//    lower + upper half), so a second launch gives the same bits.
//
// fp32 K4a and K4b (right and simple first) run the products as fp32
// FMAs on the CUDA cores too:
//  - one block of 256 threads per (64-row q tile, bh): grid
//    (ceil(T/64), BH). Nothing carries between blocks, so the TPU's
//    sequential ki grid axis becomes a loop inside the block;
//  - each K (and V) tile of 64 rows is staged in shared memory as fp32
//    with a row stride of d + 1 floats, so the column reads of the score
//    product hit 16 distinct banks. Above 48 KB (K4a 66 KB, K4b 113 KB
//    at d = 128) shared memory is dynamic after cudaFuncSetAttribute;
//  - thread (ty, tx) of a 16 x 16 grid owns score rows ty + 16 i and
//    columns tx + 16 j (i, j < 4) and output columns tx + 16 c: a 4 x 4
//    register tile, so each shared-memory load feeds two FMAs;
//  - row max and row sum are reduced over the 16 lanes of a row with
//    warp shuffles; m, l and the output accumulator stay in fp32
//    registers for the whole sweep;
//  - causal tiles stop the sweep at the diagonal tile; keys at index >= T
//    are masked, so any T works (no T % 128 rule as on the TPU);
//  - masked scores are -1e30 and a fully masked row uses 0 as its safe
//    max (K4a) or shift (K4b), exactly as the TPU kernels do, so exp()
//    underflows to 0; K4a writes lse = -1e30 for such a row (as fp32 K1
//    does);
//  - K4a reads no V and keeps only m and l per row (no output
//    accumulator); K4b accumulates p = exp(s - lse) times v with no
//    running max, no rescale and no final division. Neither keeps
//    full-sequence state on chip, so there is no residency rule (the
//    TPU's VMEM guard, :653-656) and the arm runs at every T.
//
// The bf16 K1, K4a and K4b (the training paths under AMP) run on the
// tensor cores (hopper.cuh, namespace tc):
//  - one block of two warpgroups (256 threads) per (128-row q tile, bh);
//    warpgroup wg owns q rows [64 wg, 64 wg + 64). The grid is 1-D and
//    walks the q tiles from the last (the most causal k tiles) to the
//    first, over every bh, so the light tiles fill the tail;
//  - q, k and v stay bf16 in shared memory, 128 x d tiles in the
//    128-byte swizzle that wgmma reads without bank conflicts; k (and v)
//    tiles of 128 keys stream through a ring of buffers filled by cp.async
//    (zeros past T), so the next tile's copy overlaps this tile's
//    products;
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
//  - K1 is K4a and K4b fused into one sweep: per k tile the row max of
//    S c (log2 units) is reduced over the 4 lanes of a row, the
//    correction exp2(m_old - m_new) rescales the D / 2 fp32 accumulators
//    and the lane's partial row sum l, and P = exp2(S c - m) goes from
//    the S accumulator into P V as hi + lo, as in K4b. A row that sees no
//    key yet shifts by 0 (the TPU's safe max, :199-204) and gets p = 0.
//    At the end l is reduced over the 4 lanes, o = acc / l is rounded
//    once to bf16 and lse = (m + log2 l) ln 2. Three products of 2 D
//    FLOP per visited score make the long-context shape 0.42 TFLOP of
//    tensor-core work, as K4b's. The exponentials of tile j overlap the
//    tensor cores' P V of tile j - 1: each step issues S_j, then
//    P_{j-1} V_{j-1}, and waits for S_j alone (wgmma groups retire in
//    order), so only the rescale of O and the hi/lo split wait for P V.
//    That keeps tiles j - 1 and j in shared memory while j + 1 lands: a
//    ring of kFwdSlots = 3 (k, v) slots (225 KB at d = 128);
//  - ptxas (sm_90a): K4a 126 registers at d = 128 (two blocks of 97 KB
//    shared memory per SM), K4b 222 (one block of 161 KB), K1 (bf16)
//    252 at d = 128 and 200 at d = 64 (one block a SM), no spills.
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

// -- bf16 K1, K4a, K4b on the tensor cores ------------------------------------

namespace tc {

constexpr int kBQ = 128;         // q rows per block: 64 per warpgroup
constexpr int kBK = 128;         // keys per k tile (one m64n128 product)
constexpr int kThreads = 256;    // two warpgroups
constexpr int kStages = 2;       // k (and v) tiles in the ring
constexpr int kFwdSlots = 3;     // bf16 K1's ring: P V of tile j - 1 and
                                 // S of tile j read while j + 1 lands
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Dynamic shared memory: 1024 bytes of alignment slack, the q tile, then
// kStages k tiles (K4a), kStages (k tile, v tile) pairs (K4b) or
// kFwdSlots pairs (K1).
template <int D>
struct Smem {
  static_assert(kBQ == kBK, "q, k and v tiles share one size");
  static constexpr int kTile = kBQ * D * 2;  // bytes of one bf16 tile
  static constexpr int kStats = 1024 + kTile + kStages * kTile;
  static constexpr int kAcc = 1024 + kTile + kStages * 2 * kTile;
  static constexpr int kFwd = 1024 + kTile + kFwdSlots * 2 * kTile;
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

// Issue S = Q K^T for this warpgroup's 64 rows and one k tile as one
// wgmma group: D / 16 m64n128k16, both operands K-major in shared
// memory; fp32 in s once the group is waited for.
template <int D>
__device__ __forceinline__ void issue_scores(float (&s)[kBK / 2],
                                             uint32_t q_s, uint32_t k_s,
                                             int wg) {
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
}

// S = Q K^T (issue_scores), waited for.
template <int D>
__device__ __forceinline__ void scores(float (&s)[kBK / 2], uint32_t q_s,
                                       uint32_t k_s, int wg) {
  issue_scores<D>(s, q_s, k_s, wg);
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
template <int D, bool WITH_V, int SLOTS = kStages>
__device__ __forceinline__ void fetch(uint32_t ring, const __nv_bfloat16* k,
                                      const __nv_bfloat16* v, int tile,
                                      int n_tiles, int T) {
  if (tile < n_tiles) {
    constexpr int kSlot = (WITH_V ? 2 : 1) * Smem<D>::kTile;
    const uint32_t slot = ring + (tile % SLOTS) * kSlot;
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

// The online-softmax step of one k tile (K4a, K1): fold S's row maxima
// (4 lanes a row) into m, rescale the lane's l, and overwrite s with
// P = exp2(S c - m), adding it to l. Returns each row half's correction
// exp2(m_old - m_new), which K1's O still has to take. A row that sees
// no key yet shifts by 0: its s = -inf give p = 0, as the TPU's safe
// max does (:199-204).
__device__ __forceinline__ void online_softmax(float (&s)[kBK / 2],
                                               float (&m)[2], float (&l)[2],
                                               float c, float (&corr)[2]) {
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
    corr[h] = hopper::ex2(m[h] - safe);
    m[h] = m_new;
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& x = s[4 * j + 2 * h + e];
        x = hopper::ex2(fmaf(x, c, -safe));
        sum += x;
      }
    l[h] = l[h] * corr[h] + sum;
  }
}

// P (K4b, K1) as the A fragments of P V, each value as hi + lo: the S
// accumulator of keys 16 kk .. 16 kk + 15 is, register for register,
// the A fragment of the k step kk of P V.
__device__ __forceinline__ void split_p(const float (&pr)[kBK / 2],
                                        uint32_t (&hi)[kBK / 16][4],
                                        uint32_t (&lo)[kBK / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      hopper::split_bf16(pr[8 * kk + 2 * i], pr[8 * kk + 2 * i + 1],
                         hi[kk][i], lo[kk][i]);
}

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
    float corr[2];
    online_softmax(s, m, l, c, corr);
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

// Issue O += P V for this warpgroup as one wgmma group: P as hi + lo,
// two bf16 A operands from registers, against the v tile MN-major in
// shared memory (2 kBK / 16 wgmma).
template <int D>
__device__ __forceinline__ void issue_pv(float (&acc)[D / 2],
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
}

// After the wait for a P V group: keep the compiler from touching acc,
// hi and lo before this point.
template <int D>
__device__ __forceinline__ void pv_done(float (&acc)[D / 2],
                                        uint32_t (&hi)[kBK / 16][4],
                                        uint32_t (&lo)[kBK / 16][4]) {
  hopper::fence_regs(acc);
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk) {
    hopper::fence_regs(hi[kk]);
    hopper::fence_regs(lo[kk]);
  }
}

// O += P V (issue_pv), waited for.
template <int D>
__device__ __forceinline__ void accumulate_pv(float (&acc)[D / 2],
                                              uint32_t (&hi)[kBK / 16][4],
                                              uint32_t (&lo)[kBK / 16][4],
                                              uint32_t v_s) {
  issue_pv<D>(acc, hi, lo, v_s);
  hopper::wgmma_wait<0>();
  pv_done<D>(acc, hi, lo);
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
#pragma unroll
    for (int i = 0; i < kBK / 2; ++i)
      s[i] = hopper::ex2(fmaf(s[i], c, -shift[(i / 2) % 2]));
    uint32_t hi[kBK / 16][4], lo[kBK / 16][4];
    split_p(s, hi, lo);
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

// K1 (bf16): one sweep with the online softmax; writes o and lse. m is
// the running row max of S c (log2 units), l this lane's share of the
// row's sum of exp2(S c - m), acc the row's O, both scaled by exp2(-m).
// Tile j's exponentials run while the tensor cores do tile j - 1's P V:
// each step issues S_j, then P_{j-1} V_{j-1}, and waits for S_j alone.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_wgmma_kernel(const __nv_bfloat16* __restrict__ q,
                       const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v,
                       __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                       int bh_count, int T, int causal, float sm_scale) {
  const uint32_t q_s = hopper::align_1024(smem_tc);
  const uint32_t ring = q_s + Smem<D>::kTile;
  const Place p = place(bh_count);
  const long base = (long)p.bh * T * D;
  const int n_tiles = k_tiles(p.q0, T, causal);
  const float c = sm_scale * kLog2e;
  auto slot = [&](int tile) {
    return ring + (tile % kFwdSlots) * 2 * Smem<D>::kTile;
  };

  hopper::load_tile_async<kBQ, D, kThreads>(q_s, q + base, p.q0, T,
                                            threadIdx.x);
  fetch<D, true, kFwdSlots>(ring, k + base, v + base, 0, n_tiles, T);

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, corr[2];
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float s[kBK / 2];
  uint32_t hi[kBK / 16][4], lo[kBK / 16][4];

  tile_ready();
  fetch<D, true, kFwdSlots>(ring, k + base, v + base, 1, n_tiles, T);
  scores<D>(s, q_s, slot(0), p.wg);
  if (straddles(p, 0, T, causal)) mask(s, p, 0, T, causal);
  online_softmax(s, m, l, c, corr);
  split_p(s, hi, lo);
  for (int kt = 1; kt < n_tiles; ++kt) {
    // tile kt has landed and every thread is past step kt - 1, whose
    // wait retired the last reader of tile kt - 2's slot, where kt + 1
    // goes
    tile_ready();
    fetch<D, true, kFwdSlots>(ring, k + base, v + base, kt + 1, n_tiles, T);
    issue_scores<D>(s, q_s, slot(kt), p.wg);
    issue_pv<D>(acc, hi, lo, slot(kt - 1) + Smem<D>::kTile);
    hopper::wgmma_wait<1>();  // S_kt; P V of tile kt - 1 still runs
    hopper::fence_regs(s);
    const int k0 = kt * kBK;
    if (straddles(p, k0, T, causal)) mask(s, p, k0, T, causal);
    online_softmax(s, m, l, c, corr);
    hopper::wgmma_wait<0>();
    pv_done<D>(acc, hi, lo);
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        acc[4 * j + 2 * h] *= corr[h];
        acc[4 * j + 2 * h + 1] *= corr[h];
      }
    split_p(s, hi, lo);
  }
  accumulate_pv<D>(acc, hi, lo, slot(n_tiles - 1) + Smem<D>::kTile);

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float lt = l[h];
    lt += __shfl_xor_sync(0xffffffffu, lt, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    const int r = p.row + 8 * h;
    if (r >= T) continue;
    const float inv = 1.f / fmaxf(lt, 1e-30f);
    __nv_bfloat16* out = o + base + (long)r * D + p.col;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(out + 8 * j) = hopper::pack_bf16(
          acc[4 * j + 2 * h] * inv, acc[4 * j + 2 * h + 1] * inv);
    if (p.lane % 4 == 0)
      lse[(long)p.bh * T + r] =
          m[h] == -INFINITY ? kNegInf : (m[h] + log2f(lt)) * kLn2;
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

// -- fp32 K1 on the CUDA cores ------------------------------------------------

namespace f32 {

constexpr int kBQ = 32;          // q rows per block
constexpr int kBK = 32;          // keys per k (and v) tile
constexpr int kThreads = 256;    // 4 score warps, then 4 P V warps
constexpr int kLDP = kBK + 8;    // row stride of the P tile
// named barriers (0 is __syncthreads): the score warps' and the P V
// warps' own (their ring waits), the hand-over of the upper half of d's
// partial scores, and per P slot "full" and "free"
constexpr int kBarS = 1, kBarPV = 2, kBarHalf = 3, kBarFull = 4,
              kBarFree = 6;

// Dynamic shared memory, in floats: the q tile, two k tiles and two v
// tiles (the rings), two P slots (32 x kBK, then the 32 rows'
// corrections), the partial scores of the upper half of d (16 a lane of
// two warps), then the rows' l for the end. q and k rows are padded by 4
// floats, so the 16-byte column reads of 8 consecutive k rows start in
// distinct bank quads; v rows are read along the row and need none.
// After the sweep the k ring holds the second key half's O.
template <int D>
struct Smem {
  static constexpr int kLDQ = D + 4;
  static constexpr int kQ = kBQ * kLDQ;
  static constexpr int kK = kBK * kLDQ;
  static constexpr int kV = kBK * D;
  static constexpr int kP = kBQ * kLDP + kBQ;
  static constexpr int kHalf = 2 * 32 * 16;
  static constexpr int kBytes =
      (kQ + 2 * (kK + kV) + 2 * kP + kHalf + kBQ) * 4;
  static_assert(kBQ * D <= 2 * kK, "the k ring holds O for the merge");
};

__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

template <int ID>
__device__ __forceinline__ void bar_sync(int n) {
  asm volatile("bar.sync %0, %1;\n" ::"n"(ID), "r"(n) : "memory");
}

// Arrive at named barrier ID without waiting; this thread's earlier
// shared-memory writes are visible to the threads that wait there.
template <int ID>
__device__ __forceinline__ void bar_arrive(int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"n"(ID), "r"(n) : "memory");
}

// The barrier of P slot `slot` of a pair (ID, ID + 1).
template <int ID>
__device__ __forceinline__ void slot_sync(int slot, int n) {
  if (slot)
    bar_sync<ID + 1>(n);
  else
    bar_sync<ID>(n);
}

template <int ID>
__device__ __forceinline__ void slot_arrive(int slot, int n) {
  if (slot)
    bar_arrive<ID + 1>(n);
  else
    bar_arrive<ID>(n);
}

// Start the cp.async copies of rows [row0, row0 + kBK) of a [T, D]
// matrix into dst (row stride ld floats) by the 128 threads t of one
// role, rows >= T zero-filled, and close the group.
template <int D>
__device__ __forceinline__ void fetch(float* dst, int ld, const float* src,
                                      int row0, int T, int t) {
#pragma unroll
  for (int it = 0; it < kBK * D / 4 / 128; ++it) {
    const int i = it * 128 + t;
    const int r = i / (D / 4), c = 4 * (i % (D / 4));
    const bool valid = row0 + r < T;
    hopper::cp_async_16(hopper::smem_addr(dst + r * ld + c),
                        src + (long)(valid ? row0 + r : 0) * D + c, valid);
  }
  hopper::cp_async_commit();
}

// s = Q K^T over D / 2 columns of d for this lane's 4 rows (q_row + 4 i
// rows) and 4 keys (k_row + 8 j rows), the columns summed in order. Per
// 4 columns a warp issues 8 LDS.128 against 64 FFMA. A 16-byte load is
// served a quarter-warp (8 lanes) at a time, one wavefront each at
// best: here one q address a quarter (broadcast) and 8 consecutive keys
// in distinct bank quads, so 32 wavefronts for 64 FFMA.
template <int D>
__device__ __forceinline__ void tile_scores(const float* q_row,
                                            const float* k_row,
                                            float (&s)[4][4]) {
  constexpr int LD = Smem<D>::kLDQ;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll
  for (int d = 0; d < D / 2; d += 4) {
    float4 a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = lds4(q_row + 4 * i * LD + d);
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = lds4(k_row + 8 * j * LD + d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(a[i].x, b[j].x, s[i][j]);
        s[i][j] = fmaf(a[i].y, b[j].y, s[i][j]);
        s[i][j] = fmaf(a[i].z, b[j].z, s[i][j]);
        s[i][j] = fmaf(a[i].w, b[j].w, s[i][j]);
      }
  }
}

__device__ __forceinline__ void fma4(float4& acc, float p, const float4& v) {
  acc.x = fmaf(p, v.x, acc.x);
  acc.y = fmaf(p, v.y, acc.y);
  acc.z = fmaf(p, v.z, acc.z);
  acc.w = fmaf(p, v.w, acc.w);
}

__device__ __forceinline__ void scale4(float4& x, float f) {
  x.x *= f;
  x.y *= f;
  x.z *= f;
  x.w *= f;
}

__device__ __forceinline__ float4 add4(const float4& a, const float4& b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// acc += P V over kBK / 2 keys, in order, for this lane's 8 rows (p_row
// + 2 i rows) and D / 16 columns (v_col + 64 c + 0..3). Per key a warp
// issues 8 LDS.32 of P (2 addresses: one wavefront each) and D / 64
// LDS.128 of V (8 consecutive chunks a quarter-warp: 4 wavefronts each)
// against D / 2 FFMA: 4 FFMA a wavefront at d = 128, 8 / 3 at 64.
template <int D>
__device__ __forceinline__ void tile_pv(const float* p_row,
                                        const float* v_col,
                                        float4 (&acc)[8][D / 64]) {
#pragma unroll 4
  for (int kk = 0; kk < kBK / 2; ++kk) {
    float p[8];
    float4 vv[D / 64];
#pragma unroll
    for (int i = 0; i < 8; ++i) p[i] = p_row[2 * i * kLDP + kk];
#pragma unroll
    for (int c = 0; c < D / 64; ++c) vv[c] = lds4(v_col + kk * D + 64 * c);
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int c = 0; c < D / 64; ++c) fma4(acc[i][c], p[i], vv[c]);
  }
}

// K1 (fp32): one sweep with the online softmax; writes o and lse. Block
// b of the 1-D grid takes q tile rank(b) of the heaviest-first order
// (tc::place's walk: the last q tiles, with the most causal k tiles,
// first, over every bh); blocks from `fold` on take the order from its
// end, so that with every block resident at once the second block of an
// SM is light where its first is heavy. The block's warps split the
// work by product, one k tile apart: warps 0-3 compute S_j = Q K_j^T,
// the online softmax and P_j, warps 4-7 O += P_{j-1} V_{j-1} meanwhile.
// Score warp w takes q rows [16 (w % 2), + 16) over the half w / 2 of d;
// warps 2 and 3 hand their partial scores to warps 0 and 1, which add
// them to theirs (lower half + upper half) and run the softmax. P V warp
// 4 + w takes the same rows over keys [16 (w / 2), + 16) of each tile;
// at the end warps 6 and 7 hand their O to warps 4 and 5 (lower keys +
// upper keys). Each role fills its own ring (k tiles, v tiles) by
// cp.async and waits for it at its own named barrier; P and the rows'
// corrections pass through two slots in shared memory, handed over by a
// "full" and a "free" named barrier each. In S lane (rg, kg) = (lane /
// 8, lane % 8) holds rows rg + 4 i and keys kg + 8 j; m is the running
// row max of S in log2 units (q is scaled by sm_scale log2(e) as it is
// staged), l the lane's share of the row's sum of exp2(S - m). In P V
// lane (rg2, cg) = (lane / 16, lane % 16) holds rows rg2 + 2 i and
// columns 4 cg + 64 c .. + 3.
template <int D>
__global__ void __launch_bounds__(kThreads, 2)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     float* __restrict__ lse, int bh_count, int T,
                     int causal, int fold, float sm_scale) {
  using S = Smem<D>;
  extern __shared__ float4 smem_f32[];
  float* Qs = reinterpret_cast<float*>(smem_f32);
  float* Ks = Qs + S::kQ;
  float* Vs = Ks + 2 * S::kK;
  float* Ps = Vs + 2 * S::kV;
  float4* Hs = reinterpret_cast<float4*>(Ps + 2 * S::kP);
  float* Ls = Ps + 2 * S::kP + S::kHalf;

  const int b = (int)blockIdx.x < fold
                    ? (int)blockIdx.x
                    : fold + (int)gridDim.x - 1 - (int)blockIdx.x;
  const int bh = b % bh_count;
  const int q0 = ((T + kBQ - 1) / kBQ - 1 - b / bh_count) * kBQ;
  const long base = (long)bh * T * D;
  const int nk = (T + kBK - 1) / kBK;
  const int n_tiles = causal ? min(nk, q0 / kBK + 1) : nk;
  const float c = sm_scale * tc::kLog2e;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const bool scores = warp < 4;
  const int t = threadIdx.x % 128;  // thread of its role
  const int row0 = 16 * (warp % 2);
  const int second = (warp % 4) / 2;  // upper half of d (S), of keys (P V)

  if (scores)
    fetch<D>(Ks, S::kLDQ, k + base, 0, T, t);
  else
    fetch<D>(Vs, D, v + base, 0, T, t);
  // q stays resident, scaled once as it is staged; rows >= T are zeros
  for (int i = threadIdx.x; i < kBQ * D / 4; i += kThreads) {
    const int r = i / (D / 4), col = 4 * (i % (D / 4));
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + r < T)
      x = *reinterpret_cast<const float4*>(q + base + (long)(q0 + r) * D + col);
    scale4(x, c);
    *reinterpret_cast<float4*>(Qs + r * S::kLDQ + col) = x;
  }
  __syncthreads();

  const int rg2 = lane / 16, cg = lane % 16;  // P V
  float4 acc[8][D / 64];
  float4* Hw = Hs + (warp % 2) * 4 * 32 + lane;  // this lane's partials
  if (scores) {
    const int rg = lane / 8, kg = lane % 8;
    float m[4], l[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      m[i] = -INFINITY;
      l[i] = 0.f;
    }
    for (int kt = 0; kt < n_tiles; ++kt) {
      // k tile kt has landed, and every score warp is past tile kt - 1,
      // whose ring slot tile kt + 1 takes, and past reading the partial
      // scores of tile kt - 1
      hopper::cp_async_wait<0>();
      bar_sync<kBarS>(128);
      if (kt + 1 < n_tiles)
        fetch<D>(Ks + ((kt + 1) % 2) * S::kK, S::kLDQ, k + base,
                 (kt + 1) * kBK, T, t);
      float s[4][4];
      tile_scores<D>(Qs + (row0 + rg) * S::kLDQ + second * (D / 2),
                     Ks + (kt % 2) * S::kK + kg * S::kLDQ + second * (D / 2),
                     s);
      if (second) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          Hw[32 * i] = make_float4(s[i][0], s[i][1], s[i][2], s[i][3]);
        bar_arrive<kBarHalf>(128);
        continue;
      }
      bar_sync<kBarHalf>(128);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 h = Hw[32 * i];
        s[i][0] += h.x;
        s[i][1] += h.y;
        s[i][2] += h.z;
        s[i][3] += h.w;
      }
      if (kt == n_tiles - 1) {  // the only tile past the diagonal or T
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int key = kt * kBK + kg + 8 * j;
            if (key >= T || (causal && key > q0 + row0 + rg + 4 * i))
              s[i][j] = -INFINITY;
          }
      }
      float* P = Ps + (kt % 2) * S::kP;
      if (kt >= 2) slot_sync<kBarFree>(kt % 2, 192);  // P V of kt - 2
      // online softmax over the 8 lanes of a row; a row that sees no key
      // yet shifts by 0 (the TPU's safe max, :199-204) and gets p = 0
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float mx = fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3]));
#pragma unroll
        for (int off = 1; off < 8; off <<= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        const float m_new = fmaxf(m[i], mx);
        const float safe = m_new == -INFINITY ? 0.f : m_new;
        const float corr = hopper::ex2(m[i] - safe);
        m[i] = m_new;
        float sum = 0.f;
        const int r = row0 + rg + 4 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float p = hopper::ex2(s[i][j] - safe);
          P[r * kLDP + kg + 8 * j] = p;
          sum += p;
        }
        l[i] = l[i] * corr + sum;
        if (kg == 0) P[kBQ * kLDP + r] = corr;
      }
      slot_arrive<kBarFull>(kt % 2, 192);
    }
    if (!second) {
      // l over the 8 lanes of a row; lse = (m + log2 l) ln 2
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float lt = l[i];
#pragma unroll
        for (int off = 1; off < 8; off <<= 1)
          lt += __shfl_xor_sync(0xffffffffu, lt, off);
        const int r = row0 + rg + 4 * i;
        if (kg == 0) {
          Ls[r] = lt;
          if (q0 + r < T)
            lse[(long)bh * T + q0 + r] =
                m[i] == -INFINITY ? kNegInf : (m[i] + log2f(lt)) * tc::kLn2;
        }
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int cc = 0; cc < D / 64; ++cc)
        acc[i][cc] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int kt = 0; kt < n_tiles; ++kt) {
      // v tile kt has landed, and every P V warp is past tile kt - 1
      hopper::cp_async_wait<0>();
      bar_sync<kBarPV>(128);
      if (kt + 1 < n_tiles)
        fetch<D>(Vs + ((kt + 1) % 2) * S::kV, D, v + base, (kt + 1) * kBK,
                 T, t);
      const float* P = Ps + (kt % 2) * S::kP;
      slot_sync<kBarFull>(kt % 2, 192);  // P of tile kt
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float corr = P[kBQ * kLDP + row0 + rg2 + 2 * i];
#pragma unroll
        for (int cc = 0; cc < D / 64; ++cc) scale4(acc[i][cc], corr);
      }
      const int key0 = second * (kBK / 2);
      tile_pv<D>(P + (row0 + rg2) * kLDP + key0,
                 Vs + (kt % 2) * S::kV + key0 * D + 4 * cg, acc);
      if (kt + 2 < n_tiles) slot_arrive<kBarFree>(kt % 2, 192);
    }
  }
  // the rows' l; the k ring is free, and takes the upper keys' O
  __syncthreads();
  float4* Os = reinterpret_cast<float4*>(Ks) + (warp % 2) * 8 * (D / 64) * 32;
  if (!scores && second) {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int cc = 0; cc < D / 64; ++cc)
        Os[(i * (D / 64) + cc) * 32 + lane] = acc[i][cc];
  }
  __syncthreads();
  if (scores || second) return;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = row0 + rg2 + 2 * i;
    if (q0 + r >= T) continue;
    const float li = fmaxf(Ls[r], 1e-30f);
#pragma unroll
    for (int cc = 0; cc < D / 64; ++cc) {
      const float4 a = add4(acc[i][cc], Os[(i * (D / 64) + cc) * 32 + lane]);
      *reinterpret_cast<float4*>(o + base + (long)(q0 + r) * D + 64 * cc +
                                 4 * cg) =
          make_float4(a.x / li, a.y / li, a.z / li, a.w / li);
    }
  }
}

// The grid's fold: with at most two blocks a SM (every block resident at
// once), blocks [0, SMs) take the heaviest q tiles, one a SM, and the
// rest the lightest first, so each SM's pair sums to about the mean.
// With more blocks, none (the plain heaviest-first walk).
inline int fold_point(long blocks) {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return (int)blocks;
  return blocks <= 2L * sms ? sms : (int)blocks;
}

}  // namespace f32

template <int D>
constexpr int tiles_bytes(int d_tiles, int p_tiles, int rows) {
  return (d_tiles * kBlockQ * (D + 1) + p_tiles * kBlockQ * kLDP + rows) *
         (int)sizeof(float);
}

// K1: fp32 on the CUDA cores, bf16 on the tensor cores.
int launch_fwd(const float* q, const float* k, const float* v, float* o,
               float* lse, int bh, int t, int d, int causal, float sm_scale,
               void* stream) {
  return flash::by_dim(d, [&](auto dim) {
    constexpr int D = decltype(dim)::value;
    const long blocks = (long)bh * ((t + f32::kBQ - 1) / f32::kBQ);
    return hopper::launch_1d(f32::flash_fwd_f32_kernel<D>,
                             f32::Smem<D>::kBytes, blocks, f32::kThreads,
                             stream, q, k, v, o, lse, bh, t, causal,
                             f32::fold_point(blocks), sm_scale);
  });
}

int launch_fwd(const __nv_bfloat16* q, const __nv_bfloat16* k,
               const __nv_bfloat16* v, __nv_bfloat16* o, float* lse, int bh,
               int t, int d, int causal, float sm_scale, void* stream) {
  return flash::by_dim(d, [&](auto dim) {
    constexpr int D = decltype(dim)::value;
    return tc::run(tc::flash_fwd_wgmma_kernel<D>, tc::Smem<D>::kFwd, bh, t,
                   stream, q, k, v, o, lse, bh, t, causal, sm_scale);
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
  return launch_fwd(static_cast<const float*>(q), static_cast<const float*>(k),
                    static_cast<const float*>(v), static_cast<float*>(o), lse,
                    bh, t, d, causal, sm_scale, stream);
}

extern "C" int flash_attention_fwd_bf16(const void* q, const void* k,
                                        const void* v, void* o, float* lse,
                                        int bh, int t, int d, int causal,
                                        float sm_scale, void* stream) {
  return launch_fwd(static_cast<const __nv_bfloat16*>(q),
                    static_cast<const __nv_bfloat16*>(k),
                    static_cast<const __nv_bfloat16*>(v),
                    static_cast<__nv_bfloat16*>(o), lse, bh, t, d, causal,
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
