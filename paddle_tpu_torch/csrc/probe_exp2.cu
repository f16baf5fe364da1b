// The exp / exp2 probe (P) for Hopper (sm_90a): is exp2 cheaper than exp
// on this card?
//
// Replaces the TPU kernel tools/probe_exp2.py _kernel (:26), launched by
// _run (:41): `reps` times, x <- f(-(x * 0.5 + 0.25)) elementwise over an
// fp32 array, with f = expf or exp2f. The argument stays in (-0.75,
// -0.25], where neither function overflows, and every step depends on
// the last, so nothing is hoisted out of the chain.
//
// What bounds it on an H100: for a short chain the bytes (x read once,
// out written once: 134 MB at the probe's [64, 512, 512] is 0.040 ms at
// 3.35 TB/s); for a long one the special-function unit, which evaluates
// ex2 at 16 results per clock per SM (the CUDA C Programming Guide's
// throughput table for compute capability 9.0): 132 SMs x 16 x 1.98 GHz
// = 4.18e12 per second on an H100 SXM at its maximum clock. exp2f is one
// MUFU.EX2 (plus denormal handling); expf, built without
// --use_fast_math as here, adds a range reduction of a few FMAs before
// the same MUFU.EX2. The probe's rep differencing (tools/probe_exp2.py
// :62-66) cancels the bytes and the launch, leaving the cost of the
// chain's steps.
//
// Design: one thread per element (grid-stride loop), the chain in a
// register, one 4-byte load and one store per element. The multiply and
// the add are rounded separately (__fmul_rn, __fadd_rn) as the JAX and
// PyTorch versions round them, so nvcc does not contract them into an
// FMA and the kernel computes the plain version's function.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 1 << 20;

template <bool kExp2>
__global__ void __launch_bounds__(kThreads)
exp_chain_kernel(const float* __restrict__ x, float* __restrict__ out,
                 long long n, int reps) {
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += stride) {
    float v = x[i];
    for (int r = 0; r < reps; ++r) {
      const float a = -__fadd_rn(__fmul_rn(v, 0.5f), 0.25f);
      v = kExp2 ? exp2f(a) : expf(a);
    }
    out[i] = v;
  }
}

}  // namespace

// x, out: n contiguous fp32 values on the device; use_exp2 selects exp2f
// (1) or expf (0). Launches on `stream` and returns the CUDA error code of
// the launch (0 on success); it does not synchronise.
extern "C" int probe_exp2_chain(const float* x, float* out, long long n,
                                int reps, int use_exp2, void* stream) {
  if (n < 1 || reps < 0) return (int)cudaErrorInvalidValue;
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (use_exp2)
    exp_chain_kernel<true><<<(unsigned)blocks, kThreads, 0, s>>>(x, out, n,
                                                                  reps);
  else
    exp_chain_kernel<false><<<(unsigned)blocks, kThreads, 0, s>>>(x, out, n,
                                                                   reps);
  return (int)cudaGetLastError();
}
