"""Fused matmul + batch-norm statistics: the Hopper port of the TPU
kernel in paddle_tpu/pallas/conv_bn.py.

| kernel | TPU body (launch site) | here |
|---|---|---|
| K6 | `_kernel` :38 (`_pallas_impl` :71) | `matmul_bn_stats_wgmma_kernel` (bf16) and `matmul_bn_stats_kernel` (fp32, ragged bf16), csrc/conv_bn.cu |

`matmul_bn_stats(x, w)` returns `(y, colsum, colsumsq)`: y = x @ w with
fp32 accumulation, y in x's dtype, colsum = Σ_m y and colsumsq = Σ_m y²
in fp32, both taken from the fp32 products before y is rounded. The
fused conv2d_bn op (ops/fused_ops.py) feeds it every 1x1 conv + BN.

- `matmul_bn_stats_kernel` checks device, dtype, shape and contiguity,
  picks K6's kernel by shape and dtype (`_route`): bf16 with K and N
  multiples of 8 and 16-byte aligned rows (every 1x1 shape of a ResNet)
  takes the tensor-core kernel, a persistent grid that walks the tiles
  of `_plan` with TMA loads and stores and wgmma products; fp32, and
  bf16 rows TMA cannot address, take the generic kernel. Both are CUDA
  C++ for sm_90a, built with nvcc at first use by kernels/build.py and
  called through ctypes on PyTorch's current stream; a failed build or
  launch raises. Launches are counted in
  `matmul_bn_stats_kernel.launches` and, per kernel, in
  `matmul_bn_stats_kernel.launches_by_kernel`. A CPU tensor makes it
  raise.
- `matmul_bn_stats_reference` is the plain PyTorch version (the JAX
  package's `_xla_impl` :100): it serves CPU tensors, and the card's
  checks hold the kernel against it.
- `MatmulBnStats` is the autograd Function. Its backward is the JAX
  package's `_bwd` (:134): dy = gy + gs + 2·y·gq in fp32, then dx and dw
  as fp32 matrix products, which the JAX package also leaves to the
  compiler outside Pallas. CUDA tensors take K6 in the forward unless
  the caller asks for the plain version (FLAGS_use_pallas_fused_ops
  cleared); CPU tensors always take the plain version.
"""
from __future__ import annotations

import collections
import ctypes
import functools
import threading

import torch

from . import build, note

__all__ = ['matmul_bn_stats', 'matmul_bn_stats_kernel',
           'matmul_bn_stats_reference', 'MatmulBnStats', 'SUPPORTED_DTYPES',
           'WGMMA_KERNEL', 'GENERIC_KERNEL']

SUPPORTED_DTYPES = (torch.float32, torch.bfloat16)
_SUFFIX = {torch.float32: 'f32', torch.bfloat16: 'bf16'}
_INT_MAX = 2 ** 31 - 1

_count_lock = threading.Lock()
# x, w, y, part_s, part_q, s, q; M, K, N; the stream
_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
# ... then bn, grid, stages, resident before the stream
_WGMMA_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 +
                   [ctypes.c_void_p])

WGMMA_KERNEL = 'matmul_bn_stats_wgmma_kernel'
GENERIC_KERNEL = 'matmul_bn_stats_kernel'

# The tensor-core kernel's tiles and shared memory (csrc/conv_bn.cu
# tc::layout, which the C entry point checks the plan against).
TILE_M = 128                 # two consumer warpgroups of 64 rows
TILE_K = 64                  # one 128-byte swizzled bf16 panel
TILE_N = 128                 # wgmma width (64 where N <= 64)
SMEM_LIMIT = 232448          # bytes of shared memory a block may use
MAX_STAGES = 8
RESIDENT_W_BYTES = 64 * 1024  # w's [K, BN] block stays in shared memory

Plan = collections.namedtuple(
    'Plan', 'bm bn gm gn tiles grid stages resident smem')


def _cdiv(a, b):
    return -(-a // b)


def _smem_bytes(bn, stages, resident, K):
    """Dynamic shared memory of the tensor-core kernel: the x ring
    (stages x 128 x 64 bf16), w (the ring of [64, bn] slices, or all of
    K when resident), the y staging tile (128 x bn bf16), the warps'
    column sums (8 x 2 x bn fp32), the mbarriers and 1024 bytes to align
    the swizzled tiles."""
    w_slices = _cdiv(K, TILE_K) if resident else stages
    return (1024 + stages * TILE_M * TILE_K * 2 + w_slices * TILE_K * bn * 2
            + TILE_M * bn * 2 + 8 * 2 * bn * 4 + 8 * (2 * stages + 1))


@functools.lru_cache(maxsize=None)
def _plan(M, K, N, sms):
    """Launch plan of the tensor-core kernel on a card with `sms` SMs.

    Tiles are 128 x bn, bn = 128 (64 where N <= 64), numbered m-tile
    major (t = m_tile * gn + n_block), so the n-blocks of one m-tile are
    adjacent. CTA c of the persistent grid walks tiles c, c + grid, ...;
    the grid is the largest multiple of gn within the SMs (at least gn),
    so a CTA keeps one n-block (and its column sums, and w's block when
    it is resident) for its whole walk, and the CTAs running at one time
    cover whole m-tiles, which share x through L2. The x ring gets as
    many stages as shared memory holds, up to MAX_STAGES."""
    bn = 64 if N <= 64 else TILE_N
    gm, gn = _cdiv(M, TILE_M), _cdiv(N, bn)
    tiles = gm * gn
    grid = min(max(sms // gn, 1) * gn, tiles)
    resident = _cdiv(K, TILE_K) * TILE_K * bn * 2 <= RESIDENT_W_BYTES
    stages = MAX_STAGES
    while stages > 2 and _smem_bytes(bn, stages, resident, K) > SMEM_LIMIT:
        stages -= 1
    smem = _smem_bytes(bn, stages, resident, K)
    if smem > SMEM_LIMIT:
        raise ValueError('matmul_bn_stats: no plan fits shared memory for '
                         'K=%d, N=%d' % (K, N))
    return Plan(TILE_M, bn, gm, gn, tiles, grid, stages, resident, smem)


def _walk(plan):
    """[[(m_tile, n_block), ...] for each CTA]: the tiles each CTA of the
    grid computes, in its order."""
    return [[(t // plan.gn, t % plan.gn)
             for t in range(c, plan.tiles, plan.grid)]
            for c in range(plan.grid)]


@functools.lru_cache(maxsize=None)
def _generic_tile_m():
    """Rows of the generic kernel's output tile."""
    return build.function('conv_bn', 'matmul_bn_stats_tile_m', [])()


@functools.lru_cache(maxsize=None)
def _sm_count(device_index):
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def _route(M, K, N, dtype, aligned=True):
    """The kernel K6 launches for x [M, K] @ w [K, N] of `dtype`: the
    tensor-core kernel for bf16 whose rows TMA can address (K and N
    multiples of 8, so every row starts on 16 bytes, and x, w 16-byte
    aligned), the generic kernel otherwise."""
    if dtype == torch.bfloat16 and K % 8 == 0 and N % 8 == 0 and aligned:
        return WGMMA_KERNEL
    return GENERIC_KERNEL


def _check(x, w):
    who = 'matmul_bn_stats_kernel'
    for name, t in (('x', x), ('w', w)):
        if t.device.type != 'cuda':
            raise ValueError('%s: %s is on %s, the kernel needs a CUDA '
                             'tensor' % (who, name, t.device))
        if t.dim() != 2:
            raise ValueError('%s: %s must be 2-D, got shape %s'
                             % (who, name, tuple(t.shape)))
        if not t.is_contiguous():
            raise ValueError('%s: %s must be contiguous' % (who, name))
    if x.dtype not in SUPPORTED_DTYPES:
        raise TypeError('%s: dtype %s, the kernel takes float32 or bfloat16'
                        % (who, x.dtype))
    if w.dtype != x.dtype:
        raise TypeError('%s: w is %s, x is %s' % (who, w.dtype, x.dtype))
    if w.device != x.device:
        raise ValueError('%s: w on another device than x' % who)
    M, K = x.shape
    K2, N = w.shape
    if K != K2:
        raise ValueError('%s: x is %s and w is %s: inner sizes differ'
                         % (who, tuple(x.shape), tuple(w.shape)))
    if min(M, K, N) < 1 or max(M, K, N) > _INT_MAX:
        raise ValueError('%s: M=%d, K=%d, N=%d out of range' % (who, M, K, N))


def matmul_bn_stats_kernel(x, w):
    """Launch K6. x [M, K], w [K, N]: both float32 or both bfloat16,
    contiguous, on one CUDA device. Returns (y [M, N] in x's dtype,
    colsum [N] fp32, colsumsq [N] fp32). The statistics are summed in a
    fixed order (per CTA of the tensor-core kernel's grid, or per 128-row
    tile of the generic one, then over those in order), so they are the
    same bits on every run on one card. Does not synchronise."""
    _check(x, w)
    M, K = x.shape
    N = w.shape[1]
    dev = x.device
    xp, wp = x.data_ptr(), w.data_ptr()
    kernel = _route(M, K, N, x.dtype, (xp | wp) % 16 == 0)
    if kernel == WGMMA_KERNEL:
        plan = _plan(M, K, N, _sm_count(dev.index))
        rows = plan.grid // plan.gn  # one row of partials per CTA
        extra = (plan.bn, plan.grid, plan.stages, int(plan.resident))
        fn = build.function('conv_bn', 'matmul_bn_stats_wgmma',
                            _WGMMA_ARGTYPES)
    else:
        rows = _cdiv(M, _generic_tile_m())  # one row of partials per tile
        extra = ()
        fn = build.function('conv_bn', 'matmul_bn_stats_' + _SUFFIX[x.dtype],
                            _ARGTYPES)
    y = torch.empty((M, N), dtype=x.dtype, device=dev)
    # [y | y^2][the partials' rows, then the sums]: one allocation
    stats = torch.empty((2, rows + 1, N), dtype=torch.float32, device=dev)
    s, q = stats[0, rows], stats[1, rows]
    sp, row, half = stats.data_ptr(), N * 4, (rows + 1) * N * 4
    args = (xp, wp, y.data_ptr(), sp, sp + half, sp + rows * row,
            sp + half + rows * row, M, K, N) + extra
    with torch.cuda.device(dev):  # the C entry launches on the current one
        err = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError('matmul_bn_stats_kernel: %s launch failed with '
                           'CUDA error %d' % (kernel, err))
    with _count_lock:
        matmul_bn_stats_kernel.launches += 1
        by_kernel = matmul_bn_stats_kernel.launches_by_kernel
        by_kernel[kernel] = by_kernel.get(kernel, 0) + 1
        note(('k6',))
        note(('k6', kernel))
    return y, s, q


def reset_launches():
    """Set K6's launch counts, the total and each kernel's, to 0."""
    with _count_lock:
        matmul_bn_stats_kernel.launches = 0
        matmul_bn_stats_kernel.launches_by_kernel = {
            WGMMA_KERNEL: 0, GENERIC_KERNEL: 0}


matmul_bn_stats_kernel.launches = 0
matmul_bn_stats_kernel.launches_by_kernel = {WGMMA_KERNEL: 0,
                                             GENERIC_KERNEL: 0}


def matmul_bn_stats_reference(x, w):
    """Plain PyTorch version of K6 (the JAX package's `_xla_impl`): an
    fp32 product, its column sums of y and y², then y in x's dtype. Same
    arguments and results as matmul_bn_stats_kernel, on any device."""
    y = torch.matmul(x.float(), w.float())
    return y.to(x.dtype), torch.sum(y, dim=0), torch.sum(y * y, dim=0)


class MatmulBnStats(torch.autograd.Function):
    """(y, colsum, colsumsq) of x @ w, with K6 in the forward for CUDA
    tensors and the JAX package's closed-form backward."""

    @staticmethod
    def forward(ctx, x, w, force_plain):
        if force_plain or x.device.type == 'cpu':
            y, s, q = matmul_bn_stats_reference(x, w)
        else:
            y, s, q = matmul_bn_stats_kernel(x, w)
        ctx.save_for_backward(x, w, y)
        return y, s, q

    @staticmethod
    def backward(ctx, gy, gs, gq):
        x, w, y = ctx.saved_tensors
        # s = Σ_m y and q = Σ_m y²: their cotangents fold into y's
        dy = gy.float() + gs[None, :] + 2.0 * y.float() * gq[None, :]
        dx = torch.matmul(dy, w.float().t()).to(x.dtype)
        dw = torch.matmul(x.float().t(), dy).to(w.dtype)
        return dx, dw, None


def matmul_bn_stats(x, w, force_plain=False):
    """y = x @ w (fp32 accumulation, y in x's dtype), colsum = Σ_m y and
    colsumsq = Σ_m y² (fp32). Differentiable. x [M, K] and w [K, N] are
    made contiguous here; CUDA tensors launch K6 unless force_plain."""
    return MatmulBnStats.apply(x.contiguous(), w.contiguous(),
                               bool(force_plain))
