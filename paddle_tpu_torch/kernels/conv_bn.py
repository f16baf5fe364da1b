"""Fused matmul + batch-norm statistics: the Hopper port of the TPU
kernel in paddle_tpu/pallas/conv_bn.py.

| kernel | TPU body (launch site) | here |
|---|---|---|
| K6 | `_kernel` :38 (`_pallas_impl` :71) | `matmul_bn_stats_kernel`, csrc/conv_bn.cu |

`matmul_bn_stats(x, w)` returns `(y, colsum, colsumsq)`: y = x @ w with
fp32 accumulation, y in x's dtype, colsum = Σ_m y and colsumsq = Σ_m y²
in fp32, both taken from the fp32 products before y is rounded. The
fused conv2d_bn op (ops/fused_ops.py) feeds it every 1x1 conv + BN.

- `matmul_bn_stats_kernel` checks device, dtype, shape and contiguity,
  launches K6 (CUDA C++ for sm_90a, built with nvcc at first use by
  kernels/build.py, called through ctypes on PyTorch's current stream),
  raises if the launch fails, and counts its launches in
  `matmul_bn_stats_kernel.launches`. A CPU tensor makes it raise.
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

import ctypes
import threading

import torch

from . import build

__all__ = ['matmul_bn_stats', 'matmul_bn_stats_kernel',
           'matmul_bn_stats_reference', 'MatmulBnStats', 'SUPPORTED_DTYPES']

SUPPORTED_DTYPES = (torch.float32, torch.bfloat16)
_SUFFIX = {torch.float32: 'f32', torch.bfloat16: 'bf16'}
_INT_MAX = 2 ** 31 - 1

_count_lock = threading.Lock()
# x, w, y, part_s, part_q, s, q; M, K, N; the stream
_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [ctypes.c_void_p]


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
    colsum [N] fp32, colsumsq [N] fp32). The statistics are summed per
    128-row tile and then over tiles in a fixed order, so they are the
    same bits on every run. Does not synchronise."""
    _check(x, w)
    M, K = x.shape
    N = w.shape[1]
    dev = x.device
    tile_m = build.function('conv_bn', 'matmul_bn_stats_tile_m', [])()
    gm = (M + tile_m - 1) // tile_m
    y = torch.empty((M, N), dtype=x.dtype, device=dev)
    parts = torch.empty((2, gm, N), dtype=torch.float32, device=dev)
    s = torch.empty((N,), dtype=torch.float32, device=dev)
    q = torch.empty((N,), dtype=torch.float32, device=dev)
    fn = build.function('conv_bn', 'matmul_bn_stats_' + _SUFFIX[x.dtype],
                        _ARGTYPES)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(x.data_ptr(), w.data_ptr(), y.data_ptr(),
                 parts[0].data_ptr(), parts[1].data_ptr(), s.data_ptr(),
                 q.data_ptr(), M, K, N, stream)
    if err != 0:
        raise RuntimeError('matmul_bn_stats_kernel: kernel launch failed '
                           'with CUDA error %d' % err)
    with _count_lock:
        matmul_bn_stats_kernel.launches += 1
    return y, s, q


matmul_bn_stats_kernel.launches = 0


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
