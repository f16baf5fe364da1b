"""Flash-attention forward: the Hopper port of the TPU kernel
paddle_tpu/pallas/flash_attention.py `_fwd_kernel` (:171), which the JAX
package reaches through `flash_attention` :1018 -> `_flash` :994 ->
`_fwd` :643 -> `_fwd_online` :678 (`pl.pallas_call` :684).

The kernel is CUDA C++ for sm_90a in csrc/flash_attention_fwd.cu, built
with nvcc at first use (kernels/build.py) and called through ctypes on
PyTorch's current stream. The source's header says what bounds it on an
H100 (arithmetic: ~64 FLOP per byte at the serving shape) and what its
design does about that.

- `flash_attention_fwd` is the wrapper: it checks device, dtype, shape
  and contiguity, launches the kernel, raises if the launch fails, and
  counts its launches in `flash_attention_fwd.launches`.
- `flash_attention_reference` is the plain PyTorch version of the same
  function (the JAX package's `_naive` :1053): it serves CPU tensors,
  and the card's checks hold the kernel against it.
- `flash_attention` is the public entry ([B, H, T, d] or [BH, T, d]): a
  CUDA tensor goes to the kernel or raises, a CPU tensor goes to the
  plain version; force_plain=True (FLAGS_use_flash_attention=False)
  selects the plain version explicitly.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from . import build

__all__ = ['flash_attention', 'flash_attention_fwd',
           'flash_attention_reference', 'SUPPORTED_HEAD_DIMS']

SUPPORTED_HEAD_DIMS = (64, 128)
_NEG_INF = -1e30
_MAX_GRID_Y = 65535

_fn = None
_fn_lock = threading.Lock()
_count_lock = threading.Lock()


def _kernel():
    global _fn
    with _fn_lock:
        if _fn is None:
            fn = build.library('flash_attention_fwd').flash_attention_fwd_f32
            fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + \
                [ctypes.c_float, ctypes.c_void_p]
            fn.restype = ctypes.c_int
            _fn = fn
    return _fn


def _check(q, k, v):
    for name, t in (('q', q), ('k', k), ('v', v)):
        if t.device.type != 'cuda':
            raise ValueError('flash_attention_fwd: %s is on %s, the kernel '
                             'needs a CUDA tensor' % (name, t.device))
        if t.dtype != torch.float32:
            raise TypeError('flash_attention_fwd: %s is %s, the kernel '
                            'takes float32' % (name, t.dtype))
        if t.dim() != 3 or t.shape != q.shape:
            raise ValueError('flash_attention_fwd: q, k, v must share one '
                             '[BH, T, d] shape, got %s %s %s'
                             % (tuple(q.shape), tuple(k.shape),
                                tuple(v.shape)))
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError('flash_attention_fwd: %s must be contiguous '
                             'and 16-byte aligned' % name)
        if t.device != q.device:
            raise ValueError('flash_attention_fwd: q, k, v on different '
                             'devices')
    BH, T, d = q.shape
    if d not in SUPPORTED_HEAD_DIMS:
        raise ValueError('flash_attention_fwd: head dim %d is not one of '
                         '%s' % (d, SUPPORTED_HEAD_DIMS))
    if not 1 <= BH <= _MAX_GRID_Y or T < 1:
        raise ValueError('flash_attention_fwd: BH=%d, T=%d out of range'
                         % (BH, T))


def flash_attention_fwd(q, k, v, causal, sm_scale):
    """Launch the kernel. q, k, v: [BH, T, d] float32, contiguous, on one
    CUDA device, d in SUPPORTED_HEAD_DIMS. Returns (o [BH, T, d],
    lse [BH, T] float32). Does not synchronise."""
    _check(q, k, v)
    BH, T, d = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((BH, T), dtype=torch.float32, device=q.device)
    fn = _kernel()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 lse.data_ptr(), BH, T, d, int(bool(causal)),
                 float(sm_scale), stream)
    if err != 0:
        raise RuntimeError('flash_attention_fwd: kernel launch failed with '
                           'CUDA error %d' % err)
    with _count_lock:
        flash_attention_fwd.launches += 1
    return o, lse


flash_attention_fwd.launches = 0


def flash_attention_reference(q, k, v, causal, sm_scale):
    """Plain PyTorch version: an explicit q·kᵀ·scale in fp32, a -1e30
    causal mask, softmax, then ·v. Same arguments and results as
    flash_attention_fwd, on any device."""
    s = torch.matmul(q * sm_scale, k.transpose(-1, -2)).float()
    if causal:
        T = q.shape[-2]
        mask = torch.ones((T, T), dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~mask, _NEG_INF)
    lse = torch.logsumexp(s, dim=-1)
    o = torch.matmul(torch.softmax(s, dim=-1).to(v.dtype), v).to(q.dtype)
    return o, lse


def flash_attention(q, k, v, causal=True, sm_scale=None, force_plain=False):
    """softmax(q·kᵀ·scale [+ causal mask])·v over [B, H, T, d] or
    [BH, T, d]; sm_scale defaults to d ** -0.5."""
    shape = q.shape
    T, d = shape[-2:]
    q, k, v = (t.reshape(-1, T, d) for t in (q, k, v))
    scale = float(sm_scale) if sm_scale is not None else d ** -0.5
    if force_plain or q.device.type == 'cpu':
        o, _ = flash_attention_reference(q, k, v, causal, scale)
    else:
        o, _ = flash_attention_fwd(q.contiguous(), k.contiguous(),
                                   v.contiguous(), causal, scale)
    return o.reshape(shape)
