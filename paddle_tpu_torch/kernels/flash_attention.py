"""Flash attention, forward and backward: the Hopper port of the TPU
kernels in paddle_tpu/pallas/flash_attention.py.

| kernel | TPU body (launch site) | here |
|---|---|---|
| K1  | `_fwd_kernel` :171 (`_fwd_online` :684) | `flash_attention_fwd`, csrc/flash_attention_fwd.cu |
| K2  | `_bwd_kvmajor_kernel` :512 (`_bwd_kvmajor` :952) | `flash_attention_bwd_kvmajor`, csrc/flash_attention_bwd.cu |
| K3a | `_dq_kernel` :339 (`_bwd_split` :871) | `flash_attention_bwd_dq`, same file |
| K3b | `_dkv_kernel` :385 (`_bwd_split` :898) | `flash_attention_bwd_dkv`, same file |

The kernels are CUDA C++ for sm_90a, built with nvcc at first use
(kernels/build.py) and called through ctypes on PyTorch's current
stream. They take float32 or bfloat16 q, k, v (and dO), compute in
float32, and keep lse and delta in float32 [BH, T]. Each source's header
says what bounds it on an H100 and what its design does about that.

- Each wrapper checks device, dtype, shape and contiguity, launches its
  kernel, raises if the launch fails, and counts its launches in
  `<wrapper>.launches`. A CPU tensor makes it raise.
- `flash_attention_reference` and `flash_attention_bwd_reference` are
  the plain PyTorch versions of the same functions: they serve CPU
  tensors, and the card's checks hold the kernels against them.
- `FlashAttention` is the autograd Function: its forward calls K1 and
  saves (q, k, v, o, lse); its backward computes delta = rowsum(dO·O) in
  fp32 with a torch op, as the JAX package's `_bwd` :785 does outside
  its kernels, then launches K2 (the default arm, 'kvmajor') or K3a +
  K3b (PADDLE_FLASH_BWD=split, the deterministic arm: no atomics). The
  arm is read from the environment on every call; 'onepass' (K5) is not
  ported and raises. The forward reads PADDLE_FLASH_FWD the same way on
  every call: '' or 'online' is K1, 'twopass' (K4) is not ported and
  raises, any other value raises ValueError. CPU tensors, or
  force_plain=True (FLAGS_use_flash_attention=False), take the plain
  versions.
- `flash_attention` is the public entry ([B, H, T, d] or [BH, T, d]).
"""
from __future__ import annotations

import ctypes
import os
import threading

import torch

from . import build

__all__ = ['flash_attention', 'flash_attention_fwd',
           'flash_attention_reference', 'flash_attention_bwd_kvmajor',
           'flash_attention_bwd_dq', 'flash_attention_bwd_dkv',
           'flash_attention_bwd_reference', 'FlashAttention', 'bwd_arm',
           'fwd_arm',
           'SUPPORTED_HEAD_DIMS', 'SUPPORTED_DTYPES']

SUPPORTED_HEAD_DIMS = (64, 128)
SUPPORTED_DTYPES = (torch.float32, torch.bfloat16)
BWD_ARMS = ('kvmajor', 'split', 'onepass')
FWD_ARMS = ('online', 'twopass')
_NEG_INF = -1e30
_MAX_GRID_Y = 65535
_SUFFIX = {torch.float32: 'f32', torch.bfloat16: 'bf16'}

_count_lock = threading.Lock()


def _kernel(lib_name, fn_name, n_ptrs):
    """The C entry point `fn_name` of csrc/<lib_name>.cu: n_ptrs pointers,
    then bh, t, d, causal (int), sm_scale (float) and the stream."""
    return build.function(lib_name, fn_name,
                          [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 4 +
                          [ctypes.c_float, ctypes.c_void_p])


def _count(wrapper):
    with _count_lock:
        wrapper.launches += 1


def _check(who, ref, named):
    """Every tensor in `named` must be a contiguous, 16-byte aligned CUDA
    tensor on ref's device, [BH, T, d] like ref (or [BH, T] float32 for
    lse/delta), of ref's dtype."""
    dtype = ref.dtype
    if dtype not in SUPPORTED_DTYPES:
        raise TypeError('%s: dtype %s, the kernel takes float32 or '
                        'bfloat16' % (who, dtype))
    BH, T, d = ref.shape if ref.dim() == 3 else (0, 0, 0)
    for name, t in named:
        if t.device.type != 'cuda':
            raise ValueError('%s: %s is on %s, the kernel needs a CUDA '
                             'tensor' % (who, name, t.device))
        if t.device != ref.device:
            raise ValueError('%s: %s on another device than q' % (who, name))
        rowwise = name in ('lse', 'delta')
        want_shape = (BH, T) if rowwise else (BH, T, d)
        want_dtype = torch.float32 if rowwise else dtype
        if ref.dim() != 3 or tuple(t.shape) != want_shape:
            raise ValueError('%s: %s has shape %s, want %s (q is %s)'
                             % (who, name, tuple(t.shape), want_shape,
                                tuple(ref.shape)))
        if t.dtype != want_dtype:
            raise TypeError('%s: %s is %s, want %s'
                            % (who, name, t.dtype, want_dtype))
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError('%s: %s must be contiguous and 16-byte '
                             'aligned' % (who, name))
    if d not in SUPPORTED_HEAD_DIMS:
        raise ValueError('%s: head dim %d is not one of %s'
                         % (who, d, SUPPORTED_HEAD_DIMS))
    if not 1 <= BH <= _MAX_GRID_Y or T < 1:
        raise ValueError('%s: BH=%d, T=%d out of range' % (who, BH, T))


def _launch(who, fn, ptrs, q, causal, sm_scale):
    BH, T, d = q.shape
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(*[t.data_ptr() for t in ptrs], BH, T, d,
                 int(bool(causal)), float(sm_scale), stream)
    if err != 0:
        raise RuntimeError('%s: kernel launch failed with CUDA error %d'
                           % (who, err))


# -- K1: forward ---------------------------------------------------------------

def flash_attention_fwd(q, k, v, causal, sm_scale):
    """Launch K1. q, k, v: [BH, T, d] float32 or bfloat16, contiguous, on
    one CUDA device, d in SUPPORTED_HEAD_DIMS. Returns (o [BH, T, d] in
    q's dtype, lse [BH, T] float32). Does not synchronise."""
    _check('flash_attention_fwd', q, (('q', q), ('k', k), ('v', v)))
    BH, T, d = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((BH, T), dtype=torch.float32, device=q.device)
    fn = _kernel('flash_attention_fwd',
                 'flash_attention_fwd_' + _SUFFIX[q.dtype], 5)
    _launch('flash_attention_fwd', fn, (q, k, v, o, lse), q, causal,
            sm_scale)
    _count(flash_attention_fwd)
    return o, lse


flash_attention_fwd.launches = 0


def flash_attention_reference(q, k, v, causal, sm_scale):
    """Plain PyTorch version of K1: an explicit fp32 q·kᵀ·scale, a -1e30
    causal mask, softmax, then ·v; o in q's dtype, lse fp32. Same
    arguments and results as flash_attention_fwd, on any device."""
    qf, kf, vf = q.float(), k.float(), v.float()
    s = torch.matmul(qf * sm_scale, kf.transpose(-1, -2))
    if causal:
        T = q.shape[-2]
        mask = torch.ones((T, T), dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~mask, _NEG_INF)
    lse = torch.logsumexp(s, dim=-1)
    o = torch.matmul(torch.softmax(s, dim=-1), vf).to(q.dtype)
    return o, lse


# -- K2, K3a, K3b: backward ----------------------------------------------------

def _bwd_check(who, q, k, v, do, lse, delta):
    _check(who, q, (('q', q), ('k', k), ('v', v), ('do', do),
                    ('lse', lse), ('delta', delta)))


def flash_attention_bwd_kvmajor(q, k, v, do, lse, delta, causal, sm_scale):
    """Launch K2, the kv-major one-pass backward. q, k, v, do: [BH, T, d]
    in one dtype (float32 or bfloat16); lse, delta: [BH, T] float32.
    Returns (dq, dk, dv) in q's dtype. dq is summed over k-tiles with
    float32 atomics into a zeroed buffer, then scaled and cast here, so
    its last bits vary from run to run."""
    who = 'flash_attention_bwd_kvmajor'
    _bwd_check(who, q, k, v, do, lse, delta)
    dq_acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    fn = _kernel('flash_attention_bwd',
                 'flash_attention_bwd_kvmajor_' + _SUFFIX[q.dtype], 9)
    _launch(who, fn, (q, k, v, do, lse, delta, dq_acc, dk, dv), q, causal,
            sm_scale)
    _count(flash_attention_bwd_kvmajor)
    return (dq_acc * sm_scale).to(q.dtype), dk, dv


flash_attention_bwd_kvmajor.launches = 0


def flash_attention_bwd_dq(q, k, v, do, lse, delta, causal, sm_scale):
    """Launch K3a, the split backward's dq sweep (no atomics). Same
    arguments as flash_attention_bwd_kvmajor; returns dq."""
    who = 'flash_attention_bwd_dq'
    _bwd_check(who, q, k, v, do, lse, delta)
    dq = torch.empty_like(q)
    fn = _kernel('flash_attention_bwd',
                 'flash_attention_bwd_dq_' + _SUFFIX[q.dtype], 7)
    _launch(who, fn, (q, k, v, do, lse, delta, dq), q, causal, sm_scale)
    _count(flash_attention_bwd_dq)
    return dq


flash_attention_bwd_dq.launches = 0


def flash_attention_bwd_dkv(q, k, v, do, lse, delta, causal, sm_scale):
    """Launch K3b, the split backward's dk/dv sweep. Same arguments as
    flash_attention_bwd_kvmajor; returns (dk, dv)."""
    who = 'flash_attention_bwd_dkv'
    _bwd_check(who, q, k, v, do, lse, delta)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    fn = _kernel('flash_attention_bwd',
                 'flash_attention_bwd_dkv_' + _SUFFIX[q.dtype], 8)
    _launch(who, fn, (q, k, v, do, lse, delta, dk, dv), q, causal, sm_scale)
    _count(flash_attention_bwd_dkv)
    return dk, dv


flash_attention_bwd_dkv.launches = 0


def bwd_delta(o, do):
    """delta = rowsum(dO·O) in fp32, [BH, T]: what every backward arm
    reads beside lse (the JAX package's `_bwd` :785)."""
    return torch.sum(do.float() * o.float(), dim=-1)


def flash_attention_bwd_reference(q, k, v, o, lse, do, causal, sm_scale):
    """Plain PyTorch version of the backward, explicit fp32 math:
    S = q·kᵀ·scale (masked), P = exp(S - lse), dP = dO·vᵀ,
    delta = rowsum(dO·O), dS = P∘(dP - delta); dv = Pᵀ·dO,
    dk = dSᵀ·(q·scale), dq = dS·k·scale. Returns (dq, dk, dv) in the
    input dtypes, on any device."""
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    qs = qf * sm_scale
    s = torch.matmul(qs, kf.transpose(-1, -2))
    if causal:
        T = q.shape[-2]
        mask = torch.ones((T, T), dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~mask, _NEG_INF)
    p = torch.exp(s - lse.float()[..., None])
    dp = torch.matmul(dof, vf.transpose(-1, -2))
    ds = p * (dp - bwd_delta(o, do)[..., None])
    dv = torch.matmul(p.transpose(-1, -2), dof)
    dk = torch.matmul(ds.transpose(-1, -2), qs)
    dq = torch.matmul(ds, kf) * sm_scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def bwd_arm():
    """The backward arm for this call, from PADDLE_FLASH_BWD (read on
    every call, never cached): 'kvmajor' (K2, the default) or 'split'
    (K3a + K3b). 'onepass' (K5) is not ported and raises; an unknown
    value raises too, so an A/B run never measures the default arm by
    mistake."""
    arm = os.environ.get('PADDLE_FLASH_BWD', '').strip().lower() or \
        'kvmajor'
    if arm not in BWD_ARMS:
        raise ValueError('PADDLE_FLASH_BWD=%r: expected one of %s'
                         % (arm, BWD_ARMS))
    if arm == 'onepass':
        raise NotImplementedError(
            'PADDLE_FLASH_BWD=onepass selects K5 (_bwd_onepass_kernel, '
            'paddle_tpu/pallas/flash_attention.py:436), which is not '
            'ported yet (ROADMAP.md, Queue 2); use kvmajor or split')
    return arm


def fwd_arm():
    """The forward arm for this call, from PADDLE_FLASH_FWD (read on
    every call, never cached): '' or 'online' is K1. 'twopass' (K4) is
    not ported and raises; any other value raises ValueError with the
    JAX package's message, so a typo never measures K1 by mistake."""
    arm = os.environ.get('PADDLE_FLASH_FWD', '').strip().lower()
    if arm not in ('',) + FWD_ARMS:
        raise ValueError('PADDLE_FLASH_FWD=%r: expected one of %s'
                         % (arm, FWD_ARMS))
    if arm == 'twopass':
        raise NotImplementedError(
            'PADDLE_FLASH_FWD=twopass selects K4 (_fwd_stats_kernel + '
            '_fwd_acc_kernel, paddle_tpu/pallas/flash_attention.py:229, '
            ':276), which is not ported yet (ROADMAP.md, Queue 2); use '
            'online')
    return 'online'


class FlashAttention(torch.autograd.Function):
    """o = softmax(q·kᵀ·scale [+ causal mask])·v over [BH, T, d], with
    the flash kernels in both passes for CUDA tensors."""

    @staticmethod
    def forward(ctx, q, k, v, causal, sm_scale, force_plain):
        fwd_arm()
        plain = force_plain or q.device.type == 'cpu'
        if plain:
            o, lse = flash_attention_reference(q, k, v, causal, sm_scale)
        else:
            o, lse = flash_attention_fwd(q, k, v, causal, sm_scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.sm_scale, ctx.plain = causal, sm_scale, plain
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        causal, scale = ctx.causal, ctx.sm_scale
        arm = bwd_arm()
        do = do.to(q.dtype).contiguous()
        if ctx.plain:
            dq, dk, dv = flash_attention_bwd_reference(q, k, v, o, lse, do,
                                                       causal, scale)
        else:
            delta = bwd_delta(o, do)
            if arm == 'kvmajor':
                dq, dk, dv = flash_attention_bwd_kvmajor(
                    q, k, v, do, lse, delta, causal, scale)
            else:
                dq = flash_attention_bwd_dq(q, k, v, do, lse, delta, causal,
                                            scale)
                dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, delta,
                                                 causal, scale)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, causal=True, sm_scale=None, force_plain=False):
    """softmax(q·kᵀ·scale [+ causal mask])·v over [B, H, T, d] or
    [BH, T, d]; sm_scale defaults to d ** -0.5. Differentiable: the
    backward runs K2 (or K3 under PADDLE_FLASH_BWD=split) for CUDA
    tensors and the plain backward for CPU tensors."""
    shape = q.shape
    T, d = shape[-2:]
    q, k, v = (t.reshape(-1, T, d).contiguous() for t in (q, k, v))
    scale = float(sm_scale) if sm_scale is not None else d ** -0.5
    o = FlashAttention.apply(q, k, v, bool(causal), scale, bool(force_plain))
    return o.reshape(shape)
