"""Flash attention, forward and backward: the Hopper port of the TPU
kernels in paddle_tpu/pallas/flash_attention.py.

| kernel | TPU body (launch site) | here |
|---|---|---|
| K1  | `_fwd_kernel` :171 (`_fwd_online` :684) | `flash_attention_fwd`, csrc/flash_attention_fwd.cu |
| K4a | `_fwd_stats_kernel` :229 (`_fwd_twopass` :728) | `flash_attention_fwd_stats`, same file |
| K4b | `_fwd_acc_kernel` :276 (`_fwd_twopass` :758) | `flash_attention_fwd_acc`, same file |
| K2  | `_bwd_kvmajor_kernel` :512 (`_bwd_kvmajor` :952) | `flash_attention_bwd_kvmajor`, csrc/flash_attention_bwd.cu |
| K3a | `_dq_kernel` :339 (`_bwd_split` :871) | `flash_attention_bwd_dq`, same file |
| K3b | `_dkv_kernel` :385 (`_bwd_split` :898) | `flash_attention_bwd_dkv`, same file |
| K5  | `_bwd_onepass_kernel` :436 (`_bwd` :813) | `flash_attention_bwd_onepass`, same file |

The kernels are CUDA C++ for sm_90a, built with nvcc at first use
(kernels/build.py) and called through ctypes on PyTorch's current
stream. They take float32 or bfloat16 q, k, v (and dO), accumulate in
float32, and keep lse and delta in float32 [BH, T]. In bf16 every kernel
multiplies bf16 tiles on the tensor cores (K1 is
`flash_fwd_wgmma_kernel`: K4a's online max and K4b's P·V with P as bf16
hi + lo, fused into one sweep); in float32 every kernel runs exact
float32 FMAs on the CUDA cores (no TF32). fp32 K1, the serving
prefill's forward, is `flash_fwd_f32_kernel`: 32-row q tiles on a 1-D
grid folded so that each SM's two blocks sum to about the mean work,
8 warps a block split by product (score warps and P·V warps, one k tile
apart, handing P over through shared memory at named barriers),
cp.async rings, exp2, and every sum in one fixed order, so it gives the
same bits on every launch. In bf16 the kvmajor (K2) and onepass (K5) arms
launch one kernel, `flash_bwd_wgmma_kernel` (`_bwd_entry`): both compute
the same function from the same arguments, and that kernel is kv-major,
so dk and dv are summed in registers (deterministic) and only dq goes
through float32 atomics. The split arm (K3a + K3b) has no atomics in
either dtype: bf16 K3a (`flash_bwd_dq_wgmma_kernel`) is q-major and sums
dq in registers, bf16 K3b (`flash_bwd_dkv_wgmma_kernel`) is K2's
kv-major body without dq, so each gradient is summed in one order and
written once, and the arm gives the same bits on every run. Both are
bound by bytes at the flagship shape, and neither writes a float32
buffer. Each source's header says what bounds it on an H100 and what
its design does about that.

- Each wrapper checks device, dtype, shape and contiguity, launches its
  kernel, raises if the launch fails, and counts its launches in
  `<wrapper>.launches`. A CPU tensor makes it raise.
- `flash_attention_reference`, `flash_attention_stats_reference`,
  `flash_attention_acc_reference` and `flash_attention_bwd_reference`
  are the plain PyTorch versions of the same functions: they serve CPU
  tensors, and the card's checks hold the kernels against them (K2, K3
  and K5 compute one function, the plain backward).
- `FlashAttention` is the autograd Function. Its forward reads
  PADDLE_FLASH_FWD on every call: '' or 'online' is K1, 'twopass' is K4a
  then K4b, any other value raises ValueError. It saves (q, k, v, o,
  lse). Its backward computes delta = rowsum(dO·O) in fp32 with a torch
  op, as the JAX package's `_bwd` :785 does outside its kernels, and
  reads PADDLE_FLASH_BWD on every call: 'kvmajor' (the default) is K2,
  'split' is K3a + K3b (deterministic: no atomics), 'onepass' is K5, any
  other value raises. CPU tensors, or force_plain=True
  (FLAGS_use_flash_attention=False), take the plain versions in the same
  order (under twopass the stats version, then the acc version).
- The TPU package swaps a forced arm for another when its VMEM residency
  rules would be broken (`_fwd` :653-656 for twopass, `_bwd` :799-804
  for onepass and kvmajor). Those rules are about VMEM and are not
  ported: neither K4 nor the port's K5 keeps full-sequence state on
  chip (bf16 K5 sums dq in an fp32 buffer in device memory, fp32 K5 dK
  and dV), so a forced arm runs as forced at every T. The one case
  where this differs from the JAX package is fp32 at T = 8192, d = 128,
  where the JAX package runs split in place of onepass; the results
  agree either way.
- The twopass forward does a second q·kᵀ sweep that the 2-matmul
  attention work model does not count. Each K4a launch notes that work,
  2·BH·(visited scores of its q x k tiles)·d FLOP, and
  `take_extra_flops()` drains the notes (the JAX package's
  `_note_extra_flops` / `take_extra_flops`, :126-146). The tiles are
  the kernels': 128 x 128 for bf16 (the tensor-core K4a, K4b), 64 x 64
  for fp32. The plain versions note nothing.
- `kernel_takes(q)` is the one route between kernels and plain
  versions: the kernels take a CUDA q of a dtype in SUPPORTED_DTYPES
  with a head dim in SUPPORTED_HEAD_DIMS (and BH within the grid);
  every other shape, dtype and device goes to the plain versions, as
  the JAX package sends what its kernel does not tile to the naive
  contraction (`_supported`, :1009-1050). `FlashAttention.plain_cuda_calls`
  counts the forwards that ran the plain versions on a CUDA tensor,
  whatever the reason (the route or force_plain), so a run can require
  that none did where the kernels should launch.
- `flash_attention` is the public entry ([B, H, T, d] or [BH, T, d]).
"""
from __future__ import annotations

import ctypes
import os
import threading

import torch

from . import build, note

__all__ = ['flash_attention', 'flash_attention_fwd',
           'flash_attention_reference', 'flash_attention_fwd_stats',
           'flash_attention_stats_reference', 'flash_attention_fwd_acc',
           'flash_attention_acc_reference', 'flash_attention_bwd_kvmajor',
           'flash_attention_bwd_dq', 'flash_attention_bwd_dkv',
           'flash_attention_bwd_onepass', 'flash_attention_bwd_reference',
           'FlashAttention', 'bwd_arm', 'fwd_arm', 'take_extra_flops',
           'kernel_takes', 'SUPPORTED_HEAD_DIMS', 'SUPPORTED_DTYPES']

SUPPORTED_HEAD_DIMS = (64, 128)
SUPPORTED_DTYPES = (torch.float32, torch.bfloat16)
BWD_ARMS = ('kvmajor', 'split', 'onepass')
FWD_ARMS = ('online', 'twopass')
_NEG_INF = -1e30
# (q rows, keys) of the K4a / K4b tiles: the bf16 kernels run on the
# tensor cores in 128 x 128 tiles, the fp32 ones on the CUDA cores in
# 64 x 64
_TWOPASS_TILES = {torch.bfloat16: (128, 128), torch.float32: (64, 64)}
_MAX_GRID_Y = 65535
_SUFFIX = {torch.float32: 'f32', torch.bfloat16: 'bf16'}

_count_lock = threading.Lock()
_extra_flops = 0.0


def _kernel(lib_name, fn_name, n_ptrs):
    """The C entry point `fn_name` of csrc/<lib_name>.cu: n_ptrs pointers,
    then bh, t, d, causal (int), sm_scale (float) and the stream."""
    return build.function(lib_name, fn_name,
                          [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 4 +
                          [ctypes.c_float, ctypes.c_void_p])


def _count(wrapper):
    with _count_lock:
        wrapper.launches += 1
        note(('launches', wrapper.__name__))


def twopass_extra_flops(BH, T, d, causal, dtype=torch.bfloat16):
    """The second q·kᵀ sweep of one twopass forward, as the kernels
    execute it: 2·d FLOP for every score of every visited tile pair,
    padding included. Both the q tile (bq) and the k tile (bk) follow
    the kernel of `dtype` (_TWOPASS_TILES); the visited pairs are the JAX
    package's count (`_fwd` :666-671) with the port's bq and bk and a
    ragged last tile: causal, q tile i visits k tiles up to
    ((i + 1)·bq − 1) // bk."""
    bq, bk = _TWOPASS_TILES[dtype]
    nq, nk = -(-T // bq), -(-T // bk)
    if causal:
        visited = sum(min(nk - 1, ((i + 1) * bq - 1) // bk) + 1
                      for i in range(nq))
    else:
        visited = nq * nk
    return 2.0 * BH * visited * bq * bk * d


def take_extra_flops():
    """Drain the extra-work notes of the K4a launches since the last
    drain: FLOP that ran but that the 2-matmul attention model does not
    count."""
    global _extra_flops
    with _count_lock:
        flops, _extra_flops = _extra_flops, 0.0
    return flops


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


def _masked_scores(q, k, causal, sm_scale):
    """fp32 q·kᵀ·scale with -1e30 past the causal diagonal."""
    s = torch.matmul(q.float() * sm_scale, k.float().transpose(-1, -2))
    if causal:
        T = q.shape[-2]
        mask = torch.ones((T, T), dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~mask, _NEG_INF)
    return s


def flash_attention_reference(q, k, v, causal, sm_scale):
    """Plain PyTorch version of K1: an explicit fp32 q·kᵀ·scale, a -1e30
    causal mask, softmax, then ·v; o in q's dtype, lse fp32. Same
    arguments and results as flash_attention_fwd, on any device."""
    s = _masked_scores(q, k, causal, sm_scale)
    lse = torch.logsumexp(s, dim=-1)
    o = torch.matmul(torch.softmax(s, dim=-1), v.float()).to(q.dtype)
    return o, lse


# -- K4a, K4b: the two-pass forward --------------------------------------------

def flash_attention_fwd_stats(q, k, causal, sm_scale):
    """Launch K4a, pass 1 of the two-pass forward. q, k: [BH, T, d]
    float32 or bfloat16, contiguous, on one CUDA device. Returns lse
    [BH, T] float32 (-1e30 for an all-masked row). Notes the second q·kᵀ
    sweep for take_extra_flops. Does not synchronise."""
    who = 'flash_attention_fwd_stats'
    _check(who, q, (('q', q), ('k', k)))
    BH, T, d = q.shape
    lse = torch.empty((BH, T), dtype=torch.float32, device=q.device)
    fn = _kernel('flash_attention_fwd',
                 'flash_attention_fwd_stats_' + _SUFFIX[q.dtype], 3)
    _launch(who, fn, (q, k, lse), q, causal, sm_scale)
    global _extra_flops
    with _count_lock:
        extra = twopass_extra_flops(BH, T, d, causal, q.dtype)
        _extra_flops += extra
        note(('extra_flops',), extra)
    _count(flash_attention_fwd_stats)
    return lse


flash_attention_fwd_stats.launches = 0


def flash_attention_fwd_acc(q, k, v, lse, causal, sm_scale):
    """Launch K4b, pass 2: o = Σ exp(s − lse)·v over the visited keys,
    with the shift zeroed where lse <= -5e29. q, k, v: [BH, T, d] in one
    dtype; lse: [BH, T] float32 from K4a. Returns o in q's dtype."""
    who = 'flash_attention_fwd_acc'
    _check(who, q, (('q', q), ('k', k), ('v', v), ('lse', lse)))
    o = torch.empty_like(q)
    fn = _kernel('flash_attention_fwd',
                 'flash_attention_fwd_acc_' + _SUFFIX[q.dtype], 5)
    _launch(who, fn, (q, k, v, lse, o), q, causal, sm_scale)
    _count(flash_attention_fwd_acc)
    return o


flash_attention_fwd_acc.launches = 0


def flash_attention_stats_reference(q, k, causal, sm_scale):
    """Plain PyTorch version of K4a: the row log-sum-exp of the masked
    fp32 scores, [BH, T] float32, on any device."""
    return torch.logsumexp(_masked_scores(q, k, causal, sm_scale), dim=-1)


def flash_attention_acc_reference(q, k, v, lse, causal, sm_scale):
    """Plain PyTorch version of K4b: exp(s − lse)·v in fp32, the shift
    zeroed where lse <= -5e29 (an all-masked row), o in q's dtype."""
    s = _masked_scores(q, k, causal, sm_scale)
    lse = lse.float()
    shift = torch.where(lse <= _NEG_INF / 2, torch.zeros_like(lse), lse)
    p = torch.exp(s - shift[..., None])
    return torch.matmul(p, v.float()).to(q.dtype)


# -- K2, K3a, K3b, K5: backward ------------------------------------------------

def _bwd_check(who, q, k, v, do, lse, delta):
    _check(who, q, (('q', q), ('k', k), ('v', v), ('do', do),
                    ('lse', lse), ('delta', delta)))


def _bwd_entry(arm, dtype):
    """The C entry point of csrc/flash_attention_bwd.cu that the kvmajor
    or onepass arm launches for `dtype`: in bf16 both take the
    tensor-core kernel flash_bwd_wgmma_kernel, in float32 each its
    CUDA-core kernel (K2 kv-major, K5 q-major)."""
    if arm not in ('kvmajor', 'onepass'):
        raise ValueError('_bwd_entry: arm %r is not kvmajor or onepass'
                         % (arm,))
    if dtype == torch.bfloat16:
        return 'flash_attention_bwd_wgmma_bf16'
    return 'flash_attention_bwd_%s_%s' % (arm, _SUFFIX[dtype])


def _bwd_kv_major(who, arm, q, k, v, do, lse, delta, causal, sm_scale):
    """Launch the kv-major backward of `arm` for q's dtype: dk and dv
    written once, dq summed over key tiles with float32 atomics into a
    zeroed buffer, then scaled and cast here."""
    dq_acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    fn = _kernel('flash_attention_bwd', _bwd_entry(arm, q.dtype), 9)
    _launch(who, fn, (q, k, v, do, lse, delta, dq_acc, dk, dv), q, causal,
            sm_scale)
    return (dq_acc * sm_scale).to(q.dtype), dk, dv


def flash_attention_bwd_kvmajor(q, k, v, do, lse, delta, causal, sm_scale):
    """Launch K2, the kv-major one-pass backward. q, k, v, do: [BH, T, d]
    in one dtype (float32 or bfloat16); lse, delta: [BH, T] float32.
    Returns (dq, dk, dv) in q's dtype. bf16 runs the tensor-core kernel
    (the onepass arm's too). dq is summed over key tiles with float32
    atomics into a zeroed buffer, then scaled and cast here, so its last
    bits vary from run to run; dk and dv are deterministic."""
    who = 'flash_attention_bwd_kvmajor'
    _bwd_check(who, q, k, v, do, lse, delta)
    out = _bwd_kv_major(who, 'kvmajor', q, k, v, do, lse, delta, causal,
                        sm_scale)
    _count(flash_attention_bwd_kvmajor)
    return out


flash_attention_bwd_kvmajor.launches = 0


def flash_attention_bwd_dq(q, k, v, do, lse, delta, causal, sm_scale):
    """Launch K3a, the split backward's dq sweep: q-major, dq summed in
    registers and written once (no atomics, the same bits on every
    run); bf16 runs the tensor-core kernel. Same arguments as
    flash_attention_bwd_kvmajor; returns dq."""
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
    """Launch K3b, the split backward's dk/dv sweep: kv-major, dk and dv
    summed in registers and written once (no atomics, the same bits on
    every run); bf16 runs the tensor-core kernel. Same arguments as
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


def flash_attention_bwd_onepass(q, k, v, do, lse, delta, causal, sm_scale):
    """Launch K5, the one-pass backward of PADDLE_FLASH_BWD=onepass. Same
    arguments as flash_attention_bwd_kvmajor; returns (dq, dk, dv) in q's
    dtype. bf16 runs the tensor-core kernel that bf16 K2 runs (kv-major:
    dk and dv deterministic, dq summed with float32 atomics). float32
    runs the q-major CUDA-core kernel: dk and dv are summed over q tiles
    with float32 atomics into zeroed buffers, then cast here, so their
    last bits vary from run to run."""
    who = 'flash_attention_bwd_onepass'
    _bwd_check(who, q, k, v, do, lse, delta)
    if q.dtype == torch.bfloat16:
        out = _bwd_kv_major(who, 'onepass', q, k, v, do, lse, delta, causal,
                            sm_scale)
        _count(flash_attention_bwd_onepass)
        return out
    dq = torch.empty_like(q)
    dk_acc = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
    dv_acc = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
    fn = _kernel('flash_attention_bwd', _bwd_entry('onepass', q.dtype), 9)
    _launch(who, fn, (q, k, v, do, lse, delta, dq, dk_acc, dv_acc), q,
            causal, sm_scale)
    _count(flash_attention_bwd_onepass)
    return dq, dk_acc.to(k.dtype), dv_acc.to(v.dtype)


flash_attention_bwd_onepass.launches = 0


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
    kf, vf, dof = k.float(), v.float(), do.float()
    qs = q.float() * sm_scale
    s = _masked_scores(q, k, causal, sm_scale)
    p = torch.exp(s - lse.float()[..., None])
    dp = torch.matmul(dof, vf.transpose(-1, -2))
    ds = p * (dp - bwd_delta(o, do)[..., None])
    dv = torch.matmul(p.transpose(-1, -2), dof)
    dk = torch.matmul(ds.transpose(-1, -2), qs)
    dq = torch.matmul(ds, kf) * sm_scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def bwd_arm():
    """The backward arm for this call, from PADDLE_FLASH_BWD (read on
    every call, never cached): 'kvmajor' (K2, the default), 'split' (K3a
    + K3b) or 'onepass' (K5; in bf16 the same kernel as K2). An unknown
    value raises, so an A/B run never measures the default arm by
    mistake."""
    arm = os.environ.get('PADDLE_FLASH_BWD', '').strip().lower() or \
        'kvmajor'
    if arm not in BWD_ARMS:
        raise ValueError('PADDLE_FLASH_BWD=%r: expected one of %s'
                         % (arm, BWD_ARMS))
    return arm


def fwd_arm():
    """The forward arm for this call, from PADDLE_FLASH_FWD (read on
    every call, never cached): '' or 'online' is K1, 'twopass' is K4a +
    K4b; any other value raises ValueError with the JAX package's
    message, so a typo never measures K1 by mistake."""
    arm = os.environ.get('PADDLE_FLASH_FWD', '').strip().lower()
    if arm not in ('',) + FWD_ARMS:
        raise ValueError('PADDLE_FLASH_FWD=%r: expected one of %s'
                         % (arm, FWD_ARMS))
    return arm or 'online'


def kernel_takes(q):
    """True where the kernels take q [BH, T, d] (k and v are of its shape
    and dtype): a CUDA tensor, a dtype in SUPPORTED_DTYPES, a head dim
    in SUPPORTED_HEAD_DIMS and 1 <= BH <= the grid's limit."""
    return (q.device.type == 'cuda' and q.dim() == 3
            and q.dtype in SUPPORTED_DTYPES
            and q.shape[-1] in SUPPORTED_HEAD_DIMS
            and 1 <= q.shape[0] <= _MAX_GRID_Y and q.shape[1] >= 1)


class FlashAttention(torch.autograd.Function):
    """o = softmax(q·kᵀ·scale [+ causal mask])·v over [BH, T, d], with
    the flash kernels in both passes where kernel_takes(q), the plain
    versions elsewhere or under force_plain."""

    plain_cuda_calls = 0

    @staticmethod
    def forward(ctx, q, k, v, causal, sm_scale, force_plain):
        twopass = fwd_arm() == 'twopass'
        plain = force_plain or not kernel_takes(q)
        if plain and q.device.type == 'cuda':
            with _count_lock:
                FlashAttention.plain_cuda_calls += 1
                note(('plain_cuda_calls',))
        if twopass:
            stats, acc = ((flash_attention_stats_reference,
                           flash_attention_acc_reference) if plain else
                          (flash_attention_fwd_stats, flash_attention_fwd_acc))
            lse = stats(q, k, causal, sm_scale)
            o = acc(q, k, v, lse, causal, sm_scale)
        elif plain:
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
            elif arm == 'onepass':
                dq, dk, dv = flash_attention_bwd_onepass(
                    q, k, v, do, lse, delta, causal, scale)
            else:
                dq = flash_attention_bwd_dq(q, k, v, do, lse, delta, causal,
                                            scale)
                dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, delta,
                                                 causal, scale)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, causal=True, sm_scale=None, force_plain=False):
    """softmax(q·kᵀ·scale [+ causal mask])·v over [B, H, T, d] or
    [BH, T, d]; sm_scale defaults to d ** -0.5. Differentiable. Where
    kernel_takes(q), the kernels of the arms PADDLE_FLASH_FWD and
    PADDLE_FLASH_BWD select (K1 and K2 by default) run; CPU tensors and
    shapes or dtypes the kernels do not take run the plain versions."""
    shape = q.shape
    T, d = shape[-2:]
    q, k, v = (t.reshape(-1, T, d).contiguous() for t in (q, k, v))
    scale = float(sm_scale) if sm_scale is not None else d ** -0.5
    o = FlashAttention.apply(q, k, v, bool(causal), scale, bool(force_plain))
    return o.reshape(shape)
