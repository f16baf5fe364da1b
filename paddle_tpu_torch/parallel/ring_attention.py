"""Ring attention: context parallelism for long sequences (counterpart of
paddle_tpu/parallel/ring_attention.py:36-407).

The sequence axis is sharded over the mesh's 'sp' axis: rank i of the
ring holds queries, keys and values of positions [i·Tl, (i+1)·Tl). The
K/V blocks travel the ring (each step a rank sends its block to the
previous rank and receives the next one's: the JAX package's ppermute
j -> j - 1, collectives.ring_shift), and every arriving block is folded
into the rank's result:

- forward: a block's partial (o, lse) comes from K1
  (kernels.flash_attention_fwd) with causal=True on the rank's own
  (diagonal) block and causal=False on a block from an earlier rank; a
  block from a later rank contributes nothing under causal and is not
  computed at all (the JAX package's lax.cond `masked` branch). The
  partials are merged by log-sum-exp in fp32 (`merge_partials`, the
  JAX package's `_merge_partials` :208-223, all-masked rows at -1e30),
  and the result is cast to q's dtype at the end;
- backward: the ring runs again with the global lse and
  delta = rowsum(dO·O) of the rank's merged O (computed once): each
  computed block goes through the backward arm PADDLE_FLASH_BWD picks
  (K2 by default), its dq summed at home, and its (dk, dv) travelling
  the ring with the block until one last rotation brings them home
  (:337-379). Gradients accumulate in fp32.

On a CPU tensor the blocks go through the kernels' plain versions
(flash_attention_reference, flash_attention_bwd_reference); on a CUDA
tensor through the kernels, which raise for a shape they do not take:
the ring has no path that gives way to the plain version on the card.
flash=False (FLAGS_use_flash_attention off) is the plain ring fold: the
same ring with the plain block functions on any device.

The port keeps lse as [BH, T]; the JAX package's is [BH, T, 1].
"""
from __future__ import annotations

import torch

from ..kernels import flash_attention as fa
from . import collectives as C

__all__ = ['ring_attention_local', 'merge_partials', 'RingCounters']

_NEG_INF = -1e30


class RingCounters(object):
    """Blocks computed on this rank (forward, backward), since the last
    reset: the mesh phases read them beside the kernels' counters."""
    fwd_blocks = 0
    bwd_blocks = 0


def merge_partials(o1, lse1, o2, lse2):
    """Combine two attention partials over disjoint key sets (fp32)."""
    m = torch.maximum(lse1, lse2)
    safe_m = torch.where(m <= _NEG_INF / 2, torch.zeros_like(m), m)
    w1 = torch.exp(torch.where(lse1 <= _NEG_INF / 2,
                               torch.full_like(lse1, _NEG_INF), lse1)
                   - safe_m)
    w2 = torch.exp(torch.where(lse2 <= _NEG_INF / 2,
                               torch.full_like(lse2, _NEG_INF), lse2)
                   - safe_m)
    denom = torch.clamp(w1 + w2, min=1e-30)
    o = (o1.float() * w1[..., None] + o2.float() * w2[..., None]) \
        / denom[..., None]
    lse = safe_m + torch.log(denom)
    lse = torch.where((lse1 <= _NEG_INF / 2) & (lse2 <= _NEG_INF / 2),
                      torch.full_like(lse, _NEG_INF), lse)
    return o, lse


def _plain(q, flash):
    """The plain block functions: on the CPU, or for the plain fold."""
    if not flash or q.device.type != 'cuda':
        return True
    if not fa.kernel_takes(q):
        raise ValueError(
            'ring_attention: the flash kernels do not take blocks of shape '
            '%s %s on the card' % (tuple(q.shape), q.dtype))
    return False


def _block_fwd(q, k, v, causal, scale, plain):
    RingCounters.fwd_blocks += 1
    if plain:
        return fa.flash_attention_reference(q, k, v, causal, scale)
    return fa.flash_attention_fwd(q, k, v, causal, scale)


def _block_bwd(q, k, v, o, lse, delta, do, causal, scale, plain):
    RingCounters.bwd_blocks += 1
    if plain:
        return fa.flash_attention_bwd_reference(q, k, v, o, lse, do,
                                                causal, scale)
    arm = fa.bwd_arm()
    if arm == 'kvmajor':
        return fa.flash_attention_bwd_kvmajor(q, k, v, do, lse, delta,
                                              causal, scale)
    if arm == 'onepass':
        return fa.flash_attention_bwd_onepass(q, k, v, do, lse, delta,
                                              causal, scale)
    dq = fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, causal, scale)
    dk, dv = fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, causal,
                                        scale)
    return dq, dk, dv


def ring_forward(q, k, v, ax, causal, scale, plain):
    """(o fp32, lse fp32 [BH, Tl]) of the flattened [BH, Tl, d] blocks."""
    n, my = ax.size, ax.index
    o, lse = _block_fwd(q, k, v, causal, scale, plain)
    o = o.float()
    kb, vb = k, v
    for i in range(1, n):
        kb, vb = C.ring_shift([kb, vb], ax)
        src = (my + i) % n
        if causal and src > my:
            continue
        o_b, lse_b = _block_fwd(q, kb, vb, False, scale, plain)
        o, lse = merge_partials(o, lse, o_b, lse_b)
    return o, lse


def ring_backward(q, k, v, o, lse, do, ax, causal, scale, plain):
    n, my = ax.size, ax.index
    do = do.to(q.dtype).contiguous()
    delta = fa.bwd_delta(o, do)
    dq, dk, dv = _block_bwd(q, k, v, o, lse, delta, do, causal, scale,
                            plain)
    dq, dkb, dvb = dq.float(), dk.float(), dv.float()
    kb, vb = k, v
    for i in range(1, n):
        kb, vb, dkb, dvb = C.ring_shift([kb, vb, dkb, dvb], ax)
        src = (my + i) % n
        if causal and src > my:
            continue
        dq_b, dk_b, dv_b = _block_bwd(q, kb, vb, o, lse, delta, do, False,
                                      scale, plain)
        dq = dq + dq_b.float()
        dkb = dkb + dk_b.float()
        dvb = dvb + dv_b.float()
    if n > 1:
        dkb, dvb = C.ring_shift([dkb, dvb], ax)
    return dq.to(q.dtype), dkb.to(k.dtype), dvb.to(v.dtype)


class _Ring(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, ax, causal, scale, plain):
        o, lse = ring_forward(q, k, v, ax, causal, scale, plain)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.ax, ctx.causal, ctx.scale, ctx.plain = ax, causal, scale, plain
        return o.to(q.dtype)

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = ring_backward(q, k, v, o, lse, do, ctx.ax, ctx.causal,
                                   ctx.scale, ctx.plain)
        return dq, dk, dv, None, None, None, None


def ring_attention_local(q, k, v, ax, causal=True, sm_scale=None,
                         flash=True):
    """Ring attention over this rank's blocks q, k, v [B, H, Tl, dh] (or
    [BH, Tl, dh]) along the mesh axis `ax` (collectives.Axis);
    differentiable. Returns o of q's shape and dtype: exactly softmax
    attention over the whole ring's sequence for this rank's queries."""
    shape = q.shape
    Tl, d = shape[-2:]
    q, k, v = (t.reshape(-1, Tl, d).contiguous() for t in (q, k, v))
    scale = float(sm_scale) if sm_scale is not None else d ** -0.5
    plain = _plain(q, flash)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or
                                    v.requires_grad):
        o = _Ring.apply(q, k, v, ax, bool(causal), scale, plain)
    else:
        o, _ = ring_forward(q, k, v, ax, bool(causal), scale, plain)
        o = o.to(q.dtype)
    return o.reshape(shape)
