"""Attention and KV-cache ops (counterpart of
paddle_tpu/ops/attention_ops.py: flash_attention :57, kv_cache_write :84,
kv_cache_append :96, decode_mask :113, position_embedding_at :134,
gather_time :149).

The cache ops update the Scope's cache tensor IN PLACE and return that
same tensor: the JAX package rebuilt the array functionally and relied
on buffer donation (paddle_tpu/executor.py:907) to reuse the memory.
Every shape is fixed when the prefill/decode programs are built; slot
positions are feeds and validity is masking, never a dynamic shape.
"""
from __future__ import annotations

import torch

from ..flags import get_flag
from ..kernels import flash_attention as fa
from ..registry import register_op, op_emitter, register_vjp_grad, amp_cast


@op_emitter('flash_attention')
def _flash_attention_emit(ctx, op):
    """Blockwise online-softmax attention (bf16 under AMP): the
    hand-written CUDA kernels in both passes for CUDA tensors, their
    plain versions for CPU tensors or with
    FLAGS_use_flash_attention=False."""
    q, k, v = amp_cast(ctx, ctx.get(op.single_input('Q')),
                       ctx.get(op.single_input('K')),
                       ctx.get(op.single_input('V')))
    out = fa.flash_attention(q, k, v, causal=op.attr('causal', True),
                             sm_scale=op.attr('sm_scale', None),
                             force_plain=not get_flag('use_flash_attention'))
    ctx.set(op.single_output('Out'), out)


def _flash_infer(op, block):
    q = block.var_recursive(op.single_input('Q'))
    out = block.var_recursive(op.single_output('Out'))
    out.shape = q.shape
    out.dtype = q.dtype
    out.lod_level = q.lod_level


register_op('flash_attention', infer_shape=_flash_infer)
register_vjp_grad('flash_attention', in_slots=('Q', 'K', 'V'))


@op_emitter('kv_cache_write')
def _kv_cache_write_emit(ctx, op):
    """Prefill: write whole prompts' K or V rows into their slots, in
    place. Cache [slots, T, H, dk], X [pb, T, H, dk], Slots [pb]; the
    entire [T] row is overwritten, so a slot's previous occupant never
    leaks into a new request."""
    cache = ctx.get(op.single_input('Cache'))
    x = ctx.get(op.single_input('X'))
    slots = ctx.get(op.single_input('Slots')).long()
    cache[slots] = x.to(cache.dtype)
    ctx.set(op.single_output('Out'), cache)


@op_emitter('kv_cache_append')
def _kv_cache_append_emit(ctx, op):
    """Decode: per-slot ring write of one K or V row, in place.
    Cache [slots, T, H, dk], X [slots, 1, H, dk], StepIdx [slots] (the
    absolute position of the incoming token; the row lands at
    StepIdx % T). Idle slots write too; decode_mask hides those rows and
    the next prefill of the slot overwrites them."""
    cache = ctx.get(op.single_input('Cache'))
    x = ctx.get(op.single_input('X'))
    step = ctx.get(op.single_input('StepIdx')).long()
    rows = torch.arange(cache.shape[0], device=cache.device)
    cache[rows, step % cache.shape[1]] = x[:, 0].to(cache.dtype)
    ctx.set(op.single_output('Out'), cache)


@op_emitter('decode_mask')
def _decode_mask_emit(ctx, op):
    """Ring-aware validity mask for decode scores X [slots, H, 1, T]:
    ring index j holds absolute position step - ((step - j) mod T) and is
    valid iff that is >= 0. Masked scores are set to -1e9, as in
    causal_mask, so they underflow to exact zeros in the softmax."""
    x = ctx.get(op.single_input('X'))
    step = ctx.get(op.single_input('StepIdx')).long()
    T = x.shape[-1]
    j = torch.arange(T, device=x.device)
    s = step[:, None]
    valid = (s - torch.remainder(s - j[None, :], T)) >= 0   # [slots, T]
    ctx.set(op.single_output('Out'),
            x.masked_fill(~valid[:, None, None, :], -1e9))


@op_emitter('position_embedding_at')
def _position_embedding_at_emit(ctx, op):
    """One positional row per slot: Pos [max_len, D], Index [slots] ->
    [slots, 1, D] (row Index % max_len); a 2-D Index [slots, R] gives
    [slots, R, D]."""
    pos = ctx.get(op.single_input('Pos'))
    idx = ctx.get(op.single_input('Index')).long()
    out = pos[torch.remainder(idx, pos.shape[0])]
    if idx.ndim == 1:
        out = out[:, None, :]
    ctx.set(op.single_output('Out'), out)


@op_emitter('gather_time')
def _gather_time_emit(ctx, op):
    """Per-row gather along time: X [B, T, ...], Index [B] -> [B, ...].
    Prefill picks each prompt's last real position before the lm_head."""
    x = ctx.get(op.single_input('X'))
    idx = ctx.get(op.single_input('Index')).long().clamp(0, x.shape[1] - 1)
    rows = torch.arange(x.shape[0], device=x.device)
    ctx.set(op.single_output('Out'), x[rows, idx])


def _kv_cache_update_infer(op, block):
    cache = block.var_recursive(op.single_input('Cache'))
    out = block.var_recursive(op.single_output('Out'))
    out.shape = cache.shape
    out.dtype = cache.dtype


def _decode_mask_infer(op, block):
    x = block.var_recursive(op.single_input('X'))
    out = block.var_recursive(op.single_output('Out'))
    out.shape = x.shape
    out.dtype = x.dtype


def _position_embedding_at_infer(op, block):
    pos = block.var_recursive(op.single_input('Pos'))
    idx = block.var_recursive(op.single_input('Index'))
    out = block.var_recursive(op.single_output('Out'))
    if len(idx.shape) == 2:
        out.shape = (idx.shape[0], idx.shape[1], pos.shape[-1])
    else:
        out.shape = (idx.shape[0], 1, pos.shape[-1])
    out.dtype = pos.dtype


def _gather_time_infer(op, block):
    x = block.var_recursive(op.single_input('X'))
    out = block.var_recursive(op.single_output('Out'))
    out.shape = (x.shape[0],) + tuple(x.shape[2:])
    out.dtype = x.dtype


register_op('kv_cache_write', infer_shape=_kv_cache_update_infer)
register_op('kv_cache_append', infer_shape=_kv_cache_update_infer)
register_op('decode_mask', infer_shape=_decode_mask_infer)
register_op('position_embedding_at',
            infer_shape=_position_embedding_at_infer)
register_op('gather_time', infer_shape=_gather_time_infer)
