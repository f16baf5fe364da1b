"""NN ops (counterpart of paddle_tpu/ops/nn_ops.py: layer_norm :518,
softmax :563, lookup_table :794, causal_mask :965, position_embedding
:982)."""
from __future__ import annotations

import torch

from ..registry import register_op, op_emitter, same_shape_infer


@op_emitter('layer_norm')
def _layer_norm_emit(ctx, op):
    x = ctx.get(op.single_input('X'))
    eps = op.attr('epsilon', 1e-5)
    begin = op.attr('begin_norm_axis', 1)
    axes = tuple(range(begin, x.ndim))
    xf = x.float()
    var, mean = torch.var_mean(xf, dim=axes, keepdim=True, correction=0)
    y = (xf - mean) * torch.rsqrt(var + eps)
    norm_shape = [1] * begin + list(x.shape[begin:])
    if op.input('Scale'):
        y = y * ctx.get(op.single_input('Scale')).reshape(norm_shape)
    if op.input('Bias'):
        y = y + ctx.get(op.single_input('Bias')).reshape(norm_shape)
    ctx.set(op.single_output('Y'), y.to(x.dtype))
    if op.output('Mean'):
        ctx.set(op.single_output('Mean'), mean.reshape(x.shape[:begin]))
    if op.output('Variance'):
        ctx.set(op.single_output('Variance'), var.reshape(x.shape[:begin]))


def _layer_norm_infer(op, block):
    x = block.var_recursive(op.single_input('X'))
    begin = op.attr('begin_norm_axis', 1)
    y = block.var_recursive(op.single_output('Y'))
    y.shape = x.shape
    y.dtype = x.dtype
    for slot in ('Mean', 'Variance'):
        if op.output(slot):
            v = block.var_recursive(op.single_output(slot))
            v.shape = tuple(x.shape[:begin])
            v.dtype = 'float32'


register_op('layer_norm', infer_shape=_layer_norm_infer)


@op_emitter('softmax')
def _softmax_emit(ctx, op):
    x = ctx.get(op.single_input('X'))
    # reduce in fp32, as the JAX package does for every dtype
    ctx.set(op.single_output('Out'),
            torch.softmax(x.float(), dim=-1).to(x.dtype))


register_op('softmax', infer_shape=same_shape_infer())


@op_emitter('lookup_table')
def _lookup_table_emit(ctx, op):
    w = ctx.get(op.single_input('W'))
    ids = ctx.get(op.single_input('Ids'))
    squeeze_last = ids.ndim > 1 and ids.shape[-1] == 1
    flat = ids.reshape(ids.shape[:-1]) if squeeze_last else ids
    out = w[flat.long()]
    pad = op.attr('padding_idx', -1)
    if pad != -1:
        out = out.masked_fill((flat == pad).unsqueeze(-1), 0.0)
    ctx.set(op.single_output('Out'), out)


def _lookup_table_infer(op, block):
    w = block.var_recursive(op.single_input('W'))
    ids = block.var_recursive(op.single_input('Ids'))
    out = block.var_recursive(op.single_output('Out'))
    ids_shape = tuple(ids.shape)
    if ids_shape and ids_shape[-1] == 1:
        ids_shape = ids_shape[:-1]
    out.shape = ids_shape + (w.shape[-1],)
    out.dtype = w.dtype
    out.lod_level = ids.lod_level


register_op('lookup_table', infer_shape=_lookup_table_infer)


@op_emitter('causal_mask')
def _causal_mask_emit(ctx, op):
    """Set future positions of [..., Tq, Tk] scores to -1e9 (not -inf):
    masked lanes underflow to exact zeros after the softmax's exp."""
    s = ctx.get(op.single_input('X'))
    Tq, Tk = s.shape[-2], s.shape[-1]
    mask = torch.ones((Tq, Tk), dtype=torch.bool, device=s.device).tril()
    ctx.set(op.single_output('Out'), s.masked_fill(~mask, -1e9))


register_op('causal_mask', infer_shape=same_shape_infer())


@op_emitter('position_embedding')
def _position_embedding_emit(ctx, op):
    x = ctx.get(op.single_input('X'))          # [B, T, D]
    pos = ctx.get(op.single_input('Pos'))      # [max_len, D]
    T = x.shape[1]
    ctx.set(op.single_output('Out'),
            pos[None, :T, :].expand(x.shape).to(x.dtype))


def _position_embedding_infer(op, block):
    x = block.var_recursive(op.single_input('X'))
    out = block.var_recursive(op.single_output('Out'))
    out.shape = x.shape
    out.dtype = x.dtype


register_op('position_embedding', infer_shape=_position_embedding_infer)
