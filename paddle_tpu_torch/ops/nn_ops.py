"""NN ops (counterpart of paddle_tpu/ops/nn_ops.py: layer_norm :518,
softmax :563, cross_entropy :577, square_error_cost :688, lookup_table
:794 (grad :822-866), causal_mask :965, position_embedding :982).

Grads: recorded forwards (registry.register_vjp_grad), except
lookup_table, whose grad op is a plain scatter-add (index_add_)."""
from __future__ import annotations

import torch

from ..framework import grad_var_name
from ..registry import (register_op, op_emitter, same_shape_infer,
                        register_vjp_grad, amp_cast)


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
register_vjp_grad('layer_norm', in_slots=('X', 'Scale', 'Bias'),
                  out_slots=('Y',))


@op_emitter('softmax')
def _softmax_emit(ctx, op):
    x = ctx.get(op.single_input('X'))
    # reduce in fp32, as the JAX package does for every dtype; under AMP
    # the probabilities stay fp32
    out = torch.softmax(x.float(), dim=-1)
    ctx.set(op.single_output('Out'), out if ctx.amp else out.to(x.dtype))


register_op('softmax', infer_shape=same_shape_infer())
register_vjp_grad('softmax')


@op_emitter('cross_entropy')
def _cross_entropy_emit(ctx, op):
    x = ctx.get(op.single_input('X'))          # probabilities
    label = ctx.get(op.single_input('Label'))
    eps = 1e-8
    if op.attr('soft_label', False):
        loss = -torch.sum(label * torch.log(torch.clamp(x, min=eps)),
                          dim=-1, keepdim=True)
    else:
        lbl = label.reshape(label.shape[:-1]) if label.shape[-1] == 1 \
            else label
        lbl = lbl.long()
        picked = torch.gather(x, -1, lbl[..., None])
        loss = -torch.log(torch.clamp(picked, min=eps))
        loss = loss.masked_fill(lbl[..., None] == op.attr('ignore_index',
                                                          -100), 0.0)
    ctx.set(op.single_output('Y'), loss)


def _cross_entropy_infer(op, block):
    x = block.var_recursive(op.single_input('X'))
    y = block.var_recursive(op.single_output('Y'))
    y.shape = tuple(x.shape[:-1]) + (1,)
    y.dtype = x.dtype


register_op('cross_entropy', infer_shape=_cross_entropy_infer)
register_vjp_grad('cross_entropy', in_slots=('X',), out_slots=('Y',),
                  nondiff_slots=('Label',))


@op_emitter('square_error_cost')
def _square_error_emit(ctx, op):
    x = ctx.get(op.single_input('X'))
    y = ctx.get(op.single_input('Y'))
    ctx.set(op.single_output('Out'), torch.square(x - y))


register_op('square_error_cost', infer_shape=same_shape_infer())
register_vjp_grad('square_error_cost', in_slots=('X', 'Y'))


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
    # under AMP the embedding starts the bf16 activation stream
    ctx.set(op.single_output('Out'), amp_cast(ctx, out))


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


def _lookup_table_grad_maker(op, block):
    inputs = {'Ids': list(op.input('Ids')), 'W': list(op.input('W')),
              'Out@GRAD': [grad_var_name(op.single_output('Out'))]}
    outputs = {'W@GRAD': [grad_var_name(op.single_input('W'))]}
    return [dict(type='lookup_table_grad', inputs=inputs, outputs=outputs,
                 attrs=dict(op.attrs))]


@op_emitter('lookup_table_grad')
def _lookup_table_grad_emit(ctx, op):
    """Dense scatter-add of the upstream rows into a zero table. The JAX
    package's is_sparse=True SelectedRows grad is not ported: its dense
    form (the merged rows) is computed instead."""
    w = ctx.get(op.single_input('W'))
    ids = ctx.get(op.single_input('Ids'))
    gout = ctx.get(op.single_input('Out@GRAD'))
    squeeze_last = ids.ndim > 1 and ids.shape[-1] == 1
    flat = (ids.reshape(ids.shape[:-1]) if squeeze_last else ids)
    flat = flat.reshape(-1).long()
    rows_g = gout.reshape((flat.numel(),) + tuple(w.shape[1:])).to(w.dtype)
    pad = op.attr('padding_idx', -1)
    if pad != -1:
        rows_g = rows_g.masked_fill((flat == pad).unsqueeze(-1), 0.0)
    gw = torch.zeros_like(w).index_add_(0, flat, rows_g)
    ctx.set(op.single_output('W@GRAD'), gw)


register_op('lookup_table', infer_shape=_lookup_table_infer,
            grad=_lookup_table_grad_maker)


@op_emitter('causal_mask')
def _causal_mask_emit(ctx, op):
    """Set future positions of [..., Tq, Tk] scores to -1e9 (not -inf):
    masked lanes underflow to exact zeros after the softmax's exp."""
    s = ctx.get(op.single_input('X'))
    Tq, Tk = s.shape[-2], s.shape[-1]
    mask = torch.ones((Tq, Tk), dtype=torch.bool, device=s.device).tril()
    ctx.set(op.single_output('Out'), s.masked_fill(~mask, -1e9))


register_op('causal_mask', infer_shape=same_shape_infer())
register_vjp_grad('causal_mask')


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
register_vjp_grad('position_embedding', in_slots=('Pos',),
                  nondiff_slots=('X',))
