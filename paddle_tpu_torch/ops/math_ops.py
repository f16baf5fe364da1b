"""Math / elementwise / activation / reduction ops (counterpart of
paddle_tpu/ops/math_ops.py: elementwise family :56-128, mul :135,
matmul :198, unary activations :244-305, scale :308, clip :335,
clip_by_norm :352, sum :380, mean :414, top_k :536, argmax :580).

Grads come from recorded forwards (registry.register_vjp_grad): each
emitter is plain differentiable PyTorch, and autograd reduces a
broadcast Y (the elementwise `axis` contract) back to Y's shape.
Under AMP (ctx.amp) mul/matmul run in bf16 and an elementwise op
between a bf16 activation and an fp32 parameter casts the parameter
down, as the JAX package does; an fp32 non-parameter still promotes."""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..registry import (register_op, op_emitter, same_shape_infer,
                        register_vjp_grad, amp_cast)


def _broadcast_y(x, y, axis):
    """Paddle's elementwise `axis` contract: Y's shape matches a
    contiguous window of X's shape starting at `axis`; axis == -1 aligns
    trailing dims."""
    if x.ndim == y.ndim:
        return y
    if axis != -1:
        new_shape = [1] * axis + list(y.shape) + \
            [1] * (x.ndim - axis - y.ndim)
        if len(new_shape) == x.ndim:
            return y.reshape(new_shape)
    return y.reshape([1] * (x.ndim - y.ndim) + list(y.shape))


def _register_elementwise(name, fn):
    op_type = 'elementwise_' + name

    def emit(ctx, op):
        x = ctx.get(op.single_input('X'))
        y = ctx.get(op.single_input('Y'))
        if ctx.amp:
            # a bf16 activation meeting an fp32 PARAMETER (bias add)
            # casts the parameter down instead of promoting the stream
            if x.dtype == torch.bfloat16 and y.dtype == torch.float32 \
                    and ctx.is_persistable(op.single_input('Y')):
                y = y.to(torch.bfloat16)
            elif y.dtype == torch.bfloat16 and x.dtype == torch.float32 \
                    and ctx.is_persistable(op.single_input('X')):
                x = x.to(torch.bfloat16)
        res = fn(x, _broadcast_y(x, y, op.attr('axis', -1)))
        # X-major contract: Out.shape == X.shape; fold pure-1 padding
        # that broadcasting added back to x's shape
        if res.shape != x.shape and res.numel() == x.numel():
            res = res.reshape(x.shape)
        ctx.set(op.single_output('Out'), res)

    register_op(op_type, emit=emit, infer_shape=_elementwise_infer)
    register_vjp_grad(op_type, in_slots=('X', 'Y'))


def _elementwise_infer(op, block):
    x = block.var_recursive(op.single_input('X'))
    out = block.var_recursive(op.single_output('Out'))
    out.shape = x.shape
    out.dtype = x.dtype if out.dtype is None else out.dtype
    out.lod_level = x.lod_level


# add: the model; mul, div, max: gradient clipping and L1 decay
_register_elementwise('add', torch.add)
_register_elementwise('mul', torch.mul)
_register_elementwise('div', torch.div)
_register_elementwise('max', torch.maximum)


# -- mul: the fc matmul with dim flattening (x_num_col_dims) -----------------

@op_emitter('mul')
def _mul_emit(ctx, op):
    x = ctx.get(op.single_input('X'))
    y = ctx.get(op.single_input('Y'))
    xnc = op.attr('x_num_col_dims', 1)
    ync = op.attr('y_num_col_dims', 1)
    y2 = y.reshape(int(np.prod(y.shape[:ync])), -1)
    k = int(np.prod(x.shape[xnc:]))
    if k != y2.shape[0]:
        raise ValueError('mul: cannot align x shape %s (x_num_col_dims %d) '
                         'with contraction size %d'
                         % (tuple(x.shape), xnc, y2.shape[0]))
    x2, y2 = amp_cast(ctx, x.reshape(-1, k), y2)
    out = torch.matmul(x2, y2)
    ctx.set(op.single_output('Out'),
            out.reshape(tuple(x.shape[:xnc]) + tuple(y.shape[ync:])))


def _mul_infer(op, block):
    x = block.var_recursive(op.single_input('X'))
    y = block.var_recursive(op.single_input('Y'))
    xnc = op.attr('x_num_col_dims', 1)
    ync = op.attr('y_num_col_dims', 1)
    out = block.var_recursive(op.single_output('Out'))
    out.shape = tuple(x.shape[:xnc]) + tuple(y.shape[ync:])
    out.dtype = x.dtype
    out.lod_level = x.lod_level


register_op('mul', infer_shape=_mul_infer)
register_vjp_grad('mul', in_slots=('X', 'Y'))


@op_emitter('matmul')
def _matmul_emit(ctx, op):
    x = ctx.get(op.single_input('X'))
    y = ctx.get(op.single_input('Y'))
    if op.attr('transpose_X', False) and x.ndim > 1:
        x = x.transpose(-1, -2)
    if op.attr('transpose_Y', False) and y.ndim > 1:
        y = y.transpose(-1, -2)
    x, y = amp_cast(ctx, x, y)
    out = torch.matmul(x, y)
    alpha = op.attr('alpha', 1.0)
    if alpha != 1.0:
        out = out * alpha
    ctx.set(op.single_output('Out'), out)


def _matmul_infer(op, block):
    x = block.var_recursive(op.single_input('X'))
    y = block.var_recursive(op.single_input('Y'))
    xs = list(x.shape)
    ys = list(y.shape)
    if op.attr('transpose_X', False) and len(xs) > 1:
        xs[-1], xs[-2] = xs[-2], xs[-1]
    if op.attr('transpose_Y', False) and len(ys) > 1:
        ys[-1], ys[-2] = ys[-2], ys[-1]
    if len(xs) == 1:
        xs = [1] + xs
    if len(ys) == 1:
        ys = ys + [1]
    batch = xs[:-2] if len(xs) > 2 else ys[:-2]
    out = block.var_recursive(op.single_output('Out'))
    out.shape = tuple(batch) + (xs[-2], ys[-1])
    out.dtype = x.dtype


register_op('matmul', infer_shape=_matmul_infer)
register_vjp_grad('matmul', in_slots=('X', 'Y'))


def _register_unary(op_type, fn):
    def emit(ctx, op):
        ctx.set(op.single_output('Out'), fn(ctx.get(op.single_input('X'))))

    register_op(op_type, emit=emit, infer_shape=same_shape_infer())
    register_vjp_grad(op_type)


# relu: the ResNet activations; sqrt: the global-norm clip; abs: L1 decay
_register_unary('relu', torch.relu)
_register_unary('sqrt', torch.sqrt)
_register_unary('abs', torch.abs)
# jax.nn.gelu defaults to the tanh approximation; the exact erf form
# differs by ~1e-3
_register_unary('gelu', lambda x: F.gelu(x, approximate='tanh'))


@op_emitter('scale')
def _scale_emit(ctx, op):
    x = ctx.get(op.single_input('X'))
    scale = op.attr('scale', 1.0)
    bias = op.attr('bias', 0.0)
    if op.attr('bias_after_scale', True):
        out = x * scale + bias
    else:
        out = (x + bias) * scale
    ctx.set(op.single_output('Out'), out)


register_op('scale', infer_shape=same_shape_infer())
register_vjp_grad('scale')


@op_emitter('clip')
def _clip_emit(ctx, op):
    ctx.set(op.single_output('Out'),
            torch.clamp(ctx.get(op.single_input('X')), op.attr('min'),
                        op.attr('max')))


register_op('clip', infer_shape=same_shape_infer())
register_vjp_grad('clip')


@op_emitter('clip_by_norm')
def _clip_by_norm_emit(ctx, op):
    x = ctx.get(op.single_input('X'))
    max_norm = op.attr('max_norm')
    norm = torch.sqrt(torch.sum(torch.square(x)))
    scale = torch.where(norm > max_norm,
                        max_norm / torch.clamp(norm, min=1e-12),
                        torch.ones_like(norm))
    ctx.set(op.single_output('Out'), x * scale)


register_op('clip_by_norm', infer_shape=same_shape_infer())
register_vjp_grad('clip_by_norm')


# -- sum (n-ary add, the backward fan-out op) / mean --------------------------

@op_emitter('sum')
def _sum_emit(ctx, op):
    xs = [ctx.get(n) for n in op.input('X')]
    out = xs[0]
    for x in xs[1:]:
        out = out + x
    ctx.set(op.single_output('Out'), out)


def _sum_infer(op, block):
    x = block.var_recursive(op.input('X')[0])
    out = block.var_recursive(op.single_output('Out'))
    out.shape = x.shape
    out.dtype = x.dtype
    out.lod_level = x.lod_level


register_op('sum', infer_shape=_sum_infer)
register_vjp_grad('sum', in_slots=('X',))


def _scalar_infer(op, block):
    x = block.var_recursive(op.single_input('X'))
    out = block.var_recursive(op.single_output('Out'))
    out.shape = ()
    out.dtype = x.dtype


@op_emitter('mean')
def _mean_emit(ctx, op):
    ctx.set(op.single_output('Out'), torch.mean(ctx.get(op.single_input('X'))))


register_op('mean', infer_shape=_scalar_infer)
register_vjp_grad('mean')


@op_emitter('squared_l2_norm')
def _squared_l2_norm_emit(ctx, op):
    x = ctx.get(op.single_input('X'))
    ctx.set(op.single_output('Out'), torch.sum(torch.square(x)))


register_op('squared_l2_norm', infer_shape=_scalar_infer)
register_vjp_grad('squared_l2_norm')


@op_emitter('top_k')
def _top_k_emit(ctx, op):
    values, indices = torch.topk(ctx.get(op.single_input('X')),
                                 op.attr('k', 1), dim=-1)
    ctx.set(op.single_output('Out'), values)
    ctx.set(op.single_output('Indices'), indices.to(torch.int64))


def _top_k_infer(op, block):
    x = block.var_recursive(op.single_input('X'))
    shape = tuple(x.shape[:-1]) + (op.attr('k', 1),)
    out = block.var_recursive(op.single_output('Out'))
    out.shape = shape
    out.dtype = x.dtype
    idx = block.var_recursive(op.single_output('Indices'))
    idx.shape = shape
    idx.dtype = 'int64'


register_op('top_k', infer_shape=_top_k_infer, no_grad=True)


@op_emitter('argmax')
def _argmax_emit(ctx, op):
    x = ctx.get(op.single_input('X'))
    ctx.set(op.single_output('Out'),
            torch.argmax(x, dim=op.attr('axis', -1)).to(torch.int64))


def _argmax_infer(op, block):
    x = block.var_recursive(op.single_input('X'))
    if x.shape is None:
        return
    axis = op.attr('axis', -1) % len(x.shape)
    out = block.var_recursive(op.single_output('Out'))
    out.shape = tuple(s for i, s in enumerate(x.shape) if i != axis)
    out.dtype = 'int64'


register_op('argmax', infer_shape=_argmax_infer)
