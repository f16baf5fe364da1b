"""Math / elementwise / activation ops (counterpart of
paddle_tpu/ops/math_ops.py: elementwise_add :57, mul :135, matmul :198,
gelu :295, scale :308, argmax :580)."""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..registry import register_op, op_emitter, same_shape_infer


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


@op_emitter('elementwise_add')
def _elementwise_add_emit(ctx, op):
    x = ctx.get(op.single_input('X'))
    y = ctx.get(op.single_input('Y'))
    ctx.set(op.single_output('Out'),
            x + _broadcast_y(x, y, op.attr('axis', -1)))


def _elementwise_infer(op, block):
    x = block.var_recursive(op.single_input('X'))
    out = block.var_recursive(op.single_output('Out'))
    out.shape = x.shape
    out.dtype = x.dtype if out.dtype is None else out.dtype
    out.lod_level = x.lod_level


register_op('elementwise_add', infer_shape=_elementwise_infer)


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
    out = torch.matmul(x.reshape(-1, k), y2)
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


@op_emitter('matmul')
def _matmul_emit(ctx, op):
    x = ctx.get(op.single_input('X'))
    y = ctx.get(op.single_input('Y'))
    if op.attr('transpose_X', False) and x.ndim > 1:
        x = x.transpose(-1, -2)
    if op.attr('transpose_Y', False) and y.ndim > 1:
        y = y.transpose(-1, -2)
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


@op_emitter('gelu')
def _gelu_emit(ctx, op):
    # jax.nn.gelu defaults to the tanh approximation; the exact erf form
    # differs by ~1e-3
    ctx.set(op.single_output('Out'),
            F.gelu(ctx.get(op.single_input('X')), approximate='tanh'))


register_op('gelu', infer_shape=same_shape_infer())


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
