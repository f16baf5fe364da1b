"""Math / elementwise / activation / reduction ops (counterpart of
paddle_tpu/ops/math_ops.py: elementwise family :56-128, mul :135,
matmul :198, unary activations :244-306, scale :308, clip :335,
clip_by_norm :352, sum :380, mean :414, reduce family :429-472,
comparisons and logical ops :479-511, isfinite :514, top_k :536,
argsort :560, argmax :580, cumsum :602, increment :617, where :646).

Grads come from recorded forwards (registry.register_vjp_grad): each
emitter is plain differentiable PyTorch, and autograd reduces a
broadcast Y (the elementwise `axis` contract) back to Y's shape.
Under AMP (ctx.amp) mul/matmul run in bf16 and an elementwise op
between a bf16 activation and an fp32 parameter casts the parameter
down, as the JAX package does; an fp32 non-parameter still promotes.

Attr defaults are the JAX emitters', not those of the PyTorch function
of the same name: hard_sigmoid's slope 0.2 and offset 0.5, leaky_relu's
alpha 0.02, stanh's scale_a 2/3 and scale_b 1.7159, gelu's tanh form.
elementwise_mod is floor-mod (jnp.mod, torch.remainder),
elementwise_floordiv floors, and round rounds half to even."""
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


_register_elementwise('add', torch.add)
_register_elementwise('sub', torch.sub)
_register_elementwise('mul', torch.mul)
_register_elementwise('div', torch.div)
_register_elementwise('max', torch.maximum)
_register_elementwise('min', torch.minimum)
_register_elementwise('pow', torch.pow)
_register_elementwise('mod', torch.remainder)
_register_elementwise('floordiv',
                      lambda x, y: torch.div(x, y, rounding_mode='floor'))


# -- mul: the fc matmul with dim flattening (x_num_col_dims) -----------------

def dot_operands(ctx, op):
    """(a, b, alpha, shape) of a mul or matmul op: Out = (a @ b ·
    alpha).reshape(shape) (shape None: as it is), with a and b formed as
    the op forms them (mul's dim flattening, matmul's transposes, the
    AMP cast). The remat scope's 'dots' policy serves a saved product
    through the same operands (ops/control_flow_ops.py)."""
    x = ctx.get(op.single_input('X'))
    y = ctx.get(op.single_input('Y'))
    if op.type == 'mul':
        xnc = op.attr('x_num_col_dims', 1)
        ync = op.attr('y_num_col_dims', 1)
        y2 = y.reshape(int(np.prod(y.shape[:ync])), -1)
        k = int(np.prod(x.shape[xnc:]))
        if k != y2.shape[0]:
            raise ValueError('mul: cannot align x shape %s (x_num_col_dims '
                             '%d) with contraction size %d'
                             % (tuple(x.shape), xnc, y2.shape[0]))
        a, b = amp_cast(ctx, x.reshape(-1, k), y2)
        return a, b, 1.0, tuple(x.shape[:xnc]) + tuple(y.shape[ync:])
    if op.attr('transpose_X', False) and x.ndim > 1:
        x = x.transpose(-1, -2)
    if op.attr('transpose_Y', False) and y.ndim > 1:
        y = y.transpose(-1, -2)
    a, b = amp_cast(ctx, x, y)
    return a, b, op.attr('alpha', 1.0), None


def _dot_emit(ctx, op):
    a, b, alpha, shape = dot_operands(ctx, op)
    out = torch.matmul(a, b)
    if alpha != 1.0:
        out = out * alpha
    if shape is not None:
        out = out.reshape(shape)
    ctx.set(op.single_output('Out'), out)


def _mul_infer(op, block):
    x = block.var_recursive(op.single_input('X'))
    y = block.var_recursive(op.single_input('Y'))
    xnc = op.attr('x_num_col_dims', 1)
    ync = op.attr('y_num_col_dims', 1)
    out = block.var_recursive(op.single_output('Out'))
    out.shape = tuple(x.shape[:xnc]) + tuple(y.shape[ync:])
    out.dtype = x.dtype
    out.lod_level = x.lod_level


register_op('mul', emit=_dot_emit, infer_shape=_mul_infer)
register_vjp_grad('mul', in_slots=('X', 'Y'))


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


register_op('matmul', emit=_dot_emit, infer_shape=_matmul_infer)
register_vjp_grad('matmul', in_slots=('X', 'Y'))


def _register_unary(op_type, fn):
    """fn(x, op) -> Out; attrs are read from op with the JAX emitter's
    defaults."""
    def emit(ctx, op):
        ctx.set(op.single_output('Out'),
                fn(ctx.get(op.single_input('X')), op))

    register_op(op_type, emit=emit, infer_shape=same_shape_infer())
    register_vjp_grad(op_type)


def _where0(cond, x):
    return torch.where(cond, x, torch.zeros_like(x))


def _softshrink(x, op):
    lam = op.attr('lambda', 0.5)
    return torch.where(x > lam, x - lam, _where0(x < -lam, x + lam))


_UNARY = {
    'relu': lambda x, op: torch.relu(x),
    'sigmoid': lambda x, op: torch.sigmoid(x),
    'logsigmoid': lambda x, op: F.logsigmoid(x),
    'tanh': lambda x, op: torch.tanh(x),
    'tanh_shrink': lambda x, op: x - torch.tanh(x),
    'exp': lambda x, op: torch.exp(x),
    'log': lambda x, op: torch.log(x),
    'square': lambda x, op: torch.square(x),
    'sqrt': lambda x, op: torch.sqrt(x),
    'rsqrt': lambda x, op: 1.0 / torch.sqrt(x),
    'abs': lambda x, op: torch.abs(x),
    'ceil': lambda x, op: torch.ceil(x),
    'floor': lambda x, op: torch.floor(x),
    'round': lambda x, op: torch.round(x),           # half to even
    'reciprocal': lambda x, op: 1.0 / x,
    'sin': lambda x, op: torch.sin(x),
    'cos': lambda x, op: torch.cos(x),
    'softplus': lambda x, op: torch.logaddexp(x, torch.zeros_like(x)),
    'softsign': lambda x, op: x / (1 + torch.abs(x)),
    'relu6': lambda x, op: torch.clamp(x, 0, 6),
    'softshrink': _softshrink,
    'leaky_relu': lambda x, op: torch.where(
        x >= 0, x, x * op.attr('alpha', 0.02)),
    'elu': lambda x, op: torch.where(
        x >= 0, x, op.attr('alpha', 1.0) * (torch.exp(x) - 1)),
    'pow': lambda x, op: torch.pow(x, op.attr('factor', 1.0)),
    'hard_sigmoid': lambda x, op: torch.clamp(
        x * op.attr('slope', 0.2) + op.attr('offset', 0.5), 0.0, 1.0),
    'brelu': lambda x, op: torch.clamp(x, op.attr('t_min', 0.0),
                                       op.attr('t_max', 24.0)),
    'swish': lambda x, op: x * torch.sigmoid(op.attr('beta', 1.0) * x),
    # jax.nn.gelu defaults to the tanh approximation; the exact erf form
    # differs by ~1e-3
    'gelu': lambda x, op: F.gelu(x, approximate='tanh'),
    'stanh': lambda x, op: op.attr('scale_b', 1.7159) * torch.tanh(
        op.attr('scale_a', 2.0 / 3.0) * x),
    'thresholded_relu': lambda x, op: _where0(
        x > op.attr('threshold', 1.0), x),
    'hard_shrink': lambda x, op: _where0(
        torch.abs(x) > op.attr('threshold', 0.5), x),
    'logit': lambda x, op: torch.log(x / (1.0 - x)),
}
for _type, _fn in _UNARY.items():
    _register_unary(_type, _fn)


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


def _reduce_dims(op, ndim):
    if op.attr('reduce_all', False):
        return tuple(range(ndim))
    return tuple(sorted(set(d % ndim for d in op.attr('dim', [0]))))


def _prod(x, dim, keepdim):
    for d in sorted(dim, reverse=True):
        x = torch.prod(x, dim=d, keepdim=keepdim)
    return x


def _register_reduce(name, fn):
    op_type = 'reduce_' + name

    def emit(ctx, op):
        x = ctx.get(op.single_input('X'))
        ctx.set(op.single_output('Out'),
                fn(x, dim=_reduce_dims(op, x.ndim),
                   keepdim=op.attr('keep_dim', False)))

    def infer(op, block):
        x = block.var_recursive(op.single_input('X'))
        if x.shape is None:
            return
        dims = set(_reduce_dims(op, len(x.shape)))
        keep = op.attr('keep_dim', False)
        out = block.var_recursive(op.single_output('Out'))
        out.shape = tuple(1 if i in dims else s
                          for i, s in enumerate(x.shape)
                          if keep or i not in dims)
        out.dtype = x.dtype

    register_op(op_type, infer_shape=infer, emit=emit)
    register_vjp_grad(op_type)


_register_reduce('sum', torch.sum)
_register_reduce('mean', torch.mean)
_register_reduce('max', torch.amax)
_register_reduce('min', torch.amin)
_register_reduce('prod', _prod)


# -- comparisons / logical ops (no grad) --------------------------------------

def _register_compare(op_type, fn):
    def emit(ctx, op):
        ctx.set(op.single_output('Out'),
                fn(ctx.get(op.single_input('X')),
                   ctx.get(op.single_input('Y'))))

    def infer(op, block):
        x = block.var_recursive(op.single_input('X'))
        out = block.var_recursive(op.single_output('Out'))
        out.shape = x.shape
        out.dtype = 'bool'

    register_op(op_type, emit=emit, infer_shape=infer, no_grad=True)


for _type, _fn in (('less_than', torch.lt), ('less_equal', torch.le),
                   ('greater_than', torch.gt), ('greater_equal', torch.ge),
                   ('equal', torch.eq), ('not_equal', torch.ne),
                   ('logical_and', torch.logical_and),
                   ('logical_or', torch.logical_or),
                   ('logical_xor', torch.logical_xor)):
    _register_compare(_type, _fn)


@op_emitter('logical_not')
def _logical_not_emit(ctx, op):
    ctx.set(op.single_output('Out'),
            torch.logical_not(ctx.get(op.single_input('X'))))


register_op('logical_not', infer_shape=same_shape_infer(), no_grad=True)


@op_emitter('isfinite')
def _isfinite_emit(ctx, op):
    """One bool: every element of every input is finite."""
    finite = torch.ones((), dtype=torch.bool, device=ctx.device)
    for n in op.input('X'):
        finite = finite & torch.all(torch.isfinite(ctx.get(n)))
    ctx.set(op.single_output('Out'), finite)


def _isfinite_infer(op, block):
    out = block.var_recursive(op.single_output('Out'))
    out.shape = ()
    out.dtype = 'bool'


register_op('isfinite', infer_shape=_isfinite_infer, no_grad=True)


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


@op_emitter('argsort')
def _argsort_emit(ctx, op):
    """Ascending and stable, as jnp.argsort."""
    values, indices = torch.sort(ctx.get(op.single_input('X')),
                                 dim=op.attr('axis', -1), stable=True)
    ctx.set(op.single_output('Out'), values)
    ctx.set(op.single_output('Indices'), indices.to(torch.int64))


def _argsort_infer(op, block):
    x = block.var_recursive(op.single_input('X'))
    for slot, dtype in (('Out', x.dtype), ('Indices', 'int64')):
        v = block.var_recursive(op.single_output(slot))
        v.shape = x.shape
        v.dtype = dtype


register_op('argsort', infer_shape=_argsort_infer, no_grad=True)


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


@op_emitter('cumsum')
def _cumsum_emit(ctx, op):
    x = ctx.get(op.single_input('X'))
    axis = op.attr('axis', -1)
    reverse = op.attr('reverse', False)
    out = torch.cumsum(torch.flip(x, (axis,)) if reverse else x, dim=axis)
    if reverse:
        out = torch.flip(out, (axis,))
    if op.attr('exclusive', False):
        out = out - x
    ctx.set(op.single_output('Out'), out)


register_op('cumsum', infer_shape=same_shape_infer())
register_vjp_grad('cumsum')


@op_emitter('increment')
def _increment_emit(ctx, op):
    """X + step in X's dtype. On the step counter (Out = X, persistable)
    the new value goes back to the Scope every run."""
    x = ctx.get(op.single_input('X'))
    step = op.attr('step', 1.0)
    ctx.set(op.single_output('Out'),
            x + (step if x.is_floating_point() else int(step)))


register_op('increment', infer_shape=same_shape_infer(), no_grad=True)


# -- where: elementwise / row-wise select -------------------------------------

@op_emitter('where')
def _where_emit(ctx, op):
    cond = ctx.get(op.single_input('Cond'))
    x = ctx.get(op.single_input('X'))
    y = ctx.get(op.single_input('Y'))
    # align cond's rank to x's: drop size-1 trailing axes ([B, 1] cond
    # against [B] operands), then pad with size-1 trailing axes for a
    # row-wise select
    while cond.ndim > x.ndim and cond.shape[-1] == 1:
        cond = cond.reshape(cond.shape[:-1])
    if cond.ndim > x.ndim:
        raise ValueError('where: cond rank %d not broadcastable to operand '
                         'rank %d' % (cond.ndim, x.ndim))
    cond = cond.reshape(tuple(cond.shape) + (1,) * (x.ndim - cond.ndim))
    ctx.set(op.single_output('Out'), torch.where(cond.bool(), x, y))


def _where_infer(op, block):
    x = block.var_recursive(op.single_input('X'))
    out = block.var_recursive(op.single_output('Out'))
    out.shape = x.shape
    out.dtype = x.dtype


register_op('where', infer_shape=_where_infer)
register_vjp_grad('where', in_slots=('X', 'Y'), nondiff_slots=('Cond',))
