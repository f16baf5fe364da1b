"""Tensor creation / shape ops (counterpart of paddle_tpu/ops/tensor_ops.py:
fill_constant :23, fill_zeros_like :38, assign :47, assign_value :61,
cast :77, shape :96, concat :112, split :139 (grad :169), reshape2 and
reshape :180-235 (grad :213, reshape_grad_helper :222), transpose2 and
transpose :238-273 (grad :258), slice :276, expand :316, stack :337,
squeeze/unsqueeze(2) :359-405, gather :408, scatter :427, one_hot :443,
uniform_random :483, gaussian_random :503, truncated_gaussian_random
:516, range :531, reverse :548, pad :561, label_smooth :585).

Integer results keep the dtype the Program declares (int64 for shape,
range and the indices): the JAX package runs with x64 off and returns
int32 there."""
from __future__ import annotations

import math

import numpy as np
import torch

import torch.nn.functional as F

from ..executor import torch_dtype
from ..framework import convert_np_dtype, grad_var_name
from ..registry import (register_op, op_emitter, register_vjp_grad,
                        same_shape_infer)


@op_emitter('fill_constant')
def _fill_constant_emit(ctx, op):
    ctx.set(op.single_output('Out'),
            torch.full(tuple(op.attr('shape', [])), op.attr('value', 0.0),
                       dtype=torch_dtype(op.attr('dtype', 'float32')),
                       device=ctx.device))


def _fill_constant_infer(op, block):
    out = block.var_recursive(op.single_output('Out'))
    out.shape = tuple(op.attr('shape', []))
    out.dtype = op.attr('dtype', 'float32')


register_op('fill_constant', infer_shape=_fill_constant_infer, no_grad=True)


@op_emitter('fill_zeros_like')
def _fill_zeros_like_emit(ctx, op):
    ctx.set(op.single_output('Out'),
            torch.zeros_like(ctx.get(op.single_input('X'))))


register_op('fill_zeros_like', infer_shape=same_shape_infer(), no_grad=True)


@op_emitter('assign')
def _assign_emit(ctx, op):
    ctx.set(op.single_output('Out'), ctx.get(op.single_input('X')))


register_op('assign', infer_shape=same_shape_infer())
register_vjp_grad('assign')


def device_constant(ctx, op, key, make):
    """A new device tensor equal to make()'s host data. make() runs
    once per op, device and key, and its tensor is kept on the op: a
    CUDA graph under capture cannot copy from host memory, so every
    later run copies the kept tensor on the device."""
    kept = op.__dict__.setdefault('_device_constants', {})
    t = kept.get((ctx.device, key))
    if t is None:
        t = kept[(ctx.device, key)] = torch.as_tensor(
            make(), device=ctx.device)
    return t.clone()


@op_emitter('assign_value')
def _assign_value_emit(ctx, op):
    dtype = op.attr('dtype', 'float32')

    def make():
        values = np.asarray(op.attr('values'), dtype=dtype)
        return torch.as_tensor(values.reshape(op.attr('shape')),
                               dtype=torch_dtype(convert_np_dtype(dtype)))
    ctx.set(op.single_output('Out'), device_constant(ctx, op, None, make))


def _assign_value_infer(op, block):
    out = block.var_recursive(op.single_output('Out'))
    out.shape = tuple(op.attr('shape'))
    out.dtype = op.attr('dtype', 'float32')


register_op('assign_value', infer_shape=_assign_value_infer, no_grad=True)


def _cast_dtype(op):
    return convert_np_dtype(op.attr('out_dtype') or op.attr('dtype'))


@op_emitter('cast')
def _cast_emit(ctx, op):
    ctx.set(op.single_output('Out'),
            ctx.get(op.single_input('X')).to(torch_dtype(_cast_dtype(op))))


def _cast_infer(op, block):
    x = block.var_recursive(op.single_input('X'))
    out = block.var_recursive(op.single_output('Out'))
    out.shape = x.shape
    out.dtype = _cast_dtype(op)
    out.lod_level = x.lod_level


register_op('cast', infer_shape=_cast_infer)
register_vjp_grad('cast')


@op_emitter('shape')
def _shape_emit(ctx, op):
    shape = tuple(ctx.get(op.single_input('Input')).shape)
    ctx.set(op.single_output('Out'), device_constant(
        ctx, op, shape, lambda: torch.tensor(shape, dtype=torch.int64)))


def _shape_infer(op, block):
    x = block.var_recursive(op.single_input('Input'))
    out = block.var_recursive(op.single_output('Out'))
    out.shape = (len(x.shape),) if x.shape is not None else None
    out.dtype = 'int64'


register_op('shape', infer_shape=_shape_infer, no_grad=True)


@op_emitter('concat')
def _concat_emit(ctx, op):
    ctx.set(op.single_output('Out'),
            torch.cat([ctx.get(n) for n in op.input('X')],
                      dim=op.attr('axis', 0)))


def _concat_infer(op, block):
    xs = [block.var_recursive(n) for n in op.input('X')]
    shape = list(xs[0].shape)
    axis = op.attr('axis', 0) % len(shape)
    sizes = [x.shape[axis] for x in xs]
    shape[axis] = -1 if any(s < 0 for s in sizes) else sum(sizes)
    out = block.var_recursive(op.single_output('Out'))
    out.shape = tuple(shape)
    out.dtype = xs[0].dtype


register_op('concat', infer_shape=_concat_infer)
register_vjp_grad('concat', in_slots=('X',))


@op_emitter('split')
def _split_emit(ctx, op):
    x = ctx.get(op.single_input('X'))
    axis = op.attr('axis', 0)
    sections = op.attr('sections', [])
    if not sections:
        sections = x.shape[axis] // op.attr('num', 0)
    for name, part in zip(op.output('Out'),
                          torch.split(x, sections, dim=axis)):
        ctx.set(name, part)


def _split_infer(op, block):
    x = block.var_recursive(op.single_input('X'))
    axis = op.attr('axis', 0) % len(x.shape)
    sections = op.attr('sections', [])
    num = op.attr('num', 0)
    if not sections:
        sections = [x.shape[axis] // num if x.shape[axis] >= 0 else -1] * num
    for name, size in zip(op.output('Out'), sections):
        v = block.var_recursive(name)
        shape = list(x.shape)
        shape[axis] = size
        v.shape = tuple(shape)
        v.dtype = x.dtype


def _split_grad(op, block):
    """The grad of a split is the concat of its outputs' grads."""
    return [dict(type='concat',
                 inputs={'X': [grad_var_name(n) for n in op.output('Out')]},
                 outputs={'Out': [grad_var_name(op.single_input('X'))]},
                 attrs={'axis': op.attr('axis', 0)})]


register_op('split', infer_shape=_split_infer, grad=_split_grad)


@op_emitter('reshape2')
def _reshape_emit(ctx, op):
    x = ctx.get(op.single_input('X'))
    # paddle semantics: 0 copies the input dim, -1 is inferred
    shape = [x.shape[i] if s == 0 else s
             for i, s in enumerate(op.attr('shape'))]
    ctx.set(op.single_output('Out'), x.reshape(shape))
    if op.output('XShape'):
        ctx.set(op.single_output('XShape'),
                x.new_empty((0,) + tuple(x.shape)))


def _reshape_infer(op, block):
    x = block.var_recursive(op.single_input('X'))
    shape = list(op.attr('shape'))
    for i, s in enumerate(shape):
        if s == 0:
            shape[i] = x.shape[i]
    known = [s for s in shape if s >= 0]
    if -1 in shape and x.shape is not None and all(d >= 0 for d in x.shape):
        numel = int(np.prod(x.shape))
        rest = int(np.prod(known)) if known else 1
        shape[shape.index(-1)] = numel // rest if rest else -1
    out = block.var_recursive(op.single_output('Out'))
    out.shape = tuple(shape)
    out.dtype = x.dtype
    if op.output('XShape'):
        xs = block.var_recursive(op.single_output('XShape'))
        xs.shape = (0,) + tuple(x.shape or ())
        xs.dtype = x.dtype


def _reshape_grad(op, block):
    x = block.var_recursive(op.single_input('X'))
    return [dict(type='reshape_grad_helper',
                 inputs={'Out@GRAD': [grad_var_name(op.single_output('Out'))]},
                 outputs={'X@GRAD': [grad_var_name(op.single_input('X'))]},
                 attrs={'x_shape': list(x.shape)})]


@op_emitter('reshape_grad_helper')
def _reshape_grad_emit(ctx, op):
    g = ctx.get(op.single_input('Out@GRAD'))
    shape = list(op.attr('x_shape'))
    if any(s < 0 for s in shape):
        # a runtime batch dim: take it from the grad's total size
        known = int(np.prod([s for s in shape if s >= 0]))
        shape[shape.index(-1)] = g.numel() // max(known, 1)
    ctx.set(op.single_output('X@GRAD'), g.reshape(shape))


register_op('reshape2', infer_shape=_reshape_infer, grad=_reshape_grad)
register_op('reshape', infer_shape=_reshape_infer, grad=_reshape_grad,
            emit=_reshape_emit)


@op_emitter('transpose2')
def _transpose_emit(ctx, op):
    x = ctx.get(op.single_input('X'))
    ctx.set(op.single_output('Out'), x.permute(*op.attr('axis')))
    if op.output('XShape'):
        ctx.set(op.single_output('XShape'),
                x.new_empty((0,) + tuple(x.shape)))


def _transpose_infer(op, block):
    x = block.var_recursive(op.single_input('X'))
    axis = op.attr('axis')
    out = block.var_recursive(op.single_output('Out'))
    out.shape = tuple(x.shape[a] for a in axis) if x.shape is not None \
        else None
    out.dtype = x.dtype
    if op.output('XShape'):
        xs = block.var_recursive(op.single_output('XShape'))
        xs.shape = (0,) + tuple(x.shape or ())
        xs.dtype = x.dtype


def _transpose_grad(op, block):
    """The grad of a transpose is the inverse transpose."""
    axis = op.attr('axis')
    inv = [0] * len(axis)
    for i, a in enumerate(axis):
        inv[a] = i
    return [dict(type=op.type,
                 inputs={'X': [grad_var_name(op.single_output('Out'))]},
                 outputs={'Out': [grad_var_name(op.single_input('X'))],
                          'XShape': []},
                 attrs={'axis': inv})]


register_op('transpose2', infer_shape=_transpose_infer, grad=_transpose_grad)
register_op('transpose', infer_shape=_transpose_infer, grad=_transpose_grad,
            emit=_transpose_emit)


def _clamp_bounds(s, e, dim):
    s = max(s + dim, 0) if s < 0 else min(s, dim)
    e = max(e + dim, 0) if e < 0 else min(e, dim)
    return s, e


@op_emitter('slice')
def _slice_emit(ctx, op):
    x = ctx.get(op.single_input('Input'))
    idx = [slice(None)] * x.ndim
    for a, s, e in zip(op.attr('axes'), op.attr('starts'), op.attr('ends')):
        idx[a] = slice(*_clamp_bounds(s, e, x.shape[a]))
    ctx.set(op.single_output('Out'), x[tuple(idx)])


def _slice_infer(op, block):
    x = block.var_recursive(op.single_input('Input'))
    if x.shape is None:
        return
    shape = list(x.shape)
    for a, s, e in zip(op.attr('axes'), op.attr('starts'), op.attr('ends')):
        if a >= len(shape) or shape[a] < 0:
            continue
        s2, e2 = _clamp_bounds(s, e, shape[a])
        shape[a] = max(e2 - s2, 0)
    out = block.var_recursive(op.single_output('Out'))
    out.shape = tuple(shape)
    out.dtype = x.dtype


register_op('slice', infer_shape=_slice_infer)
register_vjp_grad('slice', in_slots=('Input',))


@op_emitter('expand')
def _expand_emit(ctx, op):
    """jnp.tile: each dim repeated expand_times[i] times."""
    ctx.set(op.single_output('Out'),
            ctx.get(op.single_input('X')).repeat(*op.attr('expand_times')))


def _expand_infer(op, block):
    x = block.var_recursive(op.single_input('X'))
    out = block.var_recursive(op.single_output('Out'))
    if x.shape is not None:
        out.shape = tuple(s * t if s >= 0 else -1
                          for s, t in zip(x.shape, op.attr('expand_times')))
    out.dtype = x.dtype


register_op('expand', infer_shape=_expand_infer)
register_vjp_grad('expand')


@op_emitter('stack')
def _stack_emit(ctx, op):
    ctx.set(op.single_output('Y'),
            torch.stack([ctx.get(n) for n in op.input('X')],
                        dim=op.attr('axis', 0)))


def _stack_infer(op, block):
    x = block.var_recursive(op.input('X')[0])
    shape = list(x.shape)
    shape.insert(op.attr('axis', 0) % (len(shape) + 1), len(op.input('X')))
    out = block.var_recursive(op.single_output('Y'))
    out.shape = tuple(shape)
    out.dtype = x.dtype


register_op('stack', infer_shape=_stack_infer)
register_vjp_grad('stack', in_slots=('X',), out_slots=('Y',))


def _squeezed_shape(op_type, shape, axes):
    shape = list(shape)
    if op_type.startswith('squeeze'):
        nd = len(shape)
        drop = set(a % nd for a in axes) if axes else \
            set(i for i, s in enumerate(shape) if s == 1)
        return [s for i, s in enumerate(shape) if i not in drop]
    for a in sorted(axes):
        shape.insert(a, 1)
    return shape


def _register_squeeze(op_type):
    def emit(ctx, op):
        x = ctx.get(op.single_input('X'))
        ctx.set(op.single_output('Out'), x.reshape(
            _squeezed_shape(op_type, x.shape, op.attr('axes', []))))
        if op.output('XShape'):
            ctx.set(op.single_output('XShape'),
                    x.new_empty((0,) + tuple(x.shape)))

    def infer(op, block):
        x = block.var_recursive(op.single_input('X'))
        if x.shape is None:
            return
        out = block.var_recursive(op.single_output('Out'))
        out.shape = tuple(_squeezed_shape(op_type, x.shape,
                                          op.attr('axes', [])))
        out.dtype = x.dtype
        if op.output('XShape'):
            xs = block.var_recursive(op.single_output('XShape'))
            xs.shape = (0,) + tuple(x.shape)
            xs.dtype = x.dtype

    register_op(op_type, emit=emit, infer_shape=infer)
    register_vjp_grad(op_type)


for _type in ('squeeze', 'squeeze2', 'unsqueeze', 'unsqueeze2'):
    _register_squeeze(_type)


@op_emitter('gather')
def _gather_emit(ctx, op):
    x = ctx.get(op.single_input('X'))
    idx = ctx.get(op.single_input('Index')).reshape(-1).long()
    ctx.set(op.single_output('Out'), torch.index_select(x, 0, idx))


def _gather_infer(op, block):
    x = block.var_recursive(op.single_input('X'))
    idx = block.var_recursive(op.single_input('Index'))
    out = block.var_recursive(op.single_output('Out'))
    out.shape = (idx.shape[0],) + tuple(x.shape[1:])
    out.dtype = x.dtype


register_op('gather', infer_shape=_gather_infer)
register_vjp_grad('gather', in_slots=('X',), nondiff_slots=('Index',))


@op_emitter('scatter')
def _scatter_emit(ctx, op):
    x = ctx.get(op.single_input('X'))
    idx = ctx.get(op.single_input('Ids')).reshape(-1).long()
    upd = ctx.get(op.single_input('Updates'))
    if op.attr('overwrite', True):
        out = torch.index_copy(x, 0, idx, upd)
    else:
        out = torch.index_add(x, 0, idx, upd)
    ctx.set(op.single_output('Out'), out)


register_op('scatter', infer_shape=same_shape_infer())
register_vjp_grad('scatter', in_slots=('X', 'Updates'),
                  nondiff_slots=('Ids',))


@op_emitter('one_hot')
def _one_hot_emit(ctx, op):
    x = ctx.get(op.single_input('X'))
    flat = x.reshape(x.shape[:-1]) if x.ndim and x.shape[-1] == 1 else x
    ctx.set(op.single_output('Out'),
            F.one_hot(flat.long(), op.attr('depth')).to(
                torch_dtype(op.attr('dtype', 'float32'))))


def _one_hot_infer(op, block):
    x = block.var_recursive(op.single_input('X'))
    shape = tuple(x.shape)
    if shape and shape[-1] == 1:
        shape = shape[:-1]
    out = block.var_recursive(op.single_output('Out'))
    out.shape = shape + (op.attr('depth'),)
    out.dtype = op.attr('dtype', 'float32')


register_op('one_hot', infer_shape=_one_hot_infer, no_grad=True)


@op_emitter('range')
def _range_emit(ctx, op):
    ctx.set(op.single_output('Out'),
            torch.arange(op.attr('start'), op.attr('end'), op.attr('step'),
                         dtype=torch_dtype(op.attr('dtype', 'int64')),
                         device=ctx.device))


def _range_infer(op, block):
    out = block.var_recursive(op.single_output('Out'))
    out.shape = (int(np.ceil((op.attr('end') - op.attr('start'))
                             / op.attr('step'))),)
    out.dtype = op.attr('dtype', 'int64')


register_op('range', infer_shape=_range_infer, no_grad=True)


@op_emitter('reverse')
def _reverse_emit(ctx, op):
    ctx.set(op.single_output('Out'),
            torch.flip(ctx.get(op.single_input('X')),
                       tuple(op.attr('axis'))))


register_op('reverse', infer_shape=same_shape_infer())
register_vjp_grad('reverse')


@op_emitter('pad')
def _pad_emit(ctx, op):
    """paddings = [before_0, after_0, before_1, after_1, ...]; F.pad takes
    the pairs from the last dim first."""
    x = ctx.get(op.single_input('X'))
    p = op.attr('paddings')
    pads = []
    for i in reversed(range(x.ndim)):
        pads += [p[2 * i], p[2 * i + 1]]
    ctx.set(op.single_output('Out'),
            F.pad(x, pads, value=op.attr('pad_value', 0.0)))


def _pad_infer(op, block):
    x = block.var_recursive(op.single_input('X'))
    p = op.attr('paddings')
    out = block.var_recursive(op.single_output('Out'))
    if x.shape is not None:
        out.shape = tuple((s + p[2 * i] + p[2 * i + 1]) if s >= 0 else -1
                          for i, s in enumerate(x.shape))
    out.dtype = x.dtype


register_op('pad', infer_shape=_pad_infer)
register_vjp_grad('pad')


@op_emitter('label_smooth')
def _label_smooth_emit(ctx, op):
    x = ctx.get(op.single_input('X'))
    eps = op.attr('epsilon', 0.1)
    if op.input('PriorDist'):
        out = (1 - eps) * x + eps * ctx.get(op.single_input('PriorDist'))
    else:
        out = (1 - eps) * x + eps / x.shape[-1]
    ctx.set(op.single_output('Out'), out)


register_op('label_smooth', infer_shape=same_shape_infer())
register_vjp_grad('label_smooth')


# -- random initializers: drawn from the executor's torch.Generator ---------
# (torch's streams are not jax.random's: tests carry weights across the
# two packages instead of seeding both)

def _random_out(ctx, op):
    return torch.empty(tuple(op.attr('shape')), dtype=torch.float32,
                       device=ctx.device)


@op_emitter('uniform_random')
def _uniform_random_emit(ctx, op):
    out = _random_out(ctx, op).uniform_(op.attr('min', -1.0),
                                        op.attr('max', 1.0),
                                        generator=ctx.generator(op))
    ctx.set(op.single_output('Out'),
            out.to(torch_dtype(op.attr('dtype', 'float32'))))


@op_emitter('gaussian_random')
def _gaussian_random_emit(ctx, op):
    out = _random_out(ctx, op).normal_(op.attr('mean', 0.0),
                                       op.attr('std', 1.0),
                                       generator=ctx.generator(op))
    ctx.set(op.single_output('Out'),
            out.to(torch_dtype(op.attr('dtype', 'float32'))))


def _random_infer(op, block):
    out = block.var_recursive(op.single_output('Out'))
    out.shape = tuple(op.attr('shape'))
    out.dtype = op.attr('dtype', 'float32')


register_op('uniform_random', infer_shape=_random_infer)
register_op('gaussian_random', infer_shape=_random_infer)


@op_emitter('truncated_gaussian_random')
def _truncated_gaussian_random_emit(ctx, op):
    """A normal draw truncated to two standard deviations (the JAX
    package's truncated_normal(-2, 2)), by the inverse CDF of a uniform
    draw between the two bounds' CDF values."""
    bound = math.erf(2.0 / math.sqrt(2.0))     # 2·CDF(2) − 1
    u = _random_out(ctx, op).uniform_(-bound, bound,
                                      generator=ctx.generator(op))
    val = torch.erfinv(u).mul_(math.sqrt(2.0)).clamp_(-2.0, 2.0)
    val = val * op.attr('std', 1.0) + op.attr('mean', 0.0)
    ctx.set(op.single_output('Out'),
            val.to(torch_dtype(op.attr('dtype', 'float32'))))


register_op('truncated_gaussian_random', infer_shape=_random_infer,
            no_grad=True)
