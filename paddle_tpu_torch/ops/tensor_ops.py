"""Tensor creation / shape ops (counterpart of paddle_tpu/ops/tensor_ops.py:
fill_constant :23, reshape2 :180, transpose2 :238, slice :276,
uniform_random :483, gaussian_random :503)."""
from __future__ import annotations

import numpy as np
import torch

from ..executor import torch_dtype
from ..registry import register_op, op_emitter


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


register_op('fill_constant', infer_shape=_fill_constant_infer)


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


register_op('reshape2', infer_shape=_reshape_infer)


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


register_op('transpose2', infer_shape=_transpose_infer)


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
