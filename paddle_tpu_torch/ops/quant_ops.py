"""Quantization-aware training ops (counterpart of
paddle_tpu/ops/quant_ops.py): fake_quantize with its straight-through
grad, and fake_dequantize_max_abs.

fake_quantize rounds X / scale to bit_length-bit integers (half to even,
as jnp.round) and scales back, in X's dtype. The scale:
- abs_max: max |X| of the batch;
- range_abs_max: max(batch abs max, the stored moving scale);
- moving_average_abs_max: 0.9 x stored + 0.1 x batch abs max;
- for test (Program.clone(for_test=True)): the stored scale.
The moving scale is a persistable var the op reads (InMovingScale) and
writes (OutMovingScale) out of place; on the card the write is part of
the captured graph, copied back into the scope's tensor
(executor.rebound_persistables). The grad op passes Out@GRAD where
|X| <= the scale the forward used and zeroes it elsewhere.
"""
from __future__ import annotations

import torch

from ..framework import grad_var_name
from ..registry import register_op, op_emitter, same_shape_infer


def _forward_scale(ctx, op, x):
    """The scale the forward uses for x (module docstring)."""
    qtype = op.attr('quantize_type', 'abs_max')
    batch_scale = torch.max(torch.abs(x))
    if qtype == 'abs_max' or not op.input('InMovingScale'):
        return batch_scale
    prev = ctx.get(op.single_input('InMovingScale')).reshape(())
    if qtype == 'range_abs_max':
        return torch.maximum(batch_scale, prev)
    return 0.9 * prev + 0.1 * batch_scale


@op_emitter('fake_quantize')
def _fake_quantize_emit(ctx, op):
    x = ctx.get(op.single_input('X'))
    qmax = float((1 << (op.attr('bit_length', 8) - 1)) - 1)
    scale = _forward_scale(ctx, op, x)
    if ctx.is_test and op.input('InMovingScale'):
        scale = ctx.get(op.single_input('InMovingScale')).reshape(())
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = torch.round(torch.clamp(x / safe, -1.0, 1.0) * qmax)
    ctx.set(op.single_output('Out'), q * safe / qmax)
    if op.output('OutMovingScale'):
        ctx.set(op.single_output('OutMovingScale'),
                scale.reshape(1).to(x.dtype))


def _fake_quantize_infer(op, block):
    x = block.var_recursive(op.single_input('X'))
    out = block.var_recursive(op.single_output('Out'))
    out.shape = x.shape
    out.dtype = x.dtype
    if op.output('OutMovingScale'):
        ms = block.var_recursive(op.single_output('OutMovingScale'))
        ms.shape = (1,)
        ms.dtype = x.dtype


def _fake_quantize_grad_maker(op, block):
    """The JAX package's grad op: X, Out@GRAD (and InMovingScale) ->
    X@GRAD."""
    inputs = {'X': list(op.input('X')),
              'Out@GRAD': [grad_var_name(n) for n in op.output('Out')]}
    if op.input('InMovingScale'):
        inputs['InMovingScale'] = list(op.input('InMovingScale'))
    return [dict(type='fake_quantize_grad', inputs=inputs,
                 outputs={'X@GRAD': [grad_var_name(n)
                                     for n in op.input('X')]},
                 attrs=dict(op.attrs))]


@op_emitter('fake_quantize_grad')
def _fake_quantize_grad_emit(ctx, op):
    x = ctx.get(op.single_input('X'))
    g = ctx.get(op.single_input('Out@GRAD'))
    scale = _forward_scale(ctx, op, x)
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    ctx.set(op.single_output('X@GRAD'),
            torch.where(torch.abs(x) <= safe, g, torch.zeros_like(g)))


register_op('fake_quantize', infer_shape=_fake_quantize_infer,
            grad=_fake_quantize_grad_maker)


@op_emitter('fake_dequantize_max_abs')
def _fake_dequantize_emit(ctx, op):
    x = ctx.get(op.single_input('X'))
    scale = ctx.get(op.single_input('Scale')).reshape(())
    ctx.set(op.single_output('Out'), x * (scale / op.attr('max_range')))


register_op('fake_dequantize_max_abs', infer_shape=same_shape_infer(),
            no_grad=True)
