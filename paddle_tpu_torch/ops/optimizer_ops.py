"""Optimizer update ops (counterpart of paddle_tpu/ops/optimizer_ops.py:
sgd :47, momentum :67-90; dense gradients only).

The JAX package computes ParamOut as a fresh value and relies on buffer
donation to reuse the memory; here the Scope's parameter and velocity
tensors are updated IN PLACE (the grad ops have consumed every forward
record by then, so no autograd graph still holds them). Update math
runs in the parameter's dtype; the velocity keeps its own dtype.
"""
from __future__ import annotations

from ..registry import register_op


def _passthrough_infer(pairs):
    def fn(op, block):
        for in_slot, out_slot in pairs:
            if not op.output(out_slot):
                continue
            src = block.var_recursive(op.single_input(in_slot))
            dst = block.var_recursive(op.single_output(out_slot))
            dst.shape = src.shape
            dst.dtype = src.dtype
    return fn


def _lr(ctx, op, p):
    return ctx.get(op.single_input('LearningRate')).to(p.dtype).reshape(())


def _sgd_emit(ctx, op):
    p = ctx.get(op.single_input('Param'))
    g = ctx.get(op.single_input('Grad'))
    p.sub_(_lr(ctx, op, p) * g.to(p.dtype))
    ctx.set(op.single_output('ParamOut'), p)


register_op('sgd', emit=_sgd_emit, no_grad=True,
            infer_shape=_passthrough_infer([('Param', 'ParamOut')]))


def _momentum_emit(ctx, op):
    p = ctx.get(op.single_input('Param'))
    g = ctx.get(op.single_input('Grad')).to(p.dtype)
    v = ctx.get(op.single_input('Velocity'))
    lr = _lr(ctx, op, p)
    mu = op.attr('mu')
    if v.dtype == p.dtype:
        v_new = v.mul_(mu).add_(g)
    else:
        v_new = mu * v.to(p.dtype) + g
        v.copy_(v_new)
    if op.attr('use_nesterov', False):
        p.sub_((g + mu * v_new) * lr)
    else:
        p.sub_(lr * v_new)
    ctx.set(op.single_output('ParamOut'), p)
    ctx.set(op.single_output('VelocityOut'), v)


register_op('momentum', emit=_momentum_emit, no_grad=True,
            infer_shape=_passthrough_infer(
                [('Param', 'ParamOut'), ('Velocity', 'VelocityOut')]))
