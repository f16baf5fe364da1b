"""Optimizer update ops (counterpart of paddle_tpu/ops/optimizer_ops.py:
sgd :47, momentum :67-90, adam :91-147, adagrad :150, decayed_adagrad
:178, adamax :197, adadelta :223, rmsprop :246, ftrl :269, proximal_gd
:311, proximal_adagrad :326; dense gradients only: the port has no
SelectedRows, so Adam's lazy_mode is the dense update).

The JAX package computes every output as a fresh value and relies on
buffer donation to reuse the memory; here the Scope's tensors are
updated IN PLACE (the grad ops have consumed every forward record by
then, so no autograd graph still holds them): sgd and momentum with
in-place arithmetic, the others by computing the JAX package's formula
and copying the result into the tensor that the output names, when it
is the input's own var (ParamOut = Param, Moment1Out = Moment1,
Beta1PowOut = Beta1Pow, ...). An output under another name gets a fresh
tensor. Update math runs in the parameter's dtype; an accumulator keeps
its own dtype (bf16 velocity under FLAGS_bf16_momentum).
"""
from __future__ import annotations

import torch

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


def _store(ctx, op, in_slot, out_slot, value):
    """Write `value` to out_slot: into the input's own tensor when the
    output names the same var (an accumulator updated in place in the
    Scope), else as a fresh tensor in the input's dtype."""
    if not op.output(out_slot):
        return
    src = ctx.get(op.single_input(in_slot))
    out_name = op.single_output(out_slot)
    if out_name == op.single_input(in_slot):
        src.copy_(value)
        ctx.set(out_name, src)
    else:
        ctx.set(out_name, value.to(src.dtype))


def _dense_inputs(ctx, op, *slots):
    """Param, Grad (in the param's dtype), the learning rate as a
    0-d tensor, then the named accumulators."""
    p = ctx.get(op.single_input('Param'))
    g = ctx.get(op.single_input('Grad')).to(p.dtype)
    accs = [ctx.get(op.single_input(s)) for s in slots]
    return [p, g, _lr(ctx, op, p)] + accs


def _adam_emit(ctx, op):
    p, g, lr, m1, m2, b1p, b2p = _dense_inputs(
        ctx, op, 'Moment1', 'Moment2', 'Beta1Pow', 'Beta2Pow')
    b1 = op.attr('beta1', 0.9)
    b2 = op.attr('beta2', 0.999)
    eps = op.attr('epsilon', 1e-8)
    # lazy_mode only changes the SelectedRows update; on a dense grad
    # it is this one
    m1_new = b1 * m1 + (1 - b1) * g
    m2_new = b2 * m2 + (1 - b2) * torch.square(g)
    lr_t = (lr * torch.sqrt(1 - b2p) / (1 - b1p)).reshape(())
    _store(ctx, op, 'Param', 'ParamOut',
           p - lr_t * m1_new / (torch.sqrt(m2_new) + eps))
    _store(ctx, op, 'Moment1', 'Moment1Out', m1_new)
    _store(ctx, op, 'Moment2', 'Moment2Out', m2_new)
    _store(ctx, op, 'Beta1Pow', 'Beta1PowOut', b1p * b1)
    _store(ctx, op, 'Beta2Pow', 'Beta2PowOut', b2p * b2)


register_op('adam', emit=_adam_emit, no_grad=True,
            infer_shape=_passthrough_infer(
                [('Param', 'ParamOut'), ('Moment1', 'Moment1Out'),
                 ('Moment2', 'Moment2Out'), ('Beta1Pow', 'Beta1PowOut'),
                 ('Beta2Pow', 'Beta2PowOut')]))


def _adagrad_emit(ctx, op):
    p, g, lr, m = _dense_inputs(ctx, op, 'Moment')
    eps = op.attr('epsilon', 1e-6)
    m_new = m + torch.square(g)
    _store(ctx, op, 'Param', 'ParamOut',
           p - lr * g / (torch.sqrt(m_new) + eps))
    _store(ctx, op, 'Moment', 'MomentOut', m_new)


register_op('adagrad', emit=_adagrad_emit, no_grad=True,
            infer_shape=_passthrough_infer(
                [('Param', 'ParamOut'), ('Moment', 'MomentOut')]))


def _decayed_adagrad_emit(ctx, op):
    p, g, lr, m = _dense_inputs(ctx, op, 'Moment')
    decay = op.attr('decay', 0.95)
    eps = op.attr('epsilon', 1e-6)
    m_new = decay * m + (1 - decay) * torch.square(g)
    _store(ctx, op, 'Param', 'ParamOut',
           p - lr * g / (torch.sqrt(m_new) + eps))
    _store(ctx, op, 'Moment', 'MomentOut', m_new)


register_op('decayed_adagrad', emit=_decayed_adagrad_emit, no_grad=True,
            infer_shape=_passthrough_infer(
                [('Param', 'ParamOut'), ('Moment', 'MomentOut')]))


def _adamax_emit(ctx, op):
    p, g, lr, m, inf_norm, b1p = _dense_inputs(
        ctx, op, 'Moment', 'InfNorm', 'Beta1Pow')
    b1 = op.attr('beta1', 0.9)
    b2 = op.attr('beta2', 0.999)
    eps = op.attr('epsilon', 1e-8)
    m_new = b1 * m + (1 - b1) * g
    inf_new = torch.maximum(b2 * inf_norm, torch.abs(g) + eps)
    lr_t = (lr / (1 - b1p)).reshape(())
    _store(ctx, op, 'Param', 'ParamOut', p - lr_t * m_new / inf_new)
    _store(ctx, op, 'Moment', 'MomentOut', m_new)
    _store(ctx, op, 'InfNorm', 'InfNormOut', inf_new)


register_op('adamax', emit=_adamax_emit, no_grad=True,
            infer_shape=_passthrough_infer(
                [('Param', 'ParamOut'), ('Moment', 'MomentOut'),
                 ('InfNorm', 'InfNormOut')]))


def _adadelta_emit(ctx, op):
    p = ctx.get(op.single_input('Param'))
    g = ctx.get(op.single_input('Grad')).to(p.dtype)
    avg_sq_grad = ctx.get(op.single_input('AvgSquaredGrad'))
    avg_sq_upd = ctx.get(op.single_input('AvgSquaredUpdate'))
    rho = op.attr('rho', 0.95)
    eps = op.attr('epsilon', 1e-6)
    asg_new = rho * avg_sq_grad + (1 - rho) * torch.square(g)
    update = -torch.sqrt((avg_sq_upd + eps) / (asg_new + eps)) * g
    asu_new = rho * avg_sq_upd + (1 - rho) * torch.square(update)
    _store(ctx, op, 'Param', 'ParamOut', p + update)
    _store(ctx, op, 'AvgSquaredGrad', 'AvgSquaredGradOut', asg_new)
    _store(ctx, op, 'AvgSquaredUpdate', 'AvgSquaredUpdateOut', asu_new)


register_op('adadelta', emit=_adadelta_emit, no_grad=True,
            infer_shape=_passthrough_infer(
                [('Param', 'ParamOut'),
                 ('AvgSquaredGrad', 'AvgSquaredGradOut'),
                 ('AvgSquaredUpdate', 'AvgSquaredUpdateOut')]))


def _rmsprop_emit(ctx, op):
    p, g, lr, ms, mom = _dense_inputs(ctx, op, 'MeanSquare', 'Moment')
    rho = op.attr('decay', 0.95)
    eps = op.attr('epsilon', 1e-6)
    momentum = op.attr('momentum', 0.0)
    ms_new = rho * ms + (1 - rho) * torch.square(g)
    mom_new = momentum * mom + lr * g / torch.sqrt(ms_new + eps)
    _store(ctx, op, 'Param', 'ParamOut', p - mom_new)
    _store(ctx, op, 'MeanSquare', 'MeanSquareOut', ms_new)
    _store(ctx, op, 'Moment', 'MomentOut', mom_new)


register_op('rmsprop', emit=_rmsprop_emit, no_grad=True,
            infer_shape=_passthrough_infer(
                [('Param', 'ParamOut'), ('MeanSquare', 'MeanSquareOut'),
                 ('Moment', 'MomentOut')]))


def _ftrl_emit(ctx, op):
    p, g, lr, sq_accum, lin_accum = _dense_inputs(
        ctx, op, 'SquaredAccumulator', 'LinearAccumulator')
    l1 = op.attr('l1', 0.0)
    l2 = op.attr('l2', 0.0)
    lr_power = op.attr('lr_power', -0.5)
    new_accum = sq_accum + torch.square(g)
    if lr_power == -0.5:
        # sqrt(new) - sqrt(old) as g² / (sqrt(new) + sqrt(old)): the same
        # value without the cancellation, which the division by lr would
        # scale up (the JAX package subtracts the two roots); 0 where both
        # accumulators are 0, as the difference is (a zero gradient on a
        # fresh accumulator, which 0/0 would turn into NaN for good)
        root = torch.sqrt(new_accum)
        sigma = torch.where(
            new_accum > 0, torch.square(g) / (root + torch.sqrt(sq_accum)),
            torch.zeros_like(g)) / lr
        x = l2 + root / lr
    else:
        sigma = (torch.pow(new_accum, -lr_power)
                 - torch.pow(sq_accum, -lr_power)) / lr
        x = l2 + torch.pow(new_accum, -lr_power) / lr
    lin_new = lin_accum + g - sigma * p
    pre_shrink = (torch.sign(lin_new) * l1 - lin_new) / x
    _store(ctx, op, 'Param', 'ParamOut',
           torch.where(torch.abs(lin_new) > l1, pre_shrink,
                       torch.zeros_like(pre_shrink)))
    _store(ctx, op, 'SquaredAccumulator', 'SquaredAccumOut', new_accum)
    _store(ctx, op, 'LinearAccumulator', 'LinearAccumOut', lin_new)


register_op('ftrl', emit=_ftrl_emit, no_grad=True,
            infer_shape=_passthrough_infer(
                [('Param', 'ParamOut'),
                 ('SquaredAccumulator', 'SquaredAccumOut'),
                 ('LinearAccumulator', 'LinearAccumOut')]))


def _soft_threshold(prox, step, l1, l2):
    """FOBOS soft-threshold shared by the proximal optimizers."""
    shrunk = torch.sign(prox) * torch.clamp(torch.abs(prox) - step * l1,
                                            min=0.0)
    return shrunk / (1.0 + step * l2)


def _proximal_gd_emit(ctx, op):
    p, g, lr = _dense_inputs(ctx, op)
    prox = p - lr * g
    _store(ctx, op, 'Param', 'ParamOut',
           _soft_threshold(prox, lr, op.attr('l1', 0.0), op.attr('l2', 0.0)))


register_op('proximal_gd', emit=_proximal_gd_emit, no_grad=True,
            infer_shape=_passthrough_infer([('Param', 'ParamOut')]))


def _proximal_adagrad_emit(ctx, op):
    p, g, lr, m = _dense_inputs(ctx, op, 'Moment')
    m_new = m + torch.square(g)
    prox = p - (lr / torch.sqrt(m_new + 1e-10)) * g
    # thresholded with the PLAIN lr, not the per-element adaptive step,
    # as the JAX package does
    _store(ctx, op, 'Param', 'ParamOut',
           _soft_threshold(prox, lr, op.attr('l1', 0.0), op.attr('l2', 0.0)))
    _store(ctx, op, 'Moment', 'MomentOut', m_new)


register_op('proximal_adagrad', emit=_proximal_adagrad_emit, no_grad=True,
            infer_shape=_passthrough_infer(
                [('Param', 'ParamOut'), ('Moment', 'MomentOut')]))
