"""Learning-rate decay schedules as graph ops (counterpart of
paddle_tpu/layers/learning_rate_scheduler.py, built from the same ops).

Each returns a Variable computed from the global step counter
(nn.autoincreased_step_counter), so the counter and the rate are ops of
the training program and move with every run.
"""
from __future__ import annotations

from ..layer_helper import LayerHelper
from . import nn
from . import ops
from . import tensor

__all__ = ['exponential_decay', 'natural_exp_decay', 'inverse_time_decay',
           'polynomial_decay', 'piecewise_decay', 'noam_decay']


def _global_step(dtype='float32'):
    counter = nn.autoincreased_step_counter()
    return tensor.cast(counter, dtype)


def noam_decay(d_model, warmup_steps):
    step = _global_step()
    a = step ** -0.5
    b = (warmup_steps ** -1.5) * step
    lr = (d_model ** -0.5) * nn.elementwise_min(a, b)
    return lr


def exponential_decay(learning_rate, decay_steps, decay_rate, staircase=False):
    step = _global_step()
    div = nn.scale(step, scale=1.0 / decay_steps)
    if staircase:
        div = ops.floor(div)
    return nn.scale(_pow_scalar(float(decay_rate), div),
                    scale=float(learning_rate))


def _pow_scalar(base, exponent_var):
    """base ** exponent_var via exp(exponent * ln(base))."""
    import math
    return ops.exp(nn.scale(exponent_var, scale=math.log(base)))


def natural_exp_decay(learning_rate, decay_steps, decay_rate, staircase=False):
    step = _global_step()
    div = step / float(decay_steps)
    if staircase:
        div = ops.floor(div)
    return nn.scale(ops.exp(nn.scale(div, scale=-float(decay_rate))),
                    scale=float(learning_rate))


def inverse_time_decay(learning_rate, decay_steps, decay_rate,
                       staircase=False):
    step = _global_step()
    div = step / float(decay_steps)
    if staircase:
        div = ops.floor(div)
    denom = nn.scale(div, scale=float(decay_rate), bias=1.0,
                     bias_after_scale=True)
    one = tensor.fill_constant(shape=[1], dtype='float32',
                               value=float(learning_rate))
    return nn.elementwise_div(one, denom)


def polynomial_decay(learning_rate, decay_steps, end_learning_rate=1e-4,
                     power=1.0, cycle=False):
    step = _global_step()
    if cycle:
        div = ops.ceil(nn.scale(step, scale=1.0 / decay_steps))
        # avoid zero at step 0
        div = nn.elementwise_max(
            div, tensor.fill_constant([1], 'float32', 1.0))
        decay_steps_var = nn.scale(div, scale=float(decay_steps))
        frac = nn.elementwise_div(step, decay_steps_var)
    else:
        capped = nn.elementwise_min(
            step, tensor.fill_constant([1], 'float32', float(decay_steps)))
        frac = nn.scale(capped, scale=1.0 / decay_steps)
    one_minus = nn.scale(frac, scale=-1.0, bias=1.0)
    powed = _pow_scalar_var(one_minus, power)
    return nn.scale(powed, scale=float(learning_rate - end_learning_rate),
                    bias=float(end_learning_rate))


def _pow_scalar_var(base_var, power):
    import math
    if power == 1.0:
        return base_var
    # nn.log: the JAX package's ops.log does not exist there, so its
    # power != 1 branch raises AttributeError (ROADMAP.md, Queue 3)
    return ops.exp(nn.scale(nn.log(base_var), scale=float(power)))


def piecewise_decay(boundaries, values):
    """Piecewise-constant lr by arithmetic masking, as the JAX package
    builds it: step >= boundary[i] switches to values[i+1]."""
    assert len(boundaries) + 1 == len(values)
    step = _global_step()
    lr = tensor.fill_constant([1], 'float32', float(values[0]))
    for i, b in enumerate(boundaries):
        bound = tensor.fill_constant([1], 'float32', float(b))
        mask = tensor.cast(step >= bound, 'float32')   # 1.0 when past bound
        delta = float(values[i + 1] - values[i])
        lr = nn.elementwise_add(lr, nn.scale(mask, scale=delta))
    return lr
