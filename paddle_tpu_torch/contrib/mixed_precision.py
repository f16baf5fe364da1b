"""Mixed-precision training: bf16 compute, fp32 master weights
(counterpart of paddle_tpu/contrib/mixed_precision.py).

bfloat16 has fp32's exponent range, so no loss scaling is needed and
decorate() has no LossScaler machinery. decorate() only marks the
program (`program._use_bf16`); the Executor hands that to every emitter
as EmitContext.amp, and the matrix ops (mul, matmul, flash_attention,
the fused LM head) cast their fp32 operands to bf16 (registry.amp_cast)
and accumulate in fp32. Master weights, Momentum's velocity, softmax,
losses and logits stay fp32.

Usage (matches later-reference fluid.contrib.mixed_precision.decorate):

    optimizer = fluid.optimizer.Momentum(learning_rate=0.1, momentum=0.9)
    optimizer = fluid.contrib.mixed_precision.decorate(optimizer)
    optimizer.minimize(avg_cost)
"""
from __future__ import annotations

from ..framework import default_main_program

__all__ = ['decorate', 'bf16_guard']


class OptimizerWithMixedPrecision(object):
    """Wraps an optimizer; minimize() marks the main program for bf16
    emission. Parameter tensors and optimizer state remain fp32 (master
    weights); only the jitted compute is downcast."""

    def __init__(self, optimizer):
        self._optimizer = optimizer

    def __getattr__(self, name):
        return getattr(self._optimizer, name)

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        program = loss.block.program
        program._use_bf16 = True
        return self._optimizer.minimize(
            loss, startup_program=startup_program,
            parameter_list=parameter_list, no_grad_set=no_grad_set)


def decorate(optimizer, init_loss_scaling=1.0, use_dynamic_loss_scaling=False,
             amp_lists=None):
    """Reference-compatible signature; loss-scaling args are accepted and
    ignored (bf16 needs none)."""
    return OptimizerWithMixedPrecision(optimizer)


class bf16_guard(object):
    """Context manager marking a program for bf16 emission without touching
    the optimizer: `with fluid.contrib.mixed_precision.bf16_guard(prog): ...`
    or used directly on the default main program."""

    def __init__(self, program=None):
        self.program = program

    def __enter__(self):
        p = self.program or default_main_program()
        p._use_bf16 = True
        return p

    def __exit__(self, *exc):
        return False
