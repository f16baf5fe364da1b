"""Initializers: emit init ops into the startup program (counterpart of
paddle_tpu/initializer.py).

Each initializer appends one op (fill_constant / uniform_random /
gaussian_random) to the startup block for the parameter. The Executor
draws the random ones from its own torch.Generator, seeded from
Program.random_seed, so they do not reproduce jax.random's numbers:
tests carry weights across packages instead of seeding both.
"""
from __future__ import annotations

import numpy as np

__all__ = ['Constant', 'Uniform', 'Normal', 'Xavier', 'Initializer',
           'ConstantInitializer', 'UniformInitializer',
           'NormalInitializer', 'XavierInitializer']


class Initializer(object):
    def __call__(self, var, block):
        raise NotImplementedError

    @staticmethod
    def _compute_fans(var):
        shape = var.shape
        if len(shape) < 2:
            fan_in = fan_out = int(shape[0]) if shape else 1
        else:
            receptive = int(np.prod(shape[2:])) if len(shape) > 2 else 1
            fan_in = int(shape[1]) * receptive
            fan_out = int(shape[0]) * receptive
        return fan_in, fan_out


class Constant(Initializer):
    def __init__(self, value=0.0, force_cpu=False):
        self.value = value

    def __call__(self, var, block):
        return block.append_op(
            type='fill_constant', outputs={'Out': var},
            attrs={'shape': list(var.shape), 'dtype': var.dtype,
                   'value': float(self.value)})


class Uniform(Initializer):
    def __init__(self, low=-1.0, high=1.0, seed=0):
        self.low, self.high, self.seed = low, high, seed

    def __call__(self, var, block):
        return block.append_op(
            type='uniform_random', outputs={'Out': var},
            attrs={'shape': list(var.shape), 'dtype': var.dtype,
                   'min': self.low, 'max': self.high, 'seed': self.seed})


class Normal(Initializer):
    def __init__(self, loc=0.0, scale=1.0, seed=0):
        self.loc, self.scale, self.seed = loc, scale, seed

    def __call__(self, var, block):
        return block.append_op(
            type='gaussian_random', outputs={'Out': var},
            attrs={'shape': list(var.shape), 'dtype': var.dtype,
                   'mean': self.loc, 'std': self.scale, 'seed': self.seed})


class Xavier(Initializer):
    """Glorot init: uniform (default) or normal over fan_in + fan_out."""

    def __init__(self, uniform=True, fan_in=None, fan_out=None, seed=0):
        self.uniform = uniform
        self.fan_in = fan_in
        self.fan_out = fan_out
        self.seed = seed

    def __call__(self, var, block):
        f_in, f_out = self._compute_fans(var)
        fan_in = f_in if self.fan_in is None else self.fan_in
        fan_out = f_out if self.fan_out is None else self.fan_out
        if self.uniform:
            limit = float(np.sqrt(6.0 / (fan_in + fan_out)))
            return Uniform(-limit, limit, self.seed)(var, block)
        std = float(np.sqrt(2.0 / (fan_in + fan_out)))
        return Normal(0.0, std, self.seed)(var, block)


ConstantInitializer = Constant
UniformInitializer = Uniform
NormalInitializer = Normal
XavierInitializer = Xavier
