"""Estimate a Program's activation and parameter memory (counterpart
of paddle_tpu/contrib/memory_usage_calc.py).

Sums each var's numel × dtype size with the batch dim substituted: an
upper bracket of a step's memory, which the Executor lowers by dropping
dead tensors (transpiler.memory_optimization_transpiler; memory.py has
the measured numbers)."""
from __future__ import annotations

import numpy as np

from ..memory import dtype_bytes

__all__ = ['memory_usage']


def memory_usage(program, batch_size):
    """Returns estimated bytes for one pass of `program` at the given
    batch size (vars with a -1 leading dim count batch_size rows)."""
    if batch_size <= 0:
        raise ValueError('The batch size must be positive.')
    from ..framework import Program
    if not isinstance(program, Program):
        raise ValueError(
            'Calculating Memory Usage requires Program as its Parameter.')

    total = 0
    processed = set()
    for block in program.blocks:
        for var in block.vars.values():
            if var.name in processed or var.shape is None:
                continue
            processed.add(var.name)
            shape = [batch_size if d < 0 else d for d in var.shape]
            total += int(np.prod(shape)) * dtype_bytes(var.dtype)
    return total
