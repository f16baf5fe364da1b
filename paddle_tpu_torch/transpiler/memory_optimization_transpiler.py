"""Memory-optimization transpiler (counterpart of
paddle_tpu/transpiler/memory_optimization_transpiler.py:29-128).

`memory_optimize(program)` runs the JAX package's liveness analysis
over each block and stores the same reuse plan {var: reuses_buffer_of}
on the program (`program._memory_reuse_plan`); it does not rewrite the
program. On the card the reuse itself is already done twice over: the
Executor drops each run-local tensor after its last reader (its drop
plan), so the caching allocator hands that memory to the next op, and a
captured segment's tensors live in the executor's one CUDA-graph pool,
whose allocations are planned at capture. Renaming vars would change
neither.

`release_memory(program)` inserts a `delete_var` host op after the last
use of every temporary, as the JAX package does. Each one splits the
block's device segment (host steps run between captured segments), so
it suits small programs.
"""
from __future__ import annotations

import numpy as np

from ..memory import _liveness, dtype_bytes

__all__ = ['memory_optimize', 'release_memory', 'ControlFlowGraph']


class ControlFlowGraph(object):
    """Forward-order liveness over one block."""

    def __init__(self, block, skip_vars=()):
        self.block = block
        self.skip = set(skip_vars)
        self.uses, self.defs, self._live_out = _liveness(block)

    def liveness(self):
        """The per-op live-out sets."""
        return [set(s) for s in self._live_out]

    def reuse_plan(self):
        """Greedy reuse of a dead var of the same shape and dtype: once a
        var's last reader has run it joins a pool, and a var defined
        later takes the first pooled var that matches."""
        live_out = self._live_out
        pool = []      # (name, shape, dtype) free for reuse
        plan = {}
        for i in range(len(self.block.ops)):
            for name in self.uses[i]:
                var = self.block.vars.get(name)
                if var is None or var.persistable or name in self.skip \
                        or var.is_data:
                    continue
                if name not in live_out[i]:
                    pool.append((name, tuple(var.shape or ()), var.dtype))
            for name in self.defs[i]:
                var = self.block.vars.get(name)
                if var is None or var.persistable or name in self.skip:
                    continue
                key = (tuple(var.shape or ()), var.dtype)
                for j, (pname, pshape, pdtype) in enumerate(pool):
                    if (pshape, pdtype) == key and pname != name:
                        plan[name] = pname
                        pool.pop(j)
                        break
        return plan


def memory_optimize(input_program, skip_opt_set=None, print_log=False,
                    level=0):
    """Compute the buffer-reuse plan, attach it to the program as
    `_memory_reuse_plan` and return it; the program is not rewritten."""
    plan = {}
    saved = 0
    for block in input_program.blocks:
        p = ControlFlowGraph(block, skip_opt_set or ()).reuse_plan()
        plan.update(p)
        for name in p:
            var = block.vars.get(name)
            if var is not None and var.shape and \
                    all(d >= 0 for d in var.shape):
                saved += int(np.prod(var.shape)) * dtype_bytes(var.dtype)
    input_program._memory_reuse_plan = plan
    if print_log:
        print('memory_optimize: %d reusable vars, ~%.1f MB (reused by the '
              'executor\'s drop plan and its CUDA-graph pool)'
              % (len(plan), saved / 1e6))
    return plan


def release_memory(input_program, skip_opt_set=None):
    """Insert a delete_var host op after the last use of each
    non-persistable, non-data var."""
    skip = set(skip_opt_set or ())
    for block in input_program.blocks:
        cfg = ControlFlowGraph(block, skip)
        last_use = {}
        for i in range(len(block.ops)):
            for name in cfg.uses[i] | cfg.defs[i]:
                last_use[name] = i
        # from the back, so that the indices stay valid
        for name, idx in sorted(last_use.items(), key=lambda kv: -kv[1]):
            var = block.vars.get(name)
            if var is None or var.persistable or name in skip or \
                    var.is_data:
                continue
            block._insert_op(idx + 1, type='delete_var',
                             inputs={'X': [name]}, outputs={}, attrs={})
    return input_program
