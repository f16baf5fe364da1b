"""ParallelExecutor on one device (counterpart of
paddle_tpu/parallel_executor.py:83-327).

The JAX package shards the batch over a device mesh; the port's first
training slice runs on ONE card, so this is the script-compatible
surface over Executor that bench.py's step uses:
`ParallelExecutor(use_cuda=True, loss_name=, main_program=)` and
`run(fetch_list, feed)`. use_cuda=True means CUDAPlace(0) and raises
without a card; use_cuda=False is the explicit CPU. Meshes, several
trainers and the execution/build strategies are not ported yet
(ROADMAP.md, Queue 1).
"""
from __future__ import annotations

from .executor import CPUPlace, CUDAPlace, Executor, global_scope
from .framework import default_main_program

__all__ = ['ParallelExecutor']


class ParallelExecutor(Executor):
    def __init__(self, use_cuda=True, loss_name=None, main_program=None,
                 scope=None):
        """loss_name is accepted for the JAX package's signature; on one
        device no gradient needs scaling by it."""
        super(ParallelExecutor, self).__init__(
            CUDAPlace(0) if use_cuda else CPUPlace())
        self._main_program = main_program or default_main_program()
        self._scope = scope or global_scope()

    def run(self, fetch_list, feed=None, return_numpy=True):
        return super(ParallelExecutor, self).run(
            program=self._main_program, feed=feed, fetch_list=fetch_list,
            scope=self._scope, return_numpy=return_numpy)
