"""ParallelExecutor on one device (counterpart of
paddle_tpu/parallel_executor.py:38-327).

The JAX package shards the batch over a device mesh; the port runs on
ONE card, so this is the script-compatible surface over Executor:
`ParallelExecutor(use_cuda=True, loss_name=, main_program=,
share_vars_from=, exec_strategy=, build_strategy=)` and
`run(fetch_list, feed)`. use_cuda=True means CUDAPlace(0) and raises
without a card; use_cuda=False is the explicit CPU. The strategies'
fields are kept and mean nothing on one device (there is nothing to
all-reduce and one batch-norm's statistics are local and global at
once), except `num_iteration_per_drop_scope`, the cadence at which run()
drops the scope's kids, and `debug_graphviz_path`, where the program's
dot text is written. Several trainers, a device list and a mesh
strategy raise (ROADMAP.md, Queue 1 item 8).
"""
from __future__ import annotations

from .executor import CPUPlace, CUDAPlace, Executor, global_scope
from .framework import default_main_program

__all__ = ['ParallelExecutor', 'ExecutionStrategy', 'BuildStrategy']


class ExecutionStrategy(object):
    class ExecutorType:
        Default = 0
        Experimental = 1

    def __init__(self):
        self.num_threads = 0
        self.use_cuda = True
        self.allow_op_delay = False
        self.num_iteration_per_drop_scope = 100
        self.type = ExecutionStrategy.ExecutorType.Default


class BuildStrategy(object):
    class ReduceStrategy:
        AllReduce = 0
        Reduce = 1

    class GradientScaleStrategy:
        CoeffNumDevice = 0
        One = 1
        Customized = 2

    def __init__(self):
        self.reduce_strategy = BuildStrategy.ReduceStrategy.AllReduce
        self.gradient_scale_strategy = \
            BuildStrategy.GradientScaleStrategy.CoeffNumDevice
        self.debug_graphviz_path = ''
        self.enable_data_balance = False
        self.bn_local_stats = False


class ParallelExecutor(Executor):
    def __init__(self, use_cuda=True, loss_name=None, main_program=None,
                 share_vars_from=None, exec_strategy=None,
                 build_strategy=None, num_trainers=1, trainer_id=0,
                 scope=None, devices=None, strategy=None, **kwargs):
        """loss_name is accepted for the JAX package's signature; on one
        device no gradient needs scaling by it. share_vars_from takes
        another ParallelExecutor whose scope this one runs in (a test
        executor beside its train executor)."""
        if num_trainers != 1 or trainer_id != 0 or devices is not None \
                or strategy is not None:
            raise NotImplementedError(
                'ParallelExecutor: num_trainers, trainer_id, devices and '
                'strategy need several devices, which the port does not '
                'run yet (ROADMAP.md Queue 1 item 8)')
        super(ParallelExecutor, self).__init__(
            CUDAPlace(0) if use_cuda else CPUPlace())
        self._main_program = main_program or default_main_program()
        self._loss_name = loss_name
        self._exec_strategy = exec_strategy or ExecutionStrategy()
        self._build_strategy = build_strategy or BuildStrategy()
        self._scope = scope or global_scope()
        if share_vars_from is not None:
            self._scope = share_vars_from._scope
        self._run_count = 0
        if self._build_strategy.debug_graphviz_path:
            from .debugger import program_to_dot
            with open(self._build_strategy.debug_graphviz_path, 'w') as f:
                f.write(program_to_dot(self._main_program))

    @property
    def device_count(self):
        return 1

    def run(self, fetch_list, feed=None, feed_dict=None, return_numpy=True):
        feed = feed if feed is not None else feed_dict
        result = super(ParallelExecutor, self).run(
            program=self._main_program, feed=feed, fetch_list=fetch_list,
            scope=self._scope, return_numpy=return_numpy)
        self._run_count += 1
        drop_every = self._exec_strategy.num_iteration_per_drop_scope
        if drop_every and self._run_count % drop_every == 0:
            self._scope.drop_kids()
        return result
