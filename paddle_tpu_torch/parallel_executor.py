"""ParallelExecutor (counterpart of paddle_tpu/parallel_executor.py:38-327).

On one rank (no strategy, one trainer, a world of one) it is the
script-compatible surface over Executor, as before: use_cuda=True means
CUDAPlace(0) and raises without a card, use_cuda=False is the explicit
CPU, and the strategies' fields mean nothing but
`num_iteration_per_drop_scope` and `debug_graphviz_path`.

Over ranks it is the JAX package's mesh engine, one process a rank:
- `strategy=DistributedStrategy(dp=, tp=, sp=, pp=, ep=)`,
  `num_trainers=` or a process group already up
  (parallel.init_parallel_env) make a mesh of the world's ranks
  (parallel/mesh.py); under pp > 1 a device segment whose ops carry
  pipeline stages runs through the GPipe engine (parallel/pp_lowering.py)
  and counts into jit_cache_stats() as any segment;
  the process group is opened from the PADDLE_* env contract
  (parallel/distributed.init_parallel_env) if it is not up;
- a rank's place is devices[rank] if `devices=` is given (the world's
  places in rank order; another length raises), else
  CUDAPlace(rank % cards) with use_cuda, else CPUPlace();
- the first run places the startup values: each persistable var is
  broadcast from rank 0 (BCastParamsToDevices) and every rank keeps its
  part under the var's spec: its `dist_attr` (shard_tensor), or ZeRO's
  rule (`sharded_optimizer` or BuildStrategy.ReduceStrategy.Reduce:
  optimizer state over dp on dim 0; `sharded_params`: parameters and
  state over dp on their first dim that dp divides), else replicated;
- feeds follow _put_feed: every rank is fed the global batch and keeps
  its dp rows (a batch dp does not divide raises, with the JAX
  package's message); with num_trainers > 1 each trainer feeds its
  local batch, the global batch being their concatenation in dp order;
- every op runs through its layout rule (parallel/layout.py); a
  replicated parameter's gradient is summed over the axes its data was
  split on before the optimizer reads it;
- a fetch returns the global value on every rank (the loss is the exact
  global mean);
- BuildStrategy.bn_local_stats (or FLAGS_bn_local_stats) keeps
  batch_norm's statistics per rank; by default they are summed over dp.
A mesh run is eager: its collectives are host calls under gloo, which a
CUDA graph cannot capture (ROADMAP.md Queue 3). `collective_records()`
is the record of the collectives the last run issued
(profiler.collective_audit reads it).
"""
from __future__ import annotations

import torch

from .executor import (CPUPlace, CUDAPlace, Executor, global_scope,
                       _expand_sequence_feeds, _to_numpy, _detached)
from .framework import Variable, default_main_program

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
        AllReduce = 0   # replicated params, grad all-reduce (default)
        Reduce = 1      # sharded optimizer state (ZeRO-1)

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
        # per-rank batch_norm statistics under data parallelism (the
        # reference's semantics); False = synchronised over dp
        self.bn_local_stats = False


class ParallelExecutor(Executor):
    def __init__(self, use_cuda=True, loss_name=None, main_program=None,
                 share_vars_from=None, exec_strategy=None,
                 build_strategy=None, num_trainers=1, trainer_id=0,
                 scope=None, devices=None, strategy=None, **kwargs):
        """loss_name is accepted for the JAX package's signature: the
        loss is a global mean, so no gradient is scaled by it.
        share_vars_from takes another ParallelExecutor whose scope this
        one runs in."""
        from .parallel import distributed as D
        from .parallel.mesh import Mesh
        if strategy is not None:
            for ax in ('dp', 'tp', 'sp', 'pp', 'ep'):
                if not isinstance(getattr(strategy, ax, None), int):
                    raise TypeError(
                        'strategy must be a DistributedStrategy, got %r'
                        % (strategy,))
            world = strategy.world_size
        elif num_trainers > 1:
            world = num_trainers
        else:
            # a process group opened by init_parallel_env (the PADDLE_*
            # variables alone also describe parameter-server jobs)
            world = D.num_trainers() if D.is_initialized() else 1
        if devices is not None and len(devices) != world:
            raise ValueError('devices= holds %d places; the world has %d '
                             'ranks, one place each, in rank order'
                             % (len(devices), world))
        if num_trainers > 1 and num_trainers != world:
            raise ValueError(
                'num_trainers=%d: one process a rank, so the trainers are '
                'the %d ranks of the strategy' % (num_trainers, world))
        if world > 1:
            D.init_parallel_env(
                trainer_id=(trainer_id if num_trainers > 1 else None),
                num_trainers=world, use_cuda=use_cuda)
            if D.num_trainers() != world:
                raise ValueError('the process group has %d ranks, the mesh '
                                 '%d' % (D.num_trainers(), world))
        rank = D.trainer_id() if world > 1 else 0
        if devices is not None:
            place = devices[rank]
        elif use_cuda:
            place = CUDAPlace(rank % max(torch.cuda.device_count(), 1))
        else:
            place = CPUPlace()
        self._bn_local_stats = (
            True if getattr(build_strategy, 'bn_local_stats', False)
            else None)
        super(ParallelExecutor, self).__init__(place)
        self._main_program = main_program or default_main_program()
        self._loss_name = loss_name
        self._exec_strategy = exec_strategy or ExecutionStrategy()
        self._build_strategy = build_strategy or BuildStrategy()
        self._scope = scope or global_scope()
        if share_vars_from is not None:
            self._scope = share_vars_from._scope
        self._num_trainers, self._trainer_id = num_trainers, rank
        self._strategy = strategy
        self._world = world
        self._rank = rank
        self._local_feeds = num_trainers > 1
        self._devices = list(devices) if devices is not None else None
        self.mesh = None
        if world > 1:
            if strategy is not None:
                self.mesh = strategy.mesh_config(self._devices).build()
            else:
                self.mesh = Mesh(('dp',), (world,), self._devices)
            if self.mesh.devices is None:
                self.mesh.devices = [place] * world
            self.mesh.device_mesh          # every rank builds it, in order
        self._dp_size = self.mesh.shape.get('dp', 1) if self.mesh else 1
        self._storage = {}
        self._params_placed = False
        self._records = []
        self._pp_stats = None
        self._run_count = 0
        if self._build_strategy.debug_graphviz_path:
            from .debugger import program_to_dot
            with open(self._build_strategy.debug_graphviz_path, 'w') as f:
                f.write(program_to_dot(self._main_program))

    @property
    def device_count(self):
        return self._world

    # -- placement -------------------------------------------------------------
    def _zero_modes(self):
        st, bs = self._strategy, self._build_strategy
        zero1 = self._dp_size > 1 and (
            (st is not None and st.sharded_optimizer) or
            bs.reduce_strategy == BuildStrategy.ReduceStrategy.Reduce)
        zero3 = self._dp_size > 1 and st is not None and \
            bool(getattr(st, 'sharded_params', False))
        return zero1, zero3

    def _first_divisible(self, shape):
        for d, n in enumerate(shape or ()):
            if n and n > 0 and n % self._dp_size == 0:
                spec = [None] * len(shape)
                spec[d] = 'dp'
                return tuple(spec)
        return None

    def storage_spec(self, name):
        """The spec `name` is stored under in this executor's scope (None:
        replicated)."""
        return self._storage.get(name)

    def placements(self, name):
        """DTensor placements of persistable `name` over the mesh."""
        from .parallel.mesh import named_sharding
        return named_sharding(self.mesh, self._storage.get(name))

    def _plan_storage(self):
        from .framework import Parameter
        from .parallel.mesh import fit_spec
        zero1, zero3 = self._zero_modes()
        block = self._main_program.global_block()
        storage, gathered = {}, set()
        for name, var in block.vars.items():
            if not var.persistable or var.shape is None:
                continue
            spec = getattr(var, 'dist_attr', None)
            if spec is not None:
                spec = fit_spec(spec, var.shape, self.mesh)
            elif zero1 and not isinstance(var, Parameter) and var.shape:
                if zero3:
                    spec = self._first_divisible(var.shape)
                elif var.shape[0] and var.shape[0] > 0 and \
                        var.shape[0] % self._dp_size == 0:
                    spec = ('dp',) + (None,) * (len(var.shape) - 1)
            elif zero3 and isinstance(var, Parameter):
                spec = self._first_divisible(var.shape)
                if spec is not None:
                    gathered.add(name)
            if spec is not None and any(e is not None for e in spec):
                storage[name] = spec
        # ZeRO-1: a parameter's gradient goes to the shard of its state
        state_specs = {}
        if zero1:
            for op in block.ops:
                if 'Param' not in op.inputs or not op.input('Param'):
                    continue
                p = op.input('Param')[0]
                if p in gathered:
                    continue
                for slot, names in op.inputs.items():
                    if slot in ('Param', 'Grad', 'LearningRate'):
                        continue
                    for n in names:
                        v = block.vars.get(n)
                        if n in storage and v is not None and \
                                tuple(v.shape) == tuple(block.var(p).shape):
                            state_specs.setdefault(p, storage[n])
        return storage, gathered, state_specs

    def _bcast_params(self):
        """Broadcast every persistable value from rank 0 and keep this
        rank's part (BCastParamsToDevices, reference
        parallel_executor.cc:210)."""
        import torch.distributed as dist
        from .parallel.layout import local_part, normalize
        self._storage, self._gathered, self._state_specs = \
            self._plan_storage()
        block = self._main_program.global_block()
        names = [n for n, v in block.vars.items() if v.persistable and
                 isinstance(self._scope.find_var(n), torch.Tensor)]
        for n in sorted(names):
            t = self._scope.find_var(n)
            t = t.to(self.device).contiguous()
            dist.broadcast(t, src=0)
            spec = normalize(self._storage.get(n), t.ndim, self.mesh)
            part = local_part(t, spec, self.mesh, self._rank)
            self._scope.set_var(n, part.contiguous())
        self._params_placed = True

    # -- feeds and fetches ------------------------------------------------------
    def _feed_spec(self, name, value):
        from .parallel.layout import normalize
        var = self._main_program.global_block().vars.get(name)
        spec = getattr(var, 'dist_attr', None) if var is not None else None
        if spec is not None:
            return normalize(spec, value.ndim, self.mesh)
        if value.ndim == 0:
            return ()
        return normalize(('dp',), value.ndim, self.mesh)

    def _put_feed(self, name, t):
        from .parallel.layout import local_part
        spec = self._feed_spec(name, t)
        if self._local_feeds:
            return t, spec
        if spec and spec[0] and t.shape[0] % self._dp_size != 0:
            raise ValueError('batch size %d not divisible by dp degree %d'
                             % (t.shape[0], self._dp_size))
        return local_part(t, spec, self.mesh, self._rank), spec

    def _gather_value(self, name, value, st):
        from .parallel import collectives as C
        from .parallel.layout import normalize
        if not isinstance(value, torch.Tensor):
            return value
        if name in st.layouts:
            spec = st.spec_for(name, value)
        else:
            spec = normalize(self._storage.get(name), value.ndim, self.mesh)
        for d in range(len(spec)):
            for a in reversed(spec[d]):
                value = C.gather(value, d, C.axis(self.mesh, a))
        return value

    def global_value(self, name):
        """The whole value of persistable `name` (a collective: every
        rank calls it), gathered from the ranks' parts."""
        from .parallel.layout import DistState
        val = self._scope.find_var(name)
        if self.mesh is None:
            return val
        if not self._params_placed:
            self._bcast_params()
            val = self._scope.find_var(name)
        st = DistState(self.mesh, self._rank, self._storage, ())
        return self._gather_value(name, val, st)

    def param_gathers(self):
        """(parameter, axes) of each gather of a stored parameter shard
        in the last run (ZeRO-3's gathers on use; a tp weight is never
        gathered by the tensor-parallel rules)."""
        return list(getattr(self, '_param_gathers', []))

    def collective_records(self):
        """The collectives the last run issued: dicts {kind, axis,
        bytes, seconds, staged} (profiler.collective_audit)."""
        return list(self._records)

    # -- run ----------------------------------------------------------------------
    def run(self, fetch_list, feed=None, feed_dict=None, return_numpy=True):
        feed = feed if feed is not None else feed_dict
        if self.mesh is None:
            result = super(ParallelExecutor, self).run(
                program=self._main_program, feed=feed,
                fetch_list=fetch_list, scope=self._scope,
                return_numpy=return_numpy)
        else:
            result = self._run_mesh(fetch_list, feed or {}, return_numpy)
        self._run_count += 1
        drop_every = self._exec_strategy.num_iteration_per_drop_scope
        if drop_every and self._run_count % drop_every == 0:
            self._scope.drop_kids()
        return result

    def _run_segment(self, prepared, step_idx, step, ctx, drop, captured,
                     check_nan_inf):
        """A pp-annotated segment under pp > 1 runs through the pipeline
        engine (the JAX package's _compile_segment -> build_pp_segment_fn);
        every other segment as the Executor runs it. Under
        FLAGS_check_nan_inf a pp segment too runs op by op, every output
        scanned, as the JAX package's checked path runs it: its backward
        ops then give the gradients, with each pp rank running every
        stage on its dp rows."""
        from .obs import perf as _perf
        from .parallel.pp_lowering import build_pp_segment_fn, segment_has_pp
        st = self._strategy
        if ctx.dist is None or st is None or st.pp <= 1 or \
                check_nan_inf or not segment_has_pp(step):
            return super(ParallelExecutor, self)._run_segment(
                prepared, step_idx, step, ctx, drop, captured, check_nan_inf)
        runner = step.pp_runner
        if runner is None:
            runner = step.pp_runner = build_pp_segment_fn(
                self, step, prepared.block, prepared.program)
            self._compile_count += 1
            self._segment_misses += 1
            _perf.jit_cache_miss()
        else:
            self._segment_hits += 1
            _perf.jit_cache_hit()
        with self._segment_range(prepared, step_idx, step,
                                 step.signature(ctx.local), 'eager'):
            runner(ctx)
        # the locals whose last use lies in this segment
        for pos in step.op_offsets:
            for name in drop.get(pos, ()):
                ctx.local.pop(name, None)

    def pp_stats(self):
        """What the last pipelined step moved (parallel/pp_lowering.py
        PPStats), or None."""
        return self._pp_stats

    def _run_mesh(self, fetch_list, feed, return_numpy):
        from .parallel import collectives as C
        from .parallel.layout import DistState
        from .flags import get_flag
        if not self._params_placed:
            self._bcast_params()
        program = self._main_program
        fetch_names = [v.name if isinstance(v, Variable) else str(v)
                       for v in fetch_list]
        feed = _expand_sequence_feeds(program, feed)
        local, specs = {}, {}
        for name, value in feed.items():
            t = self._feed_tensor(program, name, value)
            local[name], specs[name] = self._put_feed(name, t)
        prepared = self._cached_prepared(program, local, fetch_names,
                                         self._scope)
        bn_local = self._bn_local_stats
        if bn_local is None:
            bn_local = bool(get_flag('bn_local_stats'))
        params = [p.name for p in program.global_block().all_parameters()
                  if getattr(p, 'trainable', True)]
        st = DistState(self.mesh, self._rank, self._storage, params,
                       self._gathered, self._state_specs, bn_local)
        st.layouts.update(specs)
        st.feed_spec = self._feed_spec
        st.feed_is_local = self._local_feeds
        with C.recording() as recs:
            results = self._run_prepared(prepared, local, self._scope,
                                         program, False, dist=st)
            out = []
            for name, val in zip(fetch_names, results):
                if name in st.partial:
                    st.sync_partials(local, [name])
                    val = local[name]
                out.append(self._gather_value(name, val, st))
        self._records = recs
        self._param_gathers = list(st.param_gathers)
        if return_numpy:
            return [_to_numpy(r) for r in out]
        return [_detached(r, False) for r in out]

