"""High-level Trainer with periodic checkpointing and exact-step resume
(counterpart of paddle_tpu/trainer.py; the reference's
python/paddle/fluid/trainer.py Trainer :169, CheckpointConfig :100,
_save_checkpoint :558, _load_checkpoint/clean_checkpoint :600-641):

- one Program pair built from the user's train_func/optimizer_func, run
  by an Executor on CUDAPlace(0) unless the caller passes a place
  (CPUPlace() for the CPU), or with parallel=True by the port's
  one-device ParallelExecutor;
- a checkpoint `<checkpoint_dir>/checkpoint_<n>/` = save_persistables
  (params, optimizer accumulators, batch-norm statistics) + a
  TRAINER_METADATA json (epoch, step, and the executor's random state)
  + a CHECKPOINT_DIGESTS manifest over every file, then a `_SUCCESS`
  marker written LAST, so a checkpoint interrupted mid-write is never
  resumed from; the oldest are pruned past max_num_checkpoints;
- resume restores the scope AND the random state from the newest valid
  checkpoint (one whose digests fail is quarantined, one that does not
  load is skipped), then the training loop fast-forwards the reader to
  the exact step, so a killed-and-restarted run continues with the same
  losses, bit for bit;
- fault handling (distributed/resilience.py): a retryable step failure
  re-runs the step in place, a fatal one rolls back to the last SUCCESS
  checkpoint; the numeric-anomaly guard (FLAGS_anomaly_action) appends
  one fused `isfinite` over the loss and every dense float gradient and
  skips, rolls back or raises on a non-finite step; every FaultEvent
  lands in the `trainer.fault.<action>` counters and the trace log.

The random state. The JAX package checkpoints its executor's step counter
and base key. The port's executor draws from torch generators instead,
so TRAINER_METADATA holds `rng`: the train program's random_seed, the
executor's generator state (get_state(), as a list of bytes) and the
state of each remat_block's generator pair, keyed by its sub_block (a
program's uid does not survive a restart). A resume sets them on the
executor before its next run, in place on the generators it already
holds, so the run that captures a graph (and every replay of a graph
that registered them) draws from the restored state.

A rollback loads persistables into the scope while the executor still
holds its captured graphs; the executor copies each loaded tensor into
the storage its graph captured before the next replay (executor.py
`_replay`), so the replay trains the restored weights.

With CheckpointConfig(pserver_endpoints=), trainer 0 has every
parameter server save its shard into each checkpoint before its SUCCESS
marker (checkpoint_notify), as the JAX package does.

The mesh path. Trainer(strategy=DistributedStrategy(...)) runs its step
through ParallelExecutor(strategy=) on every rank of the job (one
process a rank, SPMD; the process group is opened from the PADDLE_*
env contract, parallel.init_parallel_env); the Trainer of rank 0 alone
reports through EndStepEvent, as trainer_id 0 does in the pserver mode.
(In the JAX package a strategy counts only with parallel=True; here it
implies the ParallelExecutor, since a rank that ignored it would train
alone.) CheckpointConfig(sharded=True) makes checkpoint_dir a
two-generation sharded root (checkpoint/sharded.py): each rank writes
its own shards, async, with no host gather; resume pours the last
committed generation into the scope and the ParallelExecutor places it
on whatever mesh the restarted job builds. Its extras carry the port's
random state (`rng`) where the JAX package carries `rng_seed`. Without
sharded=True a mesh job keeps the host checkpoints above: every rank
gathers each persistable's whole value (ParallelExecutor.global_value,
a collective), rank 0 alone writes them, as the JAX package's one
controller writes its global arrays, and the ranks then meet at a
barrier, so no rank reads a checkpoint that is not whole yet.
Trainer.save_params writes the same way.
"""
from __future__ import annotations

import json
import os
import shutil
import sys
import time

import numpy as np
import torch

from . import io as io_mod
from .executor import CPUPlace, CUDAPlace, Executor, Scope, scope_guard
from .framework import Program, VarType, program_guard
from .obs import telemetry as _tm
from .obs import trace as _obs_trace

_STEPS = _tm.counter('trainer.steps')
_STEP_LATENCY = _tm.histogram('trainer.step_latency')

__all__ = ['Trainer', 'CheckpointConfig', 'BeginEpochEvent',
           'EndEpochEvent', 'BeginStepEvent', 'EndStepEvent',
           'FaultEvent']

_CHECKPOINT_PREFIX = 'checkpoint'
_METADATA_FILE = 'TRAINER_METADATA'
_SUCCESS_FILE = '_SUCCESS'


class BeginEpochEvent(object):
    def __init__(self, epoch_id):
        self.epoch = epoch_id


class EndEpochEvent(object):
    def __init__(self, epoch_id):
        self.epoch = epoch_id


class BeginStepEvent(object):
    def __init__(self, epoch_id, step_id):
        self.epoch = epoch_id
        self.step = step_id
        self.fetch_metrics = True


class EndStepEvent(object):
    def __init__(self, epoch_id, step_id, metrics):
        self.epoch = epoch_id
        self.step = step_id
        self.metrics = metrics


class FaultEvent(object):
    """A step hit a fault (distributed/resilience.py taxonomy). action is
    'retry' (the step re-runs in place after a retryable failure),
    'rollback' (fatal failure: scope and random state restored from the
    last SUCCESS-marked checkpoint, training resumes from there) or
    'anomaly' (the numeric guard saw a non-finite loss/gradient,
    FLAGS_anomaly_action; the step is skipped, or escalates per the
    flag); attempt counts retries, rollbacks, resp. the
    consecutive-anomaly streak. Each one bumps `trainer.fault.<action>`
    and lands in the trace log as a 'fault' event."""

    def __init__(self, epoch_id, step_id, error, action, attempt=1):
        self.epoch = epoch_id
        self.step = step_id
        self.error = error
        self.action = action
        self.attempt = attempt
        _tm.counter('trainer.fault.%s' % action).inc()
        _obs_trace.event('fault', action=action, epoch=epoch_id,
                         step=step_id, attempt=attempt,
                         error=str(error)[:200])


class CheckpointConfig(object):
    """(reference trainer.py:100) checkpoint_dir=None disables
    checkpointing; step_interval counts steps within an epoch.
    pserver_endpoints: the parameter servers trainer `trainer_id` 0 asks
    to save their shards at each checkpoint (checkpoint_notify, under
    `<checkpoint>/pserver_shards/`).

    sharded=True switches to the mesh-native path (checkpoint/):
    checkpoint_dir becomes a two-generation sharded root (current/ +
    current.prev/) written per shard with no host gather, and resume
    reshards onto whatever mesh the restarted job builds."""

    def __init__(self, checkpoint_dir=None, max_num_checkpoints=3,
                 epoch_interval=1, step_interval=10,
                 pserver_endpoints=None, trainer_id=0, sharded=False):
        self.checkpoint_dir = checkpoint_dir
        self.max_num_checkpoints = max(1, int(max_num_checkpoints))
        self.epoch_interval = max(1, int(epoch_interval))
        self.step_interval = max(1, int(step_interval))
        # pserver mode: endpoints to checkpoint_notify at each save
        # (reference trainer.py wires checkpoint_notify into the save
        # flow; DistributeTranspiler.checkpoint_notify_program builds
        # the same op for manual loops)
        self.pserver_endpoints = list(pserver_endpoints or [])
        self.trainer_id = int(trainer_id)
        self.sharded = bool(sharded)


def _poison_feed(feed):
    """The 'nan' step-fault action: NaN one element of the first float
    feed (sorted order: deterministic) so the poison flows through the
    real forward/backward into the loss and gradients. A program whose
    feeds are all integers (token ids) is left as it is."""
    feed = dict(feed)
    for key in sorted(feed):
        arr = np.asarray(feed[key])
        if arr.dtype.kind == 'f':
            arr = arr.copy()
            arr.flat[0] = np.nan
            feed[key] = arr
            break
    return feed


def _checkpoint_ids(ckpt_dir):
    if not ckpt_dir or not os.path.isdir(ckpt_dir):
        return []
    ids = []
    for name in os.listdir(ckpt_dir):
        if name.startswith(_CHECKPOINT_PREFIX + '_'):
            path = os.path.join(ckpt_dir, name)
            if os.path.exists(os.path.join(path, _SUCCESS_FILE)):
                try:
                    ids.append(int(name.split('_')[-1]))
                except ValueError:
                    continue
    return sorted(ids)


def _gen_state(gen):
    return gen.get_state().tolist()


def _set_gen_state(gen, state):
    gen.set_state(torch.tensor(state, dtype=torch.uint8))


class Trainer(object):
    """(reference trainer.py:169)

    train_func() -> loss Variable (or [loss, ...metrics]) builds the
    forward graph; optimizer_func() -> an Optimizer. place=None is
    CUDAPlace(0), which raises without a card; pass CPUPlace() for the
    CPU. strategy: a DistributedStrategy; the step runs through
    ParallelExecutor(strategy=) on every rank (module docstring).
    """

    def __init__(self, train_func, optimizer_func, place=None,
                 param_path=None, parallel=False, checkpoint_config=None,
                 strategy=None):
        self.place = place if place is not None else CUDAPlace(0)
        self.parallel = parallel or strategy is not None
        self.checkpoint_cfg = checkpoint_config
        # DistributedStrategy for the ParallelExecutor (a mesh over the
        # job's ranks, ZeRO sharding); None = the one-device executor
        self._strategy = strategy
        self._mesh_checkpointer = None
        self.scope = Scope()
        self.train_program = Program()
        self.startup_program = Program()
        from .flags import get_flag
        self._anomaly_action = str(get_flag('anomaly_action', 'none')
                                   or 'none')
        self._anomaly_skip_steps = int(get_flag('anomaly_skip_steps', 1))
        self._anomaly_streak = 0
        self._guard_var = None
        self._restored_rng = None
        self.exe = Executor(self.place)
        with program_guard(self.train_program, self.startup_program):
            outs = train_func()
            if isinstance(outs, (list, tuple)):
                self.train_outputs = list(outs)
            else:
                self.train_outputs = [outs]
            loss = self.train_outputs[0]
            optimizer = optimizer_func()
            _opt_ops, params_grads = optimizer.minimize(loss)
            if self._anomaly_action != 'none':
                self._guard_var = self._build_anomaly_guard(loss,
                                                            params_grads)
        self.loss = loss
        self._pe = None
        self.epoch_id = 0
        self.step_id = 0
        self._stop_requested = False
        with scope_guard(self.scope):
            self.exe.run(self.startup_program)
        if param_path:
            with scope_guard(self.scope):
                io_mod.load_persistables(self.exe, param_path,
                                         main_program=self.train_program)
        self._resumed = self._maybe_resume()

    def _build_anomaly_guard(self, loss, params_grads):
        """Append one fused `isfinite` reduction over the loss and every
        dense float gradient (FLAGS_anomaly_action != 'none'): a single
        scalar-bool fetch per step, computed in the step's own device
        segment (so captured with it), one cheap reduction rather than
        the op-by-op scan of FLAGS_check_nan_inf."""
        block = self.train_program.global_block()
        xs = [loss.name]
        for _param, grad in params_grads:
            if grad is None or grad.type != VarType.LOD_TENSOR:
                continue
            if not str(grad.dtype or '').startswith(('float', 'bfloat')):
                continue
            xs.append(grad.name)
        guard = block.create_var(name='_anomaly_finite_guard',
                                 dtype='bool', shape=())
        # tagged 'backward' (the JAX package leaves it untagged): it
        # reads gradients, so clone(for_test=True) must strip it, or
        # test() fails on a grad its program no longer computes
        block.append_op(type='isfinite', inputs={'X': xs},
                        outputs={'Out': [guard.name]},
                        attrs={'op_role': 'backward'})
        return guard

    # -- checkpointing -----------------------------------------------------
    def _ckpt_path(self, ckpt_id):
        return os.path.join(self.checkpoint_cfg.checkpoint_dir,
                            '%s_%d' % (_CHECKPOINT_PREFIX, ckpt_id))

    def _mesh_ckpt(self):
        if self._mesh_checkpointer is None:
            from .checkpoint import MeshCheckpointer
            self._mesh_checkpointer = MeshCheckpointer(
                self.checkpoint_cfg.checkpoint_dir)
        return self._mesh_checkpointer

    def _rank(self):
        """This process's rank in a mesh run (0 off a mesh)."""
        pe = self._pe
        return pe._rank if pe is not None and pe.mesh is not None else 0

    def _rng_state(self, executor):
        """The executor's random state for TRAINER_METADATA: the train
        program's random_seed, its generator's state (None before any
        random op drew), and each remat_block generator pair of the
        train program, keyed by sub_block."""
        gen = executor._gen
        if gen is not None and executor._gen_seed != \
                self.train_program.random_seed:
            gen = None     # the startup program's, not the train program's
        remat = []
        for (uid, sub_block), (fwd, bwd) in sorted(
                executor._remat_rng.items(), key=lambda kv: kv[0][1]):
            if uid == self.train_program._uid:
                remat.append([sub_block, _gen_state(fwd), _gen_state(bwd)])
        return {'random_seed': self.train_program.random_seed,
                'generator': None if gen is None else _gen_state(gen),
                'remat': remat}

    def _whole_values(self):
        """(scope, writes): the scope that holds each persistable's whole
        value, and whether this rank writes it. Off a mesh, the trainer's
        scope and True. On a mesh the scope holds each rank's part, so
        every rank gathers every whole value (a collective, in one order
        on every rank) into a new scope, and rank 0 alone writes."""
        pe = self._executor() if self._strategy is not None else self._pe
        if pe is None or pe.mesh is None:
            return self.scope, True
        whole = Scope()
        names = sorted(set(v.name for v in self.train_program.list_vars()
                           if io_mod.is_persistable(v) and
                           self.scope.find_var(v.name) is not None))
        for name in names:
            whole.set_var(name, pe.global_value(name))
        return whole, pe._rank == 0

    def _mesh_barrier(self):
        """On a mesh, every rank waits here for the others (after a save,
        for rank 0's files)."""
        if self._pe is not None and self._pe.mesh is not None:
            import torch.distributed as dist
            dist.barrier()

    def _train_state_extras(self, epoch_id, step_id):
        active = self._pe if self._pe is not None else self.exe
        return {'epoch_id': epoch_id, 'step_id': step_id,
                'rng': self._rng_state(active)}

    def _save_checkpoint(self, epoch_id, step_id):
        cfg = self.checkpoint_cfg
        if cfg.sharded:
            # the mesh path: this rank's shards straight from the scope,
            # async (checkpoint/sharded.py); the step blocks only for the
            # device -> host copies
            self._mesh_ckpt().save_scope(
                self.scope, self.train_program,
                extras=self._train_state_extras(epoch_id, step_id),
                pe=self._pe)
            return
        whole, writes = self._whole_values()
        if writes:
            self._save_host_checkpoint(whole, epoch_id, step_id)
        self._mesh_barrier()

    def _save_host_checkpoint(self, whole, epoch_id, step_id):
        cfg = self.checkpoint_cfg
        ids = _checkpoint_ids(cfg.checkpoint_dir)
        new_id = (ids[-1] + 1) if ids else 0
        path = self._ckpt_path(new_id)
        os.makedirs(path, exist_ok=True)
        with scope_guard(whole):
            io_mod.save_persistables(self.exe, path,
                                     main_program=self.train_program)
        with open(os.path.join(path, _METADATA_FILE), 'w') as f:
            json.dump(self._train_state_extras(epoch_id, step_id), f)
        if cfg.pserver_endpoints and cfg.trainer_id == 0:
            # pserver mode: have each parameter server save its shard
            # (params + server-side optimizer state) under this
            # checkpoint before the SUCCESS marker commits it; restore
            # happens pserver-side via
            # get_pserver_programs(checkpoint_dir=...)
            from .transpiler.distribute_transpiler import \
                build_checkpoint_notify_program
            notify = build_checkpoint_notify_program(
                os.path.join(path, 'pserver_shards'),
                cfg.pserver_endpoints, cfg.trainer_id)
            with scope_guard(self.scope):
                self.exe.run(notify)
        # digest manifest next-to-last: it covers every payload file in
        # the checkpoint (tensors, metadata, pserver shards), so resume
        # can tell corruption from a clean save (the SUCCESS marker
        # alone only proves the save COMPLETED)
        self._write_digests(path)
        # SUCCESS marker last: a partial checkpoint must never be resumed
        with open(os.path.join(path, _SUCCESS_FILE), 'w') as f:
            f.write('')
        for old in _checkpoint_ids(cfg.checkpoint_dir)[
                :-cfg.max_num_checkpoints]:
            shutil.rmtree(self._ckpt_path(old), ignore_errors=True)

    @staticmethod
    def _write_digests(path):
        """CHECKPOINT_DIGESTS: {relpath: [crc32, size]} over every file
        in the checkpoint dir (except the marker and the manifest)."""
        from .checkpoint import manifest as ckpt_manifest
        ckpt_manifest.write_digests(path)

    @staticmethod
    def _verify_checkpoint(path):
        """None if every digest matches (or the checkpoint has no
        manifest), else a reason string."""
        from .checkpoint import manifest as ckpt_manifest
        return ckpt_manifest.verify_digests(path)

    def _maybe_resume(self):
        """Restore from the newest VALID checkpoint. A dir with no
        SUCCESS marker is never considered (_checkpoint_ids); one whose
        digests fail is quarantined (renamed aside, kept for
        post-mortem); one whose metadata or tensors fail to load is
        skipped with a warning, falling back to the next-newest."""
        cfg = self.checkpoint_cfg
        if cfg is None or not cfg.checkpoint_dir:
            return False
        if cfg.sharded:
            return self._maybe_resume_sharded()
        for ckpt_id in reversed(_checkpoint_ids(cfg.checkpoint_dir)):
            path = self._ckpt_path(ckpt_id)
            try:
                reason = self._verify_checkpoint(path)
            except Exception as e:
                reason = 'unreadable digest manifest: %r' % e
            if reason is not None:
                from .distributed.statefile import quarantine_dir
                quarantine_dir(path, reason)
                continue
            try:
                with open(os.path.join(path, _METADATA_FILE)) as f:
                    meta = json.load(f)
                epoch_id = int(meta['epoch_id'])
                step_id = int(meta['step_id'])
                with scope_guard(self.scope):
                    io_mod.load_persistables(
                        self.exe, path, main_program=self.train_program)
            except Exception as e:
                print('skipping unusable checkpoint %s: %r' % (path, e),
                      file=sys.stderr)
                continue
            self.epoch_id = epoch_id
            self.step_id = step_id + 1   # resume AFTER that step
            self._restored_rng = meta.get('rng')
            self._apply_rng_state(self.exe)
            if self._pe is not None:
                self._apply_rng_state(self._pe)
                # the loaded whole values go back to their mesh layouts
                self._pe._params_placed = False
            return True
        return False

    def _maybe_resume_sharded(self):
        """The mesh path's resume: pour the last committed generation
        (digest-verified; the .prev fallback and the quarantine are
        checkpoint/restore.py's) into the scope as whole values on the
        trainer's place, and restore the train-state extras. A
        ParallelExecutor places them on its next run."""
        extras = self._mesh_ckpt().restore_scope(self.scope,
                                                 self.train_program)
        if extras is None:
            return False
        for name in self._mesh_ckpt().checkpoint_vars(self.scope,
                                                      self.train_program):
            val = self.scope.find_var(name)
            if isinstance(val, torch.Tensor):
                self.scope.set_var(name, val.to(self.place.device))
        self.epoch_id = int(extras.get('epoch_id', 0))
        self.step_id = int(extras.get('step_id', -1)) + 1
        self._restored_rng = extras.get('rng')
        self._apply_rng_state(self.exe)
        if self._pe is not None:
            self._apply_rng_state(self._pe)
            # the restored whole values go back to their mesh layouts
            self._pe._params_placed = False
        return True

    def _apply_rng_state(self, executor):
        """Set the checkpointed random state on `executor`, in place on
        the generators it already holds (a captured graph registered
        them), before its next run."""
        rng = self._restored_rng
        if not rng:
            return
        seed = rng.get('random_seed', 0)
        if rng.get('generator') is not None:
            if executor._gen is None or executor._gen_seed != seed:
                executor._gen = torch.Generator(device=executor.device)
                executor._gen_seed = seed
            _set_gen_state(executor._gen, rng['generator'])
        for sub_block, fwd_state, bwd_state in rng.get('remat', ()):
            key = (self.train_program._uid, sub_block)
            pair = executor._remat_rng.get(key)
            if pair is None:
                pair = executor._remat_rng[key] = (
                    torch.Generator(device=executor.device),
                    torch.Generator(device=executor.device))
            _set_gen_state(pair[0], fwd_state)
            _set_gen_state(pair[1], bwd_state)

    # -- training loop -----------------------------------------------------
    def _executor(self):
        if not self.parallel:
            return None
        if self._pe is None:
            from .parallel_executor import ParallelExecutor
            self._pe = ParallelExecutor(
                use_cuda=not isinstance(self.place, CPUPlace),
                loss_name=self.loss.name, main_program=self.train_program,
                scope=self.scope, strategy=self._strategy)
            self._apply_rng_state(self._pe)
        return self._pe

    def train(self, num_epochs, event_handler, reader=None,
              feed_order=None):
        """reader(): generator of feed-able batches; feed_order: the
        data-var names, matched positionally against each batch item.

        Fault handling (distributed/resilience.py taxonomy): a step that
        raises RetryableRPCError re-runs in place up to
        FLAGS_trainer_step_retries times, then escalates; a fatal
        failure rolls training back to the last SUCCESS-marked
        checkpoint (at most FLAGS_trainer_max_rollbacks times). Both
        paths emit a FaultEvent to the event handler first."""
        from .distributed.resilience import FatalRPCError
        from .flags import get_flag
        max_rollbacks = int(get_flag('trainer_max_rollbacks', 2))
        rollbacks = 0
        while True:
            try:
                result = self._train_loop(num_epochs, event_handler,
                                          reader, feed_order)
                if self._mesh_checkpointer is not None:
                    # drain the in-flight async commits (and surface an
                    # async save failure) before the caller believes the
                    # training and its checkpoints are done; on a mesh
                    # rank 0 commits, so every rank waits for it
                    self._mesh_checkpointer.wait()
                    self._mesh_barrier()
                return result
            except FatalRPCError as e:
                cfg = self.checkpoint_cfg
                if cfg is None or not cfg.checkpoint_dir or \
                        rollbacks >= max_rollbacks:
                    raise
                rollbacks += 1
                event_handler(FaultEvent(self.epoch_id, self.step_id, e,
                                         'rollback', rollbacks))
                if not self._maybe_resume():
                    raise   # no SUCCESS-marked checkpoint to fall to

    def _run_step(self, pe, fetch, feed, epoch_id, step_id,
                  event_handler):
        from .distributed import resilience
        from .flags import get_flag
        retries = int(get_flag('trainer_step_retries', 2))
        attempt = 0
        while True:
            try:
                # deterministic fault injection; 'nan' poisons one float
                # feed value so the numeric-anomaly guard sees a
                # non-finite loss computed through the real step
                if resilience.on_step() == 'nan':
                    feed = _poison_feed(feed)
                with scope_guard(self.scope):
                    if pe is not None:
                        return pe.run(fetch_list=fetch, feed=feed)
                    return self.exe.run(self.train_program, feed=feed,
                                        fetch_list=fetch)
            except resilience.RetryableRPCError as e:
                attempt += 1
                if attempt > retries:
                    raise resilience.FatalRPCError(
                        'step (%d, %d) failed after %d retries: %s'
                        % (epoch_id, step_id, retries, e)) from e
                event_handler(FaultEvent(epoch_id, step_id, e, 'retry',
                                         attempt))

    def _train_loop(self, num_epochs, event_handler, reader, feed_order):
        cfg = self.checkpoint_cfg
        start_epoch, start_step = self.epoch_id, self.step_id
        pe = self._executor()
        fetch = [v.name for v in self.train_outputs]
        if self._guard_var is not None:
            # the guard is fetched alongside the metrics (one fused
            # scalar reduction) and sliced off before events see them
            fetch = fetch + [self._guard_var.name]
        self._stop_requested = False
        for epoch_id in range(start_epoch, num_epochs):
            event_handler(BeginEpochEvent(epoch_id))
            for step_id, data in enumerate(reader()):
                if epoch_id == start_epoch and step_id < start_step:
                    continue    # fast-forward to the resumed position
                begin = BeginStepEvent(epoch_id, step_id)
                event_handler(begin)
                if self._stop_requested:
                    return
                feed = dict(zip(feed_order, data))
                _t0 = time.perf_counter()
                metrics = self._run_step(pe, fetch, feed, epoch_id,
                                         step_id, event_handler)
                _STEP_LATENCY.observe(time.perf_counter() - _t0)
                _STEPS.inc()
                if self._guard_var is not None:
                    finite = bool(np.asarray(metrics[-1]))
                    metrics = metrics[:-1]
                    if not finite:
                        self._on_anomaly(epoch_id, step_id,
                                         event_handler)
                        # skip: no EndStepEvent, no checkpoint; an
                        # anomalous step must never become a rollback
                        # target
                        self.epoch_id, self.step_id = epoch_id, step_id
                        continue
                    self._anomaly_streak = 0
                if self._rank() == 0:
                    event_handler(EndStepEvent(epoch_id, step_id, metrics))
                self.epoch_id, self.step_id = epoch_id, step_id
                if cfg and cfg.checkpoint_dir and \
                        (step_id + 1) % cfg.step_interval == 0:
                    self._save_checkpoint(epoch_id, step_id)
                if self._stop_requested:
                    return
            start_step = 0
            if cfg and cfg.checkpoint_dir and \
                    self._anomaly_streak == 0 and \
                    (epoch_id + 1) % cfg.epoch_interval == 0:
                # saved as (next epoch, step -1): resume starts cleanly at
                # epoch E+1 step 0 instead of replaying epoch E's
                # Begin/EndEpochEvent with zero steps and re-saving a
                # duplicate checkpoint
                self._save_checkpoint(epoch_id + 1, -1)
            event_handler(EndEpochEvent(epoch_id))
            if self._stop_requested:
                return

    def _on_anomaly(self, epoch_id, step_id, event_handler):
        """Numeric guard tripped: emit a FaultEvent and either tolerate
        (skip the step, up to FLAGS_anomaly_skip_steps consecutive
        times) or escalate per FLAGS_anomaly_action. A skipped step's
        UPDATE may already have poisoned the parameters: if every
        following step is anomalous too, skipping forever would train
        nothing, so 'rollback' restores the last SUCCESS checkpoint
        (known-finite params) and replays from there."""
        self._anomaly_streak += 1
        err = FloatingPointError(
            'non-finite loss/gradient at step (%d, %d) '
            '(FLAGS_anomaly_action=%s, streak %d)'
            % (epoch_id, step_id, self._anomaly_action,
               self._anomaly_streak))
        event_handler(FaultEvent(epoch_id, step_id, err, 'anomaly',
                                 self._anomaly_streak))
        if self._anomaly_streak > self._anomaly_skip_steps:
            self._anomaly_streak = 0
            if self._anomaly_action == 'rollback':
                from .distributed.resilience import FatalRPCError
                raise FatalRPCError(
                    'numeric anomaly persisted past %d skipped steps; '
                    'rolling back: %s'
                    % (self._anomaly_skip_steps, err)) from err
            raise err

    def stop(self):
        """Request the training loop exit at the next event boundary
        (reference trainer.py Trainer.stop semantics)."""
        self._stop_requested = True

    def save_params(self, param_path):
        whole, writes = self._whole_values()
        if writes:
            with scope_guard(whole):
                io_mod.save_persistables(self.exe, param_path,
                                         main_program=self.train_program)
        self._mesh_barrier()

    def test(self, reader, feed_order):
        """Mean metrics of the eval-mode program over the reader."""
        # cloned once: a fresh clone per call would be a new program,
        # prepared and captured anew each time
        if getattr(self, '_test_program', None) is None:
            self._test_program = self.train_program.clone(for_test=True)
        test_program = self._test_program
        fetch = [v.name for v in self.train_outputs]
        totals = None
        n = 0
        with scope_guard(self.scope):
            for data in reader():
                feed = dict(zip(feed_order, data))
                vals = self.exe.run(test_program, feed=feed,
                                    fetch_list=fetch)
                vals = [np.asarray(v) for v in vals]
                totals = vals if totals is None else [
                    t + v for t, v in zip(totals, vals)]
                n += 1
        return [t / max(n, 1) for t in (totals or [])]
