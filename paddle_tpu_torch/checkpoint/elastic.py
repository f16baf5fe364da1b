"""Elastic mesh recovery: the Trainer-facing face of the sharded
checkpoints (counterpart of paddle_tpu/checkpoint/elastic.py:1-99).

`MeshCheckpointer` binds a checkpoint root to a training scope: it knows
which scope vars are checkpointable (persistable, not `is_cache`: the
serving K/V rings are runtime state, not weights), snapshots this rank's
shards of them through `AsyncShardedSaver`, and on restart pours the
last committed generation back into the scope. The Supervisor contract
is the pserver mode's: a restarted rank comes up with a higher
FLAGS_trainer_incarnation, the OWNER claim fences out any zombie of the
old incarnation, the trainer fast-forwards its reader to
extras['step_id'] + 1, and the run is bit-exact against a fault-free
one.

On a mesh (`pe`, a ParallelExecutor over ranks) each value in the scope
is the rank's part under the executor's storage spec, and is saved as
that shard (sharded.local_shard). Restored values land in the scope as
whole host tensors; the ParallelExecutor places them (each rank keeps
its part) on its next run, which is exact, so bit-exactness survives the
round trip even onto another mesh than the one that saved.
"""
from __future__ import annotations

from .. import io as io_mod
from . import restore as restore_mod
from .sharded import AsyncShardedSaver, local_shard

__all__ = ['MeshCheckpointer']


class MeshCheckpointer(object):

    def __init__(self, root, incarnation=None, workers=None):
        self.root = root
        self._incarnation = incarnation
        self._workers = workers
        self._saver = None

    def _get_saver(self):
        # lazy: the OWNER claim happens on the first save, not at
        # construction; a restore-only user (a predictor loading weights)
        # must not fence out the trainer that owns the root
        if self._saver is None:
            self._saver = AsyncShardedSaver(
                self.root, incarnation=self._incarnation,
                workers=self._workers)
        return self._saver

    @staticmethod
    def checkpoint_vars(scope, program):
        """{name: value} of every persistable non-cache var the scope
        holds."""
        out = {}
        for var in program.list_vars():
            if not io_mod.is_persistable(var):
                continue
            val = scope.find_var(var.name)
            if val is not None:
                out[var.name] = val
        return out

    def save_scope(self, scope, program, extras=None, block=False, pe=None):
        """Snapshot the scope's checkpointable vars (this rank's shards of
        them, with `pe` a ParallelExecutor over ranks) as the next
        generation; returns the generation number."""
        arrays = self.checkpoint_vars(scope, program)
        mesh = getattr(pe, 'mesh', None)
        if mesh is not None:
            arrays = {n: local_shard(v, pe.storage_spec(n), mesh, pe._rank)
                      for n, v in arrays.items()}
        return self._get_saver().save(arrays, extras=extras, block=block)

    def restore_scope(self, scope, program, mesh=None):
        """Pour the newest good generation into the scope: only vars the
        program declares persistable (a stale manifest var is ignored);
        with `mesh`, each as this rank's shard on it. Returns the
        checkpoint's extras dict, or None when there is nothing to
        restore."""
        ckpt = restore_mod.load_checkpoint(self.root)
        if ckpt is None:
            return None
        wanted = {v.name for v in program.list_vars()
                  if io_mod.is_persistable(v)}
        for name in ckpt.var_names():
            if name not in wanted:
                continue
            if mesh is not None:
                scope.set_var(name, ckpt.as_torch(name, mesh))
            else:
                scope.set_var(name, ckpt.read(name))
        return dict(ckpt.extras or {})

    def wait(self):
        if self._saver is not None:
            self._saver.wait()

    def close(self):
        if self._saver is not None:
            self._saver.close()
            self._saver = None

    @property
    def last_stats(self):
        return self._saver.last_stats if self._saver is not None else None
