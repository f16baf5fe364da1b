"""Checkpoints (counterpart of paddle_tpu/checkpoint/__init__.py), from
the bottom up:

  manifest.py   the CHECKPOINT_DIGESTS digest manifest shared with the
                host path (io.py, trainer.py)
  sharded.py    AsyncShardedSaver: per-shard files, no host gather, an
                async commit (a handshake through files across ranks),
                two-generation rotation, OWNER fencing
  restore.py    topology-change restore: any region of a var from the
                shard files, a rank's shard on a new mesh
  elastic.py    MeshCheckpointer: the Trainer/Supervisor wiring

The on-disk format is the JAX package's: a generation either package
writes restores in the other.
"""
from .manifest import CheckpointCorruptError, verify_digests, write_digests
from .sharded import AsyncShardedSaver, save_sharded
from .restore import ShardedCheckpoint, load_checkpoint, restore_sharded
from .elastic import MeshCheckpointer

__all__ = ['CheckpointCorruptError', 'verify_digests', 'write_digests',
           'AsyncShardedSaver', 'save_sharded', 'ShardedCheckpoint',
           'load_checkpoint', 'restore_sharded', 'MeshCheckpointer']
