"""Topology-change restore of sharded checkpoints (counterpart of
paddle_tpu/checkpoint/restore.py:1-225; the same format).

A generation written by checkpoint/sharded.py (by either package) is
self-describing: MANIFEST.json records, per var, the global shape, the
dtype, the spec and the index box of each shard file. Restore never
needs the saving mesh: `read_slice` assembles any region of a var from
the shard files that overlap it, and `as_torch` (the counterpart of the
JAX package's `as_jax`) returns one rank's local shard under the
recorded spec adapted to the new mesh by parallel.mesh.fit_spec, read
straight from the overlapping files: the whole value is never built on
the host. Values come back as CPU tensors (bf16 from its raw 16-bit
words), on `device` when one is given.

Trust order is the JAX package's: `current/` is eligible only if its
`COMMIT` marker exists and every file matches `CHECKPOINT_DIGESTS`; a
generation that fails is quarantined aside (statefile.quarantine_dir)
and `current.prev/` is tried next; a missing COMMIT is skipped without
quarantine; both bad gives None.
"""
from __future__ import annotations

import json
import os
import time

import numpy as np
import torch

from ..distributed import statefile
from ..obs import telemetry, trace
from ..parallel import mesh as mesh_mod
from . import manifest
from .sharded import (COMMIT_FILE, CURRENT_DIR, MANIFEST_FILE, PREV_DIR,
                      TORCH_DTYPES, local_index)

__all__ = ['ShardedCheckpoint', 'load_checkpoint', 'restore_sharded']

_RESTORE_LATENCY = telemetry.histogram('ckpt.restore_latency')

# numpy dtypes of the files' raw words (bf16: its 16-bit words)
_WORDS = {'bfloat16': np.int16}


def _words(name):
    return np.dtype(_WORDS.get(name, name))


def _to_torch(arr, name):
    # np.asarray(order='C'), not ascontiguousarray: the latter promotes
    # 0-d (scalar vars) to 1-d
    arr = np.asarray(arr, order='C')
    if not arr.flags.writeable:
        arr = arr.copy()
    t = torch.from_numpy(arr)
    if name == 'bfloat16':
        t = t.view(torch.bfloat16)
    return t


class ShardedCheckpoint(object):
    """One committed, digest-verified generation, opened for reading."""

    def __init__(self, dirname, man):
        self.dirname = dirname
        self.manifest = man
        self.generation = int(man.get('generation', 0))
        self.extras = man.get('extras', {})
        self._vars = man['vars']

    def var_names(self):
        return sorted(self._vars)

    def __contains__(self, name):
        return name in self._vars

    def spec_of(self, name):
        spec = self._vars[name]['spec']
        if spec is None:
            return None
        return tuple(tuple(e) if isinstance(e, list) else e for e in spec)

    def shape_of(self, name):
        return tuple(self._vars[name]['shape'])

    def dtype_of(self, name):
        """The var's torch dtype."""
        return TORCH_DTYPES[self._vars[name]['dtype']]

    def _read_shard(self, rec, name):
        entry = self._vars[name]
        words = _words(entry['dtype'])
        box = rec['index']
        shard_shape = tuple(int(b[1]) - int(b[0]) for b in box)
        path = os.path.join(self.dirname, rec['file'])
        with open(path, 'rb') as f:
            data = f.read()
        want = int(np.prod(shard_shape, dtype=np.int64)) * words.itemsize \
            if shard_shape else words.itemsize
        if len(data) != want:
            raise manifest.CheckpointCorruptError(
                'shard file %s for var %s holds %d bytes, expected %d'
                % (rec['file'], name, len(data), want),
                path=self.dirname, file=rec['file'], var=name)
        return np.frombuffer(data, dtype=words).reshape(shard_shape)

    def _read_words(self, name, index):
        entry = self._vars[name]
        shape = tuple(entry['shape'])
        req = []
        for sl, dim in zip(index, shape):
            start, stop, _ = sl.indices(dim)
            req.append((int(start), int(stop)))
        out_shape = tuple(b - a for a, b in req)
        out = np.empty(out_shape, dtype=_words(entry['dtype']))
        covered = 0
        for rec in entry['shards']:
            box = [(int(b[0]), int(b[1])) for b in rec['index']]
            inter = [(max(a0, b0), min(a1, b1))
                     for (a0, a1), (b0, b1) in zip(req, box)]
            if any(a >= b for a, b in inter):
                continue
            shard = self._read_shard(rec, name)
            src = tuple(slice(a - b0, b - b0)
                        for (a, b), (b0, _b1) in zip(inter, box))
            dst = tuple(slice(a - r0, b - r0)
                        for (a, b), (r0, _r1) in zip(inter, req))
            out[dst] = shard[src]
            covered += int(np.prod([b - a for a, b in inter],
                                   dtype=np.int64)) if inter else 1
        want = int(np.prod(out_shape, dtype=np.int64)) if out_shape else 1
        if not out_shape and entry['shards']:
            # rank 0: a single shard file holds the scalar
            out = self._read_shard(entry['shards'][0], name).reshape(())
            covered = 1
        if covered < want:
            raise manifest.CheckpointCorruptError(
                'shard files for var %s cover only %d of %d elements of '
                'region %r' % (name, covered, want, req),
                path=self.dirname, var=name)
        return out

    def read_slice(self, name, index):
        """The region `index` (a tuple of slices over the global shape)
        of var `name`, a CPU tensor assembled from the shard files that
        overlap it. Host memory: the region, never more."""
        return _to_torch(self._read_words(name, index),
                         self._vars[name]['dtype'])

    def read(self, name):
        """The whole value of `name` as one CPU tensor (reference
        comparisons, the host path). For a rank of a mesh use
        `as_torch`, which reads the rank's region only."""
        shape = self.shape_of(name)
        return self.read_slice(name, tuple(slice(0, d) for d in shape))

    def as_torch(self, name, mesh, spec=None, rank=None, device=None):
        """The rank's local shard of `name` on `mesh` (the JAX package's
        as_jax, for one rank): spec defaults to the recorded one,
        adapted by fit_spec to the new topology; only that region is
        read. rank: default the process group's."""
        shape = self.shape_of(name)
        if spec is None:
            spec = self.spec_of(name)
        spec = mesh_mod.fit_spec(spec, shape, mesh)
        if rank is None:
            import torch.distributed as dist
            rank = dist.get_rank() if dist.is_available() and \
                dist.is_initialized() else 0
        t = self.read_slice(name, local_index(shape, spec, mesh, rank))
        return t.to(device) if device is not None else t


def _try_open(dirname):
    """-> ShardedCheckpoint | None (missing) | str reason (corrupt)."""
    if not os.path.isdir(dirname):
        return None
    if not os.path.exists(os.path.join(dirname, COMMIT_FILE)):
        return 'no COMMIT marker (save never finished)'
    man = None

    def _var_of(rel):
        if not man:
            return None
        for vname, entry in man.get('vars', {}).items():
            if any(rec['file'] == rel for rec in entry['shards']):
                return vname
        return None

    try:
        with open(os.path.join(dirname, MANIFEST_FILE)) as f:
            man = json.load(f)
    except (OSError, ValueError) as e:
        return 'unreadable MANIFEST.json: %r' % e
    reason = manifest.verify_digests(dirname, var_of=_var_of)
    if reason is not None:
        return reason
    return ShardedCheckpoint(dirname, man)


def load_checkpoint(root, quarantine=True):
    """Open the newest trustworthy generation under `root`: `current/`,
    else (after quarantining the corrupt dir aside) `current.prev/`,
    else None. A generation with no COMMIT marker is skipped silently:
    an unfinished save is expected after a crash, not corruption."""
    t0 = time.time()
    ckpt = None
    with trace.span('ckpt.restore.open', root=root):
        for sub in (CURRENT_DIR, PREV_DIR):
            dirname = os.path.join(root, sub)
            got = _try_open(dirname)
            if isinstance(got, ShardedCheckpoint):
                ckpt = got
                break
            if isinstance(got, str):
                if 'COMMIT' in got:
                    continue
                if quarantine:
                    statefile.quarantine_dir(dirname, got)
    if ckpt is not None:
        _RESTORE_LATENCY.observe(time.time() - t0)
    return ckpt


def restore_sharded(root, mesh=None, specs=None, names=None, rank=None,
                    device=None):
    """Open the newest good generation and return ({name: value},
    extras, generation): with `mesh`, each value is this rank's local
    shard on it (as_torch), else the whole value; CPU tensors unless
    `device` is given. `specs` overrides the recorded spec per var;
    `names` restricts the load. (None, None, 0) when no generation is
    loadable."""
    ckpt = load_checkpoint(root)
    if ckpt is None:
        return None, None, 0
    out = {}
    with trace.span('ckpt.restore.read', gen=ckpt.generation):
        for name in (names if names is not None else ckpt.var_names()):
            if mesh is not None:
                out[name] = ckpt.as_torch(name, mesh,
                                          spec=(specs or {}).get(name),
                                          rank=rank, device=device)
            else:
                t = ckpt.read(name)
                out[name] = t.to(device) if device is not None else t
    return out, ckpt.extras, ckpt.generation
