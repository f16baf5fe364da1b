"""Per-shard async checkpointing of a mesh run's values, no host gather
(counterpart of paddle_tpu/checkpoint/sharded.py:1-339; the same on-disk
format, so a generation either package writes restores in the other).

Each rank writes only its own shards: one flat `.bin` file a shard, raw
row-major bytes, named by _shard_filename. A shard is the rank's part of
a value under its layout (the ParallelExecutor's storage spec over the
mesh), or the whole value where the value is replicated; a box that
several ranks hold is written once, by the lowest of them (the JAX
package writes replica 0). `MANIFEST.json` records, per var, the global
shape, the dtype (ml_dtypes' name `bfloat16` for bf16, whose file holds
the raw 16-bit words), the spec in the JAX package's JSON form and the
index box of every shard file: everything a restore on any later mesh
needs (checkpoint/restore.py).

Durability is the JAX package's: a flat `CHECKPOINT_DIGESTS` crc
manifest over every payload and the manifest (checkpoint/manifest.py),
a `COMMIT` marker written last, two generations (`current/`,
`current.prev/`) rotated by rename, and an `OWNER` file that fences a
stale incarnation out (StaleIncarnationError), re-checked right before
the rotation.

The commit on several ranks. The JAX package has one controller, which
writes the manifest itself. Here every rank writes files on background
threads, where a collective would interleave with the step's own on the
same group, so the ranks meet through files: each rank writes its shard
files into the generation's staging directory, then a small record of
its shards and their digests (`.rank<r>.json`), last; rank 0's commit
thread waits for every rank's record, writes the manifest, the digests
(the records' and the manifest's) and `COMMIT`, removes the records and
rotates. A committed generation holds exactly the files of the JAX
package's.

`snapshot` copies each shard to host memory (pinned, for a card's
tensor) before the step returns: the next step overwrites the scope's
tensors in place. The largest single host allocation it makes is one
shard (`stats['max_host_bytes']`). File writes, digests, the commit and
the rotation run on FLAGS_ckpt_async_workers threads; `wait()` drains
them and re-raises an async failure.

The saver takes its rank and world explicitly (default: the process
group's, else 0 and 1), and a value as a ShardedValue (a rank's local
part with its box) or as a whole tensor, so that the per-rank write path
runs without a process group.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from .. import flags
from ..distributed import statefile
from ..distributed.resilience import StaleIncarnationError
from ..integrity import crc32
from ..obs import telemetry, trace
from . import manifest

__all__ = ['AsyncShardedSaver', 'save_sharded', 'ShardedValue',
           'local_shard', 'local_index', 'MANIFEST_FILE', 'COMMIT_FILE', 'OWNER_FILE',
           'CURRENT_DIR', 'PREV_DIR']

MANIFEST_FILE = 'MANIFEST.json'
COMMIT_FILE = 'COMMIT'
OWNER_FILE = 'OWNER'
CURRENT_DIR = 'current'
PREV_DIR = 'current.prev'
MANIFEST_FORMAT = 1
# seconds rank 0's commit waits for the other ranks' records
RECORD_TIMEOUT = 600.0

_SAVE_LATENCY = telemetry.histogram('ckpt.save_latency')
_BYTES_WRITTEN = telemetry.histogram('ckpt.bytes_written')
_GENERATIONS = telemetry.counter('ckpt.generations')

# the manifest's dtype names (numpy's, and ml_dtypes' bfloat16)
_DTYPE_NAMES = {torch.float32: 'float32', torch.float64: 'float64',
                torch.float16: 'float16', torch.bfloat16: 'bfloat16',
                torch.int64: 'int64', torch.int32: 'int32',
                torch.int16: 'int16', torch.int8: 'int8',
                torch.uint8: 'uint8', torch.bool: 'bool'}
TORCH_DTYPES = {v: k for k, v in _DTYPE_NAMES.items()}


def host_bytes(t):
    """The raw row-major bytes of a host tensor (bf16 as its 16-bit
    words)."""
    t = t.contiguous()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy().tobytes()


class ShardedValue(object):
    """One rank's part of a sharded value: `local` (a tensor), the global
    `shape`, the `spec` in the JAX package's tuple form, the `box`
    ([[start, stop], ...] over the global shape) and whether this rank
    writes it (the lowest rank holding the box)."""

    def __init__(self, local, shape, spec, box, write=True):
        self.local, self.shape, self.spec = local, tuple(shape), spec
        self.box, self.write = box, bool(write)


def local_index(shape, spec, mesh, rank):
    """The region (a tuple of slices over the global `shape`) that `rank`
    of `mesh` holds under `spec` (the JAX tuple form, or None)."""
    from ..parallel.layout import normalize
    coord = mesh.coordinate(rank)
    out = []
    for d, axes in enumerate(normalize(spec, len(shape), mesh)):
        n, idx = 1, 0
        for a in axes:
            idx = idx * mesh.shape[a] + coord[a]
            n *= mesh.shape[a]
        size = int(shape[d]) // n
        out.append(slice(idx * size, (idx + 1) * size))
    return tuple(out)


def local_shard(local, spec, mesh, rank):
    """The ShardedValue of `local`, the rank's part under `spec` (the JAX
    tuple form, or None) on `mesh`: its box from the rank's coordinate,
    and write=True only on the lowest rank holding it."""
    from ..parallel.layout import factor, normalize
    sp = normalize(spec, local.ndim, mesh)
    shape = [int(n) * factor(axes, mesh) for n, axes in zip(local.shape, sp)]
    box = _normalize_index(local_index(shape, spec, mesh, rank), shape)
    used = set(a for axes in sp for a in axes)
    coord = mesh.coordinate(rank)
    write = all(coord[a] == 0 for a in mesh.axis_names if a not in used)
    return ShardedValue(local, shape, spec if any(sp) else None, box, write)


def _spec_to_json(spec):
    """A spec (tuple form) -> the manifest's JSON list (entries: an axis
    name, a list of names for a multi-axis dim, or None); None for no
    spec."""
    if spec is None:
        return None
    out = []
    for entry in spec:
        if entry is None:
            out.append(None)
        elif isinstance(entry, (tuple, list)):
            out.append([str(e) for e in entry])
        else:
            out.append(str(entry))
    return out


def _normalize_index(index, shape):
    """Shard index (tuple of slices; replicated dims carry
    slice(None)) -> [[start, stop], ...] over the global shape."""
    out = []
    for sl, dim in zip(index, shape):
        start, stop, _step = sl.indices(dim)
        out.append([int(start), int(stop)])
    return out


def _shard_filename(name, box):
    safe = name.replace('/', '__')
    starts = '_'.join(str(b[0]) for b in box)
    return '%s.s%s.bin' % (safe, starts)


def _default_rank_world():
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


class AsyncShardedSaver(object):
    """Owns one checkpoint root for one rank; save() snapshots the rank's
    shards to host synchronously and writes and commits the generation
    asynchronously."""

    def __init__(self, root, incarnation=None, workers=None, rank=None,
                 world=None):
        self.root = root
        os.makedirs(root, exist_ok=True)
        self.incarnation = int(
            flags.get_flag('trainer_incarnation', 0)
            if incarnation is None else incarnation)
        r, w = _default_rank_world()
        self.rank = r if rank is None else int(rank)
        self.world = w if world is None else int(world)
        self._claim_owner()
        self._pool = ThreadPoolExecutor(
            max_workers=int(flags.get_flag('ckpt_async_workers', 2)
                            if workers is None else workers),
            thread_name_prefix='ckpt-save')
        self._lock = threading.Lock()   # serializes commit rotations
        self._pending = []
        self._error = None
        # generation -> the ms its snapshot blocked the step
        self._snapshot_ms = {}
        self.generation = self._last_committed_generation() + 1
        self.last_stats = None

    # -- fencing ----------------------------------------------------------

    def _owner_path(self):
        return os.path.join(self.root, OWNER_FILE)

    def _claim_owner(self):
        """Every rank refuses a root owned by a later incarnation; rank 0
        claims it."""
        self._check_fence(claim=True)
        if self.rank == 0:
            statefile.atomic_write_json(
                self._owner_path(),
                {'incarnation': self.incarnation, 'pid': os.getpid()})

    def _check_fence(self, claim=False):
        """Re-read OWNER (at the claim, and right before a commit
        rotation): a successor incarnation may have claimed the root
        while this save's write was in flight; its generations win."""
        owner = statefile.read_json(self._owner_path())
        if owner and int(owner.get('incarnation', -1)) > self.incarnation:
            if claim:
                raise StaleIncarnationError(
                    'checkpoint root %s is owned by incarnation %s; this '
                    'process is stale incarnation %d'
                    % (self.root, owner['incarnation'], self.incarnation))
            raise StaleIncarnationError(
                'fenced: checkpoint root %s now owned by incarnation %s '
                '(this process is %d)'
                % (self.root, owner['incarnation'], self.incarnation))

    # -- generation bookkeeping -------------------------------------------

    def _last_committed_generation(self):
        cur = os.path.join(self.root, CURRENT_DIR)
        if os.path.exists(os.path.join(cur, COMMIT_FILE)):
            m = statefile.read_json(os.path.join(cur, MANIFEST_FILE))
            if m:
                return int(m.get('generation', 0))
        return 0

    def _staging(self, gen):
        return os.path.join(self.root, '.staging-i%d-g%d'
                            % (self.incarnation, gen))

    # -- save -------------------------------------------------------------

    def snapshot(self, arrays):
        """Synchronous device -> host copy of this rank's shards: each
        ShardedValue it writes, and each whole value on rank 0. The only
        part that blocks the training step; its largest single host
        allocation is one shard, never a gathered value."""
        snap = {}
        max_host = 0
        for name, val in arrays.items():
            if not isinstance(val, ShardedValue):
                if not isinstance(val, torch.Tensor):
                    val = torch.as_tensor(np.asarray(val))
                val = ShardedValue(val, tuple(val.shape), None,
                                   [[0, int(d)] for d in val.shape],
                                   write=self.rank == 0)
            local = val.local
            entry = {'shape': tuple(int(d) for d in val.shape),
                     'dtype': _DTYPE_NAMES[local.dtype],
                     'spec': _spec_to_json(val.spec), 'shards': []}
            if val.write:
                host = torch.empty(tuple(local.shape), dtype=local.dtype,
                                   pin_memory=local.device.type == 'cuda')
                host.copy_(local.detach())
                max_host = max(max_host, host.numel() * host.element_size())
                entry['shards'].append((val.box, host))
            snap[name] = entry
        return snap, max_host

    def save(self, arrays, extras=None, block=False):
        """Checkpoint `arrays` ({name: ShardedValue or whole tensor}) as
        the next generation; every rank calls it with its own shards.
        `extras` is a JSON dict carried in the manifest (step counters,
        random state). Returns the generation number. With block=True
        this rank's part (and, on rank 0, the commit) completes before
        returning."""
        self._raise_pending_error()
        t0 = time.time()
        gen = self.generation
        self.generation += 1
        with trace.span('ckpt.snapshot', gen=gen):
            snap, max_host = self.snapshot(arrays)
        self._snapshot_ms[gen] = (time.time() - t0) * 1e3
        fut = self._pool.submit(self._write_and_commit, gen, snap,
                                dict(extras or {}), max_host, t0)
        self._pending.append(fut)
        self._pending = [f for f in self._pending if not f.done()]
        if block:
            fut.result()
            self._raise_pending_error()
        return gen

    def _write_and_commit(self, gen, snap, extras, max_host, t0):
        try:
            with trace.span('ckpt.write', gen=gen):
                self._do_write_and_commit(gen, snap, extras, max_host, t0)
        except BaseException as e:
            self._error = e
            raise

    def _write_shards(self, staging, gen, snap):
        """This rank's shard files, then its record, last."""
        total, files, recs = 0, {}, {}
        for name, entry in snap.items():
            shard_recs = []
            for box, host in entry['shards']:
                fname = _shard_filename(name, box)
                data = host_bytes(host)
                with statefile.atomic_replace(
                        os.path.join(staging, fname)) as f:
                    f.write(data)
                total += len(data)
                files[fname] = [crc32(data), len(data)]
                shard_recs.append({'file': fname, 'index': box})
            recs[name] = {'shape': list(entry['shape']),
                          'dtype': entry['dtype'], 'spec': entry['spec'],
                          'shards': shard_recs}
        statefile.atomic_write_json(
            os.path.join(staging, '.rank%d.json' % self.rank),
            {'generation': gen, 'incarnation': self.incarnation,
             'vars': recs, 'digests': files})
        return total, sum(len(v['shards']) for v in recs.values())

    def _gather_records(self, staging, gen):
        """Rank 0: every rank's record of generation `gen` (waiting for
        them), merged into the manifest's vars and the digests."""
        deadline = time.monotonic() + RECORD_TIMEOUT
        records = {}
        while len(records) < self.world:
            for r in range(self.world):
                if r in records:
                    continue
                rec = statefile.read_json(
                    os.path.join(staging, '.rank%d.json' % r))
                if rec and rec.get('generation') == gen and \
                        rec.get('incarnation') == self.incarnation:
                    records[r] = rec
            if len(records) < self.world:
                self._check_fence()
                if time.monotonic() > deadline:
                    raise RuntimeError(
                        'checkpoint generation %d: ranks %s wrote no record '
                        'in %g s' % (gen, sorted(set(range(self.world)) -
                                                 set(records)),
                                     RECORD_TIMEOUT))
                time.sleep(0.01)
        man_vars, digests = {}, {}
        for r in sorted(records):
            rec = records[r]
            digests.update(rec['digests'])
            for name, v in rec['vars'].items():
                cur = man_vars.setdefault(name, dict(v, shards=[]))
                cur['shards'].extend(v['shards'])
        for v in man_vars.values():
            v['shards'].sort(key=lambda s: [b[0] for b in s['index']])
        return man_vars, digests

    def _do_write_and_commit(self, gen, snap, extras, max_host, t0):
        staging = self._staging(gen)
        os.makedirs(staging, exist_ok=True)
        total_bytes, n_files = self._write_shards(staging, gen, snap)
        superseded = False
        if self.rank == 0:
            man_vars, digests = self._gather_records(staging, gen)
            path = os.path.join(staging, MANIFEST_FILE)
            statefile.atomic_write_json(path, {
                'format': MANIFEST_FORMAT,
                'generation': gen,
                'incarnation': self.incarnation,
                'time': time.time(),
                'extras': extras,
                'vars': man_vars,
            })
            for r in range(self.world):
                os.remove(os.path.join(staging, '.rank%d.json' % r))
            # digests cover every payload including the manifest; COMMIT
            # lands strictly last
            crc, size = manifest.crc32_file(path)
            digests[MANIFEST_FILE] = [crc, size]
            with open(os.path.join(staging, manifest.DIGESTS_FILE),
                      'w') as f:
                json.dump(digests, f)
            with open(os.path.join(staging, COMMIT_FILE), 'w') as f:
                f.write('%d\n' % gen)
                f.flush()
                os.fsync(f.fileno())
            with self._lock:
                self._check_fence()
                if self._last_committed_generation() >= gen:
                    # a newer generation committed while this one was
                    # writing: installing this one would roll current/
                    # back; newest wins, this one is dropped whole
                    shutil.rmtree(staging, ignore_errors=True)
                    superseded = True
                else:
                    self._rotate(staging)
        self.last_stats = {
            'generation': gen,
            'bytes': total_bytes,
            'files': n_files,
            'max_host_bytes': max_host,
            'snapshot_ms': self._snapshot_ms.pop(gen, None),
            'latency': time.time() - t0,
            'superseded': superseded,
        }
        _SAVE_LATENCY.observe(self.last_stats['latency'])
        _BYTES_WRITTEN.observe(total_bytes)
        if self.rank == 0 and not superseded:
            _GENERATIONS.inc()

    def _rotate(self, staging):
        """staging -> current, demoting current -> current.prev. A crash
        between the two renames leaves prev or current missing for a
        moment; restore tolerates both."""
        cur = os.path.join(self.root, CURRENT_DIR)
        prev = os.path.join(self.root, PREV_DIR)
        if os.path.exists(cur):
            if os.path.exists(prev):
                shutil.rmtree(prev)
            os.replace(cur, prev)
        os.replace(staging, cur)

    # -- completion -------------------------------------------------------

    def _raise_pending_error(self):
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def wait(self):
        """Drain in-flight saves; re-raise the first async failure."""
        pending, self._pending = self._pending, []
        for fut in pending:
            try:
                fut.result()
            except BaseException:
                pass   # surfaced via _raise_pending_error below
        self._raise_pending_error()

    def close(self):
        self.wait()
        self._pool.shutdown(wait=True)


def save_sharded(root, arrays, extras=None, incarnation=None):
    """One-shot blocking save (tools, tests); the Trainer holds a
    long-lived AsyncShardedSaver instead."""
    saver = AsyncShardedSaver(root, incarnation=incarnation)
    try:
        gen = saver.save(arrays, extras=extras, block=True)
    finally:
        saver.close()
    return gen
