"""The multi-process runtime (counterpart of
paddle_tpu/parallel/distributed.py:12-208).

One process a rank: init_parallel_env opens a torch.distributed process
group over the job's trainers, which the JAX package's
jax.distributed.initialize does over its controllers. The env contract
is the JAX package's (and the reference's, trainer.py:329-377):

  PADDLE_TRAINER_ID          this process's rank
  PADDLE_TRAINERS_NUM        world size (PADDLE_TRAINERS also accepted)
  PADDLE_TRAINER_ENDPOINTS   comma list host:port; the first is the
                             coordinator (tcp://<first endpoint>)

Besides it, PADDLE_DIST_INIT_METHOD (e.g. file:///tmp/x/store) names the
rendezvous instead of the first endpoint (the tests use a FileStore so
that concurrent test workers never share a port), and
PADDLE_DIST_TIMEOUT the seconds a collective may wait (default 1800).

The backend rule: NCCL where each rank has a card of its own (CUDA
ranks, and at least as many cards as ranks on the host), gloo where
ranks share a card or run on the CPU (NCCL refuses two ranks on one
device). The choice is logged to stderr once; nothing switches the
backend after a failure.
"""
from __future__ import annotations

import os
import sys

import numpy as np
import torch
import torch.distributed as dist

__all__ = ['init_parallel_env', 'is_initialized', 'trainer_id',
           'num_trainers', 'backend_for', 'local_batch_to_global',
           'host_value_to_global', 'shard_rows_for_process']


def is_initialized():
    return dist.is_available() and dist.is_initialized()


def trainer_id():
    if is_initialized():
        return dist.get_rank()
    return int(os.environ.get('PADDLE_TRAINER_ID', 0))


def num_trainers():
    if is_initialized():
        return dist.get_world_size()
    return int(os.environ.get('PADDLE_TRAINERS_NUM',
                              os.environ.get('PADDLE_TRAINERS', 1)))


def backend_for(use_cuda, world_size):
    """(backend, reason) by the module's rule."""
    if not use_cuda:
        return 'gloo', 'ranks on the CPU'
    cards = torch.cuda.device_count()
    if cards >= world_size:
        return 'nccl', '%d ranks, %d cards: a card a rank' % (world_size,
                                                               cards)
    return 'gloo', '%d ranks share %d card(s)' % (world_size, cards)


def init_parallel_env(trainer_id=None, num_trainers=None, endpoints=None,
                      coordinator=None, use_cuda=False, init_method=None):
    """Connect this process to the job. Arguments override the PADDLE_*
    env contract. A no-op when the world size is 1 or the process group
    is already up. use_cuda: whether the ranks run on cards (the
    backend rule)."""
    if is_initialized():
        return
    if trainer_id is None:
        trainer_id = int(os.environ.get('PADDLE_TRAINER_ID', 0))
    if num_trainers is None:
        num_trainers = int(os.environ.get(
            'PADDLE_TRAINERS_NUM', os.environ.get('PADDLE_TRAINERS', 1)))
    if num_trainers <= 1:
        return
    if init_method is None:
        init_method = os.environ.get('PADDLE_DIST_INIT_METHOD') or None
    if init_method is None:
        if coordinator is None:
            if endpoints is None:
                eps = os.environ.get('PADDLE_TRAINER_ENDPOINTS', '')
                endpoints = [e for e in eps.split(',') if e]
            if not endpoints:
                raise ValueError(
                    'multi-trainer init needs PADDLE_TRAINER_ENDPOINTS (or '
                    'an explicit coordinator address)')
            coordinator = endpoints[0]
        init_method = 'tcp://%s' % coordinator
    import datetime
    timeout = datetime.timedelta(seconds=float(
        os.environ.get('PADDLE_DIST_TIMEOUT', 1800)))
    backend, why = backend_for(use_cuda, num_trainers)
    if trainer_id == 0:
        sys.stderr.write('init_parallel_env: backend %s (%s), %d ranks, '
                         'rendezvous %s\n' % (backend, why, num_trainers,
                                               init_method))
    dist.init_process_group(backend, init_method=init_method,
                            rank=int(trainer_id),
                            world_size=int(num_trainers), timeout=timeout)


# -- host <-> rank helpers (the feed split and BCast analogs) -----------------

def _shard_index(mesh, names, rank):
    coord = mesh.coordinate(rank)
    idx, total = 0, 1
    for nm in names:
        idx = idx * mesh.shape[nm] + coord[nm]
        total *= mesh.shape[nm]
    return idx, total


def shard_rows_for_process(arr, mesh, axis_entry):
    """The rows of `arr` this rank holds when dim 0 is sharded over
    `axis_entry` (an axis name or tuple of names): its contiguous chunk
    by its coordinate along those axes."""
    names = axis_entry if isinstance(axis_entry, tuple) else (axis_entry,)
    names = tuple(n for n in names if n in mesh.shape)
    idx, total = _shard_index(mesh, names, trainer_id())
    rows = arr.shape[0]
    if rows % total != 0:
        raise ValueError('dim0=%d not divisible by %d shards along %r'
                         % (rows, total, names))
    per = rows // total
    return arr[idx * per:(idx + 1) * per]


def host_value_to_global(arr, mesh, spec):
    """A host value present identically on every rank -> this rank's
    shard of it under `spec` (the ncclBcast analog: each rank keeps the
    part its placement holds)."""
    from .layout import local_part, normalize
    arr = np.asarray(arr)
    return local_part(torch.from_numpy(np.ascontiguousarray(arr)),
                      normalize(spec, arr.ndim, mesh), mesh,
                      trainer_id()).numpy()


def local_batch_to_global(arr, mesh, spec):
    """This rank's part of a batch -> the whole batch (numpy) on every
    rank: the parts gathered along the dims that `spec` shards."""
    from . import collectives as C
    from .layout import normalize
    t = torch.as_tensor(np.ascontiguousarray(np.asarray(arr)))
    sp = normalize(spec, t.ndim, mesh)
    for d in range(t.ndim):
        for ax in reversed(sp[d]):
            t = C.gather(t, d, C.axis(mesh, ax))
    return t.numpy()
