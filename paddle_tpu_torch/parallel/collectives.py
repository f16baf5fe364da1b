"""The collectives of a mesh run, and their autograd forms.

Every collective goes through this module: it runs on the process group
of one mesh axis (Mesh.device_mesh.get_group(axis)), is appended to the
record that profiler.collective_audit reads, and, where the backend
cannot take the tensor where it lies, goes through a host buffer.

Which collectives go through the host is a fixed table, not a retry:
under gloo, all_reduce, broadcast, all_gather_into_tensor,
reduce_scatter_tensor and all_to_all_single take CUDA tensors, and
send/recv do not (a CUDA tensor given to gloo's send fails with
"writev ... Bad address" and leaves the pair broken; torch 2.11,
H100, chip_smoke mp1's probe). So under gloo the ring's send/recv copy
each block through a pinned host buffer and back; over NCCL nothing is
staged. A collective that fails raises: nothing takes another path
after a failure.

The autograd forms keep the invariants the layout rules rely on
(parallel/layout.py): the gradient of a replicated value is complete and
the same on every rank, and the gradient of a shard is complete for the
shard.
- all_reduce_sum: forward all-reduce, backward identity (the output is
  replicated and its consumers are too);
- sync_sum: forward all-reduce, backward all-reduce (the output is
  consumed by sharded work, so its gradient arrives in parts);
- copy_in: forward identity, backward all-reduce (a replicated input of
  sharded work: Megatron's f);
- gather: forward all-gather along a dim, backward the rank's chunk;
- gather_summed: forward all-gather, backward reduce-scatter (a shard
  gathered for sharded work: ZeRO-3's parameter gather);
- chunk: forward the rank's chunk of a replicated value, backward
  all-gather;
- all_to_all: forward and backward the same exchange of dim-0 chunks.

isend and irecv are the pipeline's point-to-point path (parallel/
pipeline.py): one tensor to or from one rank of an axis, started at once
and completed by the handle's wait(); under gloo a CUDA tensor goes
through a pinned host buffer, as the ring's does.
"""
from __future__ import annotations

import contextlib
import time
import warnings

import torch
import torch.distributed as dist

__all__ = ['Axis', 'axis', 'record', 'recording', 'all_reduce_sum',
           'sync_sum', 'copy_in', 'gather', 'gather_summed', 'chunk',
           'all_to_all', 'ring_shift', 'isend', 'irecv',
           'GLOO_CUDA_HOST_STAGED']

# collectives that gloo refuses on CUDA tensors (module docstring)
GLOO_CUDA_HOST_STAGED = frozenset({'send', 'recv'})

# kind names of profiler.collective_audit (the JAX package's five)
KINDS = ('all-reduce', 'all-gather', 'reduce-scatter',
         'collective-permute', 'all-to-all')

_RECORDS = None


@contextlib.contextmanager
def recording():
    """Collect a record of each collective issued inside: a list of
    dicts {kind, axis, bytes, seconds, staged}."""
    global _RECORDS
    prev, _RECORDS = _RECORDS, []
    out = _RECORDS
    try:
        yield out
    finally:
        _RECORDS = prev
        if prev is not None:
            prev.extend(out)


def record(kind, axis_name, nbytes, seconds=0.0, staged=False, **extra):
    if _RECORDS is not None:
        rec = {'kind': kind, 'axis': axis_name, 'bytes': int(nbytes),
               'seconds': float(seconds), 'staged': bool(staged)}
        rec.update(extra)
        _RECORDS.append(rec)


def _nbytes(t):
    return t.numel() * t.element_size()


class Axis(object):
    """One mesh axis as this rank sees it: its process group, size, this
    rank's index along it, and the global ranks of the group."""

    def __init__(self, mesh, name, rank):
        self.name = name
        self.size = mesh.shape[name]
        self.index = mesh.coordinate(rank)[name]
        self.ranks = mesh.axis_ranks(name, rank)
        self.group = mesh.device_mesh.get_group(name)
        self.gloo = dist.get_backend(self.group) == 'gloo'


_AXES = {}


def axis(mesh, name):
    """The Axis `name` of `mesh` for this process's rank (cached)."""
    key = (id(mesh), name)
    ax = _AXES.get(key)
    if ax is None or ax._mesh is not mesh:
        ax = Axis(mesh, name, dist.get_rank())
        ax._mesh = mesh
        _AXES[key] = ax
    return ax


# -- plain collectives --------------------------------------------------------

def _quiet(fn, *args, **kwargs):
    with warnings.catch_warnings():
        warnings.simplefilter('ignore', FutureWarning)
        return fn(*args, **kwargs)


def _all_reduce(t, ax):
    t = t.contiguous()
    t0 = time.perf_counter()
    dist.all_reduce(t, group=ax.group)
    record('all-reduce', ax.name, _nbytes(t), time.perf_counter() - t0)
    return t


def _all_gather(t, dim, ax):
    t = t.contiguous()
    flat = t.reshape((1,) + tuple(t.shape)) if t.ndim == 0 else t
    out = torch.empty((ax.size * flat.shape[0],) + tuple(flat.shape[1:]),
                      dtype=t.dtype, device=t.device)
    t0 = time.perf_counter()
    _quiet(dist.all_gather_into_tensor, out, flat, group=ax.group)
    record('all-gather', ax.name, _nbytes(out), time.perf_counter() - t0)
    parts = out.reshape((ax.size,) + tuple(t.shape)).unbind(0)
    return torch.cat(parts, dim)


def _reduce_scatter(t, dim, ax):
    parts = torch.stack(t.chunk(ax.size, dim), 0).contiguous()
    out = torch.empty(parts.shape[1:], dtype=t.dtype, device=t.device)
    t0 = time.perf_counter()
    _quiet(dist.reduce_scatter_tensor, out.reshape(
        (-1,) + tuple(out.shape[1:])) if out.ndim else out.reshape(1),
        parts.reshape((-1,) + tuple(parts.shape[2:])) if out.ndim
        else parts.reshape(-1), group=ax.group)
    record('reduce-scatter', ax.name, _nbytes(out),
           time.perf_counter() - t0)
    return out


def _all_to_all(t, ax):
    t = t.contiguous()
    out = torch.empty_like(t)
    t0 = time.perf_counter()
    dist.all_to_all_single(out, t, group=ax.group)
    record('all-to-all', ax.name, _nbytes(out), time.perf_counter() - t0)
    return out


def _local_chunk(t, dim, ax):
    if t.shape[dim] % ax.size:
        raise ValueError('dim %d of size %d does not divide over axis %r '
                         'of size %d' % (dim, t.shape[dim], ax.name,
                                         ax.size))
    return t.chunk(ax.size, dim)[ax.index]


def ring_shift(tensors, ax):
    """Send each tensor to the previous rank along `ax` and receive the
    next rank's (the JAX package's ppermute with perm j -> j - 1,
    paddle_tpu/parallel/ring_attention.py:96-103): one
    batch_isend_irecv. Under gloo a CUDA tensor goes through a pinned
    host buffer (GLOO_CUDA_HOST_STAGED). Returns the received tensors."""
    n = ax.size
    prev_rank = ax.ranks[(ax.index - 1) % n]
    next_rank = ax.ranks[(ax.index + 1) % n]
    staged = ax.gloo and tensors[0].device.type == 'cuda' and \
        {'send', 'recv'} <= GLOO_CUDA_HOST_STAGED
    if staged:
        torch.cuda.current_stream(tensors[0].device).synchronize()
    t0 = time.perf_counter()
    sends, recvs = [], []
    for t in tensors:
        t = t.contiguous()
        if staged:
            h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            h.copy_(t)
            t = h
        sends.append(t)
        recvs.append(torch.empty_like(t))
    ops = []
    for s, r in zip(sends, recvs):
        ops.append(dist.P2POp(dist.isend, s, prev_rank, ax.group))
        ops.append(dist.P2POp(dist.irecv, r, next_rank, ax.group))
    for w in dist.batch_isend_irecv(ops):
        w.wait()
    if staged:
        recvs = [r.to(tensors[0].device, non_blocking=True) for r in recvs]
    dt = time.perf_counter() - t0
    for r in recvs:
        record('collective-permute', ax.name, _nbytes(r), dt / len(recvs),
               staged)
    return recvs


class _P2P(object):
    """One started send or receive; wait() completes it (a receive
    returns the tensor on its device) and records it as a
    'collective-permute' with the seconds this rank waited and its
    direction."""

    def __init__(self, work, host, out, device, ax, nbytes, staged, dir_):
        self.work, self.host, self.out = work, host, out
        self.device, self.ax, self.nbytes = device, ax, nbytes
        self.staged, self.dir = staged, dir_

    def wait(self):
        t0 = time.perf_counter()
        self.work.wait()
        out = self.out
        if self.dir == 'recv' and self.staged:
            out = self.host.to(self.device, non_blocking=True)
        record('collective-permute', self.ax.name, self.nbytes,
               time.perf_counter() - t0, self.staged, dir=self.dir)
        self.work = self.host = None
        return out


def _p2p_staged(ax, device):
    return ax.gloo and device.type == 'cuda' and \
        {'send', 'recv'} <= GLOO_CUDA_HOST_STAGED


def isend(t, ax, dst_index, tag=0):
    """Start sending `t` to the rank at index `dst_index` of `ax`."""
    t = t.detach().contiguous()
    staged = _p2p_staged(ax, t.device)
    buf = t
    if staged:
        # a blocking copy: the tensor's producers are done before it
        buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        buf.copy_(t)
    work = dist.isend(buf, ax.ranks[dst_index], group=ax.group, tag=tag)
    return _P2P(work, buf, None, t.device, ax, _nbytes(t), staged, 'send')


def irecv(shape, dtype, device, ax, src_index, tag=0):
    """Start receiving a tensor of `shape` and `dtype` for `device` from
    the rank at index `src_index` of `ax`."""
    device = torch.device(device)
    staged = _p2p_staged(ax, device)
    if staged:
        host = torch.empty(tuple(shape), dtype=dtype, pin_memory=True)
        out = None
    else:
        host = out = torch.empty(tuple(shape), dtype=dtype, device=device)
    work = dist.irecv(host, ax.ranks[src_index], group=ax.group, tag=tag)
    return _P2P(work, host, out, device, ax, host.numel() *
                host.element_size(), staged, 'recv')


# -- autograd forms -----------------------------------------------------------

class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax):
        return _all_reduce(x.clone(), ax)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SyncSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax):
        ctx.ax = ax
        return _all_reduce(x.clone(), ax)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g.clone(), ctx.ax), None


class _CopyIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax):
        ctx.ax = ax
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g.clone(), ctx.ax), None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, ax):
        ctx.dim, ctx.ax = dim, ax
        return _all_gather(x, dim, ax)

    @staticmethod
    def backward(ctx, g):
        return _local_chunk(g, ctx.dim, ctx.ax).contiguous(), None, None


class _GatherSummed(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, ax):
        ctx.dim, ctx.ax = dim, ax
        return _all_gather(x, dim, ax)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.dim, ctx.ax), None, None


class _Chunk(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, ax):
        ctx.dim, ctx.ax = dim, ax
        return _local_chunk(x, dim, ax).contiguous()

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.dim, ctx.ax), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax):
        ctx.ax = ax
        return _all_to_all(x, ax)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, ctx.ax), None


def _grad_aware(t):
    return torch.is_grad_enabled() and t.requires_grad


def all_reduce_sum(x, ax):
    if _grad_aware(x):
        return _AllReduceSum.apply(x, ax)
    return _all_reduce(x.clone(), ax)


def sync_sum(x, ax):
    if _grad_aware(x):
        return _SyncSum.apply(x, ax)
    return _all_reduce(x.clone(), ax)


def copy_in(x, ax):
    if _grad_aware(x):
        return _CopyIn.apply(x, ax)
    return x


def gather(x, dim, ax):
    if _grad_aware(x):
        return _Gather.apply(x, dim, ax)
    return _all_gather(x, dim, ax)


def gather_summed(x, dim, ax):
    if _grad_aware(x):
        return _GatherSummed.apply(x, dim, ax)
    return _all_gather(x, dim, ax)


def chunk(x, dim, ax):
    if _grad_aware(x):
        return _Chunk.apply(x, dim, ax)
    return _local_chunk(x, dim, ax)


def all_to_all(x, ax):
    """Exchange dim-0 chunks: chunk i goes to the i-th rank of the axis,
    and the i-th chunk of the result came from it."""
    if _grad_aware(x):
        return _AllToAll.apply(x, ax)
    return _all_to_all(x, ax)


def reduce_scatter(x, dim, ax):
    """The rank's chunk of the sum over the axis (no autograd form: the
    gradient sync of parameters uses it)."""
    return _reduce_scatter(x, dim, ax)
