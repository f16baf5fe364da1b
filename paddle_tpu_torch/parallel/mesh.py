"""Device meshes (counterpart of paddle_tpu/parallel/mesh.py:20-160).

A MeshConfig names the parallel axes and their sizes; build() lays the
ranks out over them. The JAX package builds a jax.sharding.Mesh over
the devices of one controller; here every rank is a process of its own
(parallel/distributed.py), so build() returns a Mesh over ranks: the
axes of size > 1 in the canonical order `pp, dp, ep, sp, tp` (model
axes innermost), rank r at the row-major coordinate of r, and, once the
process group is up, the torch DeviceMesh of those axes
(`Mesh.device_mesh`), whose per-axis process groups carry the
collectives (parallel/collectives.py).

A sharding spec is the JAX package's tuple form: one entry per dim, an
axis name, a tuple of names or None. named_sharding turns it into
DTensor placements over the mesh's axes (Shard(dim) for an axis named in
a dim, Replicate() otherwise); fit_spec keeps its rule for applying a
spec recorded on one mesh to another.
"""
from __future__ import annotations

import contextlib

import numpy as np

__all__ = ['MeshConfig', 'Mesh', 'get_mesh', 'set_mesh', 'mesh_scope',
           'fit_spec', 'named_sharding', 'spec_axes', 'AXIS_ORDER']

# canonical axis order, outermost first
AXIS_ORDER = ('pp', 'dp', 'ep', 'sp', 'tp')


class MeshConfig(object):
    """Named parallel-axis sizes, e.g. MeshConfig(dp=2, tp=4). devices:
    the places of the mesh's ranks, in rank order (default: one rank a
    process of the job)."""

    def __init__(self, devices=None, **axis_sizes):
        for ax in axis_sizes:
            if ax not in AXIS_ORDER:
                raise ValueError('unknown mesh axis %r (valid: %s)'
                                 % (ax, AXIS_ORDER))
        self.axis_sizes = {ax: int(axis_sizes.get(ax, 1))
                           for ax in AXIS_ORDER}
        self.devices = devices

    @classmethod
    def from_spec(cls, shape, devices=None):
        """Parse an axis-spec string ('dp=2,tp=4'; ''/None = pure data
        parallelism over every rank of the job) into a MeshConfig."""
        shape = str(shape or '').strip()
        if not shape:
            if devices is not None:
                n = len(devices)
            else:
                from .distributed import num_trainers
                n = num_trainers()
            return cls(devices=devices, dp=n)
        sizes = {}
        for part in shape.split(','):
            part = part.strip()
            if not part:
                continue
            if '=' not in part:
                raise ValueError(
                    'mesh shape entry %r is not axis=size' % part)
            ax, n = part.split('=', 1)
            sizes[ax.strip()] = int(n)
        return cls(devices=devices, **sizes)

    @classmethod
    def from_flags(cls, devices=None):
        """Build from FLAGS_mesh_shape."""
        from ..flags import get_flag
        return cls.from_spec(get_flag('mesh_shape'), devices=devices)

    @property
    def size(self):
        return int(np.prod(list(self.axis_sizes.values())))

    def build(self):
        """The Mesh over this config's ranks (axes of size 1 dropped;
        a config of size 1 is the one-axis mesh ('dp',) of one rank)."""
        if self.devices is not None and len(self.devices) < self.size:
            raise ValueError('mesh needs %d devices, have %d'
                             % (self.size, len(self.devices)))
        axes = [ax for ax in AXIS_ORDER if self.axis_sizes[ax] > 1]
        if not axes:
            axes = ['dp']
        shape = [self.axis_sizes[ax] for ax in axes]
        devices = (list(self.devices[:self.size])
                   if self.devices is not None else None)
        return Mesh(axes, shape, devices)


class Mesh(object):
    """Ranks laid out over named axes. axis_names and shape (a dict
    axis -> size, in axis order) are the JAX Mesh's; `devices` holds
    the ranks' places in rank order (None: not given).
    coordinate(rank) is the rank's index along each axis; device_mesh
    is torch's DeviceMesh over the same layout, built on first use
    (a collective: every rank builds it in the same order)."""

    def __init__(self, axis_names, shape, devices=None):
        self.axis_names = tuple(axis_names)
        sizes = [int(n) for n in shape]
        if len(sizes) != len(self.axis_names):
            raise ValueError('mesh axes %r and shape %r differ in length'
                             % (self.axis_names, sizes))
        self.shape = dict(zip(self.axis_names, sizes))
        self.size = int(np.prod(sizes))
        self.devices = devices
        self.ranks = np.arange(self.size).reshape(sizes)
        self._device_mesh = None

    def __repr__(self):
        return 'Mesh(%s)' % ', '.join('%s=%d' % kv
                                      for kv in self.shape.items())

    def coordinate(self, rank):
        idx = np.unravel_index(int(rank), self.ranks.shape)
        return dict(zip(self.axis_names, (int(i) for i in idx)))

    def rank_at(self, **coord):
        return int(self.ranks[tuple(coord[a] for a in self.axis_names)])

    def axis_ranks(self, axis, rank):
        """The ranks of `rank`'s group along `axis`, in axis order."""
        c = self.coordinate(rank)
        out = []
        for i in range(self.shape[axis]):
            c[axis] = i
            out.append(self.rank_at(**c))
        return out

    @property
    def device_mesh(self):
        if self._device_mesh is None:
            import torch.distributed as dist
            from torch.distributed.device_mesh import DeviceMesh
            if not dist.is_initialized():
                raise RuntimeError(
                    'the DeviceMesh of %r needs the process group: call '
                    'parallel.init_parallel_env first' % self)
            if dist.get_world_size() != self.size:
                raise ValueError(
                    'mesh %r has %d ranks, the process group %d'
                    % (self, self.size, dist.get_world_size()))
            dev = 'cpu'
            if self.devices is not None and \
                    getattr(self.devices[0], 'device', None) is not None \
                    and self.devices[0].device.type == 'cuda':
                dev = 'cuda'
            self._device_mesh = DeviceMesh(
                dev, self.ranks, mesh_dim_names=self.axis_names)
        return self._device_mesh


_current_mesh = None


def set_mesh(mesh):
    global _current_mesh
    _current_mesh = mesh
    return mesh


def get_mesh():
    return _current_mesh


@contextlib.contextmanager
def mesh_scope(mesh):
    """Install `mesh` (a Mesh, or a MeshConfig to build) as the current
    mesh for the scope; the previous mesh is restored even when the body
    raises."""
    global _current_mesh
    if isinstance(mesh, MeshConfig):
        mesh = mesh.build()
    prev, _current_mesh = _current_mesh, mesh
    try:
        yield mesh
    finally:
        _current_mesh = prev


def fit_spec(spec, shape, mesh):
    """Adapt a spec to a (possibly different) mesh: drop axis names the
    mesh does not have, and drop axes whose size does not divide the dim
    they shard (paddle_tpu/parallel/mesh.py:103-137, the
    reshard-on-restore rule)."""
    if spec is None:
        return None
    out = []
    for dim, entry in zip(shape, tuple(spec) + (None,) * len(shape)):
        if entry is None:
            out.append(None)
            continue
        names = list(entry) if isinstance(entry, (tuple, list)) else [entry]
        kept, factor = [], 1
        for ax in names:
            n = mesh.shape.get(ax)
            if n is None:
                continue
            if int(dim) % (factor * n) != 0:
                continue
            kept.append(ax)
            factor *= n
        if not kept:
            out.append(None)
        elif len(kept) == 1:
            out.append(kept[0])
        else:
            out.append(tuple(kept))
    return tuple(out[:len(shape)])


def spec_axes(entry, mesh):
    """The mesh axes of one spec entry (a name, names or None) that the
    mesh has and that are > 1, in the entry's order."""
    if entry is None:
        return ()
    names = entry if isinstance(entry, (tuple, list)) else (entry,)
    return tuple(a for a in names if mesh.shape.get(a, 1) > 1)


def named_sharding(mesh, spec):
    """DTensor placements of `spec` over the mesh's axes, in axis order:
    Shard(d) for an axis that spec[d] names, Replicate() for the rest
    (names the mesh lacks are dropped, as the JAX package drops them)."""
    from torch.distributed.tensor import Replicate, Shard
    placements = {ax: Replicate() for ax in mesh.axis_names}
    for d, entry in enumerate(spec or ()):
        for ax in spec_axes(entry, mesh):
            placements[ax] = Shard(d)
    return tuple(placements[ax] for ax in mesh.axis_names)
