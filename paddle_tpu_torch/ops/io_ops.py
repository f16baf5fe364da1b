"""save / load / save_combine / load_combine and the py_reader's read op
(counterpart of paddle_tpu/ops/io_ops.py).

The tensor file format is the JAX package's, byte for byte
(io_ops.py:29-48): a 4-byte magic, a little-endian uint32 header length,
a JSON header {dtype, shape}, then the raw little-endian bytes. A model
directory saved by either package loads in the other. Loaded tensors go
straight to the executor's device.
"""
from __future__ import annotations

import json
import os
import struct

import numpy as np
import torch

from ..registry import register_op

_MAGIC = b'PTT1'   # paddle-tpu tensor v1


def write_tensor(f, arr):
    arr = np.ascontiguousarray(arr)
    header = json.dumps({'dtype': arr.dtype.name,
                         'shape': list(arr.shape)}).encode('utf-8')
    f.write(_MAGIC)
    f.write(struct.pack('<I', len(header)))
    f.write(header)
    f.write(arr.tobytes())


def read_tensor(f):
    magic = f.read(4)
    if magic != _MAGIC:
        raise ValueError('bad tensor file magic: %r' % magic)
    (hlen,) = struct.unpack('<I', f.read(4))
    header = json.loads(f.read(hlen).decode('utf-8'))
    dtype = np.dtype(header['dtype'])
    shape = tuple(header['shape'])
    n = int(np.prod(shape)) * dtype.itemsize
    return np.frombuffer(f.read(n), dtype=dtype).reshape(shape)


def _host(ctx, name):
    t = ctx.get(name)
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _device(ctx, arr):
    # np.frombuffer arrays are read-only; copy so torch owns writable memory
    return torch.from_numpy(arr.copy()).to(ctx.device)


def _makedirs_for(path):
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)


def _save_emit(ctx, op):
    path = op.attr('file_path')
    if os.path.exists(path) and not op.attr('overwrite', True):
        raise RuntimeError('%s exists and overwrite=False' % path)
    _makedirs_for(path)
    with open(path, 'wb') as f:
        write_tensor(f, _host(ctx, op.single_input('X')))


def _load_emit(ctx, op):
    with open(op.attr('file_path'), 'rb') as f:
        ctx.set(op.single_output('Out'), _device(ctx, read_tensor(f)))


def _save_combine_emit(ctx, op):
    path = op.attr('file_path')
    _makedirs_for(path)
    with open(path, 'wb') as f:
        for name in op.input('X'):
            write_tensor(f, _host(ctx, name))


def _load_combine_emit(ctx, op):
    with open(op.attr('file_path'), 'rb') as f:
        for name in op.output('Out'):
            ctx.set(name, _device(ctx, read_tensor(f)))


register_op('save', emit=_save_emit, host=True, no_grad=True)
register_op('load', emit=_load_emit, host=True, no_grad=True)
register_op('save_combine', emit=_save_combine_emit, host=True,
            no_grad=True)
register_op('load_combine', emit=_load_combine_emit, host=True,
            no_grad=True)


def _read_emit(ctx, op):
    """Pop one batch from the named py_reader. With double buffering the
    tensors are already on the card; a batch on another device is moved
    to the executor's."""
    from ..reader.pipeline import get_reader
    values = get_reader(op.attr('reader_name')).read()
    outs = op.output('Out')
    if len(values) != len(outs):
        raise ValueError('py_reader %r yields %d slots, program expects %d'
                         % (op.attr('reader_name'), len(values), len(outs)))
    for name, val in zip(outs, values):
        ctx.set(name, val.to(ctx.device))


register_op('read', emit=_read_emit, host=True, no_grad=True)
