"""DataFeeder (counterpart of paddle_tpu/data_feeder.py:13-78): a
minibatch (a list of per-sample tuples, fluid.batch's form) becomes a
feed dict of numpy arrays in each var's declared dtype, which
Executor.run places on its device. A slot of a lod_level > 0 var takes
one sequence per sample: its rows are flattened, cast and joined into a
LoDTensor (create_lod_tensor), which Executor.run pads to the batch's
longest sequence with a lengths companion."""
from __future__ import annotations

import numpy as np

from .framework import Variable, default_main_program
from .lod_tensor import create_lod_tensor

__all__ = ['DataFeeder']


class _Converter(object):
    def __init__(self, var):
        self.var = var
        self.data = []

    def feed(self, item):
        self.data.append(np.asarray(item))

    def done(self):
        shape = list(self.var.shape or [])
        if self.var.lod_level > 0:
            flat = np.concatenate(
                [d.reshape(len(d), -1) for d in self.data], axis=0)
            if self.var.dtype is not None and self.var.dtype != 'bfloat16':
                flat = flat.astype(self.var.dtype)
            if shape and all(s == 1 for s in shape[1:]):
                flat = flat.reshape(-1, *[1] * (len(shape) - 1))
            return create_lod_tensor(flat, [[len(d) for d in self.data]])
        sample_shape = shape[1:] if shape and shape[0] in (-1, None) \
            else shape
        arr = np.stack([d.reshape(sample_shape) for d in self.data])
        if self.var.dtype is not None and self.var.dtype != 'bfloat16':
            arr = arr.astype(self.var.dtype)
        return arr


class DataFeeder(object):
    def __init__(self, feed_list, place, program=None):
        self.feed_dtypes = []
        self.feed_names = []
        self.feed_vars = []
        program = program or default_main_program()
        for each_var in feed_list:
            if isinstance(each_var, str):
                each_var = program.global_block().var(each_var)
            if not isinstance(each_var, Variable):
                raise TypeError('feed_list entries must be Variables')
            self.feed_vars.append(each_var)
            self.feed_names.append(each_var.name)
            self.feed_dtypes.append(each_var.dtype)
        self.place = place

    def feed(self, iterable):
        converters = [_Converter(v) for v in self.feed_vars]
        for each_sample in iterable:
            if len(each_sample) != len(converters):
                raise ValueError('sample width %d != feed_list width %d'
                                 % (len(each_sample), len(converters)))
            for value, conv in zip(each_sample, converters):
                conv.feed(value)
        return {name: conv.done()
                for name, conv in zip(self.feed_names, converters)}

    def feed_parallel(self, iterable, num_places=None):
        """Split one batch into num_places feeds (one on one device)."""
        if num_places is None:
            num_places = 1
        samples = list(iterable)
        chunk = (len(samples) + num_places - 1) // num_places
        for i in range(num_places):
            part = samples[i * chunk:(i + 1) * chunk]
            if part:
                yield self.feed(part)
