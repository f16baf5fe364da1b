"""LoDTensor: the host-side ragged-sequence tensor of the feed path
(counterpart of paddle_tpu/lod_tensor.py).

LoD ("level of detail") is a list of offset vectors over the rows of a
dense tensor, one per nesting level. The port, like the JAX package,
never stores sequences ragged on the device: Executor.run turns a
LoDTensor feed into a padded [B, T, ...] tensor plus a [B] int32
lengths companion (executor.pad_lod_to_batch), so a segment's shapes
stay static and it can be captured as a CUDA graph. The object itself
lives on the host and keeps the reference's API (set_lod, lod,
recursive_sequence_lengths).
"""
from __future__ import annotations

import numpy as np

__all__ = ['LoDTensor', 'create_lod_tensor', 'create_random_int_lodtensor']


class LoDTensor(object):
    def __init__(self, data=None, lod=None):
        self._data = np.asarray(data) if data is not None else None
        self._lod = [list(l) for l in lod] if lod else []

    def set(self, data, place=None):
        self._data = np.asarray(data)

    def set_lod(self, lod):
        self._lod = [list(l) for l in lod]

    def lod(self):
        return [list(l) for l in self._lod]

    def set_recursive_sequence_lengths(self, lengths):
        """Lengths per sequence -> the offset form."""
        self._lod = []
        for level in lengths:
            offsets = [0]
            for n in level:
                offsets.append(offsets[-1] + int(n))
            self._lod.append(offsets)

    def recursive_sequence_lengths(self):
        return [[level[i + 1] - level[i] for i in range(len(level) - 1)]
                for level in self._lod]

    def has_valid_recursive_sequence_lengths(self):
        for level in self._lod:
            if not level or level[0] != 0:
                return False
            if any(level[j] > level[j + 1] for j in range(len(level) - 1)):
                return False
        if self._data is not None and self._lod:
            return self._lod[-1][-1] == self._data.shape[0]
        return True

    def numpy(self):
        return self._data

    def __array__(self, dtype=None):
        return self._data if dtype is None else self._data.astype(dtype)

    def shape(self):
        return list(self._data.shape) if self._data is not None else []

    def __repr__(self):
        return 'LoDTensor(shape=%s, lod=%s)' % (self.shape(), self._lod)


def create_lod_tensor(data, recursive_seq_lens, place=None):
    """A LoDTensor from an array (or a LoDTensor) and its lengths per
    sequence, or from a list of sequences (flattened to [N, 1] rows)."""
    if isinstance(data, LoDTensor):
        return create_lod_tensor(data.numpy(), recursive_seq_lens, place)
    if isinstance(data, list):
        seqs = [np.asarray(seq) for seq in data]
        data = np.concatenate([s.reshape(len(s), -1) for s in seqs], axis=0)
        recursive_seq_lens = [[len(s) for s in seqs]]
    t = LoDTensor(np.asarray(data))
    t.set_recursive_sequence_lengths(recursive_seq_lens)
    if not t.has_valid_recursive_sequence_lengths():
        raise ValueError('the sequence lengths %s do not cover the %d rows '
                         'of the data' % (recursive_seq_lens,
                                          t.numpy().shape[0]))
    return t


def create_random_int_lodtensor(recursive_seq_lens, base_shape, place, low,
                                high):
    """Random int64 rows in [low, high], drawn from numpy's global
    generator as the JAX package draws them."""
    if not isinstance(base_shape, list):
        raise TypeError('base_shape must be a list')
    shape = [sum(recursive_seq_lens[-1])] + base_shape
    data = np.random.randint(low, high + 1, shape).astype('int64')
    return create_lod_tensor(data, recursive_seq_lens, place)
