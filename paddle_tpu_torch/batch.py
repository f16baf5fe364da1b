"""fluid.batch (counterpart of paddle_tpu/batch.py): group a sample
reader into a minibatch reader."""
from __future__ import annotations

__all__ = ['batch']


def batch(reader, batch_size, drop_last=False):
    if batch_size <= 0:
        raise ValueError('batch_size should be a positive integer')

    def batch_reader():
        b = []
        for instance in reader():
            b.append(instance)
            if len(b) == batch_size:
                yield b
                b = []
        if b and not drop_last:
            yield b
    return batch_reader
