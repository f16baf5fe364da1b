"""CIFAR-10/100 (counterpart of paddle_tpu/dataset/cifar.py): samples
are (3072 float32 in [0,1] laid out CHW, int label). Synthetic
class-blob data."""
from __future__ import annotations

import numpy as np

from . import common

__all__ = ['train10', 'test10', 'train100', 'test100', 'convert']

_N_TRAIN, _N_TEST = 4096, 512


def _creator(nclass, split, n):
    rng_m = common.synthetic_rng('cifar%d' % nclass, 'means')
    means = rng_m.rand(nclass, 3072).astype('float32')

    def reader():
        rng = common.synthetic_rng('cifar%d' % nclass, split)
        for _ in range(n):
            label = int(rng.randint(0, nclass))
            img = means[label] + 0.2 * rng.randn(3072).astype('float32')
            yield np.clip(img, 0.0, 1.0).astype('float32'), label
    return reader


def train10():
    return _creator(10, 'train', _N_TRAIN)


def test10():
    return _creator(10, 'test', _N_TEST)


def train100():
    return _creator(100, 'train', _N_TRAIN)


def test100():
    return _creator(100, 'test', _N_TEST)


def convert(path):
    """Write the four CIFAR series to RecordIO shards under `path`."""
    common.convert(path, train100(), 1000, 'cifar_train100')
    common.convert(path, test100(), 1000, 'cifar_test100')
    common.convert(path, train10(), 1000, 'cifar_train10')
    common.convert(path, test10(), 1000, 'cifar_test10')
