"""MNIST (counterpart of paddle_tpu/dataset/mnist.py): samples are
(784 float32 in [-1, 1], int label). Synthetic: each class k draws from
a distinct gaussian blob pattern, so classifiers learn."""
from __future__ import annotations

import numpy as np

from . import common

__all__ = ['train', 'test', 'convert']

_N_TRAIN, _N_TEST = 8192, 1024


def _class_means():
    rng = common.synthetic_rng('mnist', 'means')
    return rng.randn(10, 784).astype('float32') * 0.5


def reader_creator(split, n):
    means = _class_means()

    def reader():
        rng = common.synthetic_rng('mnist', split)
        for _ in range(n):
            label = int(rng.randint(0, 10))
            img = means[label] + 0.3 * rng.randn(784).astype('float32')
            img = np.clip(img, -1.0, 1.0).astype('float32')
            yield img, label
    return reader


def train():
    return reader_creator('train', _N_TRAIN)


def test():
    return reader_creator('test', _N_TEST)


def convert(path):
    """Write train/test to RecordIO shards under `path`."""
    common.convert(path, train(), 1000, 'minist_train')
    common.convert(path, test(), 1000, 'minist_test')
