"""Flowers-102 (counterpart of paddle_tpu/dataset/flowers.py, the same
samples): samples are (3*224*224 float32 CHW, int label). Synthetic class-blob images at reduced
spatial detail (noise over per-class base colors)."""
from __future__ import annotations

import numpy as np

from . import common

__all__ = ['train', 'test', 'valid']

_N_CLASS = 102
_N_TRAIN, _N_TEST = 1024, 256


def _creator(split, n, use_xmap=True):
    rng_m = common.synthetic_rng('flowers', 'means')
    base = rng_m.rand(_N_CLASS, 3).astype('float32')

    def reader():
        rng = common.synthetic_rng('flowers', split)
        for _ in range(n):
            label = int(rng.randint(0, _N_CLASS))
            img = np.repeat(base[label], 224 * 224).astype('float32')
            img += 0.1 * rng.randn(3 * 224 * 224).astype('float32')
            yield np.clip(img, 0, 1), label
    return reader


def train(use_xmap=True):
    return _creator('train', _N_TRAIN, use_xmap)


def test(use_xmap=True):
    return _creator('test', _N_TEST, use_xmap)


def valid(use_xmap=True):
    return _creator('valid', _N_TEST, use_xmap)
