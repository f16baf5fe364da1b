"""UCI housing (counterpart of paddle_tpu/dataset/uci_housing.py):
samples are (13-float feature vector, 1-float price). Synthetic:
features ~ N(0,1), price = x @ w + noise with a fixed hidden w, so
fit_a_line converges as on the real data."""
from __future__ import annotations

import numpy as np

from . import common

__all__ = ['train', 'test', 'feature_names']

feature_names = ['CRIM', 'ZN', 'INDUS', 'CHAS', 'NOX', 'RM', 'AGE', 'DIS',
                 'RAD', 'TAX', 'PTRATIO', 'B', 'LSTAT']

_N_TRAIN, _N_TEST = 404, 102


def _hidden_w():
    rng = common.synthetic_rng('uci_housing', 'w')
    return rng.randn(13, 1).astype('float32')


def _make(split, n):
    rng = common.synthetic_rng('uci_housing', split)
    x = rng.randn(n, 13).astype('float32')
    w = _hidden_w()
    y = (x @ w + 0.1 * rng.randn(n, 1)).astype('float32')

    def reader():
        for i in range(n):
            yield x[i], y[i]
    return reader


def train():
    return _make('train', _N_TRAIN)


def test():
    return _make('test', _N_TEST)
