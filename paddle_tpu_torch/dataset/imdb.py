"""IMDB sentiment (counterpart of paddle_tpu/dataset/imdb.py): samples
are (list of word ids, 0/1 label). Synthetic: two vocab regions are
biased by class so sentiment models learn; word_dict() maps word -> id
with '<unk>' included."""
from __future__ import annotations

import numpy as np

from . import common

__all__ = ['train', 'test', 'word_dict', 'build_dict', 'convert']

_VOCAB = 5147
_N_TRAIN, _N_TEST = 2048, 512


def word_dict():
    d = {('w%04d' % i): i for i in range(_VOCAB - 1)}
    d['<unk>'] = _VOCAB - 1
    return d


def _creator(split, n):
    def reader():
        rng = common.synthetic_rng('imdb', split)
        half = _VOCAB // 2
        for _ in range(n):
            label = int(rng.randint(0, 2))
            length = int(rng.randint(8, 60))
            # a positive review draws 70% of its words from the upper half
            biased = rng.rand(length) < 0.7
            ids = np.where(
                biased == bool(label),
                rng.randint(half, _VOCAB - 1, length),
                rng.randint(0, half, length))
            yield ids.astype('int64').tolist(), label
    return reader


def train(word_idx=None):
    return _creator('train', _N_TRAIN)


def test(word_idx=None):
    return _creator('test', _N_TEST)


def build_dict(pattern=None, cutoff=0):
    """The synthetic corpus has a fixed catalog: every (pattern, cutoff)
    gives the same dict, as in the JAX package."""
    return word_dict()


def convert(path):
    """Write train/test to RecordIO shards under `path`."""
    w = word_dict()
    common.convert(path, train(w), 1000, 'imdb_train')
    common.convert(path, test(w), 1000, 'imdb_test')
