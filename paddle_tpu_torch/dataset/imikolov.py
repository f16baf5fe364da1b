"""imikolov / PTB n-gram LM data (counterpart of
paddle_tpu/dataset/imikolov.py): build_dict() -> word->id;
train(word_idx, n) yields n-gram id tuples (the word2vec book config).
Synthetic Markov-like id streams."""
from __future__ import annotations

import numpy as np

from . import common

__all__ = ['build_dict', 'train', 'test', 'N', 'convert']

N = 5
_VOCAB = 2074          # the PTB dict after the min_word_freq cutoff
_N_TRAIN, _N_TEST = 4096, 512


def build_dict(min_word_freq=50):
    d = {('w%04d' % i): i for i in range(_VOCAB - 2)}
    d['<s>'] = _VOCAB - 2
    d['<e>'] = _VOCAB - 1
    return d


def _creator(split, n_samples, word_idx, n):
    vocab = len(word_idx)

    def reader():
        rng = common.synthetic_rng('imikolov', split)
        # Zipfian marginal like real PTB text: unigram entropy well below
        # log(vocab), so an n-gram LM shows clear within-epoch learning by
        # fitting word frequencies alone (a uniform marginal has no such
        # signal and needs many epochs of per-word statistics), plus a
        # +-3 sequential walk for conditional signal.
        p = 1.0 / (np.arange(vocab) + 2.0)
        p /= p.sum()
        for _ in range(n_samples):
            ids = [int(rng.choice(vocab, p=p))]
            for _ in range(n - 1):
                step = int(rng.randint(-3, 4))
                ids.append(int((ids[-1] + step) % vocab))
            yield tuple(ids)
    return reader


def train(word_idx, n=N):
    return _creator('train', _N_TRAIN, word_idx, n)


def test(word_idx, n=N):
    return _creator('test', _N_TEST, word_idx, n)


def convert(path):
    """Write train/test (default dict) to RecordIO shards under `path`."""
    word_idx = build_dict()
    common.convert(path, train(word_idx), 1000, 'imikolov_train')
    common.convert(path, test(word_idx), 1000, 'imikolov_test')
