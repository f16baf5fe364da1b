"""Movie-review sentiment (counterpart of paddle_tpu/dataset/
sentiment.py): imdb's samples under their own module name."""
from __future__ import annotations

from . import common, imdb

__all__ = ['get_word_dict', 'train', 'test', 'convert']


def get_word_dict():
    return imdb.word_dict()


def train():
    return imdb.train()


def test():
    return imdb.test()


def convert(path):
    """Write train/test to RecordIO shards under `path`."""
    common.convert(path, train(), 1000, 'sentiment_train')
    common.convert(path, test(), 1000, 'sentiment_test')
