"""WMT-16 en<->de (counterpart of paddle_tpu/dataset/wmt16.py): wmt14's
synthetic scheme with the reference's (src, trg, trg_next) samples, the
JAX package's from the same seeds."""
from __future__ import annotations

from . import common

__all__ = ['train', 'test', 'get_dict', 'validation', 'fetch', 'convert']


def get_dict(lang, dict_size, reverse=False):
    d = {('%s%05d' % (lang, i)): i for i in range(dict_size)}
    if reverse:
        return {v: k for k, v in d.items()}
    return d


def _creator(split, n_samples, src_dict_size, trg_dict_size):
    def reader():
        rng = common.synthetic_rng('wmt16', split)
        for _ in range(n_samples):
            slen = int(rng.randint(3, 12))
            src = rng.randint(3, src_dict_size, slen).astype('int64')
            trg = ((src[::-1] + 11) % trg_dict_size)
            trg = [max(3, int(t)) for t in trg]
            yield (src.tolist(), [0] + trg, trg + [1])
    return reader


def train(src_dict_size, trg_dict_size, src_lang='en'):
    return _creator('train', 2048, src_dict_size, trg_dict_size)


def test(src_dict_size, trg_dict_size, src_lang='en'):
    return _creator('test', 256, src_dict_size, trg_dict_size)


def validation(src_dict_size, trg_dict_size, src_lang='en'):
    """Validation split reader (reference wmt16.py:243)."""
    return _creator('val', 256, src_dict_size, trg_dict_size)


def fetch():
    """The reference's prefetch hook (it downloads the tar). The
    synthetic corpus needs no fetch; kept so scripts calling
    dataset.wmt16.fetch() run unmodified."""
    return None


def convert(path, src_dict_size=30000, trg_dict_size=30000,
            src_lang='en'):
    """Write train/test/validation to RecordIO shards under `path`
    (reference wmt16.py:330)."""
    common.convert(path, train(src_dict_size, trg_dict_size, src_lang),
                   1000, 'wmt16_train')
    common.convert(path, test(src_dict_size, trg_dict_size, src_lang),
                   1000, 'wmt16_test')
    common.convert(path,
                   validation(src_dict_size, trg_dict_size, src_lang),
                   1000, 'wmt16_validation')
