"""WMT-14 fr->en (counterpart of paddle_tpu/dataset/wmt14.py): the
machine_translation chapter's data. Samples: (src_ids, trg_ids with <s>
(id 0) first, trg_ids with <e> (id 1) last). Synthetic: the target is a
fixed transform of the reversed source, so attention has something to
learn; the JAX package's samples from the same seeds."""
from __future__ import annotations

from . import common

__all__ = ['train', 'test', 'N', 'get_dict', 'convert']

N = 30000               # reference dict size per side


def _creator(split, n_samples, dict_size):
    def reader():
        rng = common.synthetic_rng('wmt14', split)
        for _ in range(n_samples):
            slen = int(rng.randint(3, 12))
            src = rng.randint(3, dict_size, slen).astype('int64')
            # target: reversed source with small perturbation (learnable)
            trg = ((src[::-1] + 7) % dict_size)
            trg = [max(3, int(t)) for t in trg]
            yield (src.tolist(),
                   [0] + trg,        # <s> prefix
                   trg + [1])        # <e> suffix
    return reader


def train(dict_size):
    return _creator('train', 2048, dict_size)


def test(dict_size):
    return _creator('test', 256, dict_size)


def get_dict(dict_size, reverse=True):
    """(src_dict, trg_dict) id maps (reference wmt14.py:155; reverse
    gives id->word, matching the reference default)."""
    src = {('s%05d' % i): i for i in range(dict_size)}
    trg = {('t%05d' % i): i for i in range(dict_size)}
    if reverse:
        src = {v: k for k, v in src.items()}
        trg = {v: k for k, v in trg.items()}
    return src, trg


def convert(path):
    """Write train/test (dict_size 30000, the reference tar's size) to
    RecordIO shards under `path`."""
    dict_size = 30000
    common.convert(path, train(dict_size), 1000, 'wmt14_train')
    common.convert(path, test(dict_size), 1000, 'wmt14_test')
