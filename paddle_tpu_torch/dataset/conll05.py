"""CoNLL-2005 SRL (counterpart of paddle_tpu/dataset/conll05.py): the
label_semantic_roles book config. test() yields 9-tuples (word_ids,
ctx_n2, ctx_n1, ctx_0, ctx_p1, ctx_p2, verb_ids, mark, labels) of
synthetic sequences; get_embedding() is a synthetic [7477, 32] word
table."""
from __future__ import annotations

from . import common

__all__ = ['get_dict', 'get_embedding', 'test', 'convert']

_WORD_VOCAB, _VERB_VOCAB = 7477, 3162
_N_LABELS = 59          # BIO over 29 roles, and O
_N_TEST = 1024


def get_dict():
    word_dict = {('w%05d' % i): i for i in range(_WORD_VOCAB)}
    verb_dict = {('v%04d' % i): i for i in range(_VERB_VOCAB)}
    label_dict = {('L%02d' % i): i for i in range(_N_LABELS)}
    return word_dict, verb_dict, label_dict


def get_embedding():
    rng = common.synthetic_rng('conll05', 'emb')
    return rng.randn(_WORD_VOCAB, 32).astype('float32')


def test():
    def reader():
        rng = common.synthetic_rng('conll05', 'test')
        for _ in range(_N_TEST):
            length = int(rng.randint(5, 30))
            words = rng.randint(0, _WORD_VOCAB, length).astype('int64')
            ctx = [((words + off) % _WORD_VOCAB).astype('int64')
                   for off in (-2, -1, 0, 1, 2)]
            verb_pos = int(rng.randint(0, length))
            verb = rng.randint(0, _VERB_VOCAB)
            verbs = (verb * (words * 0 + 1)).astype('int64')
            mark = (words * 0).astype('int64')
            mark[verb_pos] = 1
            labels = rng.randint(0, _N_LABELS, length).astype('int64')
            yield (words.tolist(), ctx[0].tolist(), ctx[1].tolist(),
                   ctx[2].tolist(), ctx[3].tolist(), ctx[4].tolist(),
                   verbs.tolist(), mark.tolist(), labels.tolist())
    return reader


def convert(path):
    """Write the test split to RecordIO shards under `path`."""
    common.convert(path, test(), 1000, 'conl105_test')
