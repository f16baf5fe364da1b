"""MQ2007 learning-to-rank (counterpart of paddle_tpu/dataset/mq2007.py,
the same samples): LETOR query-document features with relevance labels, servable in
pointwise / pairwise / listwise formats. Synthetic generator with the
reference's feature contract (46-dim vectors, relevance in {0,1,2},
grouped by query)."""
from __future__ import annotations

import numpy as np

from . import common

__all__ = ['train', 'test']

FEATURE_DIM = 46
_N_QUERIES_TRAIN, _N_QUERIES_TEST = 128, 32


def _gen_query(rng):
    n_docs = int(rng.randint(5, 20))
    # latent direction makes relevance learnable from features
    w = rng.randn(FEATURE_DIM)
    feats, rels = [], []
    for _ in range(n_docs):
        f = rng.rand(FEATURE_DIM).astype('float32')
        score = float(f @ w)
        feats.append(f)
        rels.append(score)
    cut = np.percentile(rels, [60, 90])
    labels = [int(0 if r < cut[0] else (1 if r < cut[1] else 2))
              for r in rels]
    return feats, labels


def _creator(split, n_queries, format):
    def pointwise():
        rng = common.synthetic_rng('mq2007', split)
        for _ in range(n_queries):
            feats, labels = _gen_query(rng)
            for f, l in zip(feats, labels):
                yield f, l

    def pairwise():
        rng = common.synthetic_rng('mq2007', split)
        for _ in range(n_queries):
            feats, labels = _gen_query(rng)
            for i in range(len(feats)):
                for j in range(len(feats)):
                    if labels[i] > labels[j]:
                        yield labels[i], labels[j], feats[i], feats[j]

    def listwise():
        rng = common.synthetic_rng('mq2007', split)
        for _ in range(n_queries):
            feats, labels = _gen_query(rng)
            yield labels, feats

    return {'pointwise': pointwise, 'pairwise': pairwise,
            'listwise': listwise}[format]


def train(format='pairwise'):
    return _creator('train', _N_QUERIES_TRAIN, format)


def test(format='pairwise'):
    return _creator('test', _N_QUERIES_TEST, format)
