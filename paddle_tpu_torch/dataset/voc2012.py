"""PASCAL VOC2012 segmentation (counterpart of
paddle_tpu/dataset/voc2012.py, the same samples): samples are (image CHW float32, segmentation label HW
int32) with 21 classes (20 objects + background) and the reference's
255 'void' border label. Synthetic generator with reference-shaped
data (offline image; same sample contract)."""
from __future__ import annotations

import numpy as np

from . import common

__all__ = ['train', 'test', 'val']

_N_CLASSES = 21
_VOID = 255
_H = _W = 64            # reference images are variable-size; fixed here
_N_TRAIN, _N_TEST, _N_VAL = 512, 128, 128


def _creator(split, n):
    def reader():
        rng = common.synthetic_rng('voc2012', split)
        for _ in range(n):
            img = rng.rand(3, _H, _W).astype('float32')
            # blobby label map: a few rectangles of random classes on
            # background, with a 1px void border around each
            label = np.zeros((_H, _W), 'int32')
            for _k in range(int(rng.randint(1, 4))):
                cls = int(rng.randint(1, _N_CLASSES))
                y0, x0 = rng.randint(0, _H - 8), rng.randint(0, _W - 8)
                h, w = rng.randint(4, 16), rng.randint(4, 16)
                y1, x1 = min(y0 + h, _H), min(x0 + w, _W)
                label[y0:y1, x0:x1] = cls
                if y0 > 0:
                    label[y0 - 1, x0:x1] = _VOID
                if y1 < _H:
                    label[y1, x0:x1] = _VOID
            yield img, label
    return reader


def train():
    return _creator('train', _N_TRAIN)


def test():
    return _creator('test', _N_TEST)


def val():
    return _creator('val', _N_VAL)
