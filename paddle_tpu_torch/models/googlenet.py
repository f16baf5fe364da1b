"""GoogLeNet / Inception v1 (counterpart of
paddle_tpu/models/googlenet.py): nine inception modules over a 7x7/2
stem, with the paper's two auxiliary classifier heads (train-time
regularizers, dropped at inference). Each inception module is four
branches concatenated on channels."""
from __future__ import annotations

from .. import layers

__all__ = ['googlenet', 'train_network']


def _inception(x, f1, f3r, f3, f5r, f5, proj):
    b1 = layers.conv2d(input=x, num_filters=f1, filter_size=1,
                       act='relu')
    b3 = layers.conv2d(
        input=layers.conv2d(input=x, num_filters=f3r, filter_size=1,
                            act='relu'),
        num_filters=f3, filter_size=3, padding=1, act='relu')
    b5 = layers.conv2d(
        input=layers.conv2d(input=x, num_filters=f5r, filter_size=1,
                            act='relu'),
        num_filters=f5, filter_size=5, padding=2, act='relu')
    bp = layers.conv2d(
        input=layers.pool2d(input=x, pool_size=3, pool_stride=1,
                            pool_padding=1, pool_type='max'),
        num_filters=proj, filter_size=1, act='relu')
    return layers.concat([b1, b3, b5, bp], axis=1)


def _aux_head(x, class_dim, is_test):
    """Auxiliary classifier (paper §5): avgpool5/3 -> 1x1x128 ->
    fc1024 -> dropout 0.7 -> softmax."""
    p = layers.pool2d(input=x, pool_size=5, pool_stride=3,
                      pool_type='avg')
    c = layers.conv2d(input=p, num_filters=128, filter_size=1,
                      act='relu')
    f = layers.fc(input=c, size=1024, act='relu')
    d = layers.dropout(x=f, dropout_prob=0.7, is_test=is_test)
    return layers.fc(input=d, size=class_dim, act='softmax')


def googlenet(input, class_dim=1000, is_test=False, aux_heads=True):
    """Returns (main_softmax, aux1, aux2); aux heads are None when
    aux_heads=False or is_test."""
    stem = layers.conv2d(input=input, num_filters=64, filter_size=7,
                         stride=2, padding=3, act='relu')
    p1 = layers.pool2d(input=stem, pool_size=3, pool_stride=2,
                       pool_type='max')
    c2r = layers.conv2d(input=p1, num_filters=64, filter_size=1,
                        act='relu')
    c2 = layers.conv2d(input=c2r, num_filters=192, filter_size=3,
                       padding=1, act='relu')
    p2 = layers.pool2d(input=c2, pool_size=3, pool_stride=2,
                       pool_type='max')

    i3a = _inception(p2, 64, 96, 128, 16, 32, 32)
    i3b = _inception(i3a, 128, 128, 192, 32, 96, 64)
    p3 = layers.pool2d(input=i3b, pool_size=3, pool_stride=2,
                       pool_type='max')

    i4a = _inception(p3, 192, 96, 208, 16, 48, 64)
    i4b = _inception(i4a, 160, 112, 224, 24, 64, 64)
    i4c = _inception(i4b, 128, 128, 256, 24, 64, 64)
    i4d = _inception(i4c, 112, 144, 288, 32, 64, 64)
    i4e = _inception(i4d, 256, 160, 320, 32, 128, 128)
    p4 = layers.pool2d(input=i4e, pool_size=3, pool_stride=2,
                       pool_type='max')

    i5a = _inception(p4, 256, 160, 320, 32, 128, 128)
    i5b = _inception(i5a, 384, 192, 384, 48, 128, 128)
    p5 = layers.pool2d(input=i5b, pool_size=7, pool_stride=1,
                       pool_type='avg', global_pooling=True)
    drop = layers.dropout(x=p5, dropout_prob=0.4, is_test=is_test)
    main = layers.fc(input=drop, size=class_dim, act='softmax')

    if aux_heads and not is_test:
        return (main, _aux_head(i4a, class_dim, is_test),
                _aux_head(i4d, class_dim, is_test))
    return main, None, None


def train_network(image, label, class_dim=1000, is_test=False,
                  aux_heads=True):
    """Loss = main + 0.3*(aux1 + aux2), the paper's weighting."""
    main, aux1, aux2 = googlenet(image, class_dim=class_dim,
                                 is_test=is_test, aux_heads=aux_heads)
    cost = layers.mean(layers.cross_entropy(input=main, label=label))
    if aux1 is not None:
        cost1 = layers.mean(layers.cross_entropy(input=aux1,
                                                 label=label))
        cost2 = layers.mean(layers.cross_entropy(input=aux2,
                                                 label=label))
        cost = cost + 0.3 * cost1 + 0.3 * cost2
    acc = layers.accuracy(input=main, label=label)
    return main, cost, acc
