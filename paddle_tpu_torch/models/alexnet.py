"""AlexNet (counterpart of paddle_tpu/models/alexnet.py): five convs
with cross-channel LRN after the first two, three fc layers. The
original's grouped convolutions are dropped, as in the JAX package."""
from __future__ import annotations

from .. import layers

__all__ = ['alexnet', 'train_network']


def alexnet(input, class_dim=1000, is_test=False):
    conv1 = layers.conv2d(input=input, num_filters=96, filter_size=11,
                          stride=4, padding=2, act='relu')
    lrn1 = layers.lrn(conv1, n=5, alpha=1e-4, beta=0.75)
    pool1 = layers.pool2d(input=lrn1, pool_size=3, pool_stride=2,
                          pool_type='max')
    conv2 = layers.conv2d(input=pool1, num_filters=256, filter_size=5,
                          padding=2, act='relu')
    lrn2 = layers.lrn(conv2, n=5, alpha=1e-4, beta=0.75)
    pool2 = layers.pool2d(input=lrn2, pool_size=3, pool_stride=2,
                          pool_type='max')
    conv3 = layers.conv2d(input=pool2, num_filters=384, filter_size=3,
                          padding=1, act='relu')
    conv4 = layers.conv2d(input=conv3, num_filters=384, filter_size=3,
                          padding=1, act='relu')
    conv5 = layers.conv2d(input=conv4, num_filters=256, filter_size=3,
                          padding=1, act='relu')
    pool5 = layers.pool2d(input=conv5, pool_size=3, pool_stride=2,
                          pool_type='max')
    drop6 = layers.dropout(x=layers.fc(input=pool5, size=4096,
                                       act='relu'),
                           dropout_prob=0.5, is_test=is_test)
    drop7 = layers.dropout(x=layers.fc(input=drop6, size=4096,
                                       act='relu'),
                           dropout_prob=0.5, is_test=is_test)
    return layers.fc(input=drop7, size=class_dim, act='softmax')


def train_network(image, label, class_dim=1000, is_test=False):
    predict = alexnet(image, class_dim=class_dim, is_test=is_test)
    cost = layers.cross_entropy(input=predict, label=label)
    avg_cost = layers.mean(x=cost)
    acc = layers.accuracy(input=predict, label=label)
    return predict, avg_cost, acc
