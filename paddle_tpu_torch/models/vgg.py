"""VGG (counterpart of paddle_tpu/models/vgg.py): conv groups by
img_conv_group, two 512-wide fc heads with batch norm and dropout.
Depth 16 (2-2-3-3-3 conv groups) or 19 (2-2-4-4-4)."""
from __future__ import annotations

from .. import layers, nets

_GROUPS = {16: (2, 2, 3, 3, 3), 19: (2, 2, 4, 4, 4)}


def vgg_net(input, class_dim=1000, is_test=False, depth=16):
    def conv_block(inp, num_filter, groups):
        return nets.img_conv_group(
            input=inp, pool_size=2, pool_stride=2,
            conv_num_filter=[num_filter] * groups, conv_filter_size=3,
            conv_act='relu', conv_with_batchnorm=True, pool_type='max')

    groups = _GROUPS[depth]
    net = input
    for width, g in zip((64, 128, 256, 512, 512), groups):
        net = conv_block(net, width, g)

    drop = layers.dropout(x=net, dropout_prob=0.5, is_test=is_test)
    fc1 = layers.fc(input=drop, size=512, act=None)
    bn = layers.batch_norm(input=fc1, act='relu', is_test=is_test)
    drop2 = layers.dropout(x=bn, dropout_prob=0.5, is_test=is_test)
    fc2 = layers.fc(input=drop2, size=512, act=None)
    return layers.fc(input=fc2, size=class_dim, act='softmax')


def vgg16(input, class_dim=1000, is_test=False):
    return vgg_net(input, class_dim=class_dim, is_test=is_test, depth=16)


def vgg19(input, class_dim=1000, is_test=False):
    return vgg_net(input, class_dim=class_dim, is_test=is_test, depth=19)


def train_network(image, label, class_dim=1000, is_test=False,
                  depth=16):
    predict = vgg_net(image, class_dim=class_dim, is_test=is_test,
                      depth=depth)
    cost = layers.cross_entropy(input=predict, label=label)
    avg_cost = layers.mean(x=cost)
    acc = layers.accuracy(input=predict, label=label)
    return predict, avg_cost, acc
