"""ResNet for ImageNet and CIFAR (counterpart of
paddle_tpu/models/resnet.py): bottleneck or basic blocks, a
conv -> BN -> relu stem, stage widths 64/128/256/512.

NCHW only. With FLAGS_use_pallas_fused_ops set when the program is
built, every conv + BN is ONE conv2d_bn op (ops/fused_ops.py), whose
1x1 path runs the matmul + BN-statistics kernel K6; otherwise each is a
conv2d op and a batch_norm op. The JAX package's space-to-depth stem
and its NHWC layout are not ported (they need the pad op and NHWC
convolutions; ROADMAP.md): space_to_depth=True and nhwc=True raise.
"""
from __future__ import annotations

from .. import layers
from ..flags import get_flag


def conv_bn_layer(input, ch_out, filter_size, stride, padding, act='relu',
                  is_test=False, fmt='NCHW'):
    if fmt != 'NCHW':
        raise NotImplementedError('ResNet in %s: only NCHW is ported' % fmt)
    if get_flag('use_pallas_fused_ops'):
        return layers.conv_bn(input, num_filters=ch_out,
                              filter_size=filter_size, stride=stride,
                              padding=padding, act=act, is_test=is_test)
    conv = layers.conv2d(input=input, num_filters=ch_out,
                         filter_size=filter_size, stride=stride,
                         padding=padding, act=None, bias_attr=False,
                         data_format=fmt)
    return layers.batch_norm(input=conv, act=act, is_test=is_test,
                             data_layout=fmt)


def shortcut(input, ch_out, stride, is_test=False, fmt='NCHW'):
    ch_in = input.shape[1]
    if ch_in != ch_out or stride != 1:
        return conv_bn_layer(input, ch_out, 1, stride, 0, act=None,
                             is_test=is_test, fmt=fmt)
    return input


def basicblock(input, ch_out, stride, is_test=False, fmt='NCHW'):
    short = shortcut(input, ch_out, stride, is_test=is_test, fmt=fmt)
    conv1 = conv_bn_layer(input, ch_out, 3, stride, 1, is_test=is_test,
                          fmt=fmt)
    conv2 = conv_bn_layer(conv1, ch_out, 3, 1, 1, act=None, is_test=is_test,
                          fmt=fmt)
    return layers.elementwise_add(x=short, y=conv2, act='relu')


def bottleneck(input, ch_out, stride, is_test=False, fmt='NCHW'):
    short = shortcut(input, ch_out * 4, stride, is_test=is_test, fmt=fmt)
    conv1 = conv_bn_layer(input, ch_out, 1, stride, 0, is_test=is_test,
                          fmt=fmt)
    conv2 = conv_bn_layer(conv1, ch_out, 3, 1, 1, is_test=is_test, fmt=fmt)
    conv3 = conv_bn_layer(conv2, ch_out * 4, 1, 1, 0, act=None,
                          is_test=is_test, fmt=fmt)
    return layers.elementwise_add(x=short, y=conv3, act='relu')


def layer_warp(block_func, input, ch_out, count, stride, is_test=False,
               fmt='NCHW'):
    res_out = block_func(input, ch_out, stride, is_test=is_test, fmt=fmt)
    for _ in range(1, count):
        res_out = block_func(res_out, ch_out, 1, is_test=is_test, fmt=fmt)
    return res_out


_DEPTH_CFG = {
    18: (basicblock, [2, 2, 2, 2]),
    34: (basicblock, [3, 4, 6, 3]),
    50: (bottleneck, [3, 4, 6, 3]),
    101: (bottleneck, [3, 4, 23, 3]),
    152: (bottleneck, [3, 8, 36, 3]),
}


def resnet_imagenet(input, class_dim=1000, depth=50, is_test=False,
                    space_to_depth=False, nhwc=False):
    if space_to_depth or nhwc:
        raise NotImplementedError(
            'resnet_imagenet(space_to_depth=%r, nhwc=%r): the space-to-depth '
            'stem and the NHWC layout are not ported (ROADMAP.md, Queue 1)'
            % (space_to_depth, nhwc))
    block_func, stages = _DEPTH_CFG[depth]
    conv = conv_bn_layer(input, ch_out=64, filter_size=7, stride=2,
                         padding=3, is_test=is_test)
    pool = layers.pool2d(input=conv, pool_type='max', pool_size=3,
                         pool_stride=2, pool_padding=1)
    res = pool
    for i, count in enumerate(stages):
        res = layer_warp(block_func, res, 64 * (2 ** i), count,
                         1 if i == 0 else 2, is_test=is_test)
    pool = layers.pool2d(input=res, pool_size=7, pool_type='avg',
                         global_pooling=True)
    return layers.fc(input=pool, size=class_dim, act='softmax')


def resnet_cifar10(input, class_dim=10, depth=32, is_test=False):
    assert (depth - 2) % 6 == 0
    n = (depth - 2) // 6
    conv1 = conv_bn_layer(input, ch_out=16, filter_size=3, stride=1,
                          padding=1, is_test=is_test)
    res1 = layer_warp(basicblock, conv1, 16, n, 1, is_test=is_test)
    res2 = layer_warp(basicblock, res1, 32, n, 2, is_test=is_test)
    res3 = layer_warp(basicblock, res2, 64, n, 2, is_test=is_test)
    pool = layers.pool2d(input=res3, pool_size=8, pool_type='avg',
                         global_pooling=True)
    return layers.fc(input=pool, size=class_dim, act='softmax')


def train_network(image, label, class_dim=1000, depth=50, is_test=False,
                  variant='imagenet', space_to_depth=False, nhwc=False):
    """Full training graph: predictions, mean cross-entropy loss,
    accuracy."""
    if variant == 'imagenet':
        predict = resnet_imagenet(image, class_dim=class_dim, depth=depth,
                                  is_test=is_test,
                                  space_to_depth=space_to_depth, nhwc=nhwc)
    else:
        predict = resnet_cifar10(input=image, class_dim=class_dim,
                                 depth=depth, is_test=is_test)
    cost = layers.cross_entropy(input=predict, label=label)
    avg_cost = layers.mean(x=cost)
    acc = layers.accuracy(input=predict, label=label)
    return predict, avg_cost, acc
