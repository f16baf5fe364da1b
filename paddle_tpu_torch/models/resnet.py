"""ResNet for ImageNet and CIFAR (counterpart of
paddle_tpu/models/resnet.py): bottleneck or basic blocks, a
conv -> BN -> relu stem, stage widths 64/128/256/512.

Layout NCHW or NHWC (nhwc=True: the feed stays NCHW and is transposed
once at the stem; every activation after it is channels-last). With
FLAGS_use_pallas_fused_ops set when the program is built, every NCHW
conv + BN is ONE conv2d_bn op (ops/fused_ops.py), whose 1x1 path runs
the matmul + BN-statistics kernel K6; otherwise, and always at NHWC,
each is a conv2d op and a batch_norm op, as in the JAX package.
space_to_depth=True replaces the 7x7/2 stem conv with its exact 4x4
retiling (space_to_depth_stem).
"""
from __future__ import annotations

from .. import layers
from ..flags import get_flag


def conv_bn_layer(input, ch_out, filter_size, stride, padding, act='relu',
                  is_test=False, fmt='NCHW'):
    if get_flag('use_pallas_fused_ops') and fmt == 'NCHW':
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
    ch_in = input.shape[1 if fmt == 'NCHW' else -1]
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


def space_to_depth(input):
    """The space-to-depth stem's input: [B, C, H, W] repacked to
    [B, 4C, H/2, W/2] (channel = (c, di, dj)) and padded by (2, 1) per
    spatial dim, where the 4x4 kernel spans m-2 in [-2, 1]."""
    _, C, H, W = input.shape
    x = layers.reshape(input, shape=[-1, C, H // 2, 2, W // 2, 2])
    x = layers.transpose(x, perm=[0, 1, 3, 5, 2, 4])  # [B,C,di,dj,h,w]
    x = layers.reshape(x, shape=[-1, C * 4, H // 2, W // 2])
    return layers.pad(x, paddings=[0, 0, 0, 0, 2, 1, 2, 1])


def space_to_depth_stem(input, is_test=False):
    """The space-to-depth stem: an exact retiling of the 7x7/stride-2
    stem conv into a 4x4/stride-1 conv over space_to_depth(input):
    every output equals the original conv's, with
    w'[o, c*4+di*2+dj, m, n] = w[o, c, 2m+di-1, 2n+dj-1], zero outside
    the 7x7 support."""
    return conv_bn_layer(space_to_depth(input), ch_out=64, filter_size=4,
                         stride=1, padding=0, is_test=is_test)


def resnet_imagenet(input, class_dim=1000, depth=50, is_test=False,
                    space_to_depth=False, nhwc=False):
    block_func, stages = _DEPTH_CFG[depth]
    fmt = 'NHWC' if nhwc else 'NCHW'
    if space_to_depth:
        if nhwc:
            raise ValueError('space_to_depth stem is NCHW-only; it cannot '
                             'be combined with nhwc=True')
        conv = space_to_depth_stem(input, is_test=is_test)
    else:
        if nhwc:
            # the one [N,3,H,W] -> [N,H,W,3] transpose of the feed
            input = layers.transpose(input, perm=[0, 2, 3, 1])
        conv = conv_bn_layer(input, ch_out=64, filter_size=7, stride=2,
                             padding=3, is_test=is_test, fmt=fmt)
    pool = layers.pool2d(input=conv, pool_type='max', pool_size=3,
                         pool_stride=2, pool_padding=1, data_format=fmt)
    res = pool
    for i, count in enumerate(stages):
        res = layer_warp(block_func, res, 64 * (2 ** i), count,
                         1 if i == 0 else 2, is_test=is_test, fmt=fmt)
    pool = layers.pool2d(input=res, pool_size=7, pool_type='avg',
                         global_pooling=True, data_format=fmt)
    # the pooled [N,1,1,C] (NHWC) flattens to the [N,C] that NCHW's
    # [N,C,1,1] does: the fc head is the same in both layouts
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
