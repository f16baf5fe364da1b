"""Composite networks (counterpart of paddle_tpu/nets.py):
simple_img_conv_pool, img_conv_group, glu, scaled_dot_product_attention
and sequence_conv_pool, built from the same layers in the same order,
so the Programs and parameter names are the JAX package's."""
from __future__ import annotations

from . import layers

__all__ = ['simple_img_conv_pool', 'img_conv_group', 'glu',
           'scaled_dot_product_attention', 'sequence_conv_pool']


def simple_img_conv_pool(input, num_filters, filter_size, pool_size,
                         pool_stride, pool_padding=0, pool_type='max',
                         global_pooling=False, conv_stride=1, conv_padding=0,
                         conv_dilation=1, conv_groups=1, param_attr=None,
                         bias_attr=None, act=None, use_cudnn=True):
    conv_out = layers.conv2d(
        input=input, num_filters=num_filters, filter_size=filter_size,
        stride=conv_stride, padding=conv_padding, dilation=conv_dilation,
        groups=conv_groups, param_attr=param_attr, bias_attr=bias_attr,
        act=act)
    return layers.pool2d(
        input=conv_out, pool_size=pool_size, pool_type=pool_type,
        pool_stride=pool_stride, pool_padding=pool_padding,
        global_pooling=global_pooling)


def img_conv_group(input, conv_num_filter, pool_size, conv_padding=1,
                   conv_filter_size=3, conv_act=None, param_attr=None,
                   conv_with_batchnorm=False, conv_batchnorm_drop_rate=0.0,
                   pool_stride=1, pool_type='max', use_cudnn=True):
    tmp = input
    assert isinstance(conv_num_filter, (list, tuple))

    def _to_list(obj):
        if isinstance(obj, (list, tuple)):
            assert len(obj) == len(conv_num_filter)
            return list(obj)
        return [obj] * len(conv_num_filter)

    conv_padding = _to_list(conv_padding)
    conv_filter_size = _to_list(conv_filter_size)
    param_attr = _to_list(param_attr)
    conv_with_batchnorm = _to_list(conv_with_batchnorm)
    conv_batchnorm_drop_rate = _to_list(conv_batchnorm_drop_rate)

    for i in range(len(conv_num_filter)):
        local_conv_act = conv_act
        if conv_with_batchnorm[i]:
            local_conv_act = None
        tmp = layers.conv2d(
            input=tmp, num_filters=conv_num_filter[i],
            filter_size=conv_filter_size[i], padding=conv_padding[i],
            param_attr=param_attr[i], act=local_conv_act)
        if conv_with_batchnorm[i]:
            tmp = layers.batch_norm(input=tmp, act=conv_act)
            drop_rate = conv_batchnorm_drop_rate[i]
            if abs(drop_rate) > 1e-5:
                tmp = layers.dropout(x=tmp, dropout_prob=drop_rate)
    return layers.pool2d(input=tmp, pool_size=pool_size,
                         pool_type=pool_type, pool_stride=pool_stride)


def glu(input, dim=-1):
    a, b = layers.split(input, num_or_sections=2, dim=dim)
    from .layers import ops as _ops
    act_b = _ops.sigmoid(b)
    return layers.elementwise_mul(a, act_b)


def scaled_dot_product_attention(queries, keys, values, num_heads=1,
                                 dropout_rate=0.0):
    """Multi-head scaled dot-product attention over [B, T, D] tensors,
    from matmul, softmax, reshape and transpose layers (the fused
    flash_attention op is layers.flash_attention)."""
    if not (len(queries.shape) == len(keys.shape) == len(values.shape) == 3):
        raise ValueError('inputs must be 3-D [batch, seq, dim]')
    if queries.shape[-1] != keys.shape[-1]:
        raise ValueError('queries and keys must have the same hidden size')
    if keys.shape[1] != values.shape[1]:
        raise ValueError('keys and values must have the same seq length')
    if queries.shape[-1] % num_heads != 0:
        raise ValueError('hidden size must divide num_heads')

    def _split_heads(x):
        if num_heads == 1:
            return x
        hidden = x.shape[-1]
        # the first reshape feeds nothing; it is kept so that the
        # Program (and its var names) is the JAX package's
        layers.reshape(
            x, shape=[0 if x.shape[0] > 0 else -1, x.shape[1],
                      num_heads, hidden // num_heads])
        reshaped = layers.reshape(
            x, shape=[-1, x.shape[1], num_heads, hidden // num_heads])
        return layers.transpose(reshaped, perm=[0, 2, 1, 3])

    def _combine_heads(x):
        if num_heads == 1:
            return x
        trans = layers.transpose(x, perm=[0, 2, 1, 3])
        return layers.reshape(
            trans, shape=[-1, trans.shape[1],
                          trans.shape[2] * trans.shape[3]])

    q = _split_heads(queries)
    k = _split_heads(keys)
    v = _split_heads(values)
    key_dim = float(queries.shape[-1] // num_heads)
    scaled_q = layers.scale(q, scale=key_dim ** -0.5)
    product = layers.matmul(scaled_q, k, transpose_y=True)
    weights = layers.softmax(product)
    if dropout_rate:
        weights = layers.dropout(weights, dropout_prob=dropout_rate,
                                 is_test=False)
    ctx_multiheads = layers.matmul(weights, v)
    return _combine_heads(ctx_multiheads)


def sequence_conv_pool(input, num_filters, filter_size, param_attr=None,
                       act='sigmoid', pool_type='max'):
    """A convolution over time (sequence_conv), then a pool over it."""
    conv_out = layers.sequence_conv(input=input, num_filters=num_filters,
                                    filter_size=filter_size,
                                    param_attr=param_attr, act=act)
    return layers.sequence_pool(input=conv_out, pool_type=pool_type)
