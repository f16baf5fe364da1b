"""NN layer functions (counterpart of paddle_tpu/layers/nn.py, with the
JAX package's signatures and defaults). Each layer appends ops to the
current block; nothing executes here. conv2d_transpose, prelu, lrn,
smooth_l1, huber_loss and the sequence, detection and sampling layers
are not ported (ROADMAP.md, Queue 1)."""
from __future__ import annotations

import numpy as np

from ..framework import Variable
from ..layer_helper import LayerHelper
from ..initializer import Constant, Normal

__all__ = [
    'fc', 'embedding', 'conv2d', 'pool2d', 'batch_norm', 'conv_bn',
    'layer_norm', 'dropout', 'cross_entropy', 'square_error_cost',
    'accuracy', 'softmax', 'softmax_with_cross_entropy',
    'sigmoid_cross_entropy_with_logits', 'mean', 'mul', 'elementwise_add',
    'elementwise_sub', 'elementwise_mul', 'elementwise_div',
    'elementwise_max', 'elementwise_min', 'elementwise_pow', 'reduce_sum',
    'reduce_mean', 'reduce_max', 'reduce_min', 'reduce_prod', 'reshape',
    'transpose', 'split', 'topk', 'matmul', 'scale', 'clip', 'clip_by_norm',
    'one_hot', 'relu', 'log', 'l2_normalize', 'pad', 'label_smooth',
    'flatten', 'stack', 'expand', 'squeeze', 'unsqueeze', 'gather',
    'scatter', 'slice', 'shape', 'autoincreased_step_counter',
    'logical_and', 'logical_or', 'logical_xor', 'logical_not',
    'where_select', 'causal_mask_bias', 'position_embedding',
]


def _pair(v):
    """int -> [v, v]; sequences pass through as 2-lists."""
    return [v, v] if isinstance(v, int) else list(v)


def fc(input, size, num_flatten_dims=1, param_attr=None, bias_attr=None,
       act=None, is_test=False, name=None):
    """Fully-connected layer. Multiple inputs each get their own weight;
    results are summed, then bias + activation."""
    helper = LayerHelper('fc', input=input, param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    dtype = helper.input_dtype()
    mul_results = []
    for input_var, p_attr in helper.iter_inputs_and_params():
        param_shape = [int(np.prod(input_var.shape[num_flatten_dims:]))] \
            + [size]
        w = helper.create_parameter(attr=p_attr, shape=param_shape,
                                    dtype=dtype)
        tmp = helper.create_variable_for_type_inference(dtype)
        helper.append_op(
            type='mul', inputs={'X': [input_var], 'Y': [w]},
            outputs={'Out': [tmp]},
            attrs={'x_num_col_dims': num_flatten_dims, 'y_num_col_dims': 1})
        mul_results.append(tmp)
    if len(mul_results) == 1:
        pre_bias = mul_results[0]
    else:
        pre_bias = helper.create_variable_for_type_inference(dtype)
        helper.append_op(type='sum', inputs={'X': mul_results},
                         outputs={'Out': [pre_bias]})
    pre_act = helper.append_bias_op(pre_bias, dim_start=num_flatten_dims)
    return helper.append_activation(pre_act)


def embedding(input, size, is_sparse=False, is_distributed=False,
              padding_idx=None, param_attr=None, dtype='float32'):
    """Embedding lookup; is_sparse/is_distributed are recorded as attrs
    and do not change the forward."""
    helper = LayerHelper('embedding', param_attr=param_attr)
    w = helper.create_parameter(attr=helper.param_attr, shape=size,
                                dtype=dtype)
    tmp = helper.create_variable_for_type_inference(dtype)
    padding_idx = -1 if padding_idx is None else (
        padding_idx if padding_idx >= 0 else size[0] + padding_idx)
    helper.append_op(
        type='lookup_table', inputs={'Ids': [input], 'W': [w]},
        outputs={'Out': [tmp]},
        attrs={'is_sparse': is_sparse, 'is_distributed': is_distributed,
               'padding_idx': padding_idx})
    return tmp


def conv2d(input, num_filters, filter_size, stride=1, padding=0, dilation=1,
           groups=None, param_attr=None, bias_attr=None, use_cudnn=True,
           act=None, name=None, data_format='NCHW'):
    """2-D convolution over data_format 'NCHW' or 'NHWC'; the filter is
    OIHW in both. use_cudnn is accepted for the JAX package's
    signature."""
    helper = LayerHelper('conv2d', param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    dtype = input.dtype
    num_channels = input.shape[1] if data_format == 'NCHW' \
        else input.shape[-1]
    groups = groups or 1
    if num_channels % groups != 0:
        raise ValueError('num_channels must be divisible by groups')
    filter_size = _pair(filter_size)
    stride = _pair(stride)
    padding = _pair(padding)
    dilation = _pair(dilation)
    filter_shape = [num_filters, num_channels // groups] + filter_size
    std = (2.0 / (filter_size[0] * filter_size[1] * num_channels)) ** 0.5
    w = helper.create_parameter(
        attr=helper.param_attr, shape=filter_shape, dtype=dtype,
        default_initializer=Normal(0.0, std))
    pre_bias = helper.create_variable_for_type_inference(dtype)
    helper.append_op(
        type='conv2d',
        inputs={'Input': [input], 'Filter': [w]},
        outputs={'Output': [pre_bias]},
        attrs={'strides': stride, 'paddings': padding, 'dilations': dilation,
               'groups': groups, 'data_format': data_format})
    pre_act = _append_channel_bias(helper, pre_bias, data_format)
    return helper.append_activation(pre_act)


def _append_channel_bias(helper, pre_bias, data_format='NCHW'):
    bias_attr = helper.bias_attr
    if not bias_attr:
        return pre_bias
    ch_axis = 1 if data_format == 'NCHW' else len(pre_bias.shape) - 1
    num_channels = pre_bias.shape[ch_axis]
    b = helper.create_parameter(attr=bias_attr, shape=[num_channels],
                                dtype=pre_bias.dtype, is_bias=True)
    tmp = helper.create_variable_for_type_inference(dtype=pre_bias.dtype)
    helper.append_op(type='elementwise_add',
                     inputs={'X': [pre_bias], 'Y': [b]},
                     outputs={'Out': [tmp]}, attrs={'axis': ch_axis})
    return tmp


def pool2d(input, pool_size=-1, pool_type='max', pool_stride=1,
           pool_padding=0, global_pooling=False, use_cudnn=True,
           ceil_mode=False, exclusive=True, name=None, data_format='NCHW'):
    """2-D max or average pooling."""
    if pool_type not in ('max', 'avg'):
        raise ValueError("pool_type must be 'max' or 'avg'")
    helper = LayerHelper('pool2d', name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        type='pool2d', inputs={'X': [input]}, outputs={'Out': [out]},
        attrs={'pooling_type': pool_type, 'ksize': _pair(pool_size),
               'global_pooling': global_pooling, 'strides': _pair(pool_stride),
               'paddings': _pair(pool_padding), 'ceil_mode': ceil_mode,
               'exclusive': exclusive, 'data_format': data_format})
    return out


def conv_bn(input, num_filters, filter_size, stride=1, padding=0,
            act=None, momentum=0.9, epsilon=1e-5, param_attr=None,
            bn_param_attr=None, bn_bias_attr=None, is_test=False,
            name=None):
    """Fused conv2d + batch_norm + activation as ONE conv2d_bn op
    (ops/fused_ops.py); no conv bias, BN's shift makes it redundant. Its
    1x1 path runs the matmul + BN-statistics kernel K6 under
    FLAGS_use_pallas_fused_ops."""
    helper = LayerHelper('conv_bn', param_attr=param_attr, name=name)
    dtype = input.dtype
    num_channels = input.shape[1]
    filter_size = _pair(filter_size)
    stride = _pair(stride)
    padding = _pair(padding)
    filter_shape = [num_filters, num_channels] + filter_size
    std = (2.0 / (filter_size[0] * filter_size[1] * num_channels)) ** 0.5
    w = helper.create_parameter(
        attr=helper.param_attr, shape=filter_shape, dtype=dtype,
        default_initializer=Normal(0.0, std))
    scale = helper.create_parameter(
        attr=bn_param_attr, shape=[num_filters], dtype=dtype,
        default_initializer=Constant(1.0))
    bias = helper.create_parameter(
        attr=bn_bias_attr, shape=[num_filters], dtype=dtype, is_bias=True)
    mean, variance = _running_stats(helper, helper.name + '.mean',
                                    helper.name + '.variance', [num_filters])
    saved_mean = helper.create_variable_for_type_inference(
        dtype='float32', stop_gradient=True)
    saved_variance = helper.create_variable_for_type_inference(
        dtype='float32', stop_gradient=True)
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(
        type='conv2d_bn',
        inputs={'Input': [input], 'Filter': [w], 'Scale': [scale],
                'Bias': [bias], 'Mean': [mean], 'Variance': [variance]},
        outputs={'Y': [out], 'MeanOut': [mean], 'VarianceOut': [variance],
                 'SavedMean': [saved_mean],
                 'SavedVariance': [saved_variance]},
        attrs={'strides': stride, 'paddings': padding,
               'momentum': momentum, 'epsilon': epsilon, 'act': act,
               'is_test': is_test})
    return out


def _running_stats(helper, mean_name, variance_name, shape):
    """The persistable running mean (0) and variance (1) of a batch norm,
    created in the main program with their init ops in the startup."""
    mean = helper.create_or_get_global_variable(
        name=mean_name, dtype='float32', shape=shape, persistable=True)
    helper.set_variable_initializer(mean, Constant(0.0))
    variance = helper.create_or_get_global_variable(
        name=variance_name, dtype='float32', shape=shape, persistable=True)
    helper.set_variable_initializer(variance, Constant(1.0))
    return mean, variance


def batch_norm(input, act=None, is_test=False, momentum=0.9, epsilon=1e-5,
               param_attr=None, bias_attr=None, data_layout='NCHW',
               in_place=False, name=None, moving_mean_name=None,
               moving_variance_name=None,
               do_model_average_for_mean_and_var=False,
               use_global_stats=False):
    """Batch normalization over the channel axis of data_layout."""
    helper = LayerHelper('batch_norm', param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    dtype = input.dtype
    channel_num = input.shape[1] if data_layout == 'NCHW' \
        else input.shape[-1]
    param_shape = [channel_num]
    scale = helper.create_parameter(
        attr=helper.param_attr, shape=param_shape, dtype=dtype,
        default_initializer=Constant(1.0))
    bias = helper.create_parameter(
        attr=helper.bias_attr, shape=param_shape, dtype=dtype, is_bias=True)
    mean, variance = _running_stats(
        helper, moving_mean_name or helper.name + '.mean',
        moving_variance_name or helper.name + '.variance', param_shape)
    saved_mean = helper.create_variable_for_type_inference(
        dtype='float32', stop_gradient=True)
    saved_variance = helper.create_variable_for_type_inference(
        dtype='float32', stop_gradient=True)
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(
        type='batch_norm',
        inputs={'X': [input], 'Scale': [scale], 'Bias': [bias],
                'Mean': [mean], 'Variance': [variance]},
        outputs={'Y': [out], 'MeanOut': [mean], 'VarianceOut': [variance],
                 'SavedMean': [saved_mean], 'SavedVariance': [saved_variance]},
        attrs={'momentum': momentum, 'epsilon': epsilon, 'is_test': is_test,
               'data_layout': data_layout,
               'use_global_stats': use_global_stats})
    return helper.append_activation(out)


def layer_norm(input, scale=True, shift=True, begin_norm_axis=1,
               epsilon=1e-5, param_attr=None, bias_attr=None, act=None,
               name=None):
    helper = LayerHelper('layer_norm', param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    dtype = input.dtype
    param_shape = [int(np.prod(input.shape[begin_norm_axis:]))]
    inputs = {'X': [input]}
    if scale:
        s = helper.create_parameter(attr=helper.param_attr, shape=param_shape,
                                    dtype=dtype,
                                    default_initializer=Constant(1.0))
        inputs['Scale'] = [s]
    if shift:
        b = helper.create_parameter(attr=helper.bias_attr, shape=param_shape,
                                    dtype=dtype, is_bias=True)
        inputs['Bias'] = [b]
    mean_out = helper.create_variable_for_type_inference(
        dtype='float32', stop_gradient=True)
    variance_out = helper.create_variable_for_type_inference(
        dtype='float32', stop_gradient=True)
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(
        type='layer_norm', inputs=inputs,
        outputs={'Y': [out], 'Mean': [mean_out], 'Variance': [variance_out]},
        attrs={'epsilon': epsilon, 'begin_norm_axis': begin_norm_axis})
    return helper.append_activation(out)


def softmax(input, use_cudnn=True, name=None):
    helper = LayerHelper('softmax', name=name)
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    helper.append_op(type='softmax', inputs={'X': [input]},
                     outputs={'Out': [out]})
    return out


def matmul(x, y, transpose_x=False, transpose_y=False, alpha=1.0, name=None):
    helper = LayerHelper('matmul', name=name)
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op(type='matmul', inputs={'X': [x], 'Y': [y]},
                     outputs={'Out': [out]},
                     attrs={'transpose_X': transpose_x,
                            'transpose_Y': transpose_y,
                            'alpha': float(alpha)})
    return out


def reshape(x, shape, actual_shape=None, act=None, inplace=False, name=None):
    helper = LayerHelper('reshape2', act=act, name=name)
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    x_shape = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op(type='reshape2', inputs={'X': [x]},
                     outputs={'Out': [out], 'XShape': [x_shape]},
                     attrs={'shape': list(shape)})
    return helper.append_activation(out)


def transpose(x, perm, name=None):
    helper = LayerHelper('transpose2', name=name)
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    x_shape = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op(type='transpose2', inputs={'X': [x]},
                     outputs={'Out': [out], 'XShape': [x_shape]},
                     attrs={'axis': list(perm)})
    return out


def slice(input, axes, starts, ends):
    helper = LayerHelper('slice')
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    helper.append_op(type='slice', inputs={'Input': [input]},
                     outputs={'Out': [out]},
                     attrs={'axes': list(axes), 'starts': list(starts),
                            'ends': list(ends)})
    return out


def causal_mask_bias(scores, name=None):
    """Mask future positions of [.., Tq, Tk] attention scores with -1e9."""
    helper = LayerHelper('causal_mask', name=name)
    out = helper.create_variable_for_type_inference(scores.dtype)
    helper.append_op(type='causal_mask', inputs={'X': [scores]},
                     outputs={'Out': [out]})
    return out


def position_embedding(x, max_len, param_attr=None, name=None):
    """Learned positional embedding table sliced to x's time axis."""
    helper = LayerHelper('position_embedding', param_attr=param_attr,
                         name=name)
    pos = helper.create_parameter(attr=helper.param_attr,
                                  shape=[max_len, x.shape[-1]], dtype=x.dtype)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type='position_embedding',
                     inputs={'X': [x], 'Pos': [pos]},
                     outputs={'Out': [out]})
    return out


def accuracy(input, label, k=1, correct=None, total=None):
    """top-k accuracy: the top_k op, then accuracy over its indices."""
    helper = LayerHelper('accuracy')
    topk_out, topk_indices = topk(input, k=k)
    acc_out = helper.create_variable_for_type_inference(dtype='float32')
    if correct is None:
        correct = helper.create_variable_for_type_inference(dtype='int32')
    if total is None:
        total = helper.create_variable_for_type_inference(dtype='int32')
    helper.append_op(
        type='accuracy',
        inputs={'Out': [topk_out], 'Indices': [topk_indices],
                'Label': [label]},
        outputs={'Accuracy': [acc_out], 'Correct': [correct],
                 'Total': [total]})
    return acc_out


def topk(input, k, name=None):
    helper = LayerHelper('top_k', name=name)
    values = helper.create_variable_for_type_inference(dtype=input.dtype)
    indices = helper.create_variable_for_type_inference(dtype='int64')
    helper.append_op(type='top_k', inputs={'X': [input]},
                     outputs={'Out': [values], 'Indices': [indices]},
                     attrs={'k': k})
    values.stop_gradient = True
    indices.stop_gradient = True
    return values, indices


def relu(x, name=None):
    helper = LayerHelper('relu', name=name)
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op(type='relu', inputs={'X': [x]}, outputs={'Out': [out]})
    return out


def mean(x, name=None):
    helper = LayerHelper('mean', name=name)
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op(type='mean', inputs={'X': [x]}, outputs={'Out': [out]})
    return out


def square_error_cost(input, label):
    helper = LayerHelper('square_error_cost')
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    helper.append_op(type='square_error_cost',
                     inputs={'X': [input], 'Y': [label]},
                     outputs={'Out': [out]})
    return out


def cross_entropy(input, label, soft_label=False, ignore_index=-100):
    helper = LayerHelper('cross_entropy')
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    helper.append_op(type='cross_entropy',
                     inputs={'X': [input], 'Label': [label]},
                     outputs={'Y': [out]},
                     attrs={'soft_label': soft_label,
                            'ignore_index': ignore_index})
    return out


def dropout(x, dropout_prob, is_test=False, seed=None, name=None,
            dropout_implementation='downgrade_in_infer'):
    helper = LayerHelper('dropout', name=name)
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    mask = helper.create_variable_for_type_inference(
        dtype=x.dtype, stop_gradient=True)
    helper.append_op(
        type='dropout', inputs={'X': [x]},
        outputs={'Out': [out], 'Mask': [mask]},
        attrs={'dropout_prob': dropout_prob, 'is_test': is_test,
               'seed': seed if seed is not None else 0,
               'dropout_implementation': dropout_implementation})
    return out


def softmax_with_cross_entropy(logits, label, soft_label=False,
                               ignore_index=-100, return_softmax=False):
    helper = LayerHelper('softmax_with_cross_entropy')
    softmax_out = helper.create_variable_for_type_inference(
        dtype=logits.dtype)
    loss = helper.create_variable_for_type_inference(dtype=logits.dtype)
    helper.append_op(type='softmax_with_cross_entropy',
                     inputs={'Logits': [logits], 'Label': [label]},
                     outputs={'Softmax': [softmax_out], 'Loss': [loss]},
                     attrs={'soft_label': soft_label,
                            'ignore_index': ignore_index})
    if return_softmax:
        return loss, softmax_out
    return loss


def sigmoid_cross_entropy_with_logits(x, label, ignore_index=-100, name=None):
    helper = LayerHelper('sigmoid_cross_entropy_with_logits', name=name)
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op(type='sigmoid_cross_entropy_with_logits',
                     inputs={'X': [x], 'Label': [label]},
                     outputs={'Out': [out]},
                     attrs={'ignore_index': ignore_index})
    return out


def mul(x, y, x_num_col_dims=1, y_num_col_dims=1, name=None):
    helper = LayerHelper('mul', name=name)
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op(type='mul', inputs={'X': [x], 'Y': [y]},
                     outputs={'Out': [out]},
                     attrs={'x_num_col_dims': x_num_col_dims,
                            'y_num_col_dims': y_num_col_dims})
    return out


def _elementwise(op_type):
    def layer(x, y, axis=-1, act=None, name=None):
        helper = LayerHelper(op_type, act=act, name=name)
        out = helper.create_variable_for_type_inference(dtype=x.dtype)
        helper.append_op(type=op_type, inputs={'X': [x], 'Y': [y]},
                         outputs={'Out': [out]}, attrs={'axis': axis})
        return helper.append_activation(out)
    layer.__name__ = op_type
    return layer


elementwise_add = _elementwise('elementwise_add')
elementwise_sub = _elementwise('elementwise_sub')
elementwise_mul = _elementwise('elementwise_mul')
elementwise_div = _elementwise('elementwise_div')
elementwise_max = _elementwise('elementwise_max')
elementwise_min = _elementwise('elementwise_min')
elementwise_pow = _elementwise('elementwise_pow')


def _reduce(op_type):
    def layer(input, dim=None, keep_dim=False, name=None):
        helper = LayerHelper(op_type, name=name)
        out = helper.create_variable_for_type_inference(dtype=input.dtype)
        if dim is not None and not isinstance(dim, (list, tuple)):
            dim = [dim]
        helper.append_op(
            type=op_type, inputs={'X': [input]}, outputs={'Out': [out]},
            attrs={'dim': dim if dim is not None else [0],
                   'keep_dim': keep_dim, 'reduce_all': dim is None})
        return out
    layer.__name__ = op_type
    return layer


reduce_sum = _reduce('reduce_sum')
reduce_mean = _reduce('reduce_mean')
reduce_max = _reduce('reduce_max')
reduce_min = _reduce('reduce_min')
reduce_prod = _reduce('reduce_prod')


def split(input, num_or_sections, dim=-1, name=None):
    helper = LayerHelper('split', name=name)
    input_shape = input.shape
    dim = dim if dim >= 0 else dim + len(input_shape)
    if isinstance(num_or_sections, int):
        num = num_or_sections
        sections = []
    else:
        num = len(num_or_sections)
        sections = list(num_or_sections)
    outs = [helper.create_variable_for_type_inference(dtype=input.dtype)
            for _ in range(num)]
    helper.append_op(type='split', inputs={'X': [input]},
                     outputs={'Out': outs},
                     attrs={'num': num if not sections else 0,
                            'sections': sections, 'axis': dim})
    return outs


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None, name=None):
    helper = LayerHelper('scale', act=act, name=name)
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op(type='scale', inputs={'X': [x]}, outputs={'Out': [out]},
                     attrs={'scale': float(scale), 'bias': float(bias),
                            'bias_after_scale': bias_after_scale})
    return helper.append_activation(out)


def clip(x, min, max, name=None):
    helper = LayerHelper('clip', name=name)
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op(type='clip', inputs={'X': [x]}, outputs={'Out': [out]},
                     attrs={'min': float(min), 'max': float(max)})
    return out


def clip_by_norm(x, max_norm, name=None):
    helper = LayerHelper('clip_by_norm', name=name)
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op(type='clip_by_norm', inputs={'X': [x]},
                     outputs={'Out': [out]},
                     attrs={'max_norm': float(max_norm)})
    return out


def one_hot(input, depth):
    helper = LayerHelper('one_hot')
    out = helper.create_variable_for_type_inference(dtype='float32')
    helper.append_op(type='one_hot', inputs={'X': [input]},
                     outputs={'Out': [out]}, attrs={'depth': depth})
    return out


def log(x, name=None):
    helper = LayerHelper('log', name=name)
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op(type='log', inputs={'X': [x]}, outputs={'Out': [out]})
    return out


def l2_normalize(x, axis, epsilon=1e-12, name=None):
    """x / sqrt(sum(x^2, axis) + eps), composed from primitive ops
    (the JAX package's composition)."""
    sq = elementwise_mul(x, x)
    summed = reduce_sum(sq, dim=axis, keep_dim=True)
    from .ops import sqrt as _sqrt
    norm = _sqrt(elementwise_add(summed, fill_const_like(summed, epsilon)))
    return elementwise_div(x, norm, axis=0 if axis != 0 else 0)


def fill_const_like(x, value):
    from .tensor import fill_constant
    return fill_constant(shape=list(x.shape), dtype=x.dtype, value=value)


def pad(x, paddings, pad_value=0.0, name=None):
    helper = LayerHelper('pad', name=name)
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op(type='pad', inputs={'X': [x]}, outputs={'Out': [out]},
                     attrs={'paddings': list(paddings),
                            'pad_value': float(pad_value)})
    return out


def label_smooth(label, prior_dist=None, epsilon=0.1, dtype='float32',
                 name=None):
    helper = LayerHelper('label_smooth', name=name)
    out = helper.create_variable_for_type_inference(dtype)
    inputs = {'X': [label]}
    if prior_dist is not None:
        inputs['PriorDist'] = [prior_dist]
    helper.append_op(type='label_smooth', inputs=inputs,
                     outputs={'Out': [out]}, attrs={'epsilon': float(epsilon)})
    return out


def flatten(x, axis=1, name=None):
    helper = LayerHelper('flatten', name=name)
    lead = int(np.prod(x.shape[:axis])) if axis > 0 else 1
    rest = int(np.prod(x.shape[axis:]))
    return reshape(x, [-1 if any(s < 0 for s in x.shape[:axis]) else lead,
                       rest])


def stack(x, axis=0):
    helper = LayerHelper('stack')
    if isinstance(x, Variable):
        x = [x]
    out = helper.create_variable_for_type_inference(dtype=x[0].dtype)
    helper.append_op(type='stack', inputs={'X': x}, outputs={'Y': [out]},
                     attrs={'axis': axis})
    return out


def expand(x, expand_times, name=None):
    helper = LayerHelper('expand', name=name)
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op(type='expand', inputs={'X': [x]},
                     outputs={'Out': [out]},
                     attrs={'expand_times': list(expand_times)})
    return out


def squeeze(input, axes, name=None):
    helper = LayerHelper('squeeze2', name=name)
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    x_shape = helper.create_variable_for_type_inference(dtype=input.dtype)
    helper.append_op(type='squeeze2', inputs={'X': [input]},
                     outputs={'Out': [out], 'XShape': [x_shape]},
                     attrs={'axes': list(axes)})
    return out


def unsqueeze(input, axes, name=None):
    helper = LayerHelper('unsqueeze2', name=name)
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    x_shape = helper.create_variable_for_type_inference(dtype=input.dtype)
    helper.append_op(type='unsqueeze2', inputs={'X': [input]},
                     outputs={'Out': [out], 'XShape': [x_shape]},
                     attrs={'axes': list(axes)})
    return out


def gather(input, index):
    helper = LayerHelper('gather')
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    helper.append_op(type='gather', inputs={'X': [input], 'Index': [index]},
                     outputs={'Out': [out]})
    return out


def scatter(input, index, updates, name=None, overwrite=True):
    helper = LayerHelper('scatter', name=name)
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    helper.append_op(type='scatter',
                     inputs={'X': [input], 'Ids': [index],
                             'Updates': [updates]},
                     outputs={'Out': [out]}, attrs={'overwrite': overwrite})
    return out


def shape(input):
    helper = LayerHelper('shape')
    out = helper.create_variable_for_type_inference(dtype='int64')
    helper.append_op(type='shape', inputs={'Input': [input]},
                     outputs={'Out': [out]})
    return out


def binary_bool_op(op_type, x, y, out=None, name=None):
    """Shared builder for bool-valued binary ops (comparisons + logicals)."""
    helper = LayerHelper(op_type, name=name)
    if out is None:
        out = helper.create_variable_for_type_inference(dtype='bool')
    helper.append_op(type=op_type, inputs={'X': [x], 'Y': [y]},
                     outputs={'Out': [out]})
    return out


def _logical_binary(op_type):
    def layer(x, y, out=None, name=None):
        return binary_bool_op(op_type, x, y, out=out, name=name)
    layer.__name__ = op_type
    return layer


logical_and = _logical_binary('logical_and')
logical_or = _logical_binary('logical_or')
logical_xor = _logical_binary('logical_xor')


def logical_not(x, out=None, name=None):
    helper = LayerHelper('logical_not', name=name)
    if out is None:
        out = helper.create_variable_for_type_inference(dtype='bool')
    helper.append_op(type='logical_not', inputs={'X': [x]},
                     outputs={'Out': [out]})
    return out


def where_select(cond, x, y, name=None):
    """Row-wise/elementwise select: out = cond ? x : y (broadcasting cond
    over trailing dims)."""
    helper = LayerHelper('where_select', name=name)
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op(type='where', inputs={'Cond': [cond], 'X': [x],
                                           'Y': [y]},
                     outputs={'Out': [out]})
    return out


def autoincreased_step_counter(counter_name=None, begin=1, step=1):
    """The global step counter (int64 [1], persistable), incremented by
    an increment op PREPENDED to the main program's global block, so it
    runs first in every step; it starts at begin - 1. The learning-rate
    schedules read it (learning_rate_scheduler.py)."""
    helper = LayerHelper('global_step_counter')
    counter_name = counter_name or '@STEP_COUNTER@'
    counter = helper.create_or_get_global_variable(
        name=counter_name, dtype='int64', shape=[1], persistable=True)
    if not any(op.type == 'increment' and
               op.output('Out') == [counter_name]
               for op in helper.main_program.global_block().ops):
        helper.set_variable_initializer(
            counter, Constant(value=float(begin - 1)))
        helper.main_program.global_block()._prepend_op(
            type='increment', inputs={'X': [counter]},
            outputs={'Out': [counter]}, attrs={'step': float(step)})
        counter.stop_gradient = True
    return counter
