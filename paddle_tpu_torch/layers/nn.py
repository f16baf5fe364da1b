"""NN layer functions (counterpart of paddle_tpu/layers/nn.py). Each
layer appends ops to the current block; nothing executes here."""
from __future__ import annotations

import numpy as np

from ..layer_helper import LayerHelper
from ..initializer import Constant

__all__ = [
    'fc', 'embedding', 'layer_norm', 'softmax', 'matmul',
    'elementwise_add', 'reshape', 'transpose', 'slice', 'causal_mask_bias',
    'position_embedding', 'mean', 'square_error_cost', 'cross_entropy',
]


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
    if len(mul_results) != 1:
        raise NotImplementedError('fc over several inputs (the sum op) '
                                  'is not ported')
    pre_act = helper.append_bias_op(mul_results[0],
                                    dim_start=num_flatten_dims)
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


def elementwise_add(x, y, axis=-1, act=None, name=None):
    helper = LayerHelper('elementwise_add', act=act, name=name)
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op(type='elementwise_add', inputs={'X': [x], 'Y': [y]},
                     outputs={'Out': [out]}, attrs={'axis': axis})
    return helper.append_activation(out)


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
