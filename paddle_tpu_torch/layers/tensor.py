"""Tensor layers (counterpart of paddle_tpu/layers/tensor.py, with the
JAX package's signatures and defaults; fill_constant_batch_size_like and
argmin are not ported)."""
from __future__ import annotations

import numpy as np

from ..framework import Variable, convert_np_dtype
from ..layer_helper import LayerHelper
from ..initializer import Constant

__all__ = [
    'create_tensor', 'create_parameter', 'create_global_var', 'cast',
    'concat', 'sums', 'assign', 'fill_constant', 'ones', 'zeros',
    'reverse', 'argmax', 'argsort', 'zeros_like',
]


def create_tensor(dtype, name=None, persistable=False):
    helper = LayerHelper('create_tensor', name=name)
    return helper.create_variable(name=helper.name, dtype=dtype,
                                  persistable=persistable)


def create_parameter(shape, dtype, name=None, attr=None, is_bias=False,
                     default_initializer=None):
    from ..param_attr import ParamAttr
    helper = LayerHelper('create_parameter', name=name)
    if attr is None:
        attr = ParamAttr(name=name)
    return helper.create_parameter(attr, shape, dtype, is_bias,
                                   default_initializer)


def create_global_var(shape, value, dtype, persistable=False,
                      force_cpu=False, name=None):
    helper = LayerHelper('global_var', name=name)
    var = helper.create_global_variable(
        dtype=dtype, shape=shape, persistable=persistable,
        name=name or helper.name)
    helper.set_variable_initializer(var, Constant(value=float(value)))
    return var


def cast(x, dtype):
    helper = LayerHelper('cast')
    dtype = convert_np_dtype(dtype)
    out = helper.create_variable_for_type_inference(dtype=dtype)
    helper.append_op(type='cast', inputs={'X': [x]}, outputs={'Out': [out]},
                     attrs={'in_dtype': x.dtype, 'out_dtype': dtype})
    return out


def concat(input, axis=0, name=None):
    helper = LayerHelper('concat', name=name)
    out = helper.create_variable_for_type_inference(
        dtype=helper.input_dtype())
    helper.append_op(type='concat', inputs={'X': input},
                     outputs={'Out': [out]}, attrs={'axis': axis})
    return out


def sums(input, out=None):
    helper = LayerHelper('sum')
    if out is None:
        out = helper.create_variable_for_type_inference(
            dtype=helper.input_dtype())
    helper.append_op(type='sum', inputs={'X': input}, outputs={'Out': [out]})
    return out


def assign(input, output=None):
    helper = LayerHelper('assign')
    if isinstance(input, Variable):
        if output is None:
            output = helper.create_variable_for_type_inference(
                dtype=input.dtype)
        helper.append_op(type='assign', inputs={'X': [input]},
                         outputs={'Out': [output]})
    elif isinstance(input, np.ndarray):
        dtype = convert_np_dtype(input.dtype)
        if output is None:
            output = helper.create_variable_for_type_inference(dtype=dtype)
        helper.append_op(type='assign_value', outputs={'Out': [output]},
                         attrs={'dtype': dtype, 'shape': list(input.shape),
                                'values': input.tolist()})
    else:
        raise TypeError('assign expects Variable or numpy array')
    return output


def fill_constant(shape, dtype, value, force_cpu=False, out=None):
    helper = LayerHelper('fill_constant')
    dtype = convert_np_dtype(dtype)
    if out is None:
        out = helper.create_variable_for_type_inference(dtype=dtype)
    helper.append_op(
        type='fill_constant', outputs={'Out': [out]},
        attrs={'shape': list(shape), 'dtype': dtype, 'value': float(value)})
    out.stop_gradient = True
    return out


def ones(shape, dtype, force_cpu=False):
    return fill_constant(shape=shape, dtype=dtype, value=1.0)


def zeros(shape, dtype, force_cpu=False):
    return fill_constant(shape=shape, dtype=dtype, value=0.0)


def zeros_like(x, out=None):
    helper = LayerHelper('zeros_like')
    if out is None:
        out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op(type='fill_zeros_like', inputs={'X': [x]},
                     outputs={'Out': [out]})
    return out


def reverse(x, axis):
    helper = LayerHelper('reverse')
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    if isinstance(axis, int):
        axis = [axis]
    helper.append_op(type='reverse', inputs={'X': [x]},
                     outputs={'Out': [out]}, attrs={'axis': axis})
    return out


def argmax(x, axis=0):
    helper = LayerHelper('argmax')
    out = helper.create_variable_for_type_inference(dtype='int64')
    helper.append_op(type='argmax', inputs={'X': [x]},
                     outputs={'Out': [out]}, attrs={'axis': axis})
    return out


def argsort(x, axis=-1, name=None):
    helper = LayerHelper('argsort', name=name)
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    ids = helper.create_variable_for_type_inference(dtype='int64')
    helper.append_op(type='argsort', inputs={'X': [x]},
                     outputs={'Out': [out], 'Indices': [ids]},
                     attrs={'axis': axis})
    return out, ids
