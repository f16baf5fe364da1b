"""Tensor layers (counterpart of paddle_tpu/layers/tensor.py)."""
from __future__ import annotations

from ..framework import convert_np_dtype
from ..layer_helper import LayerHelper

__all__ = ['fill_constant', 'argmax']


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


def argmax(x, axis=0):
    helper = LayerHelper('argmax')
    out = helper.create_variable_for_type_inference(dtype='int64')
    helper.append_op(type='argmax', inputs={'X': [x]},
                     outputs={'Out': [out]}, attrs={'axis': axis})
    return out
