"""Operator overloading on Variable (counterpart of
paddle_tpu/layers/math_op_patch.py: the same op types and attrs). A
Python number becomes a [1] fill_constant of the Variable's dtype."""
from __future__ import annotations

from ..framework import Variable
from ..layer_helper import LayerHelper


def _create_scalar_const(block_var, value):
    from .tensor import fill_constant
    return fill_constant(shape=[1], dtype=block_var.dtype, value=float(value))


def _binary(op_type, reverse=False):
    def impl(self, other):
        if isinstance(other, (int, float)):
            other = _create_scalar_const(self, other)
        elif not isinstance(other, Variable):
            return NotImplemented
        lhs, rhs = (other, self) if reverse else (self, other)
        helper = LayerHelper(op_type)
        out = helper.create_variable_for_type_inference(dtype=lhs.dtype)
        helper.append_op(type=op_type, inputs={'X': [lhs], 'Y': [rhs]},
                         outputs={'Out': [out]}, attrs={'axis': -1})
        return out
    return impl


def _unary_neg(self):
    helper = LayerHelper('scale')
    out = helper.create_variable_for_type_inference(dtype=self.dtype)
    helper.append_op(type='scale', inputs={'X': [self]},
                     outputs={'Out': [out]},
                     attrs={'scale': -1.0, 'bias': 0.0})
    return out


def monkey_patch_variable():
    Variable.__add__ = _binary('elementwise_add')
    Variable.__radd__ = _binary('elementwise_add', reverse=True)
    Variable.__sub__ = _binary('elementwise_sub')
    Variable.__rsub__ = _binary('elementwise_sub', reverse=True)
    Variable.__mul__ = _binary('elementwise_mul')
    Variable.__rmul__ = _binary('elementwise_mul', reverse=True)
    Variable.__truediv__ = _binary('elementwise_div')
    Variable.__rtruediv__ = _binary('elementwise_div', reverse=True)
    Variable.__pow__ = _binary('elementwise_pow')
    Variable.__mod__ = _binary('elementwise_mod')
    Variable.__lt__ = _binary('less_than')
    Variable.__le__ = _binary('less_equal')
    Variable.__gt__ = _binary('greater_than')
    Variable.__ge__ = _binary('greater_equal')
    Variable.__neg__ = _unary_neg


monkey_patch_variable()
