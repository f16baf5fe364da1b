"""Weight-decay regularizers appended onto gradients (counterpart of
paddle_tpu/regularizer.py; the ops they append are plain PyTorch
emitters in ops/math_ops.py)."""
from __future__ import annotations

from .layer_helper import LayerHelper

__all__ = ['L1Decay', 'L2Decay', 'L1DecayRegularizer', 'L2DecayRegularizer',
           'append_regularization_ops']


class WeightDecayRegularizer(object):
    def append_regularization_op(self, param, grad, block):
        raise NotImplementedError


class L2DecayRegularizer(WeightDecayRegularizer):
    def __init__(self, regularization_coeff=0.0):
        self._regularization_coeff = regularization_coeff

    def append_regularization_op(self, param, grad, block):
        helper = LayerHelper('l2_decay')
        decay = helper.create_variable_for_type_inference(dtype=param.dtype)
        block.append_op(type='scale', inputs={'X': [param]},
                        outputs={'Out': [decay]},
                        attrs={'scale': self._regularization_coeff,
                               'op_role': 'backward'})
        new_grad = helper.create_variable_for_type_inference(
            dtype=param.dtype)
        block.append_op(type='sum', inputs={'X': [grad, decay]},
                        outputs={'Out': [new_grad]},
                        attrs={'op_role': 'backward'})
        return block.var(new_grad.name)


class L1DecayRegularizer(WeightDecayRegularizer):
    def __init__(self, regularization_coeff=0.0):
        self._regularization_coeff = regularization_coeff

    def append_regularization_op(self, param, grad, block):
        helper = LayerHelper('l1_decay')
        sign = helper.create_variable_for_type_inference(dtype=param.dtype)
        # sign(x) = x / (|x| + eps) is fine for decay purposes; use
        # dedicated ops for exactness
        abs_ = helper.create_variable_for_type_inference(dtype=param.dtype)
        block.append_op(type='abs', inputs={'X': [param]},
                        outputs={'Out': [abs_]},
                        attrs={'op_role': 'backward'})
        eps_plus = helper.create_variable_for_type_inference(
            dtype=param.dtype)
        block.append_op(type='scale', inputs={'X': [abs_]},
                        outputs={'Out': [eps_plus]},
                        attrs={'scale': 1.0, 'bias': 1e-12,
                               'op_role': 'backward'})
        block.append_op(type='elementwise_div',
                        inputs={'X': [param], 'Y': [eps_plus]},
                        outputs={'Out': [sign]},
                        attrs={'op_role': 'backward'})
        decay = helper.create_variable_for_type_inference(dtype=param.dtype)
        block.append_op(type='scale', inputs={'X': [sign]},
                        outputs={'Out': [decay]},
                        attrs={'scale': self._regularization_coeff,
                               'op_role': 'backward'})
        new_grad = helper.create_variable_for_type_inference(
            dtype=param.dtype)
        block.append_op(type='sum', inputs={'X': [grad, decay]},
                        outputs={'Out': [new_grad]},
                        attrs={'op_role': 'backward'})
        return block.var(new_grad.name)


def append_regularization_ops(parameters_and_grads, regularization=None):
    """Per-param regularizer overrides global (reference
    regularizer.py:24 append_regularization_ops)."""
    params_and_grads = []
    for param, grad in parameters_and_grads:
        if grad is None:
            params_and_grads.append((param, grad))
            continue
        regularization_term = None
        if getattr(param, 'regularizer', None) is not None:
            regularization_term = param.regularizer
        elif regularization is not None:
            regularization_term = regularization
        if regularization_term is None:
            params_and_grads.append((param, grad))
            continue
        new_grad = regularization_term.append_regularization_op(
            param, grad, grad.block)
        params_and_grads.append((param, new_grad))
    return params_and_grads


L1Decay = L1DecayRegularizer
L2Decay = L2DecayRegularizer
